"""Core NN building blocks, eval mode (counterpart of vipformer_tpu/nn/layers.py).

Parameters are f32, as in the flax tree; every module takes the compute
dtype (`dtype`, None = promote the input with f32) and casts at use.
Attribute names follow the flax auto-names (`Dense_0`, `LayerNorm_0`,
`CrossAttention_0`, ...), so state-dict keys are the flax paths with `/`
replaced by `.` (see convert.py). Dropout and DropPath are identities in
eval and are not modelled.

The eval kernels are wired where the JAX package wires its Pallas ones:
the cross-attention's kv-LN-fused kernel K4 in `CrossAttention`
(layers.py:652-692 of the JAX package), the small-M self-attention kernel
K5 in `MultiHeadAttention` (layers.py:539-555).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vipformer_tpu_torch.ops.attention import dot_product_attention
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda.stem import BN_EPS


def promote_dtype(x: torch.Tensor, dtype) -> torch.dtype:
    """flax's promote_dtype: the module's dtype, else the input promoted
    with the f32 parameters."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, erf form 0.5*x*(1+erf(x/sqrt(2))), evaluated in f32."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


class Dense(nn.Module):
    """Linear layer: the product in the compute dtype (f32-accumulated,
    rounded on emit), cast, THEN the bias added in the compute dtype.
    Not `F.linear`, whose fused bias rounds once instead of twice."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_features)  # torch nn.Linear default init
        nn.init.uniform_(self.weight, -bound, bound)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound)

    def kernel(self, dt) -> torch.Tensor:
        """The weight as the flax kernel [in, out] in dtype `dt`."""
        return self.weight.to(dt).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote_dtype(x, self.dtype)
        y = x.to(dt) @ self.kernel(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class LayerNorm(nn.Module):
    """flax LayerNorm math: f32 fast variance max(0, E[x^2]-E[x]^2),
    eps 1e-5, cast to the compute dtype at the end."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kattn.layer_norm_f32(x, self.weight, self.bias, promote_dtype(x, self.dtype))


class BatchNorm(nn.Module):
    """Eval BatchNorm with running statistics (flax `_normalize`):
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, then cast."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(promote_dtype(x, self.dtype))


class MLP(nn.Module):
    """LN -> Dense(widen*D) -> GELU(exact) -> Dense(D)."""

    def __init__(self, d: int, widening_factor: int, dtype=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d, dtype)
        self.Dense_0 = Dense(d, widening_factor * d, dtype=dtype)
        self.Dense_1 = Dense(widening_factor * d, d, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(gelu_exact(self.Dense_0(self.LayerNorm_0(x))))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with q/k/v/output widths equal to the query's
    (the mp family; the Perceiver family's decoupled widths come with its
    slice)."""

    def __init__(self, d: int, num_heads: int, dtype=None):
        super().__init__()
        if d % num_heads:
            raise ValueError("channels must be divisible by num_heads")
        self.num_heads = num_heads
        self.scale = (d // num_heads) ** -0.5
        self.q_proj = Dense(d, d, use_bias=False, dtype=dtype)
        self.k_proj = Dense(d, d, use_bias=False, dtype=dtype)
        self.v_proj = Dense(d, d, use_bias=False, dtype=dtype)
        self.o_proj = Dense(d, d, dtype=dtype)

    def forward(self, x_q, x_kv):
        h = self.num_heads
        q, k, v = self.q_proj(x_q), self.k_proj(x_kv), self.v_proj(x_kv)
        if x_kv.shape[1] < 512 and x_q.shape[1] <= 512:
            # small-M eval attention (K5); large M belongs to the streamed
            # packed kernel (JAX attention.py:848), not ported yet
            o = kattn.fused_attention_packed_small(q, k, v, num_heads=h, scale=self.scale)
            return self.o_proj(o)

        def split(t):  # [B, N, H*C] -> [B, H, N, C]
            return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

        o = dot_product_attention(split(q), split(k), split(v), scale=self.scale)
        b, _, n, c = o.shape
        return self.o_proj(o.transpose(1, 2).reshape(b, n, h * c))


class CrossAttention(nn.Module):
    """Pre-LN cross-attention (separate q / kv norms). Eval runs K4: the kv
    LayerNorm and the k/v projections inside the attention kernel; the
    q/o projections are the Dense modules."""

    def __init__(self, d: int, num_heads: int, dtype=None):
        super().__init__()
        self.q_norm = LayerNorm(d, dtype)
        self.kv_norm = LayerNorm(d, dtype)
        self.attention = MultiHeadAttention(d, num_heads, dtype)

    def forward(self, x_q, x_kv):
        att = self.attention
        q = att.q_proj(self.q_norm(x_q))
        dt = q.dtype
        o = kattn.fused_attention_packed_kv_ln(
            q, x_kv.to(dt), self.kv_norm.weight, self.kv_norm.bias,
            att.k_proj.kernel(dt), att.v_proj.kernel(dt),
            num_heads=att.num_heads, scale=att.scale,
        )
        return att.o_proj(o)


class SelfAttention(nn.Module):
    """Pre-LN self-attention."""

    def __init__(self, d: int, num_heads: int, dtype=None):
        super().__init__()
        self.norm = LayerNorm(d, dtype)
        self.attention = MultiHeadAttention(d, num_heads, dtype)

    def forward(self, x):
        xn = self.norm(x)
        return self.attention(xn, xn)


class CrossAttentionLayer(nn.Module):
    """Residual(cross-attn) + Residual(MLP)."""

    def __init__(self, d: int, num_heads: int, widening_factor: int = 1, dtype=None):
        super().__init__()
        self.CrossAttention_0 = CrossAttention(d, num_heads, dtype)
        self.MLP_0 = MLP(d, widening_factor, dtype)

    def forward(self, x_q, x_kv):
        x = self.CrossAttention_0(x_q, x_kv) + x_q
        return self.MLP_0(x) + x


class SelfAttentionLayer(nn.Module):
    """Residual(self-attn) + Residual(MLP)."""

    def __init__(self, d: int, num_heads: int, widening_factor: int = 1, dtype=None):
        super().__init__()
        self.SelfAttention_0 = SelfAttention(d, num_heads, dtype)
        self.MLP_0 = MLP(d, widening_factor, dtype)

    def forward(self, x):
        x = self.SelfAttention_0(x) + x
        return self.MLP_0(x) + x


def dpr_schedule(max_dpr: float, num_layers: int) -> list[float]:
    """Per-layer linspace DropPath schedule 0 -> max_dpr."""
    if num_layers == 1:
        return [0.0]
    return [max_dpr * i / (num_layers - 1) for i in range(num_layers)]
