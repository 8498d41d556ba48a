"""Core NN building blocks (counterpart of vipformer_tpu/nn/layers.py).

Parameters are f32, as in the flax tree; every module takes the compute
dtype (`dtype`, None = promote the input with f32) and casts at use.
Attribute names follow the flax auto-names (`Dense_0`, `LayerNorm_0`,
`CrossAttention_0`, ...), so state-dict keys are the flax paths with `/`
replaced by `.` (see convert.py).

Train mode is the module's `training` flag (`model.train()`), the JAX
package's `deterministic=False`. Its randomness (attention dropout,
residual dropout, DropPath) draws from the `generator` argument that the
attention layers take; a nonzero rate without a generator raises.

The kernels are wired where the JAX package wires its Pallas ones, behind
the port's copies of its gates (ops/cuda/attention.py, flash_train.py,
dense.py): in eval, the cross-attention's kv-LN-fused kernel K4 in
`CrossAttention` (layers.py:652-692 of the JAX package), the LN+qkv-folded
self-attention kernel K6 in `SelfAttention` (layers.py:725-758), and in
`MultiHeadAttention` the k/v-folded kernel K15, the streamed packed kernel
K13 and the small-M kernel K5 (layers.py:451-555); in train mode, the
kv-folded training kernel K7 in `CrossAttention` (layers.py:605-650), the
training flash kernel K8 in `MultiHeadAttention` (layers.py:487-511), and
the Dense weight-gradient kernel K11 in every `Dense` whose rows fall in
its window (layers.py:171-180); and, only where their flags force them
(auto is off, as in JAX), the head-split attention K14 in
`MultiHeadAttention` where no packed kernel takes the site (a v width
other than the q/k width; ops/attention.py:53-67 of the JAX package),
the row LayerNorm K17 in `LayerNorm` and the train-mode BatchNorm
reductions K18 in `BatchNorm`. The gates keep the
JAX conditions only (with each kernel's shared memory in place of the
TPU's VMEM), so on the
card a site the JAX package gives a kernel runs one, or fails where the
kernel cannot take its shapes; the plain attention runs where no gate
holds: on the CPU ("auto" means the card, and the flags force the
kernels' plain twins there), and on the card only where the JAX package
too runs XLA's attention.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vipformer_tpu_torch.ops.attention import dot_product_attention
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.ops.cuda import flash_train as kflash
from vipformer_tpu_torch.ops.cuda import layernorm as kln
from vipformer_tpu_torch.ops.cuda.stem import BN_EPS
from vipformer_tpu_torch.parallel.mesh import all_reduce_sum, data_axis_size
from vipformer_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

BN_MOMENTUM = 0.9  # flax's; torch momentum 0.1


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
    Not `F.linear`, whose fused bias rounds once instead of twice. In train
    mode, where K11's gate holds for its row count, the same math runs as
    `dense_apply`, whose backward takes dW and db from K11.

    A tuple input is an implicit channel concat (JAX layers.py:60-155): the
    parameters are those of a Dense over the concatenation, the forward is
    one product per segment, summed in order. A segment may be an
    `(array, post_fn)` pair, `post_fn` applied to that segment's product
    (a linear operator hoisted through the layer). The bias rides the
    post-free segment with the most rows (else is added to the sum), and
    each segment takes K11 on its own row count; segments broadcast
    against each other, so a [B, 1, C] segment is multiplied once per
    cloud.

    Tensor parallelism (`shard`, parallel/sharding.py): a "col" Dense
    holds its rank's rows of the output features (and of the bias), a
    "row" Dense the matching columns of the input features, its partial
    products summed over the model group (`reduce_from_model`) before the
    whole bias is added, JAX's cast-then-bias order. K11 then sees the
    local operands, as JAX's (dense.py:222-252): a col Dense's dW from its
    local dy, a row Dense's from its local x, with no model reduction."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype = dtype
        self.tp_role: str | None = None  # "col", "row" or None (replicated)
        bound = 1.0 / math.sqrt(in_features)  # torch nn.Linear default init
        nn.init.uniform_(self.weight, -bound, bound)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound)

    @torch.no_grad()
    def shard(self, role: str, t: int, i: int) -> None:
        """Keep model rank i's slice of T: the output rows ("col", with the
        bias's) or the input columns ("row"); each kept parameter is marked
        with the torch axis it is split on (`tp_dim`)."""
        dim = 0 if role == "col" else 1
        n = self.weight.shape[dim] // t
        self.weight = nn.Parameter(self.weight.narrow(dim, i * n, n).clone())
        self.weight.tp_dim = dim
        if role == "col" and self.bias is not None:
            self.bias = nn.Parameter(self.bias[i * n:(i + 1) * n].clone())
            self.bias.tp_dim = 0
        self.tp_role = role

    def kernel(self, dt) -> torch.Tensor:
        """The weight as the flax kernel [in, out] in dtype `dt`."""
        return self.weight.to(dt).t()

    def _product(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None):
        if (self.training and torch.is_grad_enabled()
                and kdense.dense_grad_enabled(x.numel() // x.shape[-1], w.shape[0], w.shape[1],
                                              x.element_size(), x.is_cuda)):
            return kdense.dense_apply(x, w, b)
        y = x @ w
        return y + b if b is not None else y

    def forward(self, x) -> torch.Tensor:
        segs = [s if isinstance(s, tuple) else (s, None)
                for s in (x if isinstance(x, (tuple, list)) else (x,))]
        dt = self.dtype
        if dt is None:
            dt = torch.float32
            for s, _ in segs:
                dt = torch.promote_types(dt, s.dtype)
        w = self.kernel(dt)
        bias = self.bias.to(dt) if self.bias is not None else None
        if self.tp_role == "row":
            if len(segs) > 1 or segs[0][1] is not None:
                raise ValueError("a row-sharded Dense takes one plain input")
            y = reduce_from_model(self._product(segs[0][0].to(dt), w, None))
            return y + bias if bias is not None else y
        free = [i for i, (_, post) in enumerate(segs) if post is None]
        bias_seg = max(free, key=lambda i: segs[i][0].numel() // segs[i][0].shape[-1],
                       default=None)
        y, off = None, 0
        for i, (s, post) in enumerate(segs):
            c = s.shape[-1]
            part = self._product(s.to(dt), w[off:off + c], bias if i == bias_seg else None)
            if post is not None:
                part = post(part)
            y = part if y is None else y + part
            off += c
        return y + bias if bias is not None and bias_seg is None else y


class LayerNorm(nn.Module):
    """flax LayerNorm math: f32 fast variance max(0, E[x^2]-E[x]^2),
    eps 1e-5, cast to the compute dtype at the end. Where K17's gate holds
    (only when `ops.cuda.layernorm.USE_LAYERNORM` forces it, as JAX
    layers.py:251-259) the same function runs through K17, its output in
    x's dtype and then cast."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = promote_dtype(x, self.dtype)
        if kln.layernorm_enabled(x.numel() // x.shape[-1], x.shape[-1], x.element_size()):
            return kln.layernorm_apply(x, self.weight, self.bias).to(out_dtype)
        return kattn.layer_norm_f32(x, self.weight, self.bias, out_dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax nn.Dropout in train mode: keep with probability 1 - rate,
    kept values divided by 1 - rate."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): one keep draw per row
    of the leading axis."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("DropPath needs a torch.Generator")
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=generator.device).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """BatchNorm with flax's math (`_compute_stats` / `_normalize`):
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, then cast. Eval
    uses the running statistics; train mode the f32 batch statistics over
    every axis but the last, with the fast variance max(0, E[x^2] - E[x]^2),
    and updates the running ones with momentum 0.9 and the BIASED batch
    variance (flax's rule, not torch.nn.BatchNorm1d's unbiased one).
    Where K18's gate holds in train mode (only when
    `ops.cuda.batchnorm.USE_BN_TRAIN` forces it, as JAX layers.py:346-377
    and :320-325) the statistics and the backward's column sums come from
    K18 (`bn_train_apply`), its output in x's dtype and then cast.
    Under data parallelism (a process group of W > 1 ranks) it is sync-BN,
    as JAX's over its data axis (layers.py:346-377): the batch statistics
    are over every rank's rows, from the all-reduced [sum x, sum x^2] and
    the global row count, in f32 and through autograd (the backward's
    column sums are all-reduced the same way), so the running statistics
    come out equal on every rank."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = promote_dtype(x, self.dtype)
        if self.training and kbn.bn_train_enabled(x.numel() // x.shape[-1], x.shape[-1],
                                                  x.element_size()):
            y, mean, var = kbn.bn_train_apply(x, self.weight, self.bias, BN_EPS)
            self.update_running(mean.detach(), var.detach())
            return y.to(out_dtype)
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            if data_axis_size() > 1:
                count = torch.full((1,), x.numel() // x.shape[-1], dtype=torch.float32,
                                   device=x.device)
                sums = all_reduce_sum(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                                                 count]))
                c = x.shape[-1]
                mean = sums[:c] / sums[-1]
                var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(out_dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = 0.9 * ra + 0.1 * batch statistic (flax's update)."""
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class MLP(nn.Module):
    """LN -> Dense(widen*D) -> GELU(exact) -> Dense(D). Under tensor
    parallelism Dense_0 is column- and Dense_1 row-sharded: each model
    rank computes its slice of the hidden units, and the normalised input
    passes `copy_to_model` first."""

    def __init__(self, d: int, widening_factor: int, dtype=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d, dtype)
        self.Dense_0 = Dense(d, widening_factor * d, dtype=dtype)
        self.Dense_1 = Dense(widening_factor * d, d, dtype=dtype)

    def forward(self, x):
        h = self.LayerNorm_0(x)
        if self.Dense_0.tp_role == "col":
            h = copy_to_model(h)
        return self.Dense_1(gelu_exact(self.Dense_0(h)))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with decoupled widths (JAX layers.py:413-578):
    q_proj d -> qk, k_proj kv_in -> qk, v_proj kv_in -> v, o_proj v -> out
    (defaults: qk = d, v = qk, out = d, kv_in = d, on which the mp family
    runs). `dropout` is the post-softmax attention dropout of train mode.

    Routes as the JAX module does, by the port's copies of its gates: in
    eval the k/v-projection-folded kernel K15, else (after the
    projections) the training kernel K8 in train mode, the streamed packed
    kernel K13, the small-M kernel K5, and last the head-split attention:
    K14 where its gate holds (the only kernel that takes v != qk), else the
    plain attention with its dropout.

    Tensor parallelism (`shard_heads`, from parallel/sharding.py
    `shard_model`): model rank i of T runs heads [i H/T, (i+1) H/T), its
    q/k/v projections column- and o_proj row-sharded, so `num_heads`,
    `qk_channels` and `v_channels` are the rank's own and every route
    above (K5, K8, K13, K14, K15 and the plain one) runs on them; the
    inputs pass `copy_to_model` first. The plain route's dropout draws
    the mask of all H heads and keeps this rank's, the one-process mask."""

    def __init__(self, d: int, num_heads: int, dtype=None, dropout: float = 0.0, *,
                 kv_in: int | None = None, qk_channels: int | None = None,
                 v_channels: int | None = None, out_channels: int | None = None):
        super().__init__()
        qk = qk_channels or d
        v = v_channels or qk
        if qk % num_heads or v % num_heads:
            raise ValueError("qk/v channels must be divisible by num_heads")
        kv_in = kv_in or d
        self.num_heads = num_heads
        self.qk_channels, self.v_channels = qk, v
        self.model_axis, self.head_offset = 1, 0
        self.dropout = dropout
        self.scale = (qk // num_heads) ** -0.5
        self.q_proj = Dense(d, qk, use_bias=False, dtype=dtype)
        self.k_proj = Dense(kv_in, qk, use_bias=False, dtype=dtype)
        self.v_proj = Dense(kv_in, v, use_bias=False, dtype=dtype)
        self.o_proj = Dense(v, out_channels or d, dtype=dtype)

    def shard_heads(self, t: int, i: int) -> None:
        """Run model rank i's H / T heads (its Denses are sliced by
        `shard_model` after this, by their paths' roles)."""
        self.num_heads //= t
        self.qk_channels //= t
        self.v_channels //= t
        self.model_axis, self.head_offset = t, i * self.num_heads

    def forward(self, x_q, x_kv, generator=None):
        if self.model_axis > 1:
            same = x_kv is x_q
            x_q = copy_to_model(x_q)
            x_kv = x_q if same else copy_to_model(x_kv)
        h, qk, vc = self.num_heads, self.qk_channels, self.v_channels
        g, m = x_q.shape[1], x_kv.shape[1]
        on_card = x_q.is_cuda
        if kattn.packed_attention_kv_enabled(h, qk, vc, m, x_kv.shape[-1], self.dropout,
                                             self.training, on_card):
            # K15: each kv chunk projected inside the kernel, so the
            # [B, M, H*dh] k and v never exist in memory
            q = self.q_proj(x_q)
            dt = q.dtype
            o = kattn.fused_attention_packed_kv(q, x_kv.to(dt), self.k_proj.kernel(dt),
                                                self.v_proj.kernel(dt), num_heads=h,
                                                scale=self.scale)
            return self.o_proj(o)
        q, k, v = self.q_proj(x_q), self.k_proj(x_kv), self.v_proj(x_kv)
        if kflash.flash_train_enabled(h, qk, vc, self.training, on_card):
            # training flash attention with in-kernel dropout (K8): the
            # scores and the mask never exist in memory; the backward
            # regenerates the mask from the seed
            seed = kflash.draw_seed(generator, self.dropout, q.device)
            o = kflash.flash_attention_train(q, k, v, seed, h, self.scale, self.dropout,
                                             sharded=self.model_axis > 1)
            return self.o_proj(o)
        if kattn.packed_attention_enabled(h, qk, vc, m, self.dropout, self.training, on_card):
            o = kattn.fused_attention_packed(q, k, v, num_heads=h, scale=self.scale)  # K13
            return self.o_proj(o)
        if kattn.packed_small_attention_enabled(h, qk, vc, g, m, self.dropout, self.training,
                                                on_card):
            o = kattn.fused_attention_packed_small(q, k, v, num_heads=h, scale=self.scale)  # K5
            return self.o_proj(o)

        def split(t):  # [B, N, H*C] -> [B, H, N, C]
            return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

        if kattn.fused_attention_enabled(self.dropout, self.training):
            o = kattn.fused_attention(split(q), split(k), split(v), scale=self.scale)  # K14
        else:
            rate = self.dropout if self.training else 0.0
            o = dot_product_attention(split(q), split(k), split(v), scale=self.scale,
                                      dropout_rate=rate, generator=generator,
                                      heads=(self.head_offset, h * self.model_axis))
        b, _, n, c = o.shape
        return self.o_proj(o.transpose(1, 2).reshape(b, n, h * c))


class CrossAttention(nn.Module):
    """Pre-LN cross-attention (separate q / kv norms; the kv norm over the
    tokens' own width `kv_in`; the q/k, v and output widths as
    MultiHeadAttention's). Where the JAX gates hold (layers.py:
    594-692) the kv LayerNorm and the k/v projections run inside the
    attention kernel: K7 (with dropout, and a backward into x, the LN and
    the weights) in train mode, K4 in eval; the q/o projections are the
    Dense modules. Elsewhere (raw tokens whose width is not a multiple of
    128, as the Fourier image tokens; M < 512 in eval) both norms run here
    and the MultiHeadAttention routes the rest. Under tensor parallelism
    K7 and K4 run on this model rank's heads and its column slices of wk
    and wv; the normalised queries pass `copy_to_model` before q_proj and
    the raw kv tokens before K7, whose dx is then summed over the model
    group by the copy's backward (JAX flash_train.py:821-830)."""

    def __init__(self, d: int, num_heads: int, dtype=None, dropout: float = 0.0, *,
                 kv_in: int | None = None, qk_channels: int | None = None,
                 v_channels: int | None = None, out_channels: int | None = None):
        super().__init__()
        self.q_norm = LayerNorm(d, dtype)
        self.kv_norm = LayerNorm(kv_in or d, dtype)
        self.attention = MultiHeadAttention(d, num_heads, dtype, dropout, kv_in=kv_in,
                                            qk_channels=qk_channels, v_channels=v_channels,
                                            out_channels=out_channels)

    def forward(self, x_q, x_kv, generator=None):
        att = self.attention
        h, qk, vc = att.num_heads, att.qk_channels, att.v_channels
        m, din = x_kv.shape[1], x_kv.shape[-1]
        on_card = x_q.is_cuda
        sharded = att.model_axis > 1
        if kflash.flash_train_kv_enabled(h, qk, vc, din, self.training, on_card):
            xq = self.q_norm(x_q)
            q = att.q_proj(copy_to_model(xq) if sharded else xq)
            dt = q.dtype
            xkv = copy_to_model(x_kv.to(dt)) if sharded else x_kv.to(dt)
            seed = kflash.draw_seed(generator, att.dropout, q.device)
            o = kflash.flash_attention_train_kv(
                q, xkv, self.kv_norm.weight, self.kv_norm.bias,
                att.k_proj.kernel(dt), att.v_proj.kernel(dt), seed,
                h, att.scale, att.dropout, sharded=sharded,
            )
            return att.o_proj(o)
        if kattn.packed_attention_kv_enabled(h, qk, vc, m, din, att.dropout, self.training,
                                             on_card):
            q = att.q_proj(self.q_norm(x_q))
            dt = q.dtype
            o = kattn.fused_attention_packed_kv_ln(
                q, x_kv.to(dt), self.kv_norm.weight, self.kv_norm.bias,
                att.k_proj.kernel(dt), att.v_proj.kernel(dt), num_heads=h, scale=att.scale,
            )
            return att.o_proj(o)
        return att(self.q_norm(x_q), self.kv_norm(x_kv), generator)


class SelfAttention(nn.Module):
    """Pre-LN self-attention. In eval, where K6's gate holds, the pre-LN
    and the q/k/v projections run inside K6 and only o_proj stays a Dense
    (JAX layers.py:725-758); elsewhere the MultiHeadAttention routes (K15
    at 512 latents, where K6's tiles do not fit; K14 at unequal q/k and v
    widths, which no packed kernel takes). Under tensor parallelism K6
    runs on this model rank's heads with its column slices of wq|wk|wv,
    then the row-sharded o_proj (JAX turns K6 off on any mesh of more
    than one device, attention.py:807-812, for want of a shard_map
    wrapper; the result is the same, ops/cuda/attention.py)."""

    def __init__(self, d: int, num_heads: int, dtype=None, dropout: float = 0.0, *,
                 qk_channels: int | None = None, v_channels: int | None = None):
        super().__init__()
        self.norm = LayerNorm(d, dtype)
        self.attention = MultiHeadAttention(d, num_heads, dtype, dropout,
                                            qk_channels=qk_channels, v_channels=v_channels)

    def forward(self, x, generator=None):
        att = self.attention
        b, g, din = x.shape
        if kattn.packed_small_qkv_ln_enabled(att.num_heads, att.qk_channels, att.v_channels, b,
                                             g, din, self.training, x.is_cuda):
            dt = promote_dtype(x, self.norm.dtype)
            o = kattn.fused_attention_packed_small_qkv_ln(
                x.to(dt), self.norm.weight, self.norm.bias, att.q_proj.kernel(dt),
                att.k_proj.kernel(dt), att.v_proj.kernel(dt), num_heads=att.num_heads,
                scale=att.scale)
            return att.o_proj(o)
        xn = self.norm(x)
        return att(xn, xn, generator)


class _ResidualLayer(nn.Module):
    """residual = drop_path(dropout(f(x)) + x), DropPath wrapping the sum
    (JAX layers.py:799-806, 842-846); identities in eval."""

    def _residual(self, y, x, rate, generator):
        if not self.training:
            return y + x
        y = dropout(y, rate, generator)
        return drop_path(y + x, self.drop_path_rate, generator)


class CrossAttentionLayer(_ResidualLayer):
    """Residual(cross-attn) + Residual(MLP). Train mode: attention dropout
    `atten_drop` inside the kernel and on the attention output, `mlp_drop`
    on the MLP output, DropPath `drop_path_rate` on both sums. The
    residual adds the attention output to the queries, so `out_channels`
    (JAX num_output_channels) can only be d here."""

    def __init__(self, d: int, num_heads: int, widening_factor: int = 1, dtype=None,
                 atten_drop: float = 0.0, mlp_drop: float = 0.0, drop_path_rate: float = 0.0, *,
                 kv_in: int | None = None, qk_channels: int | None = None,
                 v_channels: int | None = None, out_channels: int | None = None):
        super().__init__()
        if out_channels not in (None, d):
            raise ValueError(f"the residual needs out_channels == d ({d}), got {out_channels}")
        self.CrossAttention_0 = CrossAttention(d, num_heads, dtype, atten_drop, kv_in=kv_in,
                                               qk_channels=qk_channels, v_channels=v_channels)
        self.MLP_0 = MLP(d, widening_factor, dtype)
        self.atten_drop, self.mlp_drop = atten_drop, mlp_drop
        self.drop_path_rate = drop_path_rate

    def forward(self, x_q, x_kv, generator=None):
        x = self._residual(self.CrossAttention_0(x_q, x_kv, generator), x_q, self.atten_drop,
                           generator)
        return self._residual(self.MLP_0(x), x, self.mlp_drop, generator)


class SelfAttentionLayer(_ResidualLayer):
    """Residual(self-attn) + Residual(MLP). `post_attn_drop` is the
    dropout on the attention output (the mp family passes mlp_drop,
    JAX layers.py:812-815); None means atten_drop."""

    def __init__(self, d: int, num_heads: int, widening_factor: int = 1, dtype=None,
                 atten_drop: float = 0.0, mlp_drop: float = 0.0, drop_path_rate: float = 0.0,
                 post_attn_drop: float | None = None, *, qk_channels: int | None = None,
                 v_channels: int | None = None):
        super().__init__()
        self.SelfAttention_0 = SelfAttention(d, num_heads, dtype, atten_drop,
                                             qk_channels=qk_channels, v_channels=v_channels)
        self.MLP_0 = MLP(d, widening_factor, dtype)
        self.post_attn_drop = atten_drop if post_attn_drop is None else post_attn_drop
        self.mlp_drop = mlp_drop
        self.drop_path_rate = drop_path_rate

    def forward(self, x, generator=None):
        x = self._residual(self.SelfAttention_0(x, generator), x, self.post_attn_drop, generator)
        return self._residual(self.MLP_0(x), x, self.mlp_drop, generator)


def dpr_schedule(max_dpr: float, num_layers: int) -> list[float]:
    """Per-layer linspace DropPath schedule 0 -> max_dpr."""
    if num_layers == 1:
        return [0.0]
    return [max_dpr * i / (num_layers - 1) for i in range(num_layers)]


class SelfAttentionBlock(nn.Module):
    """A stack of SelfAttentionLayers (`SelfAttentionLayer_{i}`, the flax
    names) with the linspace DropPath schedule 0 -> `max_dpr` (JAX
    layers.py:857-896)."""

    def __init__(self, num_layers: int, d: int, num_heads: int, widening_factor: int = 1,
                 dtype=None, max_dpr: float = 0.0, atten_drop: float = 0.0,
                 mlp_drop: float = 0.0, post_attn_drop: float | None = None, *,
                 qk_channels: int | None = None, v_channels: int | None = None):
        super().__init__()
        self.num_layers = num_layers
        for i, rate in enumerate(dpr_schedule(max_dpr, num_layers)):
            self.add_module(f"SelfAttentionLayer_{i}", SelfAttentionLayer(
                d, num_heads, widening_factor, dtype, atten_drop, mlp_drop, rate,
                post_attn_drop, qk_channels=qk_channels, v_channels=v_channels))

    def forward(self, x, generator=None):
        for i in range(self.num_layers):
            x = getattr(self, f"SelfAttentionLayer_{i}")(x, generator)
        return x
