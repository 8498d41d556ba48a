"""The generic Perceiver family's encoder and decoder, latent pooling and
the contrastive head (counterpart of vipformer_tpu/nn/perceiver.py, the
reference's non-`--mp` path)."""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.adapters import latent_init
from vipformer_tpu_torch.nn.layers import (
    BatchNorm,
    CrossAttentionLayer,
    Dense,
    SelfAttentionBlock,
)


def pool_latents(x_latent: torch.Tensor) -> torch.Tensor:
    """concat[max-pool, mean-pool] over the latent axis: [B, G, D] -> [B, 2D]."""
    return torch.cat([x_latent.amax(dim=1), x_latent.mean(dim=1)], dim=-1)


class LatentFeatsHead(nn.Module):
    """BN -> ReLU -> Dense(D, no bias) -> BN -> ReLU -> Dense(D, no bias),
    over the pooled [B, 2D] features."""

    def __init__(self, num_latent_channels: int, dtype=None):
        super().__init__()
        d = num_latent_channels
        self.BatchNorm_0 = BatchNorm(2 * d, dtype)
        self.Dense_0 = Dense(2 * d, d, use_bias=False, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(d, dtype)
        self.Dense_1 = Dense(d, d, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(torch.relu(self.BatchNorm_0(x)))
        return self.Dense_1(torch.relu(self.BatchNorm_1(x)))


class PerceiverEncoder(nn.Module):
    """Latent-bottleneck encoder (JAX perceiver.py:57-154): the learned
    latents `latent` [N, D] (N(0, 0.02) clamped to +-2) cross-attend to the
    input tokens [B, M, Din], then run the self-attention blocks.

    Block i (0-based) runs a cross-attention first while i <
    `num_cross_attention_layers`, then a SelfAttentionBlock. The first
    cross-attention is `cross_attn_n` itself when
    `first_cross_attention_layer_shared` or there is one cross-attention
    layer, else its own `cross_attn_1`; the first SA block likewise
    (`self_attn_1`, shared by default). A shared module exists once, under
    its `_n` name, as in the flax tree, so its parameters are in the state
    dict and the optimizer once. Train mode: attention dropout
    `atten_drop` (also on the attention outputs), `mlp_drop` on the MLP
    outputs, DropPath 0 -> `max_dpr` over each SA block's layers. The
    `num_*_qk_channels` / `num_*_v_channels` set the attentions' q/k and v
    widths (default: the query width, and v = qk); a v width other than
    the q/k width takes the head-split attention (K14 where forced)."""

    def __init__(self, num_latents: int, num_latent_channels: int, num_input_channels: int,
                 num_cross_attention_heads: int = 4,
                 num_cross_attention_qk_channels: int | None = None,
                 num_cross_attention_v_channels: int | None = None,
                 num_cross_attention_layers: int = 1,
                 first_cross_attention_layer_shared: bool = False,
                 cross_attention_widening_factor: int = 1, num_self_attention_heads: int = 4,
                 num_self_attention_qk_channels: int | None = None,
                 num_self_attention_v_channels: int | None = None,
                 num_self_attention_layers_per_block: int = 6,
                 num_self_attention_blocks: int = 1,
                 first_self_attention_block_shared: bool = True,
                 self_attention_widening_factor: int = 1, max_dpr: float = 0.0,
                 atten_drop: float = 0.1, mlp_drop: float = 0.5, dtype=None):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        if num_self_attention_blocks <= 0:
            raise ValueError("num_self_attention_blocks must be > 0")
        if num_cross_attention_layers > num_self_attention_blocks:
            raise ValueError("num_cross_attention_layers must be <= num_self_attention_blocks")
        d = num_latent_channels
        self.num_cross_attention_layers = num_cross_attention_layers
        self.num_self_attention_blocks = num_self_attention_blocks

        def cross_attn():
            return CrossAttentionLayer(
                d, num_cross_attention_heads, cross_attention_widening_factor, dtype,
                atten_drop, mlp_drop, kv_in=num_input_channels,
                qk_channels=num_cross_attention_qk_channels,
                v_channels=num_cross_attention_v_channels)

        def self_attn():
            return SelfAttentionBlock(
                num_self_attention_layers_per_block, d, num_self_attention_heads,
                self_attention_widening_factor, dtype, max_dpr, atten_drop, mlp_drop,
                qk_channels=num_self_attention_qk_channels,
                v_channels=num_self_attention_v_channels)

        self.cross_attn_n = cross_attn()
        self.self_attn_n = self_attn()
        self.share_ca = first_cross_attention_layer_shared or num_cross_attention_layers == 1
        self.share_sa = first_self_attention_block_shared or num_self_attention_blocks == 1
        if not self.share_ca:
            self.cross_attn_1 = cross_attn()
        if not self.share_sa:
            self.self_attn_1 = self_attn()
        self.latent = nn.Parameter(latent_init((num_latents, d)))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """x [B, M, Din] tokens -> latents [B, N, D] in x's dtype."""
        x_latent = self.latent.to(x.dtype)[None].expand(x.shape[0], -1, -1)
        first_ca = self.cross_attn_n if self.share_ca else self.cross_attn_1
        first_sa = self.self_attn_n if self.share_sa else self.self_attn_1
        x_latent = first_sa(first_ca(x_latent, x, generator), generator)
        for i in range(1, self.num_self_attention_blocks):
            if i < self.num_cross_attention_layers:
                x_latent = self.cross_attn_n(x_latent, x, generator)
            x_latent = self.self_attn_n(x_latent, generator)
        return x_latent


class PerceiverDecoder(nn.Module):
    """Output-query decoder (JAX perceiver.py:157-204): the queries [B, Q,
    Cq] cross-attend to the latents [B, N, D] (`cross_attn`), then a
    SelfAttentionBlock without DropPath (`self_attn`). The output adapter
    that makes the queries and reads the result belongs to the model, as
    in the flax tree. The q/k and v widths as PerceiverEncoder's."""

    def __init__(self, num_latent_channels: int, num_query_channels: int,
                 num_cross_attention_heads: int = 4,
                 num_cross_attention_qk_channels: int | None = None,
                 num_cross_attention_v_channels: int | None = None,
                 cross_attention_widening_factor: int = 1, num_self_attention_heads: int = 4,
                 num_self_attention_qk_channels: int | None = None,
                 num_self_attention_v_channels: int | None = None,
                 num_self_attention_layers_per_block: int = 2,
                 self_attention_widening_factor: int = 1, atten_drop: float = 0.0,
                 mlp_drop: float = 0.0, dtype=None):
        super().__init__()
        self.cross_attn = CrossAttentionLayer(
            num_query_channels, num_cross_attention_heads, cross_attention_widening_factor,
            dtype, atten_drop, mlp_drop, kv_in=num_latent_channels,
            qk_channels=num_cross_attention_qk_channels,
            v_channels=num_cross_attention_v_channels)
        self.self_attn = SelfAttentionBlock(
            num_self_attention_layers_per_block, num_query_channels, num_self_attention_heads,
            self_attention_widening_factor, dtype, 0.0, atten_drop, mlp_drop,
            qk_channels=num_self_attention_qk_channels, v_channels=num_self_attention_v_channels)

    def forward(self, query: torch.Tensor, x_latent: torch.Tensor, generator=None):
        return self.self_attn(self.cross_attn(query.to(x_latent.dtype), x_latent, generator),
                              generator)
