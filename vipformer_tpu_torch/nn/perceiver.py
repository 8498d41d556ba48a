"""Latent pooling and the contrastive head (counterpart of the
`pool_latents` / `LatentFeatsHead` part of vipformer_tpu/nn/perceiver.py;
the generic Perceiver encoder/decoder come with a later slice)."""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import BatchNorm, Dense


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
