"""Patch-embedding blocks, eval mode (counterpart of vipformer_tpu/nn/pointnet.py).

Channel-last layouts as in the JAX package: every 1x1 Conv1d of the
reference is a Dense over the last axis.
"""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import BatchNorm, Dense, LayerNorm, gelu_exact


class Group2Emb(nn.Module):
    """Point-BERT style mini-PointNet: local patch [B, G, S, C] -> [B, G, D].

    Dense 3->64, BN, ReLU, Dense 64->128, group max, concat[global, local],
    Dense 256->256, BN, ReLU, Dense 256->D, group max. This is the unfused
    eval path (the `patch_compat` stem); the default stem runs the fused
    kernel K3 on the same weights (ops/cuda/stem.py)."""

    def __init__(self, in_channels: int, dim_model: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, 64, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64, dtype)
        self.Dense_1 = Dense(64, 128, dtype=dtype)
        self.Dense_2 = Dense(256, 256, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(256, dtype)
        self.Dense_3 = Dense(256, dim_model, dtype=dtype)
        self.dtype = dtype

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.Dense_0(point_groups)))
        x = self.Dense_1(x)  # [B, G, S, 128]
        global_feat = x.amax(dim=2, keepdim=True)  # [B, G, 1, 128]
        # implicit-concat Dense (JAX nn.layers.Dense on a tuple): one
        # product per segment, each emitted in the compute dtype, the bias
        # riding the local segment, then the sum — cat[global, local] @ W
        # without the [B, G, S, 256] broadcast concat
        dt = x.dtype
        w = self.Dense_2.kernel(dt)  # [256, 256]
        c = global_feat.shape[-1]
        x = (global_feat @ w[:c]) + ((x @ w[c:]) + self.Dense_2.bias.to(dt))
        x = torch.relu(self.BatchNorm_1(x))
        return self.Dense_3(x).amax(dim=2)  # [B, G, D]


class PositionEmb(nn.Module):
    """Center-coordinate MLP: C -> 128 -> GELU -> D."""

    def __init__(self, in_channels: int, dim_model: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, 128, dtype=dtype)
        self.Dense_1 = Dense(128, dim_model, dtype=dtype)

    def forward(self, centers: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(gelu_exact(self.Dense_0(centers)))


class PointCloudInputAdapter(nn.Module):
    """Per-point MLP C -> 64 -> LN -> ReLU -> D."""

    def __init__(self, in_channels: int, num_input_channels: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, 64, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(64, dtype)
        self.Dense_1 = Dense(64, num_input_channels, dtype=dtype)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.LayerNorm_0(self.Dense_0(pts))))
