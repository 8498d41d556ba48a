"""Patch-embedding and dense-decode blocks (counterpart of
vipformer_tpu/nn/pointnet.py).

Channel-last layouts as in the JAX package: every 1x1 Conv1d of the
reference is a Dense over the last axis.
"""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import BatchNorm, Dense, LayerNorm, gelu_exact
from vipformer_tpu_torch.ops.cuda.g2e_train import g2e_train_apply
from vipformer_tpu_torch.ops.geometry import three_nn_weights


class Group2Emb(nn.Module):
    """Point-BERT style mini-PointNet: local patch [B, G, S, C] -> [B, G, D].

    Dense 3->64, BN, ReLU, Dense 64->128, group max, concat[global, local],
    Dense 256->256, BN, ReLU, Dense 256->D, group max. In eval this is the
    unfused path (the `patch_compat` stem); the default eval stem runs the
    fused kernel K3 on the same weights (ops/cuda/stem.py). Train mode runs
    K9 (ops/cuda/g2e_train.py) with batch-statistics BatchNorm and applies
    the running-statistics update with the kernel's batch statistics
    outside it, as JAX pointnet.py:74-108 does."""

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
        if self.training:
            return self._fused_train(point_groups)
        x = torch.relu(self.BatchNorm_0(self.Dense_0(point_groups)))
        x = self.Dense_1(x)  # [B, G, S, 128]
        global_feat = x.amax(dim=2, keepdim=True)  # [B, G, 1, 128]
        # implicit-concat Dense: cat[global, local] @ W without the
        # [B, G, S, 256] broadcast concat
        x = torch.relu(self.BatchNorm_1(self.Dense_2((global_feat, x))))
        return self.Dense_3(x).amax(dim=2)  # [B, G, D]

    def _fused_train(self, point_groups: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or point_groups.dtype
        bn0, bn1 = self.BatchNorm_0, self.BatchNorm_1
        wb = (self.Dense_0.weight.t(), self.Dense_0.bias, bn0.weight, bn0.bias,
              self.Dense_1.weight.t(), self.Dense_1.bias, self.Dense_2.weight.t(),
              self.Dense_2.bias, bn1.weight, bn1.bias, self.Dense_3.weight.t(),
              self.Dense_3.bias)
        out, (mu0, var0, mu1, var1) = g2e_train_apply(point_groups.to(dt), wb,
                                                      point_groups.shape[2])
        bn0.update_running(mu0, var0)
        bn1.update_running(mu1, var1)
        return out


class PositionEmb(nn.Module):
    """Center-coordinate MLP: C -> 128 -> GELU -> D."""

    def __init__(self, in_channels: int, dim_model: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, 128, dtype=dtype)
        self.Dense_1 = Dense(128, dim_model, dtype=dtype)

    def forward(self, centers: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(gelu_exact(self.Dense_0(centers)))


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN upsampling + per-point Dense/BN/ReLU stack
    (JAX pointnet.py:128-180). The first Dense is hoisted through the
    interpolation, which is linear in the features: its source segment is
    multiplied on the S source rows and then interpolated to the N points
    (a post-fn segment of the implicit-concat Dense), so the [B, N, Ds]
    interpolated features never exist. The parameters are those of Dense
    over concat([skip, interpolated])."""

    def __init__(self, in_dst: int, in_src: int, mlp, dtype=None):
        super().__init__()
        widths = [in_dst + in_src] + list(mlp)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", Dense(cin, cout, dtype=dtype))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout, dtype))
        self.depth = len(mlp)

    def forward(self, xyz_dst, xyz_src, feats_dst, feats_src):
        """xyz_dst [B, N, 3], xyz_src [B, S, 3], feats_dst [B, N, Dd] (the
        skip features) or None, feats_src [B, S, Ds] -> [B, N, mlp[-1]]."""
        wmat = three_nn_weights(xyz_dst, xyz_src)  # [B, N, S] f32

        def interp(h):  # the weights cast to the product's dtype, as JAX :161
            return wmat.to(h.dtype) @ h

        if feats_dst is not None:
            x = (feats_dst, (feats_src.to(feats_dst.dtype), interp))
        else:
            x = ((feats_src, interp),)
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return x


class PointCloudInputAdapter(nn.Module):
    """Per-point MLP C -> 64 -> LN -> ReLU -> D."""

    def __init__(self, in_channels: int, num_input_channels: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, 64, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(64, dtype)
        self.Dense_1 = Dense(64, num_input_channels, dtype=dtype)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.LayerNorm_0(self.Dense_0(pts))))
