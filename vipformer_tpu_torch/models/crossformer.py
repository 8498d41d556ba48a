"""CrossFormer models, eval forward (counterpart of
vipformer_tpu/models/crossformer.py: the point-cloud pretraining branch and
the classification finetune model).

Every model takes `device` and `dtype` (the compute dtype; parameters stay
f32 as in the flax tree) and a `seed` for its random init, drawn with a
`torch.Generator`. Eval only: dropout and DropPath are identities, and FPS
starts at index 0 (the JAX models without an `fps` rng).
"""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import BatchNorm, CrossAttentionLayer, Dense, SelfAttentionLayer
from vipformer_tpu_torch.nn.perceiver import LatentFeatsHead, pool_latents
from vipformer_tpu_torch.nn.pointnet import Group2Emb, PointCloudInputAdapter, PositionEmb
from vipformer_tpu_torch.ops.cuda.stem import fused_stem_supported, group2emb_fused_apply
from vipformer_tpu_torch.ops.geometry import (
    divide_patches,
    farthest_point_sample_with_centers,
    knn,
)


class MPEncoder(nn.Module):
    """Modal-prior encoder: cross-attention(s), then the self-attention
    stack with the position embedding re-added before every layer; returns
    the final latents. (The per-layer taps of the segmentation models come
    with their slice.)"""

    def __init__(self, num_latent_channels: int, num_cross_attention_layers: int = 1,
                 num_cross_attention_heads: int = 4, num_self_attention_layers: int = 6,
                 num_self_attention_heads: int = 4, widening_factor: int = 1, dtype=None):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        d = num_latent_channels
        self.num_cross_attention_layers = num_cross_attention_layers
        self.cross_attn_n = CrossAttentionLayer(d, num_cross_attention_heads, widening_factor,
                                                dtype)
        if num_cross_attention_layers > 1:
            self.cross_attn_1 = CrossAttentionLayer(d, num_cross_attention_heads,
                                                    widening_factor, dtype)
        self.sa_layers = []
        for i in range(num_self_attention_layers):
            layer = SelfAttentionLayer(d, num_self_attention_heads, widening_factor, dtype)
            self.add_module(f"sa_{i}", layer)  # flax name: encoder/sa_{i}
            self.sa_layers.append(layer)

    def forward(self, group_embs, pos_embs, pts_embs):
        # a single cross-attention layer is shared (one entry in the tree)
        first = self.cross_attn_n if self.num_cross_attention_layers == 1 else self.cross_attn_1
        x = first(group_embs + pos_embs, pts_embs)
        for i, sa_layer in enumerate(self.sa_layers):
            if i + 1 < self.num_cross_attention_layers:
                x = self.cross_attn_n(x + pos_embs, pts_embs)
            x = sa_layer(x + pos_embs)
        return x


class _PointPatchStem(nn.Module):
    """Shared point-cloud stem: per-point embeddings + FPS/kNN patches.

    pts [B, N, 3] -> (pts_embs [B, N, D], group_embs [B, G, D],
    pos_embs [B, G, D], centers [B, G, 3])."""

    def __init__(self, num_latents: int, num_latent_channels: int, group_size: int,
                 patch_compat: bool = False, dtype=None):
        super().__init__()
        self.num_latents = num_latents
        self.group_size = group_size
        self.patch_compat = patch_compat
        self.dtype = dtype
        d = num_latent_channels
        # xyz clouds (the xyz+rgb semseg stem comes with its slice)
        self.input_adapter = PointCloudInputAdapter(3, d, dtype)
        self.group2emb = Group2Emb(3, d, dtype)
        self.position_emb = PositionEmb(3, d, dtype)

    def forward(self, pts):
        dt = self.dtype or pts.dtype
        pts_embs = self.input_adapter(pts.to(dt))
        if fused_stem_supported(self.num_latents, self.group_size, pts.shape[1], True,
                                self.patch_compat):
            # eval fast path: FPS (K1) banks the centers, kNN (K2), then the
            # gather + Group2Emb chain (K3) with no [B, G, S, C] tensor
            _, centers = farthest_point_sample_with_centers(pts, self.num_latents)
            idx = knn(self.group_size, pts[..., :3], centers[..., :3])
            group_embs = group2emb_fused_apply(self.group2emb, pts, centers, idx, dt)
        else:
            neighbors, centers = divide_patches(
                pts, self.num_latents, self.group_size,
                neighbor_dtype=dt, compat=self.patch_compat,
            )
            group_embs = self.group2emb(neighbors)
        pos_embs = self.position_emb(centers.to(dt))
        return pts_embs, group_embs, pos_embs, centers


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Deterministic random init from `seed` (torch-default Linear bounds;
    norms at identity, BatchNorm statistics at mean 0 / var 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                bound = mod.weight.shape[1] ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))
    return model


class _PointModel(nn.Module):
    """Stem + MPEncoder + max||mean pooling: the common body of
    CrossFormerPC and CrossFormerPCFT (eval; the random init from `seed`
    happens in the subclass once its head exists)."""

    def __init__(self, num_latents, num_latent_channels, group_size, patch_compat,
                 num_cross_attention_layers, num_cross_attention_heads,
                 num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, dtype):
        super().__init__()
        self.stem = _PointPatchStem(num_latents, num_latent_channels, group_size,
                                    patch_compat=patch_compat, dtype=dtype)
        self.encoder = MPEncoder(
            num_latent_channels, num_cross_attention_layers, num_cross_attention_heads,
            num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, dtype)

    def _finish(self, device, seed):
        init_weights(self, seed)
        self.to(device)
        self.eval()

    def backbone(self, pts):
        pts_embs, group_embs, pos_embs, _ = self.stem(pts)
        return pool_latents(self.encoder(group_embs, pos_embs, pts_embs))


class CrossFormerPC(_PointModel):
    """Point-cloud pretraining branch: pts [B, N, 3] ->
    (projected_feats [B, D], backbone_feats [B, 2D])."""

    def __init__(self, num_latents: int = 128, num_latent_channels: int = 384,
                 group_size: int = 32, patch_compat: bool = False,
                 num_cross_attention_layers: int = 1, num_cross_attention_heads: int = 6,
                 num_self_attention_layers: int = 6, num_self_attention_heads: int = 6,
                 mlp_widen_factor: int = 4, dtype=None, device="cpu", seed: int = 0):
        super().__init__(num_latents, num_latent_channels, group_size, patch_compat,
                         num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads,
                         mlp_widen_factor, dtype)
        self.latent_head = LatentFeatsHead(num_latent_channels, dtype)
        self._finish(device, seed)

    def forward(self, pts):
        backbone_feats = self.backbone(pts)
        return self.latent_head(backbone_feats), backbone_feats


class FinetuneHead(nn.Module):
    """BN/ReLU classification head 2D -> D -> D/2 -> classes."""

    def __init__(self, num_latent_channels: int, num_classes: int, dtype=None):
        super().__init__()
        d = num_latent_channels
        self.BatchNorm_0 = BatchNorm(2 * d, dtype)
        self.Dense_0 = Dense(2 * d, d, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(d, dtype)
        self.Dense_1 = Dense(d, d // 2, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(d // 2, dtype)
        self.Dense_2 = Dense(d // 2, num_classes, dtype=dtype)

    def forward(self, x):
        x = self.Dense_0(torch.relu(self.BatchNorm_0(x)))
        x = self.Dense_1(torch.relu(self.BatchNorm_1(x)))
        return self.Dense_2(torch.relu(self.BatchNorm_2(x)))


class CrossFormerPCFT(_PointModel):
    """Classification finetune model: pts [B, N, 3] ->
    (logits [B, classes], backbone_feats [B, 2D])."""

    def __init__(self, num_latents: int = 128, num_latent_channels: int = 384,
                 group_size: int = 32, patch_compat: bool = False,
                 num_cross_attention_layers: int = 1, num_cross_attention_heads: int = 6,
                 num_self_attention_layers: int = 6, num_self_attention_heads: int = 6,
                 mlp_widen_factor: int = 4, num_obj_classes: int = 40, dtype=None,
                 device="cpu", seed: int = 0):
        super().__init__(num_latents, num_latent_channels, group_size, patch_compat,
                         num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads,
                         mlp_widen_factor, dtype)
        self.finetune_head = FinetuneHead(num_latent_channels, num_obj_classes, dtype)
        self._finish(device, seed)

    def forward(self, pts):
        backbone_feats = self.backbone(pts)
        return self.finetune_head(backbone_feats), backbone_feats
