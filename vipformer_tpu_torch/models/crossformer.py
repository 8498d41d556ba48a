"""CrossFormer models (counterpart of vipformer_tpu/models/crossformer.py:
the point-cloud and image pretraining branches, the classification
finetune model, and the part- and semantic-segmentation models).

Every model takes `device` (the card by default; the CPU only when asked)
and `dtype` (the compute dtype; parameters stay f32 as in the flax tree)
and a `seed` for its random init, drawn with a `torch.Generator`. Models
are built in eval mode: dropout and DropPath are identities and FPS starts
at index 0 (the JAX models without an `fps` rng). After `model.train()`
the forward is the JAX `deterministic=False` one: batch-statistics
BatchNorm, the training kernels K7-K10, and dropout, DropPath and FPS's
random start drawn from the `generator` argument (FPS starts at 0 when it
is None, and a nonzero dropout rate then raises).
"""

from __future__ import annotations

import torch
from torch import nn

from vipformer_tpu_torch.nn.adapters import ImagePatchify, _PatchDense, latent_init
from vipformer_tpu_torch.nn.layers import (
    BatchNorm,
    CrossAttentionLayer,
    Dense,
    LayerNorm,
    SelfAttentionLayer,
    dpr_schedule,
    dropout,
)
from vipformer_tpu_torch.nn.perceiver import LatentFeatsHead, pool_latents
from vipformer_tpu_torch.nn.pointnet import (
    FeaturePropagation,
    Group2Emb,
    PointCloudInputAdapter,
    PositionEmb,
)
from vipformer_tpu_torch.ops.cuda.stem import fused_stem_supported, group2emb_fused_apply
from vipformer_tpu_torch.ops.geometry import (
    divide_patches,
    farthest_point_sample_with_centers,
    index_points,
    knn,
)


class MPEncoder(nn.Module):
    """Modal-prior encoder: cross-attention(s), then the self-attention
    stack with the position embedding re-added before every layer. With
    `modal_prior=True` it returns the final latents; else the tuple of the
    latents after the self-attention layers numbered (1-based) in
    `layer_idx` (JAX crossformer.py:111-133). Train mode: attention
    dropout `atten_drop`, residual dropout `mlp_drop` (also after the
    self-attention, the mp family's rule), DropPath linspace 0 -> `max_dpr`
    over the self-attention layers and 0 in the cross-attention layers."""

    def __init__(self, num_latent_channels: int, num_cross_attention_layers: int = 1,
                 num_cross_attention_heads: int = 4, num_self_attention_layers: int = 6,
                 num_self_attention_heads: int = 4, widening_factor: int = 1, dtype=None,
                 max_dpr: float = 0.0, atten_drop: float = 0.0, mlp_drop: float = 0.0,
                 modal_prior: bool = True, layer_idx: tuple[int, ...] = ()):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        d = num_latent_channels
        self.num_cross_attention_layers = num_cross_attention_layers
        self.modal_prior = modal_prior
        self.layer_idx = tuple(layer_idx)
        drops = dict(atten_drop=atten_drop, mlp_drop=mlp_drop)
        self.cross_attn_n = CrossAttentionLayer(d, num_cross_attention_heads, widening_factor,
                                                dtype, **drops)
        if num_cross_attention_layers > 1:
            self.cross_attn_1 = CrossAttentionLayer(d, num_cross_attention_heads,
                                                    widening_factor, dtype, **drops)
        self.sa_layers = []
        dprs = dpr_schedule(max_dpr, num_self_attention_layers)
        for i in range(num_self_attention_layers):
            layer = SelfAttentionLayer(d, num_self_attention_heads, widening_factor, dtype,
                                       drop_path_rate=dprs[i], post_attn_drop=mlp_drop, **drops)
            self.add_module(f"sa_{i}", layer)  # flax name: encoder/sa_{i}
            self.sa_layers.append(layer)

    def forward(self, group_embs, pos_embs, pts_embs, generator=None):
        # a single cross-attention layer is shared (one entry in the tree)
        first = self.cross_attn_n if self.num_cross_attention_layers == 1 else self.cross_attn_1
        x = first(group_embs + pos_embs, pts_embs, generator)
        feats = []
        for i, sa_layer in enumerate(self.sa_layers):
            if i + 1 < self.num_cross_attention_layers:
                x = self.cross_attn_n(x + pos_embs, pts_embs, generator)
            x = sa_layer(x + pos_embs, generator)
            if i + 1 in self.layer_idx:
                feats.append(x)
        return x if self.modal_prior else tuple(feats)


class _PointPatchStem(nn.Module):
    """Shared point-cloud stem: per-point embeddings + FPS/kNN patches.

    pts [B, N, C] -> (pts_embs [B, N, D], group_embs [B, G, D],
    pos_embs [B, G, D], centers [B, G, C]); C = `in_channels`, whose first
    three are xyz (FPS, kNN and the centering read those)."""

    def __init__(self, num_latents: int, num_latent_channels: int, group_size: int,
                 patch_compat: bool = False, dtype=None, in_channels: int = 3):
        super().__init__()
        self.num_latents = num_latents
        self.group_size = group_size
        self.patch_compat = patch_compat
        self.dtype = dtype
        d = num_latent_channels
        # every layer takes all `in_channels` (xyz, or semseg's xyz+rgb)
        self.input_adapter = PointCloudInputAdapter(in_channels, d, dtype)
        self.group2emb = Group2Emb(in_channels, d, dtype)
        self.position_emb = PositionEmb(in_channels, d, dtype)

    def forward(self, pts, generator=None):
        dt = self.dtype or pts.dtype
        pts_embs = self.input_adapter(pts.to(dt))
        if fused_stem_supported(self.num_latents, self.group_size, pts.shape[1],
                                not self.training, self.patch_compat):
            # eval fast path: FPS (K1) banks the centers, kNN (K2), then the
            # gather + Group2Emb chain (K3) with no [B, G, S, C] tensor
            fps_idx, centers = farthest_point_sample_with_centers(pts, self.num_latents)
            if pts.shape[-1] > 3:
                # the position embedding takes every channel of the centers,
                # as the unfused path's `fps` gathers them; K1 banks the xyz
                # only (JAX's fused path stops there and then fails its
                # 6-channel PositionEmb: ROADMAP Queue 3)
                centers = index_points(pts, fps_idx)
            idx = knn(self.group_size, pts[..., :3], centers[..., :3])
            group_embs = group2emb_fused_apply(self.group2emb, pts, centers, idx, dt)
        else:
            # train mode: FPS (K1, random start from `generator`), kNN (K2),
            # the centered gather (K10; with patch_compat the row gather K12
            # and the reference's slice) and train-mode Group2Emb (K9); in
            # eval only the compat stem comes here (K12, unfused Group2Emb)
            neighbors, centers = divide_patches(
                pts, self.num_latents, self.group_size, generator,
                neighbor_dtype=dt, compat=self.patch_compat,
            )
            group_embs = self.group2emb(neighbors)
        pos_embs = self.position_emb(centers.to(dt))
        return pts_embs, group_embs, pos_embs, centers


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Deterministic random init from `seed` (torch-default Linear bounds;
    norms at identity, BatchNorm statistics at mean 0 / var 1, the image
    position embedding standard normal, the Perceiver's latents and output
    queries N(0, 0.02) clamped to +-2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Dense, _PatchDense)):
                bound = mod.weight.shape[1] ** -0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))
            elif isinstance(mod, ImagePatchify):
                mod.position_emb.copy_(torch.randn(mod.position_emb.shape, generator=gen))
            for name, p in mod.named_parameters(recurse=False):
                if name in ("latent", "output_query"):  # the Perceiver's learned queries
                    p.copy_(latent_init(p.shape, gen))
    return model


def _finish(model: nn.Module, device, seed: int) -> None:
    """Random init from `seed`, then onto `device`, in eval mode."""
    init_weights(model, seed)
    model.to(device)
    model.eval()


class _PointModel(nn.Module):
    """Stem + MPEncoder + max||mean pooling: the common body of
    CrossFormerPC and CrossFormerPCFT (the random init from `seed` happens
    in the subclass once its head exists)."""

    def __init__(self, num_latents, num_latent_channels, group_size, patch_compat,
                 num_cross_attention_layers, num_cross_attention_heads,
                 num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, dtype,
                 max_dpr, atten_drop, mlp_drop):
        super().__init__()
        self.stem = _PointPatchStem(num_latents, num_latent_channels, group_size,
                                    patch_compat=patch_compat, dtype=dtype)
        self.encoder = MPEncoder(
            num_latent_channels, num_cross_attention_layers, num_cross_attention_heads,
            num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, dtype,
            max_dpr, atten_drop, mlp_drop)

    def backbone(self, pts, generator=None):
        pts_embs, group_embs, pos_embs, _ = self.stem(pts, generator)
        return pool_latents(self.encoder(group_embs, pos_embs, pts_embs, generator))


class CrossFormerPC(_PointModel):
    """Point-cloud pretraining branch: pts [B, N, 3] ->
    (projected_feats [B, D], backbone_feats [B, 2D])."""

    def __init__(self, num_latents: int = 128, num_latent_channels: int = 384,
                 group_size: int = 32, patch_compat: bool = False,
                 num_cross_attention_layers: int = 1, num_cross_attention_heads: int = 6,
                 num_self_attention_layers: int = 6, num_self_attention_heads: int = 6,
                 mlp_widen_factor: int = 4, max_dpr: float = 0.0, atten_drop: float = 0.1,
                 mlp_drop: float = 0.5, dtype=None, device="cuda", seed: int = 0):
        super().__init__(num_latents, num_latent_channels, group_size, patch_compat,
                         num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads,
                         mlp_widen_factor, dtype, max_dpr, atten_drop, mlp_drop)
        self.latent_head = LatentFeatsHead(num_latent_channels, dtype)
        _finish(self, device, seed)

    def forward(self, pts, generator=None):
        backbone_feats = self.backbone(pts, generator)
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
                 mlp_widen_factor: int = 4, num_obj_classes: int = 40, max_dpr: float = 0.0,
                 atten_drop: float = 0.1, mlp_drop: float = 0.5, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__(num_latents, num_latent_channels, group_size, patch_compat,
                         num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads,
                         mlp_widen_factor, dtype, max_dpr, atten_drop, mlp_drop)
        self.finetune_head = FinetuneHead(num_latent_channels, num_obj_classes, dtype)
        _finish(self, device, seed)

    def forward(self, pts, generator=None):
        backbone_feats = self.backbone(pts, generator)
        return self.finetune_head(backbone_feats), backbone_feats


class LabelConv(nn.Module):
    """One-hot object-label conditioning: Dense(64, no bias) -> BatchNorm ->
    LeakyReLU(0.2) (JAX crossformer.py:381-391)."""

    def __init__(self, num_obj_classes: int = 16, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(num_obj_classes, 64, use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64, dtype)

    def forward(self, onehot):
        return torch.nn.functional.leaky_relu(self.BatchNorm_0(self.Dense_0(onehot)), 0.2)


class SegHead(nn.Module):
    """Dense decode head: Dense 512 -> BN -> ReLU -> Dropout(`drop`, 0.5 as
    the reference) -> Dense 256 -> BN -> ReLU -> Dense(classes) (JAX
    crossformer.py:394-419). `x` may be a tuple of channel segments (the
    implicit-concat Dense): the seg model passes (per-point features
    [B, N, Dp], global features [B, 1, Dg]), so the global segment is
    multiplied once per cloud."""

    def __init__(self, in_features: int, num_classes: int, dtype=None, drop: float = 0.5):
        super().__init__()
        self.Dense_0 = Dense(in_features, 512, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(512, dtype)
        self.Dense_1 = Dense(512, 256, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(256, dtype)
        self.Dense_2 = Dense(256, num_classes, dtype=dtype)
        self.drop = drop

    def forward(self, x, generator=None):
        x = torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        if self.training:
            x = dropout(x, self.drop, generator)
        x = torch.relu(self.BatchNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class _SegModel(nn.Module):
    """The segmentation models' common body (JAX crossformer.py:422-563).

    The encoder's latents after the `layer_idx` self-attention layers go
    through one shared LayerNorm (`norm`) and are concatenated ([B, G,
    kD]); their max and mean over the groups (and, with `label_conv`, the
    object-label embedding) form the global feature [B, 1, Dg], which stays
    un-broadcast (a segment of the head's first Dense); the 3-NN feature
    propagation lifts the group features to every point over the xyz, with
    the xyz as skip features, and the head classifies each point. The
    head's dropout rate is `seg_head.drop` (0.5, the reference's; the
    comparisons with the CPU set it to 0)."""

    def __init__(self, in_channels, num_latents, num_latent_channels, group_size, patch_compat,
                 num_cross_attention_layers, num_cross_attention_heads,
                 num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, max_dpr,
                 atten_drop, mlp_drop, layer_idx, num_classes, dtype, label_conv: bool):
        super().__init__()
        if not layer_idx:
            raise ValueError("segmentation needs layer_idx taps")
        d, k = num_latent_channels, len(layer_idx)
        self.stem = _PointPatchStem(num_latents, d, group_size, patch_compat=patch_compat,
                                    dtype=dtype, in_channels=in_channels)
        self.encoder = MPEncoder(
            d, num_cross_attention_layers, num_cross_attention_heads, num_self_attention_layers,
            num_self_attention_heads, mlp_widen_factor, dtype, max_dpr, atten_drop, mlp_drop,
            modal_prior=False, layer_idx=layer_idx)
        self.norm = LayerNorm(d, dtype)
        if label_conv:
            self.label_conv = LabelConv(16, dtype)  # ShapeNetPart's 16 object categories
        self.propagation = FeaturePropagation(3, k * d, (mlp_widen_factor * d, 1024), dtype)
        self.seg_head = SegHead(1024 + 2 * k * d + (64 if label_conv else 0), num_classes, dtype)

    def _segment(self, pts, cls_onehot, generator):
        pts_embs, group_embs, pos_embs, centers = self.stem(pts, generator)
        feats = self.encoder(group_embs, pos_embs, pts_embs, generator)
        x = torch.cat([self.norm(f) for f in feats], dim=-1)  # [B, G, kD]
        parts = [x.amax(dim=1), x.mean(dim=1)]
        if cls_onehot is not None:
            parts.append(self.label_conv(cls_onehot.to(x.dtype)))
        global_feat = torch.cat(parts, dim=-1)[:, None, :]
        xyz = pts[..., :3]
        f0 = self.propagation(xyz, centers[..., :3], xyz.to(x.dtype), x)
        return self.seg_head((f0, global_feat.to(f0.dtype)), generator)


class CrossFormerPartSeg(_SegModel):
    """Part segmentation model (JAX crossformer.py:422-493): pts [B, N, 3],
    cls_onehot [B, 16] -> logits [B, N, num_part_classes], the label
    embedding (`label_conv`) in the global feature."""

    def __init__(self, num_latents: int = 128, num_latent_channels: int = 384,
                 group_size: int = 32, patch_compat: bool = False,
                 num_cross_attention_layers: int = 1, num_cross_attention_heads: int = 6,
                 num_self_attention_layers: int = 12, num_self_attention_heads: int = 6,
                 mlp_widen_factor: int = 4, max_dpr: float = 0.1, atten_drop: float = 0.0,
                 mlp_drop: float = 0.0, layer_idx: tuple[int, ...] = (2, 6, 10),
                 num_part_classes: int = 50, dtype=None, device="cuda", seed: int = 0):
        super().__init__(3, num_latents, num_latent_channels, group_size, patch_compat,
                         num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads, mlp_widen_factor,
                         max_dpr, atten_drop, mlp_drop, layer_idx, num_part_classes, dtype,
                         label_conv=True)
        _finish(self, device, seed)

    def forward(self, pts, cls_onehot, generator=None):
        return self._segment(pts, cls_onehot, generator)


class CrossFormerSemSeg(_SegModel):
    """Semantic segmentation model for S3DIS blocks (JAX crossformer.py:
    496-563): pts [B, N, point_channels] (xyz + rgb) -> logits [B, N,
    num_obj_classes]. The stem takes every point channel (the centers keep
    them for the position embedding); no label conditioning (the
    reference's unused `label_conv` is left out, as in JAX)."""

    def __init__(self, point_channels: int = 6, num_latents: int = 128,
                 num_latent_channels: int = 384, group_size: int = 32, patch_compat: bool = False,
                 num_cross_attention_layers: int = 1, num_cross_attention_heads: int = 6,
                 num_self_attention_layers: int = 12, num_self_attention_heads: int = 6,
                 mlp_widen_factor: int = 4, max_dpr: float = 0.1, atten_drop: float = 0.0,
                 mlp_drop: float = 0.0, layer_idx: tuple[int, ...] = (2, 6, 10),
                 num_obj_classes: int = 13, dtype=None, device="cuda", seed: int = 0):
        super().__init__(point_channels, num_latents, num_latent_channels, group_size,
                         patch_compat, num_cross_attention_layers, num_cross_attention_heads,
                         num_self_attention_layers, num_self_attention_heads, mlp_widen_factor,
                         max_dpr, atten_drop, mlp_drop, layer_idx, num_obj_classes, dtype,
                         label_conv=False)
        _finish(self, device, seed)

    def forward(self, pts, generator=None):
        return self._segment(pts, None, generator)


class CrossFormerImg(nn.Module):
    """Image pretraining branch: imgs [B, H, W, 3] -> (projected_feats
    [B, D], backbone_feats [B, 2D]). ViT patchify + learned position
    embedding; the patch embeddings are both the queries and the kv tokens
    of the same MPEncoder."""

    def __init__(self, img_height: int = 144, img_width: int = 144, patch_size: int = 12,
                 num_latent_channels: int = 384, num_cross_attention_layers: int = 1,
                 num_cross_attention_heads: int = 6, num_self_attention_layers: int = 6,
                 num_self_attention_heads: int = 6, mlp_widen_factor: int = 4,
                 max_dpr: float = 0.0, atten_drop: float = 0.1, mlp_drop: float = 0.5,
                 dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.patch2emb = ImagePatchify(img_height, img_width, patch_size, num_latent_channels,
                                       dtype=dtype)
        self.encoder = MPEncoder(
            num_latent_channels, num_cross_attention_layers, num_cross_attention_heads,
            num_self_attention_layers, num_self_attention_heads, mlp_widen_factor, dtype,
            max_dpr, atten_drop, mlp_drop)
        self.latent_head = LatentFeatsHead(num_latent_channels, dtype)
        _finish(self, device, seed)

    def forward(self, imgs, generator=None):
        dt = self.dtype or imgs.dtype
        patch_embs, pos_embs = self.patch2emb(imgs.to(dt))
        x_latent = self.encoder(patch_embs, pos_embs, patch_embs, generator)
        backbone_feats = pool_latents(x_latent)
        return self.latent_head(backbone_feats), backbone_feats
