"""Image patch embedding (counterpart of the `ImagePatchify` part of
vipformer_tpu/nn/adapters.py; the Fourier adapter of the generic
Perceiver family comes with its slice)."""

from __future__ import annotations

import math

import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import promote_dtype


class _PatchDense(nn.Module):
    """Dense over flattened p x p patches: the same parameters as the JAX
    module (kernel [p*p*c, D], rows in (p1, p2, c) order like the
    reference's rearrange; here stored as `weight` [D, p*p*c]) and bias
    [D]. Applied as unfold + one matmul in the compute dtype, f32
    accumulated, rounded, then the bias added: no convolution, so cuDNN's
    TF32 default cannot reach it, and a f32 matmul runs in full f32
    (torch.backends.cuda.matmul.allow_tf32 is False by default)."""

    def __init__(self, patch_size: int, in_channels: int, features: int, dtype=None):
        super().__init__()
        fan_in = patch_size * patch_size * in_channels
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(features, fan_in))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype = dtype
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs [B, H, W, C] -> [B, (H/p)*(W/p), D]."""
        b, h, w, c = imgs.shape
        p = self.patch_size
        dt = promote_dtype(imgs, self.dtype)
        patches = (imgs.to(dt).view(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, (h // p) * (w // p), p * p * c))
        return patches @ self.weight.to(dt).t() + self.bias.to(dt)


class ImagePatchify(nn.Module):
    """ViT-style patchify + linear embed + learned position embedding
    (`position_emb` [1, P, D], randn init): imgs [B, H, W, C] ->
    (patch embeddings [B, P, D], position embedding [1, P, D]), both in the
    compute dtype."""

    def __init__(self, img_height: int, img_width: int, patch_size: int,
                 num_latent_channels: int, in_channels: int = 3, dtype=None):
        super().__init__()
        self.Dense_0 = _PatchDense(patch_size, in_channels, num_latent_channels, dtype)
        num_patches = (img_height // patch_size) * (img_width // patch_size)
        self.position_emb = nn.Parameter(torch.randn(1, num_patches, num_latent_channels))

    def forward(self, imgs: torch.Tensor):
        patch_embs = self.Dense_0(imgs)
        return patch_embs, self.position_emb.to(patch_embs.dtype)
