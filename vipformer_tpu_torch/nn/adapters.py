"""Input and output adapters (counterpart of vipformer_tpu/nn/adapters.py):
the ViT patch embedding of the mp image branch, the Fourier
position-encoded pixel adapter of the generic Perceiver family, and the
Perceiver's output-query classification adapter."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from vipformer_tpu_torch.nn.layers import Dense, promote_dtype


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


@lru_cache(maxsize=8)
def _fourier_encoding(spatial_shape: tuple[int, ...], num_bands: int) -> np.ndarray:
    """Fourier position encoding of a spatial grid, computed once on the
    host in f32 (JAX adapters.py:99-121): positions in [-1, 1] per
    dimension (meshgrid 'ij'), frequencies linspace(1, size/2, bands),
    [positions, sin(pi f p) per dimension, cos(pi f p) per dimension] ->
    [prod(shape), len(shape) * (2 * bands + 1)]."""
    coords = [np.linspace(-1.0, 1.0, s) for s in spatial_shape]
    pos = np.stack(np.meshgrid(*coords, indexing="ij"), axis=-1)
    grids = [pos[..., i:i + 1] * np.linspace(1.0, s / 2.0, num_bands)[None, :]
             for i, s in enumerate(spatial_shape)]
    enc = [pos]
    enc.extend(np.sin(math.pi * g) for g in grids)
    enc.extend(np.cos(math.pi * g) for g in grids)
    out = np.concatenate(enc, axis=-1).astype(np.float32)
    return out.reshape(-1, out.shape[-1])


@lru_cache(maxsize=8)
def _fourier_encoding_on(spatial_shape: tuple[int, ...], num_bands: int, device: torch.device,
                         dtype: torch.dtype) -> torch.Tensor:
    """`_fourier_encoding` cast to `dtype` on `device`, made once per key
    (the JAX adapter's encoding is a constant of its compiled program), so
    a forward uploads nothing. Made outside inference mode, so that
    later autograd-recording forwards may use it."""
    with torch.inference_mode(False):
        enc = torch.from_numpy(_fourier_encoding(spatial_shape, num_bands))
        return enc.to(device=device, dtype=dtype)


def fourier_channels(spatial_ndim: int, num_bands: int) -> int:
    return spatial_ndim * (2 * num_bands + 1)


class ImageInputAdapter(nn.Module):
    """Raw pixels with the Fourier grid encoding (non-mp image path, JAX
    adapters.py:128-158): imgs [B, H, W, C] -> [B, H*W, C + 2*(2*bands+1)]
    in the images' dtype (the encoding cast to it before the concat). No
    parameters."""

    def __init__(self, image_shape: tuple[int, int, int], num_frequency_bands: int = 64):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_frequency_bands = num_frequency_bands

    @property
    def num_input_channels(self) -> int:
        return self.image_shape[-1] + fourier_channels(len(self.image_shape) - 1,
                                                       self.num_frequency_bands)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if (h, w, c) != self.image_shape:
            raise ValueError(f"input image shape {(h, w, c)} != {self.image_shape}")
        enc = _fourier_encoding_on((h, w), self.num_frequency_bands, x.device, x.dtype)
        return torch.cat([x.reshape(b, h * w, c), enc[None].expand(b, -1, -1)], dim=-1)


class ClassificationOutputAdapter(nn.Module):
    """Learned output queries `output_query` [queries, channels] (N(0, 0.02)
    clamped to +-2) and a linear head (`linear`); the singleton query axis
    of the logits is squeezed (JAX adapters.py:161-190)."""

    def __init__(self, num_classes: int, num_output_queries: int = 1,
                 num_output_query_channels: int | None = None, dtype=None):
        super().__init__()
        qc = num_output_query_channels or num_classes
        self.output_query = nn.Parameter(latent_init((num_output_queries, qc)))
        self.linear = Dense(qc, num_classes, dtype=dtype)

    def query(self, batch: int) -> torch.Tensor:
        """The queries broadcast to [batch, queries, channels]."""
        return self.output_query[None].expand(batch, -1, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear(x)
        return out.squeeze(1) if out.shape[1] == 1 else out


def latent_init(shape, generator: torch.Generator | None = None, stddev: float = 0.02,
                clip: float = 2.0) -> torch.Tensor:
    """N(0, stddev) clamped to +-clip (JAX nn/init.py:42-49)."""
    return torch.clamp(torch.randn(shape, generator=generator) * stddev, -clip, clip)
