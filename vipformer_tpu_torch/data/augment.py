"""Host-side augmentations for pretraining (the port's own copy of the
two-view point chain and the image chain of vipformer_tpu/data/augment.py):
pure numpy functions of an explicit `np.random.Generator`, so a pipeline
is replayable from its seed.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def angle_axis(angle: float, axis: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix about `axis` by `angle`
    (reference `data_utils.py:6-34`)."""
    u = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    cross = np.array(
        [[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]]
    )
    return (c * np.eye(3) + s * cross + (1 - c) * np.outer(u, u)).astype(
        np.float32
    )


def normalize_unit_sphere(pts: np.ndarray) -> np.ndarray:
    """Center at the centroid, scale to the unit sphere
    (reference `PointcloudNormalize`, `data_utils.py:206-221`)."""
    out = pts.copy()
    xyz = out[:, :3]
    xyz = xyz - xyz.mean(axis=0)
    m = np.max(np.sqrt(np.sum(xyz**2, axis=1)))
    out[:, :3] = xyz / m
    return out


def random_scale(
    pts: np.ndarray, rng: np.random.Generator, lo=0.8, hi=1.25, p=1.0
) -> np.ndarray:
    if rng.uniform() > p:
        return pts
    out = pts.copy()
    out[:, :3] *= rng.uniform(lo, hi)
    return out


def random_rotate(
    pts: np.ndarray,
    rng: np.random.Generator,
    axis=np.array([0.0, 1.0, 0.0]),
    p=1.0,
) -> np.ndarray:
    """Rotate about a fixed axis (default y, like the pretrain chain) or all
    three axes when axis is None (reference `data_utils.py:69-97`)."""
    if rng.uniform() > p:
        return pts
    if axis is None:
        angles = rng.uniform(size=3) * 2 * np.pi
        R = (
            angle_axis(angles[2], np.array([0.0, 0.0, 1.0]))
            @ angle_axis(angles[1], np.array([0.0, 1.0, 0.0]))
            @ angle_axis(angles[0], np.array([1.0, 0.0, 0.0]))
        )
    else:
        R = angle_axis(rng.uniform() * 2 * np.pi, axis)
    out = pts.copy()
    out[:, :3] = pts[:, :3] @ R.T
    if pts.shape[1] > 3 and pts.shape[1] >= 6:
        out[:, 3:6] = pts[:, 3:6] @ R.T  # rotate normals too
    return out


def random_jitter(
    pts: np.ndarray, rng: np.random.Generator, std=0.01, clip=0.05, p=1.0
) -> np.ndarray:
    if rng.uniform() > p:
        return pts
    out = pts.copy()
    noise = np.clip(std * rng.standard_normal((len(pts), 3)), -clip, clip)
    out[:, :3] += noise.astype(pts.dtype)
    return out


def random_translate(
    pts: np.ndarray, rng: np.random.Generator, translate_range=0.1, p=1.0
) -> np.ndarray:
    """Translate proportionally to the bbox extent
    (reference `data_utils.py:151-166`)."""
    if rng.uniform() > p:
        return pts
    xyz = pts[:, :3]
    diff = xyz.max(axis=0) - xyz.min(axis=0)
    t = rng.uniform(-translate_range, translate_range, size=3) * diff
    out = pts.copy()
    out[:, :3] += t.astype(pts.dtype)
    return out


def random_input_dropout(
    pts: np.ndarray, rng: np.random.Generator, max_dropout_ratio=0.875, p=1.0
) -> np.ndarray:
    """Drop a random fraction of points by overwriting them with the first
    point (reference `data_utils.py:174-190` — keeps the shape static, which
    is also exactly what a jit-compiled consumer needs)."""
    if rng.uniform() > p:
        return pts
    ratio = rng.random() * max_dropout_ratio
    drop = rng.random(len(pts)) <= ratio
    out = pts.copy()
    out[drop] = pts[0]
    return out


def pretrain_transform(
    pts: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """The ShapeNetRender augmentation chain (reference `datasets/data.py:16-36`):
    Normalize -> Scale[0.5, 2] -> Rotate(y) -> Translate(0.5) -> Jitter ->
    RandomInputDropout, all with p=1."""
    pts = normalize_unit_sphere(pts)
    pts = random_scale(pts, rng, lo=0.5, hi=2.0)
    pts = random_rotate(pts, rng)
    pts = random_translate(pts, rng, translate_range=0.5)
    pts = random_jitter(pts, rng)
    pts = random_input_dropout(pts, rng)
    return pts.astype(np.float32)


# ---------------------------------------------------------------------------
# image augmentations (reference torchvision chain, utils.py:21-25:
# Resize -> ColorJitter(0.4, 0.4, 0.4) -> RandomHorizontalFlip -> ToTensor ->
# Normalize(imagenet)).

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_PRECISION_BITS = 22  # PIL's fixed point for 8-bit images (32 - 8 - 2)


@functools.lru_cache(maxsize=64)
def _bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's BILINEAR coefficients along one axis (Resample.c
    `precompute_coeffs`, then `normalize_coeffs_8bpc`): output pixel i
    reads inputs idx[i, j] with integer weights w[i, j] (fixed point,
    2^22 = 1). The triangle's support widens by the scale where it
    shrinks; each row's weights are normalised to 1 before rounding."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), dtype=np.int64)
    w = np.zeros((out_size, ksize), dtype=np.int32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        x = np.arange(lo, hi)
        k = np.maximum(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0)
        if k.sum() != 0.0:
            k = k / k.sum()
        idx[i, :len(x)] = x
        w[i, :len(x)] = np.trunc(np.where(k < 0, -0.5, 0.5) + k * (1 << _PRECISION_BITS))
    keep = (w != 0).any(axis=0)  # a tap no output pixel weighs (where it grows)
    return idx[:, keep], w[:, keep]


def _resample_rows(x: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit pass of PIL's separable resampling along the rows of x
    [in, M] uint8 -> [out_size, M] uint8: a sum of integer products (int32,
    as PIL's) from a half, shifted down and clipped to [0, 255]."""
    idx, w = _bilinear_taps(x.shape[0], out_size)
    acc = np.full((out_size, x.shape[1]), 1 << (_PRECISION_BITS - 1), dtype=np.int32)
    for j in range(idx.shape[1]):
        acc += x[idx[:, j]] * w[:, j, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8 as PIL's
    `Image.resize((width, height), Image.BILINEAR)` computes it, without
    PIL: the width pass first into an 8-bit image, then the height pass,
    each skipped where that side keeps its size."""
    img = np.asarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if w != width:
        cols = _resample_rows(np.ascontiguousarray(img.transpose(1, 0, 2)).reshape(w, h * c),
                              width)
        img = cols.reshape(width, h, c).transpose(1, 0, 2)
    if h != height:
        img = _resample_rows(np.ascontiguousarray(img).reshape(h, -1), height)
    return np.ascontiguousarray(img).reshape(height, width, c)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of an [H, W, C] float image (host-side, numpy)."""
    H, W, C = img.shape
    if (H, W) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def color_jitter(
    img: np.ndarray, rng: np.random.Generator,
    brightness=0.4, contrast=0.4, saturation=0.4,
) -> np.ndarray:
    """Random brightness/contrast/saturation in random order on a [0,1]
    float image (torchvision ColorJitter semantics)."""
    ops = []
    if brightness:
        b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * b)
    if contrast:
        c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(
            lambda x: (x - x.mean(axis=(0, 1), keepdims=True)) * c
            + x.mean(axis=(0, 1), keepdims=True)
        )
    if saturation:
        s = rng.uniform(max(0, 1 - saturation), 1 + saturation)

        def sat(x, s=s):
            gray = x @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
            return gray[..., None] * (1 - s) + x * s

        ops.append(sat)
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return np.clip(img, 0.0, 1.0)


def image_transform(
    img: np.ndarray, rng: np.random.Generator, height: int, width: int
) -> np.ndarray:
    """Full pretrain image chain on a uint8/float [H, W, 3] image ->
    normalized float32 [height, width, 3].

    uint8 inputs take the PIL path — Resize, then ImageEnhance-based
    ColorJitter in random op order, exactly what torchvision runs on PIL
    images in the reference chain (`utils.py:21-25`) — which is also ~10x
    faster per sample than the numpy float path (PIL's C loops vs numpy
    temporaries; measured 7.5 -> 0.7 ms at 137->144 px, the difference
    between starving the chip and feeding it, tools/bench_pipeline.py).
    Float inputs keep the numpy path.
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        from PIL import Image, ImageEnhance

        pil = Image.fromarray(img).resize(
            (width, height), Image.BILINEAR
        )
        ops = [
            ImageEnhance.Brightness,
            ImageEnhance.Contrast,
            ImageEnhance.Color,  # torchvision "saturation"
        ]
        factors = [rng.uniform(0.6, 1.4) for _ in ops]
        for i in rng.permutation(len(ops)):
            pil = ops[i](pil).enhance(factors[i])
        out = np.asarray(pil, dtype=np.float32) / 255.0
        if rng.uniform() < 0.5:
            out = out[:, ::-1, :]
        return ((out - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)

    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    img = _resize_bilinear(img, height, width)
    img = color_jitter(img, rng)
    if rng.uniform() < 0.5:
        img = img[:, ::-1, :]
    return ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
