"""Batched augmentations on the tensors' own device (counterpart of
vipformer_tpu/data/augment_device.py).

The pretrain step's `--device_augs` mode ships each raw cloud once and one
uint8 image a sample; both augmented point views (reference
`datasets/data.py:16-36`: Normalize -> Scale[0.5, 2] -> Rotate(y) ->
Translate(0.5) -> Jitter -> RandomInputDropout) and the image chain
(reference `utils.py:21-25`: Resize -> ColorJitter(.4, .4, .4) ->
RandomHorizontalFlip -> Normalize) then run inside the step, as batched
torch ops on [B, N, C] and [B, H, W, 3] tensors.

Every random op is a draw step and a pure function of its draws:
`draw_*(..., generator)` takes its numbers from an explicit
`torch.Generator` on the tensors' device (each cloud its own factor, as
the host chain's per-sample draws), and the function of the same name
without `draw_` applies them. `random_*` composes the two. A test hands
the pure functions fixed draws (JAX's, re-derived from its key); the
streams themselves are not JAX's threefry streams and do not try to be.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _uniform(shape, generator: torch.Generator, lo: float = 0.0, hi: float = 1.0) -> Tensor:
    """Uniform f32 draws in [lo, hi) on the generator's device."""
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def _join_xyz(xyz: Tensor, pts: Tensor) -> Tensor:
    return xyz if pts.shape[-1] == 3 else torch.cat([xyz, pts[..., 3:]], dim=-1)


def normalize_unit_sphere(pts: Tensor) -> Tensor:
    """Per cloud: xyz centred at its centroid and scaled into the unit
    sphere (reference `PointcloudNormalize`, `data_utils.py:206-221`)."""
    xyz = pts[..., :3] - pts[..., :3].mean(dim=-2, keepdim=True)
    m = torch.sqrt((xyz * xyz).sum(-1)).amax(dim=-1, keepdim=True)
    return _join_xyz(xyz / m[..., None], pts)


def draw_scale(b: int, generator, lo: float = 0.5, hi: float = 2.0) -> Tensor:
    return _uniform((b, 1, 1), generator, lo, hi)


def scale(pts: Tensor, s: Tensor) -> Tensor:
    """xyz times each cloud's factor s [B, 1, 1] (reference
    `PointcloudScale`, `data_utils.py:56-66`)."""
    return _join_xyz(pts[..., :3] * s, pts)


def random_scale(pts: Tensor, generator, lo: float = 0.5, hi: float = 2.0) -> Tensor:
    return scale(pts, draw_scale(pts.shape[0], generator, lo, hi))


def draw_rotate_y(b: int, generator) -> Tensor:
    return _uniform((b, 1), generator, 0.0, 2.0 * math.pi)


def rotate_y(pts: Tensor, angle: Tensor) -> Tensor:
    """Each cloud rotated about the y axis by its angle [B, 1] (reference
    `PointcloudRotate`, `data_utils.py:69-97`); the normals too where
    C >= 6."""
    c, s = torch.cos(angle), torch.sin(angle)

    def rot(v):
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)

    parts = [rot(pts[..., :3])]
    if pts.shape[-1] >= 6:
        parts.append(rot(pts[..., 3:6]))
    if pts.shape[-1] > 3 * len(parts):
        parts.append(pts[..., 3 * len(parts):])
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def random_rotate_y(pts: Tensor, generator) -> Tensor:
    return rotate_y(pts, draw_rotate_y(pts.shape[0], generator))


def draw_translate(b: int, generator, translate_range: float = 0.1) -> Tensor:
    return _uniform((b, 1, 3), generator, -translate_range, translate_range)


def translate(pts: Tensor, t: Tensor) -> Tensor:
    """xyz moved by t [B, 1, 3] times each cloud's bounding-box extent
    (reference `PointcloudTranslate`, `data_utils.py:151-166`)."""
    xyz = pts[..., :3]
    diff = xyz.amax(dim=-2, keepdim=True) - xyz.amin(dim=-2, keepdim=True)
    return _join_xyz(xyz + t * diff, pts)


def random_translate(pts: Tensor, generator, translate_range: float = 0.1) -> Tensor:
    return translate(pts, draw_translate(pts.shape[0], generator, translate_range))


def draw_jitter(b: int, n: int, generator) -> Tensor:
    """Standard normal draws [B, N, 3]."""
    return torch.randn((b, n, 3), generator=generator, device=generator.device)


def jitter(pts: Tensor, z: Tensor, std: float = 0.01, clip: float = 0.05) -> Tensor:
    """xyz plus std * z clipped to +-clip (reference `PointcloudJitter`,
    `data_utils.py:134-148`)."""
    return _join_xyz(pts[..., :3] + (std * z).clamp(-clip, clip), pts)


def random_jitter(pts: Tensor, generator, std: float = 0.01, clip: float = 0.05) -> Tensor:
    return jitter(pts, draw_jitter(pts.shape[0], pts.shape[1], generator), std, clip)


def draw_input_dropout(b: int, n: int, generator,
                       max_dropout_ratio: float = 0.875) -> tuple[Tensor, Tensor]:
    """(ratio [B, 1] in [0, max_dropout_ratio), u [B, N] in [0, 1))."""
    ratio = _uniform((b, 1), generator) * max_dropout_ratio
    return ratio, _uniform((b, n), generator)


def input_dropout_mask(ratio: Tensor, u: Tensor) -> Tensor:
    """[B, N] bool: the points a cloud drops (u <= its ratio)."""
    return u <= ratio


def input_dropout(pts: Tensor, ratio: Tensor, u: Tensor) -> Tensor:
    """Each dropped point overwritten by its cloud's first point (reference
    `PointcloudRandomInputDropout`, `data_utils.py:174-190`): the shape
    stays static."""
    return torch.where(input_dropout_mask(ratio, u)[..., None], pts[:, :1, :], pts)


def random_input_dropout(pts: Tensor, generator, max_dropout_ratio: float = 0.875) -> Tensor:
    return input_dropout(pts, *draw_input_dropout(pts.shape[0], pts.shape[1], generator,
                                                  max_dropout_ratio))


def draw_pretrain_view(b: int, n: int, generator) -> dict:
    """The draws of one view, in the chain's order."""
    d = {"scale": draw_scale(b, generator, 0.5, 2.0), "angle": draw_rotate_y(b, generator),
         "translate": draw_translate(b, generator, 0.5), "jitter": draw_jitter(b, n, generator)}
    d["ratio"], d["u"] = draw_input_dropout(b, n, generator)
    return d


def pretrain_view(pts: Tensor, d: dict) -> Tensor:
    """One ShapeNetRender view, every op at p = 1: Normalize -> Scale[0.5,
    2] -> Rotate(y) -> Translate(0.5) -> Jitter -> RandomInputDropout."""
    pts = normalize_unit_sphere(pts)
    pts = scale(pts, d["scale"])
    pts = rotate_y(pts, d["angle"])
    pts = translate(pts, d["translate"])
    pts = jitter(pts, d["jitter"])
    return input_dropout(pts, d["ratio"], d["u"])


def pretrain_two_views(pts: Tensor, generator) -> tuple[Tensor, Tensor]:
    """Two independent views of each raw cloud [B, N, C] (f32), the first
    view's draws taken first: the device-side counterpart of
    ShapeNetRender's `trans_1` and `trans_2` (reference
    `datasets/data.py:107-116`)."""
    b, n = pts.shape[0], pts.shape[1]
    d1 = draw_pretrain_view(b, n, generator)
    d2 = draw_pretrain_view(b, n, generator)
    return pretrain_view(pts, d1), pretrain_view(pts, d2)


def draw_scale_and_translate(b: int, generator, scale_low: float = 2.0 / 3.0,
                             scale_high: float = 3.0 / 2.0,
                             translate_range: float = 0.2) -> tuple[Tensor, Tensor]:
    return (_uniform((b, 1, 3), generator, scale_low, scale_high),
            _uniform((b, 1, 3), generator, -translate_range, translate_range))


def scale_and_translate(pts: Tensor, s: Tensor, t: Tensor) -> Tensor:
    """xyz * s + t, s and t [B, 1, 3]: the finetune-time batch augmentation
    (reference `PointcloudScaleAndTranslate`, `data_utils.py:407-423`)."""
    return _join_xyz(pts[..., :3] * s + t, pts)


def scale_and_translate_device(pts: Tensor, generator, scale_low: float = 2.0 / 3.0,
                               scale_high: float = 3.0 / 2.0,
                               translate_range: float = 0.2) -> Tensor:
    return scale_and_translate(pts, *draw_scale_and_translate(
        pts.shape[0], generator, scale_low, scale_high, translate_range))


# ---------------------------------------------------------------- images

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)
# the six orders of (brightness, contrast, saturation)
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    """The chain's constant tensors on `device`, made once: a host-to-device
    copy of a new tensor waits for the card, so a step must not make them."""
    return {"luma": torch.tensor(LUMA, device=device),
            "orders": torch.tensor(JITTER_ORDERS, dtype=torch.int64, device=device),
            "mean": torch.tensor(IMAGENET_MEAN, device=device),
            "std": torch.tensor(IMAGENET_STD, device=device)}


def jitter_affine(factors: Tensor, mean_rgb: Tensor, order: Tensor) -> tuple[Tensor, Tensor]:
    """Each sample's ColorJitter as one affine map of RGB: (M [B, 3, 3],
    d [B, 3]) from factors [B, 3] (brightness, contrast, saturation),
    the image's channel means [B, 3] and the order [B, 3] of the ops
    (indices into the factors). Every PIL ImageEnhance op is affine:
    brightness b x, saturation s x + (1 - s) (luma . x), contrast
    c x + (1 - c) g with g the mean luma of its input, whose channel means
    move by the same map, so the chain composes exactly; batched over the
    samples with no vmap."""
    b_, dev = factors.shape[0], factors.device
    f = factors.to(torch.float32)
    luma = _constants(dev)["luma"]
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(b_, 3, 3)
    fb, fc, fs = f[:, 0, None, None], f[:, 1, None, None], f[:, 2, None, None]
    m_ops = torch.stack([fb * eye, fc * eye,
                         fs * eye + (1.0 - fs) * luma.expand(b_, 3, 3)], dim=1)  # [B, 3, 3, 3]
    m, d, mu = eye, torch.zeros(b_, 3, device=dev), mean_rgb.to(torch.float32)
    rows = torch.arange(b_, device=dev)
    for step in range(3):
        op = order[:, step].long()
        g = mu @ luma  # [B]
        d_ops = torch.stack([torch.zeros_like(mu), ((1.0 - f[:, 1]) * g)[:, None].expand(b_, 3),
                             torch.zeros_like(mu)], dim=1)  # [B, 3, 3]
        m_i, d_i = m_ops[rows, op], d_ops[rows, op]
        m = m_i @ m
        d = (m_i @ d[..., None])[..., 0] + d_i
        mu = (m_i @ mu[..., None])[..., 0] + d_i
    return m, d


def draw_image_chain(b: int, generator) -> dict:
    """factors [B, 3] in [0.6, 1.4), order [B, 3] (one of the six), flip
    [B] bool (p = 0.5)."""
    factors = _uniform((b, 3), generator, 0.6, 1.4)
    k = torch.randint(0, len(JITTER_ORDERS), (b,), generator=generator, device=generator.device)
    orders = _constants(generator.device)["orders"][k]
    flip = _uniform((b,), generator) < 0.5
    return {"factors": factors, "order": orders, "flip": flip}


def resize_images(x: Tensor, height: int, width: int) -> Tensor:
    """Bilinear resize of [B, H, W, C] f32 images with half-pixel centres,
    antialiased where it shrinks (a triangle filter widened by the scale,
    its weights renormalised at the borders), as jax.image.resize's
    "linear"."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def image_pretrain_chain(imgs: Tensor, d: dict, height: int | None = None,
                         width: int | None = None) -> Tensor:
    """[B, H, W, 3] uint8 (or [0, 255] float) -> normalised f32
    [B, height, width, 3]: a resize where a target size is given and
    differs, each sample's ColorJitter as one affine pass in its random
    order, the flip of W where `flip`, the ImageNet normalisation."""
    x = imgs.to(torch.float32)
    if height and width and tuple(x.shape[1:3]) != (height, width):
        x = resize_images(x, height, width)
    m, off = jitter_affine(d["factors"], x.mean(dim=(1, 2)), d["order"])
    x = torch.einsum("bhwc,bkc->bhwk", x, m) + off[:, None, None, :]
    x = x.clamp(0.0, 255.0) / 255.0
    x = torch.where(d["flip"][:, None, None, None], x.flip(2), x)
    c = _constants(x.device)
    return (x - c["mean"]) / c["std"]


def random_image_chain(imgs: Tensor, generator, height: int | None = None,
                       width: int | None = None) -> Tensor:
    return image_pretrain_chain(imgs, draw_image_chain(imgs.shape[0], generator), height, width)
