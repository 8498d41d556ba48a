"""Deterministic synthetic stand-ins (the port's own copy of the
classification-cloud, part-segmentation, semantic-segmentation and
splat-image parts of vipformer_tpu/data/synthetic.py): class-structured
parametric clouds, an orthographic splat of each as its "render",
height-banded part labels, and S3DIS-shaped blocks whose class follows the
height, so the objectives have real signal without the real corpora.
"""

from __future__ import annotations

import numpy as np


def _primitive(label: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """A noisy parametric shape whose geometry depends on the label."""
    kind = label % 4
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-1, 1, n)
    squash = 0.4 + 0.15 * (label // 4)
    if kind == 0:  # ellipsoid
        phi = np.arccos(v)
        pts = np.stack(
            [np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u) * squash,
             np.cos(phi)], -1)
    elif kind == 1:  # torus
        r = 0.25 + 0.05 * (label // 4)
        w = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack(
            [(1 - r * np.cos(w)) * np.cos(u),
             (1 - r * np.cos(w)) * np.sin(u), r * np.sin(w) * (1 + squash)],
            -1)
    elif kind == 2:  # box surface
        face = rng.integers(0, 6, n)
        a = rng.uniform(-1, 1, n)
        b = rng.uniform(-1, 1, n)
        pts = np.zeros((n, 3))
        s = np.where(face % 2 == 0, 1.0, -1.0)
        ax = face // 2
        for d in range(3):
            sel = ax == d
            pts[sel, d] = s[sel] * squash * 2
            pts[sel, (d + 1) % 3] = a[sel]
            pts[sel, (d + 2) % 3] = b[sel]
    else:  # cone
        h = rng.uniform(0, 1, n)
        pts = np.stack(
            [(1 - h) * np.cos(u) * squash, (1 - h) * np.sin(u), 2 * h - 1],
            -1)
    pts += 0.02 * rng.standard_normal((n, 3))
    return pts.astype(np.float32)


def synthetic_classification(
    num_samples: int, num_points: int, num_classes: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """-> (data [S, N, 3], labels [S])."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_samples)
    data = np.stack(
        [_primitive(int(l), num_points, rng) for l in labels]
    )
    return data.astype(np.float32), labels.astype(np.int64)


# ShapeNetPart category metadata (reference datasets/shapenet_part.py:77-78)
SEG_NUM = (4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3)
INDEX_START = (0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41, 44, 47)


def synthetic_partseg(num_samples: int, num_points: int,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (data [S, N, 3], obj_label [S, 1], seg [S, N]): part ids from the
    category's own range, banded by height so they are learnable."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 16, num_samples)
    data = np.stack([_primitive(int(l), num_points, rng) for l in labels])
    segs = np.zeros((num_samples, num_points), dtype=np.int64)
    for i, l in enumerate(labels):
        k = SEG_NUM[l]
        z = data[i, :, 2]
        bands = np.clip(((z - z.min()) / max(np.ptp(z), 1e-6) * k).astype(int), 0, k - 1)
        segs[i] = INDEX_START[l] + bands
    return data.astype(np.float32), labels.astype(np.int64)[:, None], segs


def synthetic_semseg(num_samples: int, num_points: int = 4096, num_classes: int = 13,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """-> (data f32 [S, N, 9], labels int64 [S, N]) shaped like the S3DIS
    chopped blocks: xyz, an rgb that encodes the class (plus noise), and the
    normalised position (here xyz again); the class is the height band."""
    rng = np.random.default_rng(seed)
    data = np.zeros((num_samples, num_points, 9), dtype=np.float32)
    labels = np.zeros((num_samples, num_points), dtype=np.int64)
    for i in range(num_samples):
        xyz = rng.uniform(0, 1, (num_points, 3))
        cls = np.clip((xyz[:, 2] * num_classes).astype(int), 0, num_classes - 1)
        rgb = np.stack([cls / num_classes] * 3, -1) + 0.1 * rng.uniform(size=(num_points, 3))
        data[i, :, :3] = xyz
        data[i, :, 3:6] = np.clip(rgb, 0, 1)
        data[i, :, 6:9] = xyz
        labels[i] = cls
    return data, labels


def splat_image(pts: np.ndarray, size: int = 137) -> np.ndarray:
    """Orthographic splat of a cloud into an RGB uint8 image (a stand-in for
    the ShapeNetRendering views; depth colors the channel mix)."""
    img = np.zeros((size, size, 3), dtype=np.float32)
    xyz = pts[:, :3]
    lo, hi = xyz.min(0), xyz.max(0)
    uvz = (xyz - lo) / np.maximum(hi - lo, 1e-6)
    u = np.clip((uvz[:, 0] * (size - 1)).astype(int), 0, size - 1)
    v = np.clip((uvz[:, 1] * (size - 1)).astype(int), 0, size - 1)
    z = uvz[:, 2]
    img[v, u, 0] = np.maximum(img[v, u, 0], 1 - z)
    img[v, u, 1] = np.maximum(img[v, u, 1], z)
    img[v, u, 2] = 0.5
    return (img * 255).astype(np.uint8)
