"""Point-cloud geometry (counterpart of vipformer_tpu/ops/geometry.py).

FPS and kNN go through the K1/K2 wrappers (`ops/cuda/fps.py`,
`ops/cuda/knn.py`), and large row gathers through K12
(`ops/cuda/gather.py`): their CUDA kernels on a CUDA tensor, their plain
twins on a CPU tensor. Selection always reads f32 coordinates, whatever the
compute dtype. No TF32 anywhere: a reduced-precision distance flips kNN
sets at the k boundary.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops.cuda import fps as _fps
from vipformer_tpu_torch.ops.cuda import gather as _gather
from vipformer_tpu_torch.ops.cuda import knn as _knn


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """src [B, N, C], dst [B, M, C] -> [B, N, M] squared distances as
    |x|^2 + |y|^2 - 2<x,y>, in full f32 (the inner product is an elementwise
    sum, so no TF32 matmul setting can reach it)."""
    src = src.float()
    dst = dst.float()
    inner = (src[:, :, None, :] * dst[:, None, :, :]).sum(dim=-1)
    s2 = (src * src).sum(dim=-1)[:, :, None]
    d2 = (dst * dst).sum(dim=-1)[:, None, :]
    return s2 + d2 - 2.0 * inner


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C].

    Where the JAX package's gate sends the gather to its Pallas kernel
    (geometry.py:57-80: C <= 128, N >= 128, K >= 512 on its accelerator),
    the port gathers through K12 (`ops/cuda/gather.py:row_gather_enabled`);
    the `patch_compat` stem's neighbour gather is one such."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1)
    if _gather.row_gather_enabled(c, n, flat.shape[1], points.is_cuda):
        out = _gather.gather_rows(points, flat)
    else:
        out = torch.gather(points, 1, flat.long()[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def knn(k: int, points: torch.Tensor, queries: torch.Tensor, method: str = "kernel"):
    """Indices of the k nearest `points` [B, N, C] for each of the
    `queries` [B, S, C] -> int32 [B, S, k], nearest first.

    method: 'kernel' (K2: packed keys over the difference-of-squares
    distances), 'exact' (top_k over `square_distance`), or 'packed' (one
    sort over (distance bits | index) keys of `square_distance`)."""
    if method == "kernel":
        return _knn.knn(k, points, queries)
    d = square_distance(queries, points)
    if method == "exact":
        return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices.to(torch.int32)
    if method != "packed":
        raise ValueError(f"unknown knn method {method!r}")
    n = points.shape[1]
    mask = (1 << _knn.idx_bits_for(n)) - 1
    col = torch.arange(n, dtype=torch.int32, device=d.device)
    keys = (d.view(torch.int32) & ~mask) | col
    return torch.sort(keys, dim=-1).values[..., :k] & mask


def _start(pts: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor | None:
    """Random start indices for FPS (reference `torch.randint` start), or
    None for index 0 (deterministic eval)."""
    if generator is None:
        return None
    b, n = pts.shape[0], pts.shape[1]
    return torch.randint(0, n, (b,), generator=generator,
                         device=generator.device).to(pts.device)


def farthest_point_sample(pts, npoint: int, generator: torch.Generator | None = None):
    """FPS indices int32 [B, npoint] over the xyz of pts [B, N, C]."""
    return _fps.fps(pts, npoint, _start(pts, generator))[0]


def farthest_point_sample_with_centers(pts, npoint: int,
                                       generator: torch.Generator | None = None):
    """(idx int32 [B, npoint], centers [B, npoint, 3] in pts.dtype); the
    centers are the f32 coordinates K1 selected."""
    idx, centers = _fps.fps(pts, npoint, _start(pts, generator))
    return idx, centers.to(pts.dtype)


def fps(pts, npoint: int, generator: torch.Generator | None = None):
    """FPS returning the sampled points themselves: [B, npoint, C]."""
    if pts.shape[-1] == 3:
        return farthest_point_sample_with_centers(pts, npoint, generator)[1]
    return index_points(pts, farthest_point_sample(pts, npoint, generator))


def divide_patches(points, num_groups: int, group_size: int,
                   generator: torch.Generator | None = None, neighbor_dtype=None,
                   compat: bool = False):
    """FPS centers -> kNN neighbourhoods -> center-normalised patches.

    Returns (neighbors [B, G, S, C], centers [B, G, C]). The default
    subtracts each center from the xyz channels of its neighbours (the
    reference's documented intent) in one gather kernel, K10
    (ops/cuda/gather.py); `compat=True` reproduces the reference's actual
    slice, which subtracts the centers (all channels) from the first three
    neighbours of each group, after the row gather of `index_points` (K12
    on the card; geometry.py:295-349 of the JAX package). `generator`
    draws FPS's random start per cloud."""
    centers = fps(points, num_groups, generator)
    idx = knn(group_size, points[..., :3], centers[..., :3])
    src = points.to(neighbor_dtype) if neighbor_dtype is not None else points
    if not compat:
        b = src.shape[0]
        flat = _gather.gather_rows_centered(src, centers, idx.reshape(b, -1), group_size)
        return flat.view(b, num_groups, group_size, src.shape[-1]), centers
    neighbors = index_points(src, idx)  # [B, G, S, C], K12 on the card
    c = centers.to(neighbors.dtype)
    head = neighbors[:, :, :3, :] - c[:, :, None, :]
    return torch.cat([head, neighbors[:, :, 3:, :]], dim=2), centers


def three_nn_weights(xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """Row-stochastic inverse-distance 3-NN weights [B, N, S] (JAX
    geometry.py:381-420): of each destination point's squared distances to
    the S sources (full f32, `square_distance`), three passes each take the
    first minimum (argmin's first index on ties), add 1 / (d + eps) at its
    column and mask it with inf; the rows are divided by their sums."""
    d = square_distance(xyz_dst, xyz_src)  # [B, N, S]
    cols = torch.arange(d.shape[-1], device=d.device)
    w_unnorm = torch.zeros_like(d)
    w_sum = torch.zeros_like(d[..., :1])
    for _ in range(3):
        i = torch.argmin(d, dim=-1, keepdim=True)  # first index on ties
        v = torch.gather(d, -1, i)
        onehot = cols == i
        w_k = 1.0 / (v + eps)
        w_unnorm = w_unnorm + onehot * w_k
        w_sum = w_sum + w_k
        d = torch.where(onehot, torch.inf, d)
    return w_unnorm / w_sum


def three_nn_interpolate(xyz_dst: torch.Tensor, xyz_src: torch.Tensor, feats_src: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance 3-NN interpolation of feats_src [B, S, D] at the
    S sources to the N destinations: [B, N, D], one batched product with the
    weights in the features' dtype."""
    return three_nn_weights(xyz_dst, xyz_src, eps).to(feats_src.dtype) @ feats_src
