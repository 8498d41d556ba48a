"""Point-cloud geometry (counterpart of vipformer_tpu/ops/geometry.py).

FPS and kNN go through the K1/K2 wrappers (`ops/cuda/fps.py`,
`ops/cuda/knn.py`): their CUDA kernels on a CUDA tensor, their plain twins
on a CPU tensor. Selection always reads f32 coordinates, whatever the
compute dtype. No TF32 anywhere: a reduced-precision distance flips kNN
sets at the k boundary.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops.cuda import fps as _fps
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
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
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
    reference's documented intent); `compat=True` reproduces the
    reference's actual slice, which subtracts the centers (all channels)
    from the first three neighbours of each group (geometry.py:295-349 of
    the JAX package)."""
    centers = fps(points, num_groups, generator)
    idx = knn(group_size, points[..., :3], centers[..., :3])
    src = points.to(neighbor_dtype) if neighbor_dtype is not None else points
    neighbors = index_points(src, idx)  # [B, G, S, C]
    c = centers.to(neighbors.dtype)
    if compat:
        head = neighbors[:, :, :3, :] - c[:, :, None, :]
        neighbors = torch.cat([head, neighbors[:, :, 3:, :]], dim=2)
    else:
        delta = neighbors[..., :3] - c[..., None, :3]
        neighbors = torch.cat([delta, neighbors[..., 3:]], dim=-1)
    return neighbors, centers
