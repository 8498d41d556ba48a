"""K2: exact kNN with packed (distance | index) keys (counterpart of
ops/pallas/knn.py).

`knn` launches `csrc/knn.cu` on a CUDA tensor and runs its plain twin
`knn_plain` on a CPU tensor. Distances are the kernel's f32 difference of
squares summed over c = 0, 1, 2 in order — not `square_distance`'s matmul
identity, which rounds differently — and every packed key is unique, so
the twin gives the kernel's indices in the kernel's order (and the Pallas
kernel's).

The kernel selects in one pass to a threshold and one to compact the keys
below it (`csrc/geometry.cuh` `knn_query`); a query with more candidates
than its warp's slots takes the exact k-round scan, and so does every
k above `THRESHOLD_KMAX`. `knn(..., overflow=t)` adds the count of such
queries to the int32 card tensor `t`.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

LAUNCHES = cuda.LaunchCounter()
MAX_POINTS = 4096  # the cloud and the warps' candidate slots in shared memory
THRESHOLD_KMAX = 128  # csrc/geometry.cuh KNN_KMAX: past it the exact scan


def idx_bits_for(n: int) -> int:
    return max(1, (n - 1).bit_length())


def knn_plain(k: int, points: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """points f32 [B, N, 3], queries f32 [B, S, 3] -> int32 [B, S, k],
    nearest first."""
    n = points.shape[1]
    d = torch.zeros(
        (points.shape[0], queries.shape[1], n), dtype=torch.float32,
        device=points.device,
    )
    for c in range(3):
        delta = queries[:, :, None, c] - points[:, None, :, c]
        d = d + delta * delta
    mask = (1 << idx_bits_for(n)) - 1
    col = torch.arange(n, dtype=torch.int32, device=points.device)
    keys = (d.view(torch.int32) & ~mask) | col
    return torch.sort(keys, dim=-1).values[..., :k] & mask


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        overflow: torch.Tensor | None = None) -> torch.Tensor:
    """Indices of the k nearest `points` [B, N, >=3] for each of the
    `queries` [B, S, >=3] (xyz read as f32) -> int32 [B, S, k], nearest
    first. `overflow`: an int32 [1] card tensor the kernel adds the count
    of queries that took the exact scan to (the twin takes none)."""
    b, n, _ = points.shape
    s = queries.shape[1]
    points = points[..., :3].to(torch.float32).contiguous()
    queries = queries[..., :3].to(torch.float32).contiguous()
    if not points.is_cuda:
        return knn_plain(k, points, queries)
    if not (0 < k <= n <= MAX_POINTS):
        raise ValueError(f"knn kernel needs 0 < k <= N <= {MAX_POINTS}, got k={k}, N={n}")
    cuda.require(queries, "queries", torch.float32)
    if overflow is not None:
        cuda.require(overflow, "overflow", torch.int32, (1,))
    out = torch.empty((b, s, k), dtype=torch.int32, device=points.device)
    LAUNCHES.n += 1
    cuda.launch("knn_f32", points.device, points.data_ptr(), queries.data_ptr(), out.data_ptr(), b,
                n, s, k, None if overflow is None else overflow.data_ptr())
    return out
