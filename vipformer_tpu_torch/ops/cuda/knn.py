"""K2: exact kNN with packed (distance | index) keys (counterpart of
ops/pallas/knn.py).

`knn` launches `csrc/knn.cu` on a CUDA tensor and runs its plain twin
`knn_plain` on a CPU tensor. Distances are the kernel's f32 difference of
squares summed over c = 0, 1, 2 in order — not `square_distance`'s matmul
identity, which rounds differently — so the twin selects the same index
sets as the kernel (and as the Pallas kernel).
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

LAUNCHES = cuda.LaunchCounter()
MAX_POINTS = 4096  # keys per lane held in registers (128 x 32 lanes)


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


def knn(k: int, points: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Indices of the k nearest `points` [B, N, >=3] for each of the
    `queries` [B, S, >=3] (xyz read as f32) -> int32 [B, S, k]."""
    b, n, _ = points.shape
    s = queries.shape[1]
    points = points[..., :3].to(torch.float32).contiguous()
    queries = queries[..., :3].to(torch.float32).contiguous()
    if not points.is_cuda:
        return knn_plain(k, points, queries)
    if not (0 < k <= n <= MAX_POINTS):
        raise ValueError(f"knn kernel needs 0 < k <= N <= {MAX_POINTS}, got k={k}, N={n}")
    cuda.require(queries, "queries", torch.float32)
    out = torch.empty((b, s, k), dtype=torch.int32, device=points.device)
    LAUNCHES.n += 1
    cuda.check(cuda.lib().knn_f32(
        points.data_ptr(), queries.data_ptr(), out.data_ptr(), b, n, s, k,
        cuda.stream_ptr(),
    ), "knn_f32")
    return out
