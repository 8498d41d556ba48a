"""K16: farthest point sampling and the kNN of its centers in one launch
(counterpart of ops/pallas/patchify.py:fps_knn_pallas).

`fps_knn` launches `csrc/patchify.cu` on a CUDA tensor and runs its plain
twin `fps_knn_plain` on a CPU tensor. The kernel runs K1's FPS step and
K2's kNN selection (the device functions of csrc/geometry.cuh), its kNN
warps selecting each center's neighbours while its FPS warps pick the next
centers, so its indices equal K1 followed by K2 on K1's centers bit for
bit; the twin is that composition of the two twins.

The JAX package wires its kernel nowhere (ops/geometry.py:305-309: slower
than FPS + kNN on its TPU). `USE_FPS_KNN` routes the port's FPS + kNN
(`ops/geometry.py:fps_knn`) through it: None (auto) and False keep K1 +
K2, on the card too; True forces K16. It changes no result, only the
launches.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda
from vipformer_tpu_torch.ops.cuda import fps as _fps
from vipformer_tpu_torch.ops.cuda import knn as _knn

LAUNCHES = cuda.LaunchCounter()
USE_FPS_KNN: bool | None = None
MAX_POINTS = _knn.MAX_POINTS  # K2's limit: the cloud in shared memory


def fps_knn_enabled() -> bool:
    """Whether FPS + kNN run as K16: only when USE_FPS_KNN forces it."""
    return bool(USE_FPS_KNN)


def fps_knn_plain(xyz: torch.Tensor, num_groups: int, group_size: int, start: torch.Tensor):
    """xyz f32 [B, N, 3], start int32 [B] -> (centers_idx int32 [B, G],
    neighbor_idx int32 [B, G, K]): K1's twin, then K2's on its centers."""
    cidx, centers = _fps.fps_plain(xyz, num_groups, start)
    return cidx, _knn.knn_plain(group_size, xyz, centers)


def fps_knn(xyz: torch.Tensor, num_groups: int, group_size: int,
            start: torch.Tensor | None = None, overflow: torch.Tensor | None = None):
    """FPS centers and their kNN over xyz [B, N, >=3] (the first three
    channels, read as f32). `start`: optional int [B] FPS start indices
    (default 0). -> (centers_idx int32 [B, G], neighbor_idx int32
    [B, G, K], nearest first). `overflow`: as `knn`'s, counting centers."""
    b, n, _ = xyz.shape
    xyz = xyz[..., :3].to(torch.float32).contiguous()
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=xyz.device)
    start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
    if not xyz.is_cuda:
        return fps_knn_plain(xyz, num_groups, group_size, start)
    if not (0 < group_size <= n <= MAX_POINTS and 0 < num_groups <= n):
        raise ValueError(f"fps_knn kernel needs 0 < K <= N <= {MAX_POINTS} and 0 < G <= N, "
                         f"got G={num_groups}, K={group_size}, N={n}")
    if overflow is not None:
        cuda.require(overflow, "overflow", torch.int32, (1,))
    cidx = torch.empty((b, num_groups), dtype=torch.int32, device=xyz.device)
    nidx = torch.empty((b, num_groups, group_size), dtype=torch.int32, device=xyz.device)
    LAUNCHES.n += 1
    cuda.launch("fps_knn_f32", xyz.device, xyz.data_ptr(), start.data_ptr(), cidx.data_ptr(),
                nidx.data_ptr(), b, n, num_groups, group_size,
                None if overflow is None else overflow.data_ptr())
    return cidx, nidx
