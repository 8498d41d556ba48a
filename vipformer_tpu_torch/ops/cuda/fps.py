"""K1: farthest point sampling (counterpart of ops/pallas/fps.py).

`fps` launches `csrc/fps.cu` on a CUDA tensor and runs its plain twin
`fps_plain` on a CPU tensor. Both compute the squared distance as
(x-cx)^2 + (y-cy)^2 + (z-cz)^2 with separately rounded operations, in the
Pallas kernel's order, and break argmax ties towards the first index, so
their indices agree exactly.

The kernel holds a cloud in registers, PPL points a lane, in
`fps_warps(N)` warps: a step's argmax is two warp reductions (redux.sync)
and, past one warp, one block barrier. PPL is 8 (4 warps at 1,024
points): one warp of 32 points a lane, with no barrier, and 2 warps of
16 measured slower (PERF.md).
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

LAUNCHES = cuda.LaunchCounter()
MAX_POINTS = 8 * 1024  # the cloud in shared memory (96 KB), 32 warps of 32 x 8 points
PPL = 8  # points a lane (csrc/geometry.cuh FPS_PPL)


def fps_warps(n: int) -> int:
    """Warps a cloud of n points takes: lane l of warp w holds points
    (w PPL + k) 32 + l, k < PPL."""
    return -(-n // (32 * PPL))


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor):
    """xyz f32 [B, N, 3], start int32 [B] -> (idx int32 [B, npoint],
    centers f32 [B, npoint, 3])."""
    b, n, _ = xyz.shape
    xs, ys, zs = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.long()
    cols = torch.arange(n, device=xyz.device).expand(b, n)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    centers = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    for i in range(npoint):
        idx[:, i] = far.to(torch.int32)
        c = xyz[rows, far]  # [B, 3]
        centers[:, i] = c
        dx = xs - c[:, 0:1]
        dy = ys - c[:, 1:2]
        dz = zs - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, d)
        # first index of the maximum (torch.argmax does not promise ties)
        m = dist.max(dim=1, keepdim=True).values
        far = torch.where(dist == m, cols, n).min(dim=1).values
    return idx, centers


def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor | None = None):
    """FPS indices and centers for xyz [B, N, >=3] (first 3 channels,
    read as f32). `start`: optional int [B] start indices (default 0)."""
    b, n, _ = xyz.shape
    xyz = xyz[..., :3].to(torch.float32).contiguous()
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=xyz.device)
    start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint, start)
    if n > MAX_POINTS:
        raise ValueError(f"fps kernel takes at most {MAX_POINTS} points, got {n}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    centers = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    LAUNCHES.n += 1
    cuda.launch("fps_f32", xyz.device, xyz.data_ptr(), start.data_ptr(), idx.data_ptr(),
                centers.data_ptr(), b, n, npoint)
    return idx, centers
