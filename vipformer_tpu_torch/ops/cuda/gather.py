"""K10: the patch gather with centering, forward and backward (counterpart
of `gather_rows_centered_pallas` in ops/pallas/gather.py).

`gather_rows_centered(points, centers, idx, group_size)`: points [B, N, C],
centers [B, G, >=3], idx int [B, G*S] -> [B, G*S, C] = points[idx] minus
the xyz of the owning group's center (r // S) on channels 0..2; the
center is rounded to the points' dtype first and the difference is taken
in f32 and rounded once. Extra channels ride along uncentered.

A `torch.autograd.Function` launches `csrc/gather.cu` on CUDA tensors and
runs the plain twins below on CPU tensors. The backward scatter-adds the
gradient into the points (several groups may pick one point) and sums it,
negated, over each group's rows into its center: on the card one launch
of `scatter_sorted_kernel` (`scatter_plan` cuts each cloud's points into
slices, a block each), which sorts each cloud's rows by point and sums
each point's rows in row order, so d_points comes out in the points'
dtype with the same bits in every run.

K12: the plain row gather (counterpart of `gather_rows_pallas`,
ops/pallas/gather.py:180).

`gather_rows(points, idx)`: points [B, N, C <= 128], idx int [B, K] ->
[B, K, C] = points[b, idx[b, k]], a copy (bit-exact, any K), on K10's
forward kernel with the centering compiled out. Its backward is K10's
VJP kernel without the centers: each point's rows summed in row order in
f32, rounded once to the points' dtype, deterministic. `row_gather_enabled` is the port's copy of the JAX package's gate
(`mxu_gather_enabled`, gather.py:434-444), which `index_points` consults.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

FWD_LAUNCHES = cuda.LaunchCounter()
BWD_LAUNCHES = cuda.LaunchCounter()
ROWS_FWD_LAUNCHES = cuda.LaunchCounter()
ROWS_BWD_LAUNCHES = cuda.LaunchCounter()
MAX_ROW_CHANNELS = 128  # the Pallas kernel's table row: one tile of lanes
CENTERED_RUN_ROWS = 64  # K10's forward: the most rows of a warp's run (2 a lane)
CENTERED_STAGE_BYTES = 4096  # ... and the most bytes of its staged output
# the VJPs' kernel (csrc/gather.cu scatter_sorted_kernel): a block a slice
# of one cloud's points, the cloud's row ids in its shared memory
SCATTER_MAX_ROWS = 16384  # K: a cloud's rows
SCATTER_MAX_PART = 4096  # the most points a block owns
SCATTER_MIN_PART = 32  # ... and the fewest, where slices are cut to fill the card
SCATTER_BLOCKS_PER_SM = 3  # blocks of 512 threads an SM holds (40 registers a thread)
SCATTER_STAGE_BYTES = 65536  # a cloud's g in at most 64 KB is staged in shared memory
# None = auto (on the card where the JAX gate's shape conditions hold); a
# bool forces it, as the JAX package's USE_MXU_GATHER (gather.py:38)
USE_ROW_GATHER: bool | None = None


def _group_ids(k: int, group_size: int, device) -> torch.Tensor:
    return torch.arange(k, device=device) // group_size


def gather_centered_plain(points, centers, idx, group_size: int):
    b, _, c = points.shape
    k = idx.shape[1]
    dt = points.dtype
    nb = torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c)).float()
    cz = centers[..., :3].to(dt).float()[:, _group_ids(k, group_size, points.device)]
    return torch.cat([nb[..., :3] - cz, nb[..., 3:]], dim=-1).to(dt)


def scatter_centered_plain(g, idx, n: int, gnum: int, group_size: int):
    """-> (d_points f32 [B, N, C], d_centers f32 [B, G, 3] rounded to g's dtype)."""
    b, k, c = g.shape
    gf = g.float()
    dp = torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    dp.scatter_add_(1, idx.long()[..., None].expand(-1, -1, c), gf)
    dc = -gf[..., :3].reshape(b, gnum, group_size, 3).sum(2)
    return dp, dc.to(g.dtype).float()


def check_centered_sizes(b: int, n: int, c: int, k: int) -> None:
    """What K10's forward kernel takes (csrc/gather.cu): C <= MAX_ROW_CHANNELS,
    and B*N*C, B*K*C below 2^31 (32-bit offsets)."""
    if c > MAX_ROW_CHANNELS:
        raise ValueError(f"centered gather kernel takes C <= {MAX_ROW_CHANNELS} channels, got {c}")
    if max(b * n * c, b * k * c) >= 2**31:
        raise ValueError("centered gather kernel indexes B*N*C and B*K*C with 32-bit integers")


def centered_run_rows(c: int, itemsize: int) -> int:
    """Output rows a warp of K10's forward takes as one run (csrc/gather.cu):
    at most CENTERED_RUN_ROWS, its C channels of `itemsize` bytes staged in
    at most CENTERED_STAGE_BYTES, and a multiple of 8, so that every run
    starts on a 16-byte boundary of the output."""
    return min(CENTERED_RUN_ROWS, CENTERED_STAGE_BYTES // (c * itemsize) // 8 * 8)


def scatter_plan(b: int, n: int, k: int, c: int, itemsize: int,
                 sms: int) -> tuple[int, int, bool]:
    """(np, lanes, stage) of the VJPs' kernel (csrc/gather.cu
    scatter_sorted_kernel) for B clouds of N points, K rows a cloud and C
    channels of `itemsize` bytes on `sms` SMs: each cloud's points cut
    into slices of np (ceil(N / np) blocks a cloud), as many as one wave
    of SCATTER_BLOCKS_PER_SM blocks an SM holds where slices of
    SCATTER_MIN_PART points allow (one a cloud where B alone fills the
    wave), none above SCATTER_MAX_PART; a group of `lanes` lanes a point
    (a power of two, 4 channels a lane); `stage`: the cloud's g copied
    into shared memory first (where its K C elements take at most 64 KB).
    Raises at a shape the kernel is not built for."""
    if c > MAX_ROW_CHANNELS:
        raise ValueError(f"scatter kernel takes C <= {MAX_ROW_CHANNELS} channels, got {c}")
    if k > SCATTER_MAX_ROWS:
        raise ValueError(f"scatter kernel takes K <= {SCATTER_MAX_ROWS} rows a cloud (their ids "
                         f"in shared memory), got {k}")
    fit = max(1, SCATTER_BLOCKS_PER_SM * sms // max(b, 1))
    parts = max(-(-n // SCATTER_MAX_PART), min(fit, max(1, n // SCATTER_MIN_PART)))
    lanes = 1
    while 4 * lanes < c:
        lanes *= 2
    stage = k * c * itemsize <= SCATTER_STAGE_BYTES
    return -(-n // parts), lanes, stage


def _scatter_args(g, n: int) -> tuple:
    """(np, lanes, vec, stage) for a launch on g [B, K, C]: vec where C is a
    multiple of 4 and g starts on 16 bytes (4 channels a load)."""
    b, k, c = g.shape
    np_, lanes, stage = scatter_plan(b, n, k, c, g.element_size(), cuda.sm_count(g.device.index))
    return np_, lanes, int(c % 4 == 0 and g.data_ptr() % 16 == 0), int(stage)


def gather_centered_kernel(points, centers, idx, group_size: int):
    b, n, c = points.shape
    gnum, k = centers.shape[1], idx.shape[1]
    dt = points.dtype
    if k != gnum * group_size:
        raise ValueError(f"idx has {k} rows, expected G*S = {gnum * group_size}")
    check_centered_sizes(b, n, c, k)
    points = points.contiguous()
    cz = centers[..., :3].float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    cuda.require(points, "points", dt, (b, n, c))
    cuda.require(cz, "centers", torch.float32, (b, gnum, 3))
    cuda.require(idx, "idx", torch.int32, (b, k))
    out = torch.empty((b, k, c), dtype=dt, device=points.device)
    fn = cuda.entry_point("gather_centered", dt)
    FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        points.data_ptr(), cz.data_ptr(), idx.data_ptr(), out.data_ptr(),
        b, n, c, gnum, k, group_size, centered_run_rows(c, points.element_size()),
        cuda.stream_ptr()), fn)
    return out


def scatter_centered_kernel(g, idx, n: int, gnum: int, group_size: int):
    """K10's VJP, one launch: (d_points [B, N, C] in g's dtype, d_centers
    f32 [B, G, 3] rounded to g's dtype), the same bits in every run."""
    b, k, c = g.shape
    dt = g.dtype
    if k != gnum * group_size:
        raise ValueError(f"grad has {k} rows, expected G*S = {gnum * group_size}")
    g = g.contiguous()
    idx = idx.to(torch.int32).contiguous()
    cuda.require(g, "grad", dt, (b, k, c))
    cuda.require(idx, "idx", torch.int32, (b, k))
    np_, lanes, vec, stage = _scatter_args(g, n)
    dp = torch.empty((b, n, c), dtype=dt, device=g.device)
    dc = torch.empty((b, gnum, 3), dtype=torch.float32, device=g.device)
    fn = cuda.entry_point("scatter_centered", dt)
    BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        g.data_ptr(), idx.data_ptr(), dp.data_ptr(), dc.data_ptr(),
        b, n, c, gnum, k, group_size, np_, lanes, vec, stage, cuda.stream_ptr()), fn)
    return dp, dc


class _GatherCentered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, centers, idx, group_size):
        fwd = gather_centered_kernel if points.is_cuda else gather_centered_plain
        ctx.save_for_backward(idx)
        ctx.meta = (points.shape[1], points.dtype, centers.shape, centers.dtype, group_size)
        return fwd(points, centers, idx, group_size)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n, p_dtype, c_shape, c_dtype, group_size = ctx.meta
        bwd = scatter_centered_kernel if grad.is_cuda else scatter_centered_plain
        dp, dc = bwd(grad.to(p_dtype), idx, n, c_shape[1], group_size)
        if c_shape[-1] > 3:
            dc = torch.cat([dc, dc.new_zeros(*c_shape[:-1], c_shape[-1] - 3)], dim=-1)
        return dp.to(p_dtype), dc.to(c_dtype), None, None


def gather_rows_centered(points, centers, idx, group_size: int):
    """points[idx] minus the owning group's center xyz (see module doc)."""
    return _GatherCentered.apply(points, centers, idx, group_size)


# ------------------------------------------------------------------ K12


def row_gather_enabled(c: int, n: int, flat_k: int, on_card: bool) -> bool:
    """Whether `index_points` gathers a [B, N, C] table at K = flat_k rows
    through K12: forced by USE_ROW_GATHER, else on the card where the JAX
    gate holds (C <= 128, N >= 128, K >= 512; its TPU-backend check is the
    port's `on_card`)."""
    if USE_ROW_GATHER is not None:
        return USE_ROW_GATHER
    return on_card and c <= MAX_ROW_CHANNELS and n >= 128 and flat_k >= 512


def gather_rows_plain(points, idx):
    """points [B, N, C], idx int [B, K] -> [B, K, C]."""
    c = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c))


def scatter_rows_plain(g, idx, n: int):
    """g [B, K, C], idx int [B, K] -> d_points f32 [B, N, C]: each row of g
    added into row idx[b, k], in f32."""
    b, _, c = g.shape
    dp = torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    return dp.scatter_add_(1, idx.long()[..., None].expand(-1, -1, c), g.float())


def _rows_operands(t, idx, name: str):
    b, c = t.shape[0], t.shape[2]
    if c > MAX_ROW_CHANNELS:
        raise ValueError(f"row gather kernel takes C <= {MAX_ROW_CHANNELS} channels, got {c}")
    if b * idx.shape[1] * c >= 2**31:
        raise ValueError("row gather kernel indexes B*K*C elements with 32-bit integers")
    t = t.contiguous()
    idx = idx.to(torch.int32).contiguous()
    cuda.require(t, name, t.dtype)
    cuda.require(idx, "idx", torch.int32, (b, idx.shape[1]))
    return t, idx


def gather_rows_kernel(points, idx):
    """K12's forward: K10's warp-run kernel with the centering compiled out
    (csrc/gather.cu), runs of `centered_run_rows` rows; B*N*C and B*K*C
    below 2^31, as K10's."""
    points, idx = _rows_operands(points, idx, "points")
    b, n, c = points.shape
    k = idx.shape[1]
    check_centered_sizes(b, n, c, k)
    dt = points.dtype
    fn = cuda.entry_point("gather_rows", dt)
    out = torch.empty((b, k, c), dtype=dt, device=points.device)
    ROWS_FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, c, k,
        centered_run_rows(c, points.element_size()), cuda.stream_ptr()), fn)
    return out


def scatter_rows_kernel(g, idx, n: int):
    """K12's VJP, one launch: d_points [B, N, C] in g's dtype, the same bits
    in every run (K10's VJP kernel without the centers)."""
    g, idx = _rows_operands(g, idx, "grad")
    b, k, c = g.shape
    np_, lanes, vec, stage = _scatter_args(g, n)
    fn = cuda.entry_point("scatter_rows", g.dtype)
    dp = torch.empty((b, n, c), dtype=g.dtype, device=g.device)
    ROWS_BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        g.data_ptr(), idx.data_ptr(), dp.data_ptr(), b, n, c, k, np_, lanes, vec, stage,
        cuda.stream_ptr()), fn)
    return dp


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (points.shape[1], points.dtype)
        return (gather_rows_kernel if points.is_cuda else gather_rows_plain)(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n, dt = ctx.meta
        bwd = scatter_rows_kernel if grad.is_cuda else scatter_rows_plain
        return bwd(grad.to(dt), idx, n).to(dt), None


def gather_rows(points, idx):
    """points[b, idx[b, k]] (see module doc): K12 on CUDA tensors, the plain
    twin on CPU tensors; differentiable in the points."""
    return _GatherRows.apply(points, idx)
