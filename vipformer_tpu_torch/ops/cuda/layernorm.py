"""K17: row LayerNorm, forward and backward (counterpart of
ops/pallas/layernorm.py).

* `ln_fwd_plain` / `ln_fwd`: x [R, D], scale, bias f32 [D] -> (y [R, D] in
  x's dtype, mu f32 [R], rsig f32 [R]).
* `ln_bwd_plain` / `ln_bwd`: (x, dy [R, D], mu, rsig, scale) -> (dx [R, D]
  in x's dtype, dscale f32 [D], dbias f32 [D]).
  The kernel entry points launch `csrc/layernorm.cu` on CUDA tensors and
  run the plain twin on CPU tensors.
* `layernorm_enabled`: the port's copy of the JAX gate (layernorm.py:149-
  177): off under auto (measured slower in-model on the JAX package's
  TPU), and when forced, on where the JAX kernel's row blocking is
  feasible.
* `layernorm_apply`: flax LayerNorm's function as a
  `torch.autograd.Function` over K17 (JAX `layernorm_apply`, :180-262).
"""

from __future__ import annotations

import math

import torch

from vipformer_tpu_torch.ops import cuda

FWD_LAUNCHES = cuda.LaunchCounter()
BWD_LAUNCHES = cuda.LaunchCounter()
# None = auto (off, as in JAX layernorm.py:44,177), a bool forces it
USE_LAYERNORM: bool | None = None
_VMEM_BUDGET = 8 * 1024 * 1024  # the JAX kernel's row-block budget (:47)
# the forward kernels (csrc/layernorm.cu ln_fwd_kernel, ln_fwd_staged_kernel):
# warps a block (at most), the most columns a lane holds (so D <= 2,048),
# ln_fwd_kernel's lane-group sizes (the staged kernel's is a warp), and the
# shared memory a staged block aims at (two tile buffers a warp; two
# blocks or more an SM)
FWD_WARPS = 8
FWD_LANE_COLS = 64
FWD_MAX_D = 32 * FWD_LANE_COLS
FWD_LANES = (32, 16, 8, 4, 2)
STAGED_SMEM_BYTES = 100 * 1024
# the backward kernel (ln_bwd_kernel): warps a block, columns a lane holds
# in registers (a warp covers 512 of a row); the widest vector a lane of
# either kernel loads (bytes)
BWD_WARPS = 16
LANE_COLS = 16
VEC_BYTES = 16


def _pick_block_rows(r: int, d: int, itemsize: int) -> int:
    """The JAX package's row-block picker (layernorm.py:50-59): the largest
    power-of-two block in [256, 4096] that divides R and whose in/out
    blocks and f32 temporaries fit the budget; 0 if none does."""
    br = 4096
    while br >= 256:
        if r % br == 0 and br * d * (4 * itemsize + 12) <= _VMEM_BUDGET:
            return br
        br //= 2
    return 0


def layernorm_enabled(rows: int, d: int, itemsize: int) -> bool:
    """Whether a LayerNorm over `rows` rows of width d takes K17: only when
    USE_LAYERNORM forces it, and then where the JAX row blocking is
    feasible."""
    if USE_LAYERNORM is not None:
        return USE_LAYERNORM and _pick_block_rows(rows, d, itemsize) > 0
    return False


def ln_fwd_plain(x2d, scale, bias):
    xf = x2d.float()
    mu = xf.mean(-1)
    mu2 = (xf * xf).mean(-1)
    rsig = torch.rsqrt(torch.clamp_min(mu2 - mu * mu, 0.0) + cuda.LN_EPS)
    y = (xf - mu[:, None]) * (rsig[:, None] * scale) + bias
    return y.to(x2d.dtype), mu, rsig


def ln_bwd_plain(x2d, dy2d, mu, rsig, scale):
    xf, dyf = x2d.float(), dy2d.float()
    xhat = (xf - mu[:, None]) * rsig[:, None]
    dxhat = dyf * scale
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rsig[:, None] * (dxhat - m1 - xhat * m2)
    return dx.to(x2d.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def _f32(t, name, shape):
    t = t.float().contiguous()
    cuda.require(t, name, torch.float32, shape)
    return t


def staged_head_bytes(d: int) -> int:
    """The staged kernel's scale and bias in shared memory: (scale[k],
    bias[k], scale[k + 1], bias[k + 1]) a column (csrc/layernorm.cu
    staged_head_bytes)."""
    return 16 * d


def staged_tile_rows(d: int, itemsize: int) -> int:
    """Rows of a warp's tile in the staged kernel: the fewest whose bytes
    are a multiple of 16 (8 at an odd bf16 width, 4 at an odd f32 one)."""
    return VEC_BYTES // math.gcd(d * itemsize, VEC_BYTES)


def staged_smem_bytes(d: int, itemsize: int, rows_block: int) -> int:
    """A staged block's shared memory: scale and bias, then two tile
    buffers for each of its warps (rows_block / tile rows)."""
    return staged_head_bytes(d) + 2 * rows_block * d * itemsize


def fwd_plan(d: int, itemsize: int, *ptrs: int) -> tuple[int, int, int, int, bool]:
    """(lanes a row, columns a vector, vectors a lane, rows a block, staged)
    of the forward (csrc/layernorm.cu), D <= FWD_MAX_D as the backward.

    Where a row's bytes are a multiple of 16, or a pointer is off a 16-byte
    boundary, ln_fwd_kernel: the row's D / vec vectors go to a group of
    `lanes` lanes, nv each; of the group sizes that give a lane at most
    max(4, ceil(vectors / 32)) vectors, the one that leaves the fewest
    slots empty, the larger on a tie (D = 384 bf16: 16 lanes of 3 vectors,
    2 rows a warp; D = 64 bf16: 8 lanes of 1, 4 rows a warp), FWD_WARPS
    warps a block. Elsewhere (D = 261) the staged kernel: a warp's tile of
    `staged_tile_rows` rows moves in 16-byte vectors through shared memory,
    where 32 / tile rows lanes a row read it two columns a word in bf16
    (one in f32), nv words a lane at most (D = 261 bf16: 8 rows, 4 lanes
    of 33 words); as many warps a block (up to FWD_WARPS) as fit two tile
    buffers each in STAGED_SMEM_BYTES."""
    if not 1 <= d <= FWD_MAX_D:
        raise NotImplementedError(f"K17's forward takes 1 <= D <= {FWD_MAX_D}, got {d}")
    if (d * itemsize) % VEC_BYTES and not any(p % VEC_BYTES for p in ptrs):
        tile_rows = staged_tile_rows(d, itemsize)
        lanes = 32 // tile_rows
        # a row's words: D / 2, or one more where it starts or ends mid-word
        vec, per_row = (2, d // 2 + 1) if itemsize == 2 else (1, d)
        warps = (STAGED_SMEM_BYTES - staged_head_bytes(d)) // (2 * tile_rows * d * itemsize)
        return (lanes, vec, -(-per_row // lanes), max(1, min(FWD_WARPS, warps)) * tile_rows,
                True)
    vec = vec_for(d, itemsize, *ptrs, lane_vectors=1)
    nvec = d // vec
    limit = max(4, -(-nvec // 32))
    best = None
    for lanes in FWD_LANES:
        nv = -(-nvec // lanes)
        if nv <= limit and (best is None or lanes * nv - nvec < best[0]):
            best = (lanes * nv - nvec, lanes, nv)
    _, lanes, nv = best
    return lanes, vec, nv, FWD_WARPS * (32 // lanes), False


def ln_fwd(x2d, scale, bias):
    """K17's forward kernel on a CUDA tensor, the twin on a CPU tensor."""
    if not x2d.is_cuda:
        return ln_fwd_plain(x2d, scale.float(), bias.float())
    r, d = x2d.shape
    dt = x2d.dtype
    fn = cuda.entry_point("ln_fwd", dt)
    x2d = x2d.contiguous()
    cuda.require(x2d, "x", dt, (r, d))
    # ln_fwd_kernel loads scale and bias in 16-byte vectors: a view off
    # that boundary is copied
    scale, bias = (t if t.data_ptr() % VEC_BYTES == 0 else t.clone()
                   for t in (_f32(scale, "scale", (d,)), _f32(bias, "bias", (d,))))
    y = torch.empty_like(x2d)
    plan = fwd_plan(d, x2d.element_size(), x2d.data_ptr(), y.data_ptr())
    mu = torch.empty((r,), dtype=torch.float32, device=x2d.device)
    rsig = torch.empty_like(mu)
    FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                       y.data_ptr(), mu.data_ptr(), rsig.data_ptr(), r, d,
                                       *plan[:4], int(plan[4]),
                                       cuda.sm_count(x2d.device.index or 0),
                                       cuda.stream_ptr()), fn)
    return y, mu, rsig


def warps_per_row(d: int) -> int:
    """Warps that share a row in the backward: 1 to D = 512, else 2 or 4
    (D <= 2,048; the JAX gate admits D <= 1,638 in bf16, 1,170 in f32)."""
    wpr = 1
    while LANE_COLS * 32 * wpr < d:
        wpr *= 2
    if wpr > 4:
        raise NotImplementedError(f"K17's backward takes D <= 2048, got {d}")
    return wpr


def vec_for(d: int, itemsize: int, *ptrs: int, lane_vectors: int = 32) -> int:
    """Columns a vector: the widest power of two of at most VEC_BYTES that
    divides D and every pointer's alignment and leaves at least
    `lane_vectors` vectors a row. The backward asks 32, one a lane (D =
    384 bf16: 8; D = 64 bf16: 2; D = 261: 1); the forward 1 (D = 64 bf16:
    8)."""
    v = VEC_BYTES // itemsize
    while v > 1 and (d % v or d // v < lane_vectors
                     or any(p % (v * itemsize) for p in ptrs)):
        v //= 2
    return v


def bwd_plan(r: int, d: int, sms: int) -> tuple[int, int, int]:
    """(rows a split, splits, splits a group) of the backward: about one
    block an SM, no more blocks than the rows fill (a row for each of a
    block's row slots); the partials are summed in groups of about
    sqrt(splits) (csrc/layernorm.cu)."""
    slots = BWD_WARPS // warps_per_row(d)
    per = -(-r // min(sms, -(-r // slots)))
    splits = -(-r // per)
    return per, splits, math.isqrt(splits - 1) + 1


def split_rows(r: int, per: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) of each split, as the kernel cuts them."""
    return [(lo, min(r, lo + per)) for lo in range(0, r, per)]


def ln_bwd(x2d, dy2d, mu, rsig, scale):
    """K17's backward kernel on CUDA tensors, the twin on CPU tensors; x
    and dy share the dtype (f32 or bf16)."""
    if not x2d.is_cuda:
        return ln_bwd_plain(x2d, dy2d, mu, rsig, scale.float())
    r, d = x2d.shape
    dt = x2d.dtype
    fn = cuda.entry_point("ln_bwd", dt)
    x2d, dy2d = x2d.contiguous(), dy2d.contiguous()
    cuda.require(x2d, "x", dt, (r, d))
    cuda.require(dy2d, "dy", dt, (r, d))
    mu, rsig = _f32(mu, "mu", (r,)), _f32(rsig, "rsig", (r,))
    scale = _f32(scale, "scale", (d,))
    dev = x2d.device
    per, splits, group = bwd_plan(r, d, cuda.sm_count(dev.index or 0))
    dx = torch.empty_like(x2d)
    f32 = dict(dtype=torch.float32, device=dev)
    ds, db = torch.empty((d,), **f32), torch.empty((d,), **f32)
    part = torch.empty((splits + -(-splits // group), 2, d), **f32)
    vec = vec_for(d, x2d.element_size(), x2d.data_ptr(), dy2d.data_ptr(), dx.data_ptr())
    BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(x2d.data_ptr(), dy2d.data_ptr(), mu.data_ptr(),
                                       rsig.data_ptr(), scale.data_ptr(), dx.data_ptr(),
                                       ds.data_ptr(), db.data_ptr(), part.data_ptr(),
                                       cuda.arrive_counters("ln_bwd", dev), r, d, per, group, vec,
                                       warps_per_row(d), cuda.stream_ptr()), fn)
    return dx, ds, db


class _LayerNormApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias):
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        y, mu, rsig = ln_fwd(x2, scale, bias)
        ctx.save_for_backward(x2, scale, mu, rsig)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, mu, rsig = ctx.saved_tensors
        # the cotangent in x's dtype, as JAX's VJP casts it (:232)
        dx, ds, db = ln_bwd(x2, dy.reshape(x2.shape).to(x2.dtype), mu, rsig, scale)
        return dx.view(ctx.shape), ds.to(scale.dtype), db.to(scale.dtype)


def layernorm_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm over the last axis of x through K17 -> y in x's
    dtype; scale, bias [D] f32. Differentiable in all three."""
    return _LayerNormApply.apply(x, scale, bias)
