"""K11: the Dense backward's weight and bias gradients (counterpart of
ops/pallas/dense.py).

* `dense_grads_plain` / `dense_grads`: x [R, Cin], dy [R, Cout] ->
  (dW f32 [Cin, Cout], db f32 [Cout]), f32-accumulated; `dense_grads`
  launches `csrc/dense.cu` on CUDA tensors and runs the plain twin on CPU
  tensors. The dtype picks the kernel (`cuda.tc_route`): bf16 runs on the
  tensor cores (mma.sync tiles of csrc/mma.cuh, 128 x 128 of dW a block,
  32-row steps through a cp.async ring), f32 on the CUDA cores (64 x 64,
  16-row steps), since a tensor-core f32 product is TF32 and would break
  the f32 gradient bound. `plan_splits` / `split_rows` split the rows
  over blocks for either.
* `dense_grad_enabled`: the port's copy of the JAX package's gate
  (dense.py:127-186), so both packages route the same Dense layers. Under
  tensor parallelism a sharded Dense calls it with its local widths (Cout
  / T for a column-, Cin / T for a row-sharded one), as JAX's gate divides
  them (dense.py:145-159), and K11 takes the local operands: dW comes out
  as the rank's slice, with no model reduction (dense.py:222-252).
* `dense_apply`: the Dense product as a `torch.autograd.Function` whose
  backward takes dW and db from K11, rounded to the compute dtype as the
  JAX custom VJP does (dense.py:259-260); dx stays a plain matmul.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

LAUNCHES = cuda.LaunchCounter()
# None = auto (on the card inside the row window), a bool forces it (the
# JAX package's USE_DENSE_GRAD, dense.py:36)
USE_DENSE_GRAD: bool | None = None
# the JAX gate's row-block budget (dense.py:41) and its measured window
# (dense.py:181-186): the window's rows, and Cin, Cout <= 1024
_VMEM_BUDGET = 8 * 1024 * 1024
MIN_ROWS, MAX_ROWS, MAX_WIDTH = 16384, 131072, 1024
# each route's kernel: (dW rows, dW columns) a block, rows a step
TILES = {torch.float32: (64, 64, 16), torch.bfloat16: (128, 128, 32)}
BLOCKS_PER_SM = 2  # blocks an SM takes in a wave (the bf16 kernel's __launch_bounds__)


def _pick_block_rows(r: int, cin: int, cout: int, itemsize: int) -> int:
    """The JAX package's row-block picker (dense.py:66-73): the largest
    power-of-two block <= 4096 that divides R and double-buffers within
    the budget; 0 if none does (the JAX kernel cannot run then)."""
    br = 4096
    while br >= 128:
        if r % br == 0 and 2 * br * (cin + cout) * itemsize <= _VMEM_BUDGET:
            return br
        br //= 2
    return 0


def dense_grad_enabled(rows: int, cin: int, cout: int, itemsize: int, on_card: bool = True) -> bool:
    """Whether a Dense over `rows` rows takes its (dW, db) from K11: forced
    by USE_DENSE_GRAD (still needing a feasible JAX row blocking), else on
    the card inside the JAX package's window (its TPU-backend check is
    the port's `on_card`)."""
    if USE_DENSE_GRAD is not None:
        return USE_DENSE_GRAD and _pick_block_rows(rows, cin, cout, itemsize) > 0
    if not on_card:
        return False
    return (MIN_ROWS <= rows <= MAX_ROWS and cin <= MAX_WIDTH and cout <= MAX_WIDTH
            and _pick_block_rows(rows, cin, cout, itemsize) > 0)


def dense_grads_plain(x2d: torch.Tensor, dy2d: torch.Tensor):
    """-> (dW f32 [Cin, Cout], db f32 [Cout])."""
    dyf = dy2d.float()
    return x2d.float().t() @ dyf, dyf.sum(0)


def plan_splits(r: int, cin: int, cout: int, dt: torch.dtype, sms: int) -> int:
    """Row splits of dtype `dt`'s kernel on a card of `sms` SMs: as many as
    one wave of blocks holds (BLOCKS_PER_SM an SM over the dW tiles), so
    that no block waits for a second wave, at least one, and at most one a
    row step, so none is empty."""
    tm, tn, step = TILES[dt]
    tiles = -(-cin // tm) * -(-cout // tn)
    return max(1, min(-(-r // step), BLOCKS_PER_SM * sms // tiles))


def split_rows(r: int, splits: int, step: int) -> list[tuple[int, int]]:
    """The rows [begin, end) of each split, as csrc/dense.cu's
    `split_range` cuts them: whole steps, split s of S taking steps
    [s n / S, (s + 1) n / S) of the n = ceil(R / step)."""
    n = -(-r // step)
    return [(s * n // splits * step, min(r, (s + 1) * n // splits * step))
            for s in range(splits)]


def dense_grads(x2d: torch.Tensor, dy2d: torch.Tensor):
    """K11 on CUDA tensors, the plain twin on CPU tensors. Shapes as
    `dense_grads_plain`; x and dy share the dtype (f32 or bf16)."""
    if not x2d.is_cuda:
        return dense_grads_plain(x2d, dy2d)
    r, cin = x2d.shape
    cout = dy2d.shape[1]
    dt = x2d.dtype
    fn = cuda.tc_route("dense_grads", dt)
    x2d, dy2d = x2d.contiguous(), dy2d.contiguous()
    cuda.require(x2d, "x", dt, (r, cin))
    cuda.require(dy2d, "dy", dt, (r, cout))
    # the bf16 kernel copies an operand whose width is a multiple of 8 in
    # 16-byte chunks, any other by plain loads
    xp, dyp = x2d.data_ptr(), dy2d.data_ptr()
    if cin % 8 == 0:
        cuda.require_aligned(fn, x=xp)
    if cout % 8 == 0:
        cuda.require_aligned(fn, dy=dyp)
    splits = plan_splits(r, cin, cout, dt, cuda.sm_count(x2d.device.index))
    f32 = dict(dtype=torch.float32, device=x2d.device)
    dw, db = torch.empty((cin, cout), **f32), torch.empty((cout,), **f32)
    # the split partials of dW, then of db, in one scratch allocation
    part = torch.empty((splits * (cin * cout + cout),), **f32)
    wpart = part.data_ptr()
    bpart = wpart + 4 * splits * cin * cout
    LAUNCHES.n += 1
    cuda.launch(fn, x2d.device, xp, dyp, dw.data_ptr(), db.data_ptr(), wpart, bpart, r, cin, cout,
                splits)
    return dw, db


class _DenseApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        y = x @ w
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw, db = dense_grads(x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1]))
        return dx, dw.to(w.dtype), db.to(w.dtype) if ctx.has_bias else None


def dense_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """y = (x @ w emitted in x's dtype) + b, with x, w [Cin, Cout] and b
    already in the compute dtype: nn.layers.Dense's math, whose backward
    takes (dW, db) from K11."""
    return _DenseApply.apply(x, w, b)
