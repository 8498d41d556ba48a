"""K11: the Dense backward's weight and bias gradients (counterpart of
ops/pallas/dense.py).

* `dense_grads_plain` / `dense_grads`: x [R, Cin], dy [R, Cout] ->
  (dW f32 [Cin, Cout], db f32 [Cout]), f32-accumulated; `dense_grads`
  launches `csrc/dense.cu` on CUDA tensors and runs the plain twin on CPU
  tensors.
* `dense_grad_enabled`: the port's copy of the JAX package's gate
  (dense.py:127-186), so both packages route the same Dense layers.
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
ROW_STEP = 16  # rows per staging step of the CUDA kernel
BLOCKS_PER_SM = 2  # the wrapper splits the rows until about this many blocks per SM


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


def splits_for(r: int, cin: int, cout: int, sms: int) -> int:
    """Row splits of the kernel: enough blocks for BLOCKS_PER_SM per SM,
    whole 16-row steps per split, and no split left empty."""
    tiles = -(-cin // 64) * -(-cout // 64)
    want = max(1, min(-(-r // ROW_STEP), -(-BLOCKS_PER_SM * sms // tiles)))
    per = -(-(-(-r // want)) // ROW_STEP) * ROW_STEP
    return -(-r // per)


def dense_grads(x2d: torch.Tensor, dy2d: torch.Tensor):
    """K11 on CUDA tensors, the plain twin on CPU tensors. Shapes as
    `dense_grads_plain`; x and dy share the dtype (f32 or bf16)."""
    if not x2d.is_cuda:
        return dense_grads_plain(x2d, dy2d)
    r, cin = x2d.shape
    cout = dy2d.shape[1]
    dt = x2d.dtype
    fn = cuda.entry_point("dense_grads", dt)
    x2d, dy2d = x2d.contiguous(), dy2d.contiguous()
    cuda.require(x2d, "x", dt, (r, cin))
    cuda.require(dy2d, "dy", dt, (r, cout))
    splits = splits_for(r, cin, cout,
                        torch.cuda.get_device_properties(x2d.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    dw, db = torch.empty((cin, cout), **f32), torch.empty((cout,), **f32)
    wpart = torch.empty((splits, cin, cout), **f32)
    bpart = torch.empty((splits, cout), **f32)
    LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        x2d.data_ptr(), dy2d.data_ptr(), dw.data_ptr(), db.data_ptr(), wpart.data_ptr(),
        bpart.data_ptr(), r, cin, cout, splits, cuda.stream_ptr()), fn)
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
