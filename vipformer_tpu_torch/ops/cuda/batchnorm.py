"""K18: train-mode BatchNorm's column reductions (counterpart of
ops/pallas/batchnorm.py).

* `bn_stats_plain` / `bn_stats`: x [R, C] -> (sum x, sum x^2), f32 [C].
* `bn_grad_reduces_plain` / `bn_grad_reduces`: (x, dy [R, C], mean, rstd
  f32 [C]) -> (dscale = sum dy * xhat, dbias = sum dy), f32 [C], xhat
  recomputed from the saved statistics.
  The kernel entry points launch `csrc/batchnorm.cu` on CUDA tensors and
  run the plain twin on CPU tensors. The gradient reduces run in one
  launch (one pass, about one block an SM, the split partials summed by
  the last blocks to arrive behind integer counters; `bwd_plan`).
* `bn_train_enabled`: the port's copy of the JAX gate (batchnorm.py:149-
  171): off under auto (the JAX package measured the kernel a net loss on
  its TPU), and when forced, on where the JAX kernel's row blocking is
  feasible.
* `bn_train_apply`: the train-mode BatchNorm core as a
  `torch.autograd.Function` (JAX `bn_train_apply`, :178-295): statistics
  from K18, the normalize and dx as plain elementwise tensor code, as the
  JAX package leaves them to XLA. Under data parallelism (W > 1 ranks) it
  is sync-BN, as JAX's psums over its data axis (:199-215, :247-260):
  K18's raw sums and the row count are all-reduced before the normalise,
  and its (dscale, dbias) before dx, which needs the global sums; the
  gradients returned for scale and bias stay this rank's sums, since the
  step sums the ranks' gradients afterwards (reducing them here too would
  count them W times). One launch of each kernel a call at any W. Under
  tensor parallelism the sums go over the data group (the ranks of one
  model index), whose D = W / T ranks hold disjoint rows.
"""

from __future__ import annotations

import math

import torch

from vipformer_tpu_torch.ops import cuda
from vipformer_tpu_torch.ops.cuda.layernorm import vec_for
from vipformer_tpu_torch.parallel.mesh import all_reduce_, data_axis_size

STATS_LAUNCHES = cuda.LaunchCounter()
GRAD_LAUNCHES = cuda.LaunchCounter()
# None = auto (off, as in JAX batchnorm.py:49,171), a bool forces it
USE_BN_TRAIN: bool | None = None
_VMEM_BUDGET = 8 * 1024 * 1024  # the JAX kernel's row-block budget (:51)
BLOCKS_PER_SM = 8  # the statistics kernel's row splits: about this many blocks per SM
COLS_PER_BLOCK = 64  # columns of one block of the statistics kernel
GRAD_WARPS = 16  # warps of a block of the gradient kernel, each on its own rows


def _pick_block_rows(r: int, c: int, n_inputs: int, itemsize: int) -> int:
    """The JAX package's row-block picker (batchnorm.py:54-60): the largest
    power-of-two block <= 4096 that divides R and double-buffers its
    inputs within the budget; 0 if none does."""
    br = 4096
    while br >= 128:
        if r % br == 0 and 2 * n_inputs * br * c * itemsize <= _VMEM_BUDGET:
            return br
        br //= 2
    return 0


def bn_train_enabled(r: int, c: int, itemsize: int) -> bool:
    """Whether a train-mode BatchNorm over r rows of c channels takes K18:
    only when USE_BN_TRAIN forces it, and then where the JAX kernel's row
    blocking of (x, dy) is feasible."""
    if USE_BN_TRAIN is not None:
        return USE_BN_TRAIN and _pick_block_rows(r, c, 2, itemsize) > 0
    return False


def bn_stats_plain(x2d: torch.Tensor):
    xf = x2d.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_grad_reduces_plain(x2d, dy2d, mean, rstd):
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * rstd
    return (dyf * xhat).sum(0), dyf.sum(0)


def splits_for(r: int, c: int, sms: int) -> int:
    """Row splits of the statistics kernel: about BLOCKS_PER_SM blocks per
    SM over the column tiles, at most one split per 8 rows."""
    tiles = -(-c // COLS_PER_BLOCK)
    return max(1, min(-(-r // 8), -(-BLOCKS_PER_SM * sms // tiles)))


def _operand(t: torch.Tensor, name: str, dt, shape) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load column pairs)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    cuda.require(t, name, dt, shape)
    return t


def bwd_plan(r: int, sms: int) -> tuple[int, int, int]:
    """(rows a split, splits, splits a group) of the gradient kernel: about
    one block an SM, no more blocks than the rows fill (a row for each of a
    block's warps); the partials are summed in groups of about
    sqrt(splits) (csrc/batchnorm.cu grad_kernel)."""
    per = -(-r // min(sms, -(-r // GRAD_WARPS)))
    splits = -(-r // per)
    return per, splits, math.isqrt(splits - 1) + 1


def _scratch(r: int, c: int, device):
    splits = splits_for(r, c, torch.cuda.get_device_properties(device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=device)
    return splits, torch.empty((c,), **f32), torch.empty((c,), **f32), \
        torch.empty((splits, 2, c), **f32)


def bn_stats(x2d: torch.Tensor):
    """K18's statistics kernel on a CUDA tensor, the twin on a CPU tensor."""
    if not x2d.is_cuda:
        return bn_stats_plain(x2d)
    r, c = x2d.shape
    dt = x2d.dtype
    fn = cuda.entry_point("bn_stats", dt)
    x2d = _operand(x2d, "x", dt, (r, c))
    splits, s, ss, part = _scratch(r, c, x2d.device)
    STATS_LAUNCHES.n += 1
    cuda.launch(fn, x2d.device, x2d.data_ptr(), s.data_ptr(), ss.data_ptr(), part.data_ptr(), r, c,
                splits)
    return s, ss


def bn_grad_reduces(x2d, dy2d, mean, rstd):
    """K18's gradient-reduce kernel on CUDA tensors, the twin on CPU
    tensors; x and dy share the dtype (f32 or bf16)."""
    if not x2d.is_cuda:
        return bn_grad_reduces_plain(x2d, dy2d, mean, rstd)
    r, c = x2d.shape
    dt = x2d.dtype
    fn = cuda.entry_point("bn_grad_reduces", dt)
    x2d = _operand(x2d, "x", dt, (r, c))
    dy2d = _operand(dy2d, "dy", dt, (r, c))
    mean = _operand(mean.float(), "mean", torch.float32, (c,))
    rstd = _operand(rstd.float(), "rstd", torch.float32, (c,))
    dev = x2d.device
    per, splits, group = bwd_plan(r, cuda.sm_count(dev.index or 0))
    f32 = dict(dtype=torch.float32, device=dev)
    ds, db = torch.empty((c,), **f32), torch.empty((c,), **f32)
    part = torch.empty((splits + -(-splits // group), 2, c), **f32)
    vec = vec_for(c, x2d.element_size(), x2d.data_ptr(), dy2d.data_ptr())
    GRAD_LAUNCHES.n += 1
    cuda.launch(fn, dev, x2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                ds.data_ptr(), db.data_ptr(), part.data_ptr(),
                cuda.arrive_counters("bn_grad", dev), r, c, per, group, vec)
    return ds, db


class _BnTrainApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        r = x2.shape[0]
        s, ss = bn_stats(x2)
        if data_axis_size() > 1:  # the seam: the global sums and row count
            s, ss, r = _all_reduce(s, ss, torch.full((1,), float(r), device=s.device))
            r = r[0]
        ctx.rows = r
        mean = s / r
        var = torch.clamp_min(ss / r - mean * mean, 0.0)  # the fast variance
        rstd = torch.rsqrt(var + eps)
        # flax's _normalize order, all in f32, cast to x's dtype at the end
        y = ((x.float() - mean) * (rstd * scale.float()) + bias.float()).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        r = ctx.rows
        if dy is None:
            dy = torch.zeros_like(x)
        dscale, dbias = bn_grad_reduces(x2, dy.reshape(-1, c).to(x.dtype), mean, rstd)
        gscale, gbias = dscale, dbias
        if data_axis_size() > 1:  # the seam: dx needs every rank's sums
            zero = torch.zeros_like(dscale)
            gscale, gbias, dmean, dvar = _all_reduce(
                dscale, dbias, zero if dmean is None else dmean.float(),
                zero if dvar is None else dvar.float())
        xc = x.float() - mean
        xhat = xc * rstd
        # the standard BN dx: the per-channel sums factor scale out
        # (JAX batchnorm.py:268-281)
        dx = dy.float() - gbias / r
        dx -= xhat * (gscale / r)
        dx *= scale.float() * rstd
        # the mean/var outputs' cotangents (none in the train steps, where
        # they feed only the running update), exactly as JAX :282-288
        if dmean is not None:
            dx += dmean.float() / r
        if dvar is not None:
            dx += dvar.float() * 2.0 * xc / r
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None


def _all_reduce(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The data group's sums of 1-D f32 tensors, in one all-reduce."""
    flat = all_reduce_(torch.cat(ts))
    return tuple(flat.split([t.numel() for t in ts]))


def bn_train_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BatchNorm over the leading axes of x [..., C] -> (y in
    x's dtype, batch mean f32 [C], biased batch var f32 [C]), differentiable
    in x, scale, bias (and through mean and var)."""
    return _BnTrainApply.apply(x, scale, bias, eps)
