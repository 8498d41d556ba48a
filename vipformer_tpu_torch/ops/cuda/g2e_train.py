"""K9: train-mode Group2Emb, forward and backward (counterpart of
ops/pallas/g2e_train.py).

`g2e_train_apply(x0, wb, s)` runs the mini-PointNet with batch-statistics
BatchNorm over the neighbour patches x0 [B, G, S, Cin] and returns
(out [B, G, D], (mu0, var0, mu1, var1)); the statistics are the f32 batch
mean and biased variance for the running-average update, which the module
applies outside the kernel (nn/pointnet.py). `wb` is the 12-tuple of f32
parameters in chain order, weights as [in, out]:
(w0, b0, gamma0, beta0, w1, b1, w2, b2, gamma1, beta1, w3, b3).

A `torch.autograd.Function` launches `csrc/g2e_train.cu` on CUDA tensors
and runs the plain twins below on CPU tensors; both follow the Pallas
kernel's numerics (Dense rounded to the compute dtype before its bias,
f32 BatchNorm statistics of the rounded activations, first-argmax routing
of the final max pool, equal tie split of the h2 global pool). Between
forward and backward only h3p, the argmax and the statistics are kept.

The dtype picks the kernels (`cuda.tc_route`): bf16 runs the passes on the
tensor cores over row tiles of whole groups (`tile_plan`: 128 rows hold
floor(128 / S) groups, so S <= 128), persistent blocks on `grids`, with no
h4, dh4 or f32 [R, .] array in device memory (`bwd_workspace`), at any D:
the final Dense's columns are padded with zeros to a multiple of 64
(`tc_width`), which changes no output; f32 runs the CUDA-core kernels,
since a tensor-core f32 product is TF32.

Under data parallelism (a process group of W > 1 ranks, `parallel/`) it is
sync-BN, as the JAX kernel psums over its data axis (g2e_train.py:409-411,
:448-450, :536-543, :602-608): the forward's two BatchNorms take their
statistics from the ranks' all-reduced column sums over the global row
count, and the backward's two BatchNorm backwards take the all-reduced
(sum dy, sum dy xhat) for dh; the gradients returned for the BatchNorm
scales and shifts stay this rank's sums, since the step sums the ranks'
gradients afterwards. The kernels and the twins split at the same seams:
a kernel call then runs in three launches of its entry point (`stage` 1-3,
csrc/g2e_train.cu `seam`), with an all-reduce between them; at W = 1 one
launch (`stage` 0) runs the whole pass as before. A call counts one launch
in either case. Under tensor parallelism the seams go over the data group
(the D = W / T ranks of one model index); the stem is replicated on the
model ranks of a data index, which run it on the same rows.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.parallel.mesh import all_reduce_, data_axis_size

FWD_LAUNCHES = cuda.LaunchCounter()
BWD_LAUNCHES = cuda.LaunchCounter()
BN_EPS = 1e-5
C1, C2, C3 = 64, 128, 256  # Group2Emb's hidden widths
MAX_CIN = 16
WGRAD_SPLITS = 64  # row splits of the weight-gradient products
COLSUM_BLOCKS = 256  # row blocks of the column-sum partials
DB3_BLOCKS = 32  # row blocks of the bf16 backward's db3 (column sums of dy over the groups)
# rows of the statistics table [10, C3]
MU0, VAR0, RSTD0, A0, SH0, MU1, VAR1, RSTD1, A1, SH1 = range(10)
# the bf16 kernels' row tile (whole groups), the multiple of 64 they take D
# in, F3's column slices and P1's chunks of D (csrc/g2e_train.cu)
TILE_ROWS = 128
TC_COLS = 64
OUT_COLS = (256, 192, 128, 64)
DY3_COLS = 384


def tile_plan(r: int, s: int) -> tuple[int, int]:
    """(rows of a tile, tiles) of the bf16 kernels, as csrc/g2e_train.cu
    `tile_at` cuts them: floor(128 / S) whole groups a tile, the last tile
    holding what is left."""
    rows = TILE_ROWS // s * s
    return rows, -(-r // rows)


def tc_width(d: int) -> int:
    """The width the bf16 kernels take the final Dense at: D padded with
    zero columns to a multiple of 64."""
    return -(-d // TC_COLS) * TC_COLS


def out_cols(d: int) -> int:
    """F3's column slice of the padded width d: the widest of 256, 192,
    128 and 64 that divides it."""
    return next(n for n in OUT_COLS if d % n == 0)


def _pad_cols(t: torch.Tensor, d: int) -> torch.Tensor:
    """t with its last dimension padded by zeros to d."""
    return torch.nn.functional.pad(t, (0, d - t.shape[-1])) if t.shape[-1] != d else t


def grids(r: int, s: int, d: int, sms: int) -> dict[str, int]:
    """The persistent grids of the bf16 kernels on a card of `sms` SMs (one
    block an SM) at output width d: F2 and P2's second half ("mid") one
    block a tile up to a wave; F3 ("out") and P1 / P2's first half ("dy3")
    a whole number of blocks for each column slice (tc_width(d) / N of
    them, and 2), block b taking slice b % slices and every (grid /
    slices)-th tile."""
    _, tiles = tile_plan(r, s)
    d = tc_width(d)
    slices = d // out_cols(d)
    return {"mid": min(tiles, sms),
            "out": slices * min(tiles, max(1, sms // slices)),
            "dy3": 2 * min(tiles, max(1, sms // 2))}


def wgrad_splits(r: int, d: int, sms: int) -> tuple[int, int, int]:
    """Row splits of the bf16 weight gradients dW3 [256, tc_width(D)], dW2
    [256, 256] and dW1 [64, 128]: K11's plan (one wave of 128 x 128
    tiles)."""
    return tuple(kdense.plan_splits(r, ci, co, torch.bfloat16, sms)
                 for ci, co in ((C3, tc_width(d)), (C3, C3), (C1, C2)))


def bwd_workspace(r: int, s: int, cin: int, d: int, dt: torch.dtype, dev, sms: int) -> dict:
    """The backward's scratch, by name, in the order the entry point takes
    it. bf16: the bf16 operands the weight gradients read (x1, xc, dh3p,
    dh2) and dy1, each group's sum of dh3p (f32, R / S rows), then the
    column partials (f64: P1's and P2's sums are f64) and the split
    partials; no h4, dh4, dy3 or dxc, and nothing in f32 of R rows. f32:
    the CUDA-core passes' intermediates."""
    f32 = dict(dtype=torch.float32, device=dev)
    act = dict(dtype=dt, device=dev)
    if dt == torch.bfloat16:
        g = grids(r, s, d, sms)
        s3, s2, s1 = wgrad_splits(r, d, sms)
        d = tc_width(d)
        wsize = max(COLSUM_BLOCKS * (cin * C1 + C1), s3 * (C3 * d + d), s2 * (C3 * C3 + C3),
                    s1 * (C1 * C2 + C2))
        return dict(x1=torch.empty((r, C1), **act), xc=torch.empty((r, C3), **act),
                    dh3p=torch.empty((r, C3), **act), dh2=torch.empty((r, C2), **act),
                    dy1=torch.empty((r, C1), **act),
                    # each group's sum of dh3p (P2's first half -> second half)
                    gsum=torch.empty((r // s, C3), **f32),
                    # P1's and P2's column partials over 256 columns (f64),
                    # db3's over D (DB3_BLOCKS blocks)
                    part=torch.empty((max(g["dy3"] // 2, g["mid"], DB3_BLOCKS), 2, max(C3, d)),
                                     dtype=torch.float64, device=dev),
                    wpart=torch.empty((wsize,), **f32))
    return dict(
        dh4=torch.empty((r, d), **act), dy3=torch.empty((r, C3), **f32),
        h2=torch.empty((r, C2), **act), gmax=torch.empty((r // s, C2), **act),
        dh3p=torch.empty((r, C3), **act), dxc=torch.empty((r, C3), **f32),
        dh2=torch.empty((r, C2), **act), dy1=torch.empty((r, C1), **f32),
        dh1p=torch.empty((r, C1), **act),
        # column partials of the widest column sum: db3 over D columns
        # (D = 384 at the segmentation widths), the BatchNorm sums over C3
        part=torch.empty((COLSUM_BLOCKS, 2, max(C3, d)), **f32),
        wpart=torch.empty((WGRAD_SPLITS, C3 * max(C3, d)), **f32),
    )


def _dense(x, w, b, dt):
    """nn.layers.Dense numerics: f32-accumulated product, rounded to the
    compute dtype, then the bias added in it."""
    return (x.float() @ w.to(dt).float()).to(dt) + b.to(dt)


def _global_rows(r: int) -> float:
    """The rows of every rank's call over the data group: its ranks hold
    equal shards of the global batch (parallel/sharding.py), so D r (the
    model ranks of one data index hold the same rows, not more)."""
    return float(r * data_axis_size())


def _seam(*ts: torch.Tensor) -> torch.Tensor:
    """The BatchNorm seam: the data group's sums of the column sums `ts`,
    stacked [len(ts), C], in one all-reduce (their stack itself at D = 1)."""
    out = torch.stack(ts)
    if data_axis_size() > 1:
        all_reduce_(out)
    return out


def _bn_stats(h: torch.Tensor, gamma, beta, n: float):
    """(mean, var, rstd, a, c) of f32 rows h, fast variance clipped at 0,
    over the n rows of every rank (the sums all-reduced at the seam)."""
    s, ss = _seam(h.sum(0), (h * h).sum(0))
    mu = s / n
    var = torch.clamp_min(ss / n - mu * mu, 0.0)
    rstd = torch.rsqrt(var + BN_EPS)
    a = gamma.float() * rstd
    return mu, var, rstd, a, beta.float() - mu * a


def _affine_relu(h: torch.Tensor, a, c, dt):
    return torch.relu((h.float() * a + c).to(dt))


def _stats_table(bn0, bn1) -> torch.Tensor:
    table = torch.zeros((10, C3), dtype=torch.float32, device=bn1[0].device)
    for i, v in enumerate(bn0):
        table[i, :C1] = v
    for i, v in enumerate(bn1):
        table[5 + i] = v
    return table


def _recompute(x0f, wb, stats, s):
    """x1, h2, gmax, xc (rows [R, .]) from x0 and the BN0 statistics."""
    w0, b0, _, _, w1, b1 = wb[:6]
    dt = x0f.dtype
    r = x0f.shape[0]
    h1p = _dense(x0f, w0, b0, dt)
    x1 = _affine_relu(h1p, stats[A0, :C1], stats[SH0, :C1], dt)
    h2 = _dense(x1, w1, b1, dt)
    gmax = h2.view(r // s, s, C2).amax(dim=1)
    xc = torch.cat([gmax.repeat_interleave(s, dim=0), h2], dim=-1)
    return h1p, x1, h2, gmax, xc


def g2e_fwd_plain(x0f, wb, s: int):
    """x0f [R, Cin] in the compute dtype -> (out [R/S, D], h3p [R, 256],
    amax int32 [R/S, D], stats f32 [10, 256])."""
    _, _, g0, be0, _, _, w2, b2, g1, be1, w3, b3 = wb
    dt = x0f.dtype
    r = x0f.shape[0]
    n = _global_rows(r)
    h1p = _dense(x0f, wb[0], wb[1], dt)
    bn0 = _bn_stats(h1p.float(), g0, be0, n)
    table = _stats_table(bn0, [torch.zeros(C3, device=x0f.device)] * 5)
    _, _, _, _, xc = _recompute(x0f, wb, table, s)
    h3p = _dense(xc, w2, b2, dt)
    bn1 = _bn_stats(h3p.float(), g1, be1, n)
    stats = _stats_table(bn0, bn1)
    x3 = _affine_relu(h3p, stats[A1], stats[SH1], dt)
    h4 = _dense(x3, w3, b3, dt).view(r // s, s, -1)
    out = h4.amax(dim=1)
    amax = (h4 == out[:, None, :]).to(torch.int32).argmax(dim=1).to(torch.int32)
    return out, h3p, amax, stats


def g2e_bwd_plain(x0f, wb, h3p, amax, stats, dy, s: int, acc: torch.dtype = torch.float32,
                  rss: bool = False):
    """-> (dx0 [R, Cin] in the compute dtype, 12 f32 parameter gradients).
    The backward's arithmetic runs in `acc` between the compute dtype's
    rounding points (f32, as the Pallas kernel; the card tests also take
    f64, a reference whose own arithmetic error is far below the bounds).
    With `rss`, also each column's root sum of squares of the rows summed
    into the exactly-zero gradients of b0, b1 and b2 (dh1p, dh2, dh3p):
    the scale of the rounding noise the card tests hold those sums to."""
    w0, _, g0, _, w1, _, w2, _, g1, _, w3, _ = wb
    dt = x0f.dtype
    r = x0f.shape[0]
    n = _global_rows(r)
    ng, d = dy.shape
    h1p, x1, h2, gmax, xc = _recompute(x0f, wb, stats, s)
    x3 = _affine_relu(h3p, stats[A1], stats[SH1], dt)
    st = stats.to(acc)
    rows = torch.arange(s, device=dy.device)[None, :, None]
    dh4 = torch.where(rows == amax[:, None, :], dy[:, None, :],
                      torch.zeros((), dtype=dy.dtype, device=dy.device))
    dh4 = dh4.to(dt).reshape(r, d).to(acc)
    dw3, db3 = x3.to(acc).t() @ dh4, dh4.sum(0)
    dy3 = torch.where(x3 > 0, dh4 @ w3.to(dt).to(acc).t(), 0.0)
    xhat3 = (h3p.to(acc) - st[MU1]) * st[RSTD1]
    s1b, s2b = dy3.sum(0), (dy3 * xhat3).sum(0)  # this rank's; the seam's for dh3p
    t1b, t2b = _seam(s1b, s2b)
    dh3p = (g1.to(acc) * st[RSTD1] * ((dy3 - t1b / n) - xhat3 * (t2b / n))).to(dt).to(acc)
    dw2, db2 = xc.to(acc).t() @ dh3p, dh3p.sum(0)
    dxc = dh3p @ w2.to(dt).to(acc).t()
    eq = (h2 == gmax.repeat_interleave(s, dim=0)).to(acc)
    dgmax = dxc[:, :C2].view(r // s, s, C2).sum(1)
    cnt = eq.view(r // s, s, C2).sum(1)
    dh2 = (dxc[:, C2:] + (dgmax / cnt).repeat_interleave(s, dim=0) * eq).to(dt).to(acc)
    dw1, db1 = x1.to(acc).t() @ dh2, dh2.sum(0)
    dy1 = torch.where(x1 > 0, dh2 @ w1.to(dt).to(acc).t(), 0.0)
    xhat1 = (h1p.to(acc) - st[MU0, :C1]) * st[RSTD0, :C1]
    s1a, s2a = dy1.sum(0), (dy1 * xhat1).sum(0)
    t1a, t2a = _seam(s1a, s2a)
    dh1p = (g0.to(acc) * st[RSTD0, :C1]
            * ((dy1.to(dt).to(acc) - t1a / n) - xhat1 * (t2a / n))).to(dt).to(acc)
    dw0, db0 = x0f.to(acc).t() @ dh1p, dh1p.sum(0)
    dx0 = (dh1p @ w0.to(dt).to(acc).t()).to(dt)
    grads = (dw0, db0, s2a, s1a, dw1, db1, dw2, db2, s2b, s1b, dw3, db3)
    if rss:
        return dx0, tuple(t.float() for t in grads), tuple(
            t.square().sum(0).sqrt().float() for t in (dh1p, dh2, dh3p))
    return dx0, tuple(t.float() for t in grads)


def h2_pool(x0f, wb, stats, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The twin's h2 [R, 128] and its group max [R / S, 128] (the global
    pool whose ties split dxc's gmax half), from x0 and BN0's statistics."""
    _, _, h2, gmax, _ = _recompute(x0f, wb, stats, s)
    return h2, gmax


def kernel_h2_pool(work: dict, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernels' h2 and group max, as their backward wrote them to
    its workspace (xc = [gmax | h2], bf16)."""
    xc = work["xc"]
    return xc[:, C2:], xc[::s, :C2]


def tie_flips(h2_a, gmax_a, h2_b, gmax_b, s: int) -> tuple[int, float]:
    """Where two computations of h2 (a kernel's and the twin's) disagree on
    the tie set h2 == gmax of a (group, column), the backward's tie split
    sends that column's gradient to other rows. Returns the number of such
    (group, column) pairs and the largest gap, in bf16 ulps of the group
    max, between a side's max and its h2 at a row that ties on one side
    only: at most 1 where a flip is a true near-tie (the two competing h2
    values one rounding apart); 0.0 when no tie set differs."""
    r, c = h2_a.shape
    ha, hb = (h.float().view(r // s, s, c) for h in (h2_a, h2_b))
    ga, gb = gmax_a.float()[:, None, :], gmax_b.float()[:, None, :]
    diff = (ha == ga) != (hb == gb)
    flipped = diff.any(dim=1)
    if not bool(flipped.any()):
        return 0, 0.0
    gap = torch.where(diff, torch.maximum(ga - ha, gb - hb), 0.0).amax(dim=1)
    _, e = torch.frexp(torch.maximum(ga.abs(), gb.abs())[:, 0, :])
    ulp = torch.ldexp(torch.ones_like(gap), e - 8)  # bf16: 8 significant bits
    return int(flipped.sum()), float((gap / ulp)[flipped].max())


def _kernel_weights(wb, dt):
    """Weights and biases in the compute dtype, BN scale/shift in f32, all
    contiguous, in chain order."""
    out = []
    for i, t in enumerate(wb):
        bn = i in (2, 3, 8, 9)
        out.append(t.detach().to(torch.float32 if bn else dt).contiguous())
    return out


def _check(x0f, wb, s):
    """(R, Cin, D) of a launch; raises ValueError on what the kernels do
    not take, before any launch."""
    r, cin = x0f.shape
    d = wb[10].shape[1]
    if s < 1 or r % s:
        raise ValueError(f"g2e kernel needs whole groups: {r} rows, group size {s}")
    if cin > MAX_CIN or tuple(wb[0].shape) != (cin, C1) or tuple(wb[4].shape) != (C1, C2) \
            or tuple(wb[6].shape) != (2 * C2, C3) or wb[10].shape[0] != C3:
        raise ValueError("g2e kernel expects Group2Emb's 64/128/256 widths and Cin <= 16")
    if x0f.dtype == torch.bfloat16 and s > TILE_ROWS:
        raise ValueError(f"the bf16 g2e kernels hold whole groups of at most {TILE_ROWS} "
                         f"rows in a tile, got group size {s}")
    return r, cin, d


def g2e_fwd_kernel(x0f, wb, s: int):
    r, cin, d = _check(x0f, wb, s)
    dt, dev = x0f.dtype, x0f.device
    x0f = x0f.contiguous()
    cuda.require(x0f, "x0", dt, (r, cin))
    fn = cuda.tc_route("g2e_fwd", dt)
    w = _kernel_weights(wb, dt)
    dk = tc_width(d) if dt == torch.bfloat16 else d
    w[10], w[11] = _pad_cols(w[10], dk), _pad_cols(w[11], dk)
    out = torch.empty((r // s, dk), dtype=dt, device=dev)
    amax = torch.empty((r // s, dk), dtype=torch.int32, device=dev)
    h3p = torch.empty((r, C3), dtype=dt, device=dev)
    stats = torch.zeros((10, C3), dtype=torch.float32, device=dev)
    if dt == torch.bfloat16:
        g = grids(r, s, d, cuda.sm_count(dev.index))
        part = torch.empty((max(COLSUM_BLOCKS, g["mid"]), 2, C3), dtype=torch.float32,
                           device=dev)
        args = (out, amax, h3p, stats, part)
        sizes = (r, s, cin, dk, COLSUM_BLOCKS, g["mid"], g["out"])
    else:
        h2 = torch.empty((r, C2), dtype=dt, device=dev)
        gmax = torch.empty((r // s, C2), dtype=dt, device=dev)
        h4 = torch.empty((r, d), dtype=dt, device=dev)
        part = torch.empty((COLSUM_BLOCKS, 2, C3), dtype=torch.float32, device=dev)
        args = (out, amax, h3p, stats, h2, gmax, h4, part)
        sizes = (r, s, cin, d, COLSUM_BLOCKS)
    FWD_LAUNCHES.n += 1
    ptrs = (x0f.data_ptr(), *(t.data_ptr() for t in w), *(t.data_ptr() for t in args), *sizes)
    if data_axis_size() == 1:
        cuda.launch(fn, dev, *ptrs, None, float(r), 0)
    else:  # three launches, the seams' sums all-reduced between them
        # stage 1 writes BN0's sums [2, 64]; stage 2 reads them (its first
        # launch) and writes BN1's [2, 256] over them; stage 3 reads those
        n = _global_rows(r)
        sums = torch.empty((2 * C3,), dtype=torch.float32, device=dev)
        cuda.launch(fn, dev, *ptrs, sums.data_ptr(), n, 1)
        all_reduce_(sums[:2 * C1])
        cuda.launch(fn, dev, *ptrs, sums.data_ptr(), n, 2)
        all_reduce_(sums)
        cuda.launch(fn, dev, *ptrs, sums.data_ptr(), n, 3)
    if dk != d:
        out, amax = out[:, :d].contiguous(), amax[:, :d].contiguous()
    return out, h3p, amax, stats


def g2e_bwd_kernel(x0f, wb, h3p, amax, stats, dy, s: int, work: dict | None = None):
    """The backward on CUDA tensors. `work` is the scratch to use, as
    `bwd_workspace` makes it (made here when None): a caller that passes
    it can read what the bf16 passes wrote there (x1, xc = [gmax | h2],
    dh3p, dh2, dy1; `kernel_h2_pool`)."""
    r, cin, d = _check(x0f, wb, s)
    dt, dev = x0f.dtype, x0f.device
    x0f, dy = x0f.contiguous(), dy.contiguous()
    cuda.require(dy, "dy", dt, (r // s, d))
    cuda.require(h3p, "h3p", dt, (r, C3))
    cuda.require(amax, "amax", torch.int32, (r // s, d))
    cuda.require(stats, "stats", torch.float32, (10, C3))
    fn = cuda.tc_route("g2e_bwd", dt)
    w0, b0, g0, _, w1, b1, w2, b2, g1, _, w3, _ = _kernel_weights(wb, dt)
    dx0 = torch.empty_like(x0f)
    dk = tc_width(d) if dt == torch.bfloat16 else d
    # the padded columns: zero weights, zero dy (their argmax 0 is never used)
    w3, dy, amax = _pad_cols(w3, dk), _pad_cols(dy, dk), _pad_cols(amax, dk)
    shapes = [tuple(t.shape) for t in wb[:10]] + [(C3, dk), (dk,)]
    grads = [torch.empty(sh, dtype=torch.float32, device=dev) for sh in shapes]
    sms = cuda.sm_count(dev.index)
    if work is None:
        work = bwd_workspace(r, s, cin, d, dt, dev, sms)
    if dt == torch.bfloat16:
        # the weight gradients' loaders read h3p, amax and dy 16 bytes at a time
        cuda.require_aligned(fn, h3p=h3p.data_ptr(), amax=amax.data_ptr(), dy=dy.data_ptr())
        weights = (w0, b0, g0, w1, b1, w2, g1, w3)
        g = grids(r, s, d, sms)
        sizes = (r, s, cin, dk, COLSUM_BLOCKS, g["mid"], g["dy3"], *wgrad_splits(r, d, sms))
    else:
        weights = (w0, b0, g0, w1, b1, w2, b2, g1, w3)
        sizes = (r, s, cin, d, COLSUM_BLOCKS, WGRAD_SPLITS)
    BWD_LAUNCHES.n += 1
    ptrs = (x0f.data_ptr(), *(t.data_ptr() for t in weights), h3p.data_ptr(), amax.data_ptr(),
            stats.data_ptr(), dy.data_ptr(), dx0.data_ptr(), *(t.data_ptr() for t in grads),
            *(t.data_ptr() for t in work.values()), *sizes)
    if data_axis_size() == 1:
        cuda.launch(fn, dev, *ptrs, None, float(r), 0)
    else:  # three launches; dh takes the seams' all-reduced (sum dy, sum dy xhat)
        n = _global_rows(r)
        cuda.launch(fn, dev, *ptrs, None, n, 1)  # this rank's dbeta1, dgamma1
        sums = _seam(grads[9], grads[8])
        cuda.launch(fn, dev, *ptrs, sums.data_ptr(), n, 2)  # this rank's dbeta0, dgamma0
        sums = _seam(grads[3], grads[2])
        cuda.launch(fn, dev, *ptrs, sums.data_ptr(), n, 3)
    if dk != d:
        grads[10], grads[11] = grads[10][:, :d].contiguous(), grads[11][:d].contiguous()
    return dx0, tuple(grads)


class _G2ETrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, s, *wb):
        x0f = x0.reshape(-1, x0.shape[-1])
        fwd = g2e_fwd_kernel if x0.is_cuda else g2e_fwd_plain
        out, h3p, amax, stats = fwd(x0f, wb, s)
        ctx.save_for_backward(x0f, h3p, amax, stats, *wb)
        ctx.s, ctx.x0_shape = s, x0.shape
        mu0, var0 = stats[MU0, :C1].clone(), stats[VAR0, :C1].clone()
        mu1, var1 = stats[MU1].clone(), stats[VAR1].clone()
        ctx.mark_non_differentiable(mu0, var0, mu1, var1)
        b, g = x0.shape[0], x0.shape[1]
        return out.reshape(b, g, -1), mu0, var0, mu1, var1

    @staticmethod
    def backward(ctx, dout, *_):
        x0f, h3p, amax, stats, *wb = ctx.saved_tensors
        dy = dout.reshape(-1, dout.shape[-1]).to(x0f.dtype)
        bwd = g2e_bwd_kernel if x0f.is_cuda else g2e_bwd_plain
        dx0, grads = bwd(x0f, wb, h3p, amax, stats, dy, ctx.s)
        return (dx0.reshape(ctx.x0_shape), None,
                *(gr.to(w.dtype) for gr, w in zip(grads, wb)))


def g2e_train_apply(x0: torch.Tensor, wb, s: int):
    """Fused train-mode Group2Emb: x0 [B, G, S, Cin] in the compute dtype,
    wb the 12 f32 parameters -> (out [B, G, D], (mu0, var0, mu1, var1))."""
    out, mu0, var0, mu1, var1 = _G2ETrain.apply(x0, s, *wb)
    return out, (mu0, var0, mu1, var1)
