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
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

FWD_LAUNCHES = cuda.LaunchCounter()
BWD_LAUNCHES = cuda.LaunchCounter()
BN_EPS = 1e-5
C1, C2, C3 = 64, 128, 256  # Group2Emb's hidden widths
MAX_CIN = 16
WGRAD_SPLITS = 64  # row splits of the weight-gradient products
COLSUM_BLOCKS = 256  # row blocks of the column-sum partials
# rows of the statistics table [10, C3]
MU0, VAR0, RSTD0, A0, SH0, MU1, VAR1, RSTD1, A1, SH1 = range(10)


def _dense(x, w, b, dt):
    """nn.layers.Dense numerics: f32-accumulated product, rounded to the
    compute dtype, then the bias added in it."""
    return (x.float() @ w.to(dt).float()).to(dt) + b.to(dt)


def _bn_stats(h: torch.Tensor, gamma, beta, n: float):
    """(mean, var, rstd, a, c) of f32 rows h, fast variance clipped at 0."""
    mu = h.sum(0) / n
    var = torch.clamp_min((h * h).sum(0) / n - mu * mu, 0.0)
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
    n = float(r)
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


def g2e_bwd_plain(x0f, wb, h3p, amax, stats, dy, s: int):
    """-> (dx0 [R, Cin] in the compute dtype, 12 f32 parameter gradients)."""
    w0, _, g0, _, w1, _, w2, _, g1, _, w3, _ = wb
    dt = x0f.dtype
    r = x0f.shape[0]
    n = float(r)
    ng, d = dy.shape
    h1p, x1, h2, gmax, xc = _recompute(x0f, wb, stats, s)
    x3 = _affine_relu(h3p, stats[A1], stats[SH1], dt)
    rows = torch.arange(s, device=dy.device)[None, :, None]
    dh4 = torch.where(rows == amax[:, None, :], dy[:, None, :],
                      torch.zeros((), dtype=dy.dtype, device=dy.device))
    dh4 = dh4.to(dt).reshape(r, d).float()
    dw3, db3 = x3.float().t() @ dh4, dh4.sum(0)
    dy3 = torch.where(x3.float() > 0, dh4 @ w3.to(dt).float().t(), 0.0)
    xhat3 = (h3p.float() - stats[MU1]) * stats[RSTD1]
    s1b, s2b = dy3.sum(0), (dy3 * xhat3).sum(0)
    dh3p = (g1.float() * stats[RSTD1] * ((dy3 - s1b / n) - xhat3 * (s2b / n))).to(dt).float()
    dw2, db2 = xc.float().t() @ dh3p, dh3p.sum(0)
    dxc = dh3p @ w2.to(dt).float().t()
    eq = (h2.float() == gmax.float().repeat_interleave(s, dim=0)).float()
    dgmax = dxc[:, :C2].view(r // s, s, C2).sum(1)
    cnt = eq.view(r // s, s, C2).sum(1)
    dh2 = (dxc[:, C2:] + (dgmax / cnt).repeat_interleave(s, dim=0) * eq).to(dt).float()
    dw1, db1 = x1.float().t() @ dh2, dh2.sum(0)
    dy1 = torch.where(x1.float() > 0, dh2 @ w1.to(dt).float().t(), 0.0)
    xhat1 = (h1p.float() - stats[MU0, :C1]) * stats[RSTD0, :C1]
    s1a, s2a = dy1.sum(0), (dy1 * xhat1).sum(0)
    dh1p = (g0.float() * stats[RSTD0, :C1]
            * ((dy1.to(dt).float() - s1a / n) - xhat1 * (s2a / n))).to(dt).float()
    dw0, db0 = x0f.float().t() @ dh1p, dh1p.sum(0)
    dx0 = (dh1p @ w0.to(dt).float().t()).to(dt)
    return dx0, (dw0, db0, s2a, s1a, dw1, db1, dw2, db2, s2b, s1b, dw3, db3)


def _kernel_weights(wb, dt):
    """Weights and biases in the compute dtype, BN scale/shift in f32, all
    contiguous, in chain order."""
    out = []
    for i, t in enumerate(wb):
        bn = i in (2, 3, 8, 9)
        out.append(t.detach().to(torch.float32 if bn else dt).contiguous())
    return out


def _check(x0f, wb, s):
    r, cin = x0f.shape
    d = wb[10].shape[1]
    if s < 1 or r % s:
        raise ValueError(f"g2e kernel needs whole groups: {r} rows, group size {s}")
    if cin > MAX_CIN or tuple(wb[0].shape) != (cin, C1) or tuple(wb[4].shape) != (C1, C2) \
            or tuple(wb[6].shape) != (2 * C2, C3) or wb[10].shape[0] != C3:
        raise ValueError("g2e kernel expects Group2Emb's 64/128/256 widths and Cin <= 16")
    return r, cin, d


def g2e_fwd_kernel(x0f, wb, s: int):
    r, cin, d = _check(x0f, wb, s)
    dt, dev = x0f.dtype, x0f.device
    x0f = x0f.contiguous()
    cuda.require(x0f, "x0", dt, (r, cin))
    w = _kernel_weights(wb, dt)
    out = torch.empty((r // s, d), dtype=dt, device=dev)
    amax = torch.empty((r // s, d), dtype=torch.int32, device=dev)
    h3p = torch.empty((r, C3), dtype=dt, device=dev)
    stats = torch.zeros((10, C3), dtype=torch.float32, device=dev)
    h2 = torch.empty((r, C2), dtype=dt, device=dev)
    gmax = torch.empty((r // s, C2), dtype=dt, device=dev)
    h4 = torch.empty((r, d), dtype=dt, device=dev)
    part = torch.empty((COLSUM_BLOCKS, 2, C3), dtype=torch.float32, device=dev)
    fn = cuda.entry_point("g2e_fwd", dt)
    FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        x0f.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(), amax.data_ptr(),
        h3p.data_ptr(), stats.data_ptr(), h2.data_ptr(), gmax.data_ptr(), h4.data_ptr(),
        part.data_ptr(), r, s, cin, d, COLSUM_BLOCKS, cuda.stream_ptr()), fn)
    return out, h3p, amax, stats


def g2e_bwd_kernel(x0f, wb, h3p, amax, stats, dy, s: int):
    r, cin, d = _check(x0f, wb, s)
    dt, dev = x0f.dtype, x0f.device
    x0f, dy = x0f.contiguous(), dy.contiguous()
    cuda.require(dy, "dy", dt, (r // s, d))
    cuda.require(h3p, "h3p", dt, (r, C3))
    cuda.require(amax, "amax", torch.int32, (r // s, d))
    cuda.require(stats, "stats", torch.float32, (10, C3))
    w0, b0, g0, _, w1, b1, w2, b2, g1, _, w3, _ = _kernel_weights(wb, dt)
    f32 = dict(dtype=torch.float32, device=dev)
    dx0 = torch.empty_like(x0f)
    grads = [torch.empty(tuple(t.shape), **f32) for t in wb]
    work = dict(
        dh4=torch.empty((r, d), dtype=dt, device=dev), dy3=torch.empty((r, C3), **f32),
        h2=torch.empty((r, C2), dtype=dt, device=dev),
        gmax=torch.empty((r // s, C2), dtype=dt, device=dev),
        dh3p=torch.empty((r, C3), dtype=dt, device=dev), dxc=torch.empty((r, C3), **f32),
        dh2=torch.empty((r, C2), dtype=dt, device=dev), dy1=torch.empty((r, C1), **f32),
        dh1p=torch.empty((r, C1), dtype=dt, device=dev),
        # column partials of the widest column sum: db3 over D columns
        # (D = 384 at the segmentation widths), the BatchNorm sums over C3
        part=torch.empty((COLSUM_BLOCKS, 2, max(C3, d)), **f32),
        wpart=torch.empty((WGRAD_SPLITS, C3 * max(C3, d)), **f32),
    )
    fn = cuda.entry_point("g2e_bwd", dt)
    BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        x0f.data_ptr(), w0.data_ptr(), b0.data_ptr(), g0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g1.data_ptr(), w3.data_ptr(),
        h3p.data_ptr(), amax.data_ptr(), stats.data_ptr(), dy.data_ptr(), dx0.data_ptr(),
        *(t.data_ptr() for t in grads), *(t.data_ptr() for t in work.values()),
        r, s, cin, d, COLSUM_BLOCKS, WGRAD_SPLITS, cuda.stream_ptr()), fn)
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
