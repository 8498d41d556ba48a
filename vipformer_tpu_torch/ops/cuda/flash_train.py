"""K8 and K7: training attention with in-kernel dropout, forward and
backward (counterpart of ops/pallas/flash_train.py).

* `flash_attention_train` (K8): packed q [B, G, H*dh], k/v [B, M, H*dh].
* `flash_attention_train_kv` (K7): the same with the kv LayerNorm and the
  bias-free k/v projections folded in: q [B, G, H*dh], raw x [B, M, Din],
  LN scale/bias f32 [Din], wk/wv [Din, H*dh]; gradients flow to all six.

Each is a `torch.autograd.Function` whose forward and backward launch
`csrc/flash_train.cu` on CUDA tensors and run the plain twins below on CPU
tensors. Semantics are torch's softmax -> dropout -> @V with the softmax
denominator over the undropped p; the forward keeps only the per-row
logsumexp, the backward recomputes p and regenerates the dropout mask.

K8's forward and backward and K7's forward and backward pick their
kernels by dtype (`cuda.tc_route`): bf16 runs on the tensor cores
(mma.sync, csrc/mma.cuh), f32 on the CUDA cores. In bf16, K7's LayerNorm-
folded k|v projection (`kv_project_kernel` runs it alone), its backward's
attention (K8's tensor-core backward, bf16 dk, dv), dx through the
projections and the weight gradients run on the tensor cores; its forward
attention, the LayerNorm backward and its column sums on the CUDA cores.

Dropout: the keep bit of (cloud b, head h, query g, key m) is a pure
function of (seed, b*H + h, g, m) through a 32-bit integer hash, and kept
values are scaled by 1/(1-rate). `keep_mask_plain` computes the same bits
with int64 tensor ops, so the kernel and the twin drop the same elements.
The seed is an int32 tensor [1] on the operands' device, so drawing it
from a generator needs no host synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch

from vipformer_tpu_torch.ops import cuda
from vipformer_tpu_torch.ops.cuda import dense

FWD_LAUNCHES = cuda.LaunchCounter()
BWD_LAUNCHES = cuda.LaunchCounter()
KV_FWD_LAUNCHES = cuda.LaunchCounter()
KV_BWD_LAUNCHES = cuda.LaunchCounter()
KERNEL_HEAD_DIM = 64  # head width the CUDA kernels are built for
WGRAD_SPLITS = 64  # token-axis splits of K7's f32 weight-gradient product
COLSUM_BLOCKS = 256  # row blocks of the column-sum partials
# K7's bf16 products (csrc/flash_train.cu tc) take the contraction in
# stages of 32 columns (Din, 2D) or token rows (dW)
KV_TC_STEP = 32
_M32 = 0xFFFFFFFF
_MIX = 0x045D9F3B


def dropout_threshold(rate: float) -> int:
    """keep = bits >= threshold, bits uniform over [0, 2^32)."""
    return min(int(round(rate * 2.0**32)), _M32)


def keep_scale(rate: float) -> float:
    """1 - rate as the f32 value the kernels divide by."""
    return float(np.float32(1.0 - rate))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' 32-bit hash on int64 tensors holding uint32 values
    (products stay below 2^59, so nothing overflows)."""
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    return x ^ (x >> 16)


def keep_mask_plain(seed: torch.Tensor, bh: int, g: int, m: int, rate: float) -> torch.Tensor:
    """bool [bh, g, m]: keep bit of (b*H + h, query row, key column)."""
    dev = seed.device
    s = _mix32(seed.to(torch.int64).reshape(1) & _M32)
    k1 = _mix32((torch.arange(bh, device=dev) + s) & _M32)  # [bh]
    rk = _mix32((torch.arange(g, device=dev)[None, :] + k1[:, None]) & _M32)  # [bh, g]
    bits = _mix32((torch.arange(m, device=dev)[None, None, :] + rk[..., None]) & _M32)
    return bits >= dropout_threshold(rate)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, H*dh] -> [B, H, N, dh] in f32."""
    b, n, d = x.shape
    return x.view(b, n, h, d // h).transpose(1, 2).float()


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H*dh]."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def _dropped(p, seed, rate):
    """p [B, H, G, M] with the dropout mask applied and kept values / (1-rate)."""
    if rate == 0.0:
        return p
    b, h, g, m = p.shape
    keep = keep_mask_plain(seed, b * h, g, m, rate).view(b, h, g, m)
    return torch.where(keep, p / keep_scale(rate), torch.zeros_like(p))


def attention_fwd_plain(q, k, v, seed, num_heads: int, scale: float, rate: float):
    """-> (out [B, G, H*dh] in v's dtype, lse f32 [B, H, G])."""
    dt = v.dtype
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) * scale
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    lse = (mx + torch.log(l)).squeeze(-1)
    pd = _dropped(p, seed, rate).to(dt).float()
    o = (pd @ _heads(v, num_heads)) / l
    return _merge(o).to(dt), lse


def attention_delta(dout: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, f32 [B, H, G] (computed outside the
    kernels, as the JAX package computes it outside its Pallas call)."""
    b, g, d = out.shape
    prod = dout.float() * out.float()
    return prod.view(b, g, num_heads, d // num_heads).sum(-1).transpose(1, 2).contiguous()


def attention_bwd_plain(q, k, v, dout, lse, delta, seed, num_heads: int, scale: float,
                        rate: float, kv_dtype=None):
    """-> (dq in q's dtype, dk, dv in `kv_dtype` (default k's dtype))."""
    h = num_heads
    qh, kh, vh, doh = _heads(q, h), _heads(k, h), _heads(v, h), _heads(dout, h)
    s = (qh @ kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    pd = _dropped(p, seed, rate)
    dv = pd.transpose(-1, -2) @ doh
    dpd = doh @ vh.transpose(-1, -2)
    ds = (pd * dpd - p * delta[..., None]) * scale
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    kv_dtype = kv_dtype or k.dtype
    return _merge(dq).to(q.dtype), _merge(dk).to(kv_dtype), _merge(dv).to(kv_dtype)


def ln_kv_plain(x, ln_w, ln_b):
    """K7's LayerNorm of the raw tokens: (xhat, rstd, xhat * w + b), f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp_min(mu2 - mu * mu, 0.0) + cuda.LN_EPS)
    xhat = (xf - mu) * rstd
    return xhat, rstd, xhat * ln_w.float() + ln_b.float()


def kv_project_plain(x, ln_w, ln_b, wk, wv):
    """k, v = LN(x) rounded to x's dtype, projected, rounded again."""
    dt = x.dtype
    xn = ln_kv_plain(x, ln_w, ln_b)[2].to(dt).float()
    return (xn @ wk.float()).to(dt), (xn @ wv.float()).to(dt)


def attention_kv_fwd_plain(q, x, ln_w, ln_b, wk, wv, seed, num_heads: int, scale: float,
                           rate: float):
    k, v = kv_project_plain(x, ln_w, ln_b, wk, wv)
    return attention_fwd_plain(q, k, v, seed, num_heads, scale, rate)


def attention_kv_bwd_plain(q, x, ln_w, ln_b, wk, wv, dout, lse, delta, seed, num_heads: int,
                           scale: float, rate: float):
    """-> (dq, dx, dln_w, dln_b, dwk, dwv); dwk/dwv in the weights' dtype."""
    k, v = kv_project_plain(x, ln_w, ln_b, wk, wv)
    dq, dk, dv = attention_bwd_plain(q, k, v, dout, lse, delta, seed, num_heads, scale, rate,
                                     kv_dtype=torch.float32)
    xhat, rstd, xn = ln_kv_plain(x, ln_w, ln_b)
    dxn = dk @ wk.float().t() + dv @ wv.float().t()
    din = x.shape[-1]
    dln_w = (dxn * xhat).reshape(-1, din).sum(0)
    dln_b = dxn.reshape(-1, din).sum(0)
    dxhat = dxn * ln_w.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    xn2 = xn.reshape(-1, din)
    dwk = (xn2.t() @ dk.reshape(-1, dk.shape[-1])).to(wk.dtype)
    dwv = (xn2.t() @ dv.reshape(-1, dv.shape[-1])).to(wv.dtype)
    return dq, dx, dln_w, dln_b, dwk, dwv


# ------------------------------------------------------------ kernels


def _check_heads(d: int, num_heads: int) -> None:
    """The kernels are built for one head width; the gates have no
    condition on it (as JAX's), so another width fails here."""
    if d != num_heads * KERNEL_HEAD_DIM:
        raise NotImplementedError(f"training attention kernels are built for "
                                  f"dh={KERNEL_HEAD_DIM}; got D={d}, H={num_heads}")


def _dropout_args(rate: float) -> tuple:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return keep_scale(rate), dropout_threshold(rate), int(rate > 0.0)


def _seed(seed: torch.Tensor, dev) -> torch.Tensor:
    seed = seed.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
    cuda.require(seed, "seed", torch.int32, (1,))
    return seed


def attention_fwd_kernel(q, k, v, seed, num_heads: int, scale: float, rate: float):
    b, g, d = q.shape
    m = k.shape[1]
    dt = q.dtype
    _check_heads(d, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t, shape in (("q", q, (b, g, d)), ("k", k, (b, m, d)), ("v", v, (b, m, d))):
        cuda.require(t, name, dt, shape)
    fn = cuda.tc_route("attn_train_fwd", dt)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    cuda.require_aligned(fn, q=qp, k=kp, v=vp)
    seed = _seed(seed, q.device)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    lse = torch.empty((b, num_heads, g), dtype=torch.float32, device=q.device)
    FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        qp, kp, vp, seed.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, g, m, num_heads, float(scale), *_dropout_args(rate),
        cuda.stream_ptr()), fn)
    return out, lse


def attention_bwd_kernel(q, k, v, dout, lse, delta, seed, num_heads: int, scale: float,
                         rate: float):
    b, g, d = q.shape
    m = k.shape[1]
    dt = q.dtype
    _check_heads(d, num_heads)
    dout = dout.contiguous()
    cuda.require(dout, "dout", dt, (b, g, d))
    cuda.require(lse, "lse", torch.float32, (b, num_heads, g))
    cuda.require(delta, "delta", torch.float32, (b, num_heads, g))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t, shape in (("q", q, (b, g, d)), ("k", k, (b, m, d)), ("v", v, (b, m, d))):
        cuda.require(t, name, dt, shape)
    fn = cuda.tc_route("attn_train_bwd", dt)
    cuda.require_aligned(fn, q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                         dout=dout.data_ptr())
    seed = _seed(seed, q.device)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seed.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, g, m, num_heads, float(scale), *_dropout_args(rate), cuda.stream_ptr()), fn)
    return dq, dk, dv


def _kv_operands(q, x, ln_w, ln_b, wk, wv, num_heads):
    b, g, d = q.shape
    m, din = x.shape[1], x.shape[2]
    dt = q.dtype
    _check_heads(d, num_heads)
    q, x, wk, wv = q.contiguous(), x.contiguous(), wk.contiguous(), wv.contiguous()
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    for name, t, shape in (("q", q, (b, g, d)), ("x", x, (b, m, din)), ("wk", wk, (din, d)),
                           ("wv", wv, (din, d))):
        cuda.require(t, name, dt, shape)
    cuda.require(ln_w, "ln_w", torch.float32, (din,))
    cuda.require(ln_b, "ln_b", torch.float32, (din,))
    if dt == torch.bfloat16:
        _check_tc_din(din)
        cuda.require_aligned(cuda.tc_route("attn_train_kv_fwd", dt), q=q.data_ptr(),
                             x=x.data_ptr(), wk=wk.data_ptr(), wv=wv.data_ptr())
    return q, x, ln_w, ln_b, wk, wv


def _check_tc_din(din: int) -> None:
    """The bf16 products stream Din in KV_TC_STEP-column stages (the
    gate admits multiples of 128)."""
    if din % KV_TC_STEP:
        raise NotImplementedError(f"K7's bf16 kernels take Din a multiple of {KV_TC_STEP}, "
                                  f"got {din}")


def wgrad_splits(rows: int, din: int, d: int, sms: int) -> int:
    """Token-row splits of K7's bf16 weight gradients [Din, 2D]: K11's plan
    (dense.plan_splits) for its 128 x 128 tiles and 32-row steps."""
    return dense.plan_splits(rows, din, 2 * d, torch.bfloat16, sms)


def kv_project_kernel(x, ln_w, ln_b, wk, wv):
    """K7's bf16 LN-folded k|v projection alone (csrc/flash_train.cu
    tc::kv_project, which K7's forward and backward launch): x [B, M, Din]
    -> k, v [B, M, D] in bf16, on the card, for holding it against
    `kv_project_plain`. It counts no launch: on the main paths the kernel
    runs inside K7's forward and backward, which their counters count."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K7's tensor-core projection takes bfloat16, got {x.dtype}")
    b, m, din = x.shape
    d = wk.shape[1]
    x, wk, wv = x.contiguous(), wk.contiguous(), wv.contiguous()
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    for name, t, shape in (("x", x, (b, m, din)), ("wk", wk, (din, d)), ("wv", wv, (din, d))):
        cuda.require(t, name, torch.bfloat16, shape)
    cuda.require(ln_w, "ln_w", torch.float32, (din,))
    cuda.require(ln_b, "ln_b", torch.float32, (din,))
    _check_heads(d, d // KERNEL_HEAD_DIM)
    _check_tc_din(din)
    fn = "kv_project_tc_bf16"
    cuda.require_aligned(fn, x=x.data_ptr(), wk=wk.data_ptr(), wv=wv.data_ptr())
    dev = x.device
    k, v = (torch.empty((b, m, d), dtype=torch.bfloat16, device=dev) for _ in range(2))
    xn = torch.empty((b * m, din), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((b * m, 2), dtype=torch.float32, device=dev)
    cuda.check(getattr(cuda.lib(), fn)(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        k.data_ptr(), v.data_ptr(), xn.data_ptr(), stats.data_ptr(), b * m, din,
        d // KERNEL_HEAD_DIM, cuda.stream_ptr()), fn)
    return k, v


def attention_kv_fwd_kernel(q, x, ln_w, ln_b, wk, wv, seed, num_heads: int, scale: float,
                            rate: float):
    q, x, ln_w, ln_b, wk, wv = _kv_operands(q, x, ln_w, ln_b, wk, wv, num_heads)
    b, g, d = q.shape
    m, din = x.shape[1], x.shape[2]
    dt, dev = q.dtype, q.device
    seed = _seed(seed, dev)
    out = torch.empty((b, g, d), dtype=dt, device=dev)
    lse = torch.empty((b, num_heads, g), dtype=torch.float32, device=dev)
    kbuf = torch.empty((b, m, d), dtype=dt, device=dev)
    vbuf = torch.empty_like(kbuf)
    rowstats = torch.empty((b * m, 2), dtype=torch.float32, device=dev)
    # bf16: the normalised tokens, the projection's A operand
    xn = [torch.empty((b * m, din), dtype=dt, device=dev).data_ptr()] \
        if dt == torch.bfloat16 else []
    fn = cuda.tc_route("attn_train_kv_fwd", dt)
    KV_FWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        q.data_ptr(), x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), seed.data_ptr(), out.data_ptr(), lse.data_ptr(), kbuf.data_ptr(),
        vbuf.data_ptr(), rowstats.data_ptr(), *xn, b, g, m, din, num_heads, float(scale),
        *_dropout_args(rate), cuda.stream_ptr()), fn)
    return out, lse


def attention_kv_bwd_kernel(q, x, ln_w, ln_b, wk, wv, dout, lse, delta, seed, num_heads: int,
                            scale: float, rate: float):
    q, x, ln_w, ln_b, wk, wv = _kv_operands(q, x, ln_w, ln_b, wk, wv, num_heads)
    b, g, d = q.shape
    m, din = x.shape[1], x.shape[2]
    dt, dev = q.dtype, q.device
    rows = b * m
    dout = dout.contiguous()
    cuda.require(dout, "dout", dt, (b, g, d))
    cuda.require(lse, "lse", torch.float32, (b, num_heads, g))
    cuda.require(delta, "delta", torch.float32, (b, num_heads, g))
    fn = cuda.tc_route("attn_train_kv_bwd", dt)
    cuda.require_aligned(fn, dout=dout.data_ptr())
    seed = _seed(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dx = torch.empty_like(q), torch.empty_like(x)
    dw = torch.empty((din, 2 * d), **f32)
    dln_w, dln_b = torch.empty((din,), **f32), torch.empty((din,), **f32)
    kbuf = torch.empty((b, m, d), dtype=dt, device=dev)
    vbuf = torch.empty_like(kbuf)
    rowstats = torch.empty((rows, 2), **f32)
    dxn = torch.empty((rows, din), **f32)
    part = torch.empty((COLSUM_BLOCKS, 2, din), **f32)
    if dt == torch.bfloat16:  # the tensor-core products: bf16 xn, dk, dv
        splits = wgrad_splits(rows, din, d, cuda.sm_count(dev.index or 0))
        scratch = (torch.empty((rows, din), dtype=dt, device=dev), torch.empty_like(kbuf),
                   torch.empty_like(kbuf), dxn, part,
                   torch.empty((splits, din, 2 * d), **f32))
    else:
        splits = WGRAD_SPLITS
        scratch = (torch.empty((b, m, d), **f32), torch.empty((b, m, d), **f32), dxn, part,
                   torch.empty((splits, din, 2 * d), **f32))
    KV_BWD_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        q.data_ptr(), x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), seed.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dx.data_ptr(), dw.data_ptr(), dln_w.data_ptr(), dln_b.data_ptr(),
        kbuf.data_ptr(), vbuf.data_ptr(), rowstats.data_ptr(), *(t.data_ptr() for t in scratch),
        b, g, m, din, num_heads, splits, COLSUM_BLOCKS, float(scale),
        *_dropout_args(rate), cuda.stream_ptr()), fn)
    return dq, dx, dln_w, dln_b, dw[:, :d].to(wk.dtype), dw[:, d:].to(wv.dtype)


def dropout_mask_kernel(seed: torch.Tensor, bh: int, g: int, m: int, rate: float):
    """The kernels' keep bits as bool [bh, g, m] (for checking the twin)."""
    seed = _seed(seed, seed.device)
    out = torch.empty((bh, g, m), dtype=torch.uint8, device=seed.device)
    cuda.check(cuda.lib().dropout_mask_u8(seed.data_ptr(), bh, g, m, dropout_threshold(rate),
                                          out.data_ptr(), cuda.stream_ptr()), "dropout_mask_u8")
    return out.bool()


# ------------------------------------------------------------ autograd


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, num_heads, scale, rate):
        fwd = attention_fwd_kernel if q.is_cuda else attention_fwd_plain
        out, lse = fwd(q, k, v, seed, num_heads, scale, rate)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.cfg = (num_heads, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed = ctx.saved_tensors
        num_heads, scale, rate = ctx.cfg
        delta = attention_delta(dout, out, num_heads)
        bwd = attention_bwd_kernel if q.is_cuda else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, dout, lse, delta, seed, num_heads, scale, rate)
        return dq, dk, dv, None, None, None, None


class _FlashTrainKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, x, ln_w, ln_b, wk, wv, seed, num_heads, scale, rate):
        fwd = attention_kv_fwd_kernel if q.is_cuda else attention_kv_fwd_plain
        out, lse = fwd(q, x, ln_w, ln_b, wk, wv, seed, num_heads, scale, rate)
        ctx.save_for_backward(q, x, ln_w, ln_b, wk, wv, out, lse, seed)
        ctx.cfg = (num_heads, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, x, ln_w, ln_b, wk, wv, out, lse, seed = ctx.saved_tensors
        num_heads, scale, rate = ctx.cfg
        delta = attention_delta(dout, out, num_heads)
        bwd = attention_kv_bwd_kernel if q.is_cuda else attention_kv_bwd_plain
        dq, dx, dln_w, dln_b, dwk, dwv = bwd(q, x, ln_w, ln_b, wk, wv, dout, lse, delta, seed,
                                             num_heads, scale, rate)
        return (dq, dx, dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype), dwk, dwv,
                None, None, None, None)


def flash_attention_train(q, k, v, seed, num_heads: int, scale: float, rate: float):
    """Differentiable training attention with dropout `rate` (K8)."""
    return _FlashTrain.apply(q, k, v, seed, num_heads, scale, rate)


def flash_attention_train_kv(q, x_kv, ln_w, ln_b, wk, wv, seed, num_heads: int, scale: float,
                             rate: float):
    """Training cross-attention with the kv LN and k/v projections folded
    in (K7); gradients flow to q, x_kv, ln_w, ln_b, wk and wv."""
    return _FlashTrainKV.apply(q, x_kv, ln_w, ln_b, wk, wv, seed, num_heads, scale, rate)


def draw_seed(generator: torch.Generator | None, rate: float, device) -> torch.Tensor:
    """The dropout seed, an int32 tensor [1] on `device`, drawn from
    `generator` (on the generator's device, so no host synchronisation);
    zero when the rate is 0. A nonzero rate needs a generator."""
    if rate == 0.0:
        return torch.zeros((1,), dtype=torch.int32, device=device)
    if generator is None:
        raise ValueError("dropout needs a torch.Generator")
    seed = torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32, generator=generator,
                         device=generator.device)
    return seed.to(device)


def flash_train_enabled(num_heads: int, qk_ch: int, v_ch: int, training: bool,
                        on_card: bool) -> bool:
    """Whether a train-mode attention runs K8 (JAX flash_train.py:1007-1045):
    train mode, equal q/k and v widths divisible by the heads; the
    attention gates' flag (`attention.USE_FUSED_ATTENTION`) forces it;
    auto on the card. The kernel walks any G and M in tiles, so the TPU's
    VMEM conditions on them have no counterpart here; at a head width the
    kernel is not built for it raises (`_check_heads`)."""
    from vipformer_tpu_torch.ops.cuda import attention

    if not training or qk_ch != v_ch or qk_ch % num_heads:
        return False
    if attention.USE_FUSED_ATTENTION is not None:
        return attention.USE_FUSED_ATTENTION
    return on_card


def flash_train_kv_enabled(num_heads: int, qk_ch: int, v_ch: int, d_in: int, training: bool,
                           on_card: bool) -> bool:
    """Whether a train-mode CrossAttention runs K7 (JAX flash_train.py:
    978-1004): raw tokens Din a multiple of 128 and at most 1024, and K8's
    gate."""
    if d_in % 128 or d_in > 1024:
        return False
    return flash_train_enabled(num_heads, qk_ch, v_ch, training, on_card)
