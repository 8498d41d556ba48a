"""K4 and K5: eval attention on packed [B, tokens, H*dh] layouts
(counterpart of ops/pallas/attention.py).

* `fused_attention_packed_kv_ln` (K4, the cross-attention): the kv
  LayerNorm and the k/v projections run inside the kernel, softmax is
  online over kv chunks, and the output is divided by l after PV.
* `fused_attention_packed_small` (K5, the self-attention): the whole score
  block at once, softmax normalised before PV.

Each launches `csrc/attention.cu` on CUDA tensors and runs its plain twin
on CPU tensors. Numerics follow the Pallas kernels: f32 logits, `p` cast
to v's dtype before an f32-accumulated PV.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

KV_LN_LAUNCHES = cuda.LaunchCounter()
SMALL_LAUNCHES = cuda.LaunchCounter()
LN_EPS = 1e-5
KERNEL_HEAD_DIM = 64  # head width the CUDA kernels are built for
KV_CHUNK = 2048  # the Pallas kernel's kv chunk cap (attention.py:144)
KV_Q_TILE = 128  # query rows per K4 block
KV_CHUNK_TOKENS = 32  # kv tokens per K4 chunk
KV_MAX_DIN = 1024  # the normalised chunk [Din, 36] f32 stays in shared memory
SMALL_SMEM_BYTES = 227 * 1024  # dynamic shared memory a Hopper block can use


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, H*dh] -> [B, H, N, dh]."""
    b, n, d = x.shape
    return x.view(b, n, h, d // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H*dh]."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def _kv_chunk_for(m: int, cap: int = KV_CHUNK) -> int:
    """Largest divisor of m that is <= cap (m itself when m <= cap)."""
    if m <= cap:
        return m
    return max(c for c in range(1, cap + 1) if m % c == 0)


def layer_norm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """nn.layers.LayerNorm's math: f32 fast-variance stats, eps 1e-5."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    return ((xf - mu) * (torch.rsqrt(var + LN_EPS) * w) + b).to(dt)


def attention_kv_ln_plain(q, x_kv, ln_w, ln_b, wk, wv, num_heads: int, scale: float):
    """q [B, G, H*dh], x_kv raw [B, M, Din], ln_w/ln_b f32 [Din],
    wk/wv [Din, H*dh] -> [B, G, H*dh] in q's dtype."""
    dt = q.dtype
    xn = layer_norm_f32(x_kv, ln_w, ln_b, dt)
    k = _heads((xn.float() @ wk.float()).to(dt), num_heads).float()
    v = _heads((xn.float() @ wv.float()).to(dt), num_heads)
    qh = _heads(q, num_heads).float()
    m = k.shape[2]
    mc = _kv_chunk_for(m)
    m_run = l_run = acc = None
    for j in range(0, m, mc):
        logits = (qh @ k[:, :, j:j + mc].transpose(-1, -2)) * scale  # [B,H,G,Mc]
        m_new = logits.amax(dim=-1)
        if m_run is not None:
            m_new = torch.maximum(m_run, m_new)
        p = torch.exp(logits - m_new[..., None])
        pv = p.to(dt).float() @ v[:, :, j:j + mc].float()
        if m_run is None:
            l_run, acc = p.sum(dim=-1), pv
        else:
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + pv
        m_run = m_new
    return _merge((acc / l_run[..., None]).to(dt))


def attention_small_plain(q, k, v, num_heads: int, scale: float):
    """q [B, G, H*dh], k/v [B, M, H*dh] -> [B, G, H*dh] in v's dtype."""
    logits = (_heads(q, num_heads).float()
              @ _heads(k, num_heads).float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ _heads(v, num_heads).float()
    return _merge(o.to(v.dtype))


def fused_attention_packed_kv_ln(q, x_kv, ln_w, ln_b, wk, wv, *, num_heads: int,
                                 scale: float) -> torch.Tensor:
    """Eval cross-attention with the kv LayerNorm and k/v projections folded
    in. Shapes as `attention_kv_ln_plain`."""
    if not q.is_cuda:
        return attention_kv_ln_plain(q, x_kv, ln_w, ln_b, wk, wv, num_heads, scale)
    b, g, d = q.shape
    m, din = x_kv.shape[1], x_kv.shape[2]
    dt = q.dtype
    fn = cuda.entry_point("attn_kv_ln", dt)
    if d != num_heads * KERNEL_HEAD_DIM or din > KV_MAX_DIN:
        raise ValueError(
            f"attn_kv_ln kernel needs dh={KERNEL_HEAD_DIM} and Din <= {KV_MAX_DIN}; "
            f"got D={d}, H={num_heads}, Din={din}"
        )
    q, x_kv, wk, wv = q.contiguous(), x_kv.contiguous(), wk.contiguous(), wv.contiguous()
    ln_w = ln_w.float().contiguous()
    ln_b = ln_b.float().contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(x_kv, "x_kv", dt, (b, m, din))
    cuda.require(ln_w, "ln_w", torch.float32, (din,))
    cuda.require(ln_b, "ln_b", torch.float32, (din,))
    cuda.require(wk, "wk", dt, (din, d))
    cuda.require(wv, "wv", dt, (din, d))
    nsplit = kv_splits(b * num_heads * -(-g // KV_Q_TILE), -(-m // KV_CHUNK_TOKENS),
                       torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    part_acc = torch.empty((b, num_heads, nsplit, g, KERNEL_HEAD_DIM) if nsplit > 1 else (1,),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, num_heads, nsplit, g, 2) if nsplit > 1 else (1,),
                          dtype=torch.float32, device=q.device)
    KV_LN_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        q.data_ptr(), x_kv.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        wk.data_ptr(), wv.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, g, m, din, num_heads, nsplit, float(scale), cuda.stream_ptr(),
    ), fn)
    return out


def kv_splits(blocks: int, nchunks: int, sms: int) -> int:
    """How many blocks share one (cloud, head, query tile)'s kv chunks in
    K4: enough for about two blocks per SM, with no split left empty."""
    want = max(1, min(nchunks, -(-2 * sms // blocks)))
    per = -(-nchunks // want)
    return -(-nchunks // per)


def fused_attention_packed_small(q, k, v, *, num_heads: int, scale: float) -> torch.Tensor:
    """Eval small-M attention, whole score block per (cloud, head).
    Shapes as `attention_small_plain`."""
    if not q.is_cuda:
        return attention_small_plain(q, k, v, num_heads, scale)
    b, g, d = q.shape
    m = k.shape[1]
    dt = v.dtype
    fn = cuda.entry_point("attn_small", dt)
    ldh = KERNEL_HEAD_DIM + 1
    smem = 4 * ((g + 2 * m) * ldh + g * (m + 1))
    if d != num_heads * KERNEL_HEAD_DIM or g > 512 or smem > SMALL_SMEM_BYTES:
        raise ValueError(
            f"attn_small kernel needs dh={KERNEL_HEAD_DIM}, G <= 512 and its f32 tiles "
            f"in shared memory; got D={d}, H={num_heads}, G={g}, M={m}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(k, "k", dt, (b, m, d))
    cuda.require(v, "v", dt, (b, m, d))
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    SMALL_LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, g, m, num_heads, float(scale), cuda.stream_ptr(),
    ), fn)
    return out
