"""K4, K5, K6, K13 and K15: eval attention on packed [B, tokens, H*dh]
layouts, and K14 on the head-split [B, H, tokens, dh] one (counterpart of
ops/pallas/attention.py), and the gates that route each attention site to
them.

* `fused_attention_packed_kv_ln` (K4, the cross-attention): the kv
  LayerNorm and the k/v projections run inside the kernel, softmax is
  online over kv chunks, and the output is divided by l after PV.
* `fused_attention_packed_small` (K5, the self-attention): the whole key
  axis of a (cloud, head) at once, softmax normalised before PV.
* `fused_attention_packed_small_qkv_ln` (K6): K5 with the self-attention's
  pre-LN and its q/k/v projections folded in; raw tokens in, o_proj's
  input out. `packed_small_qkv_ln_enabled` is the port's copy of the JAX
  gate (attention.py:789-823).
* `fused_attention_packed` (K13): flash attention on projected q/k/v,
  online softmax streamed over kv chunks, any M (the Fourier image
  cross-attention's 20,736 tokens).
* `fused_attention_packed_kv` (K15): K13 with the bias-free k/v
  projections folded in, each token projected once per head.
* `fused_attention` (K14, csrc/mha.cu): head-split q [B, H, G, dh] over
  k [B, H, M, dh] and v [B, H, M, dv], the whole M per (b, h), softmax
  normalised before PV; the only kernel that takes dv != dh, so it serves
  the sites no packed kernel takes. `fused_attention_enabled` is the
  copy of the JAX gate (attention.py:104-122): auto is off, on the card
  too, and `USE_FUSED_ATTENTION` forces it.

The gates are the port's copies of the JAX package's
(`packed_attention_kv_enabled`, `packed_attention_enabled`,
`packed_small_attention_enabled`, attention.py:515-576 and 826-855): the
same structural conditions, with each CUDA kernel's own limits (head width
64, shared memory) in place of the TPU's VMEM budgets. `USE_FUSED_ATTENTION`
None means auto, which is on the card only; True / False force, as the
JAX package's flag of the same name, which also drives the training
gates of ops/cuda/flash_train.py.

Each launches `csrc/attention.cu` (K14: `csrc/mha.cu`) on CUDA tensors
and runs its plain twin on CPU tensors. Numerics follow the Pallas
kernels: f32 logits, `p` cast to v's dtype before an f32-accumulated PV.

K4, K5, K6, K13, K14 and K15 pick their kernel by dtype (`cuda.tc_route`):
bf16 runs on the tensor cores (mma.sync, csrc/mma.cuh), f32 on the CUDA
cores, since a tensor-core f32 product is TF32 and would break the f32
bounds. The bf16 K4 normalises the kv tokens once in a first pass (xn,
bf16, written to device memory), then projects each 64-token tile of xn
onto a head's k|v on chip (up to Din = KV_LN_TC_TILE_DB_DIN a whole tile
at a time, the head's [wk|wv] columns resident; past it in Din chunks of
KV_LN_TC_CHUNK with the weights' rows) and runs K13's online softmax on
the tile. Past one query tile (G > TC_Q_TILE) the same kernels write k
and v once and K13's kernel attends over them, so that no tile is
projected once per query tile (`kv_ln_plan` splits the tiles over
blocks).
The bf16 K15 (`packed_kv_plan`) runs, past one query tile (G >
TC_Q_TILE) and up to PKV_MAX_TOKENS queries and tokens (the Perceiver's
512 latents), one thread-block cluster a (cloud, head) of
ceil(max(G, M) / PKV_SLICE) blocks: each projects its PKV_SLICE tokens
of x onto the head's k|v (Din streamed in chunks), copies them into
every block's shared memory over the cluster, and attends its PKV_SLICE
query rows over the whole cloud's k|v there, so that each token is
projected once per head and k and v never reach device memory. Elsewhere
K4's bf16 passes run on the tokens as they are (no LayerNorm), split as
`kv_ln_plan` splits K4's.
The bf16 K5 stages a (cloud, head)'s whole k and v in shared memory for
64 query rows a block (its logits in registers up to 128 keys, K14's two
passes above); the bf16 K6 projects a (cloud, head)'s q, k and v on chip,
Din streamed in chunks of QKV_TC_CHUNK columns, then runs K5's attention
on them.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

KV_LN_LAUNCHES = cuda.LaunchCounter()
SMALL_LAUNCHES = cuda.LaunchCounter()
SMALL_QKV_LN_LAUNCHES = cuda.LaunchCounter()
PACKED_LAUNCHES = cuda.LaunchCounter()
PACKED_KV_LAUNCHES = cuda.LaunchCounter()
HEAD_SPLIT_LAUNCHES = cuda.LaunchCounter()
# Attention gates: None = auto (on the card, within each kernel's limits);
# True / False force every attention kernel gate on or off.
USE_FUSED_ATTENTION: bool | None = None
KERNEL_HEAD_DIM = 64  # head width the CUDA kernels are built for
KV_CHUNK = 2048  # the Pallas kernel's kv chunk cap (attention.py:144)
KV_Q_TILE = 128  # query rows per block of the CUDA-core K4, K13 and K15
KV_CHUNK_TOKENS = 32  # kv tokens per chunk of the CUDA-core K4, K13 and K15
KV_MAX_DIN = 1024  # the CUDA-core kernels keep a normalised chunk [Din, 36] f32 on chip
TC_Q_TILE = 128  # query rows per block of the tensor-core K4 and K13
TC_TILE_TOKENS = 64  # kv tokens per tile of the tensor-core K4 and K13
TC_BLOCKS_PER_SM = 2  # tensor-core K4 and K13 blocks an SM holds (their __launch_bounds__)
TC_WAVE_FILL = 0.9  # the least share of its last wave's block slots the split fills
KV_LN_TC_TILE_DIN = 256  # the tensor-core K4 takes whole tiles of xn up to this Din
KV_LN_TC_TILE_DB_DIN = 384  # ... and up to this one double-buffered, one block an SM
KV_LN_TC_CHUNK = 64  # Din columns a chunk of the tensor-core K4 past it
KV_LN_TC_STAGES = 3  # chunks in the ring of the tensor-core K4 past it
PKV_SLICE = 256  # the bf16 K15's cluster kernel: tokens and query rows a block (8 warps x 32)
PKV_MAX_TOKENS = 512  # ... its largest G and M: the cloud's k|v [512, 128] on chip
PKV_STAGES = 2  # ... the Din chunks in its projection's ring
PKV_KC = 64  # ... the Din columns a chunk of its projection
SMALL_SMEM_BYTES = 227 * 1024  # dynamic shared memory a Hopper block can use


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, H*dh] -> [B, H, N, dh]."""
    b, n, d = x.shape
    return x.view(b, n, h, d // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H*dh]."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def require_head_width(kernel: str, d: int, num_heads: int) -> None:
    """The CUDA attention kernels are built for one head width. The gates
    route by the JAX package's conditions, which have none on it, so at
    another width the call fails here instead of running plain attention
    on the card."""
    if d != num_heads * KERNEL_HEAD_DIM:
        raise NotImplementedError(f"the {kernel} kernel is built for dh={KERNEL_HEAD_DIM}; "
                                  f"got D={d}, H={num_heads}")


def _kv_chunk_for(m: int, cap: int = KV_CHUNK) -> int:
    """Largest divisor of m that is <= cap (m itself when m <= cap)."""
    if m <= cap:
        return m
    return max(c for c in range(1, cap + 1) if m % c == 0)


def layer_norm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dt) -> torch.Tensor:
    """nn.layers.LayerNorm's math: f32 fast-variance stats, eps cuda.LN_EPS."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    return ((xf - mu) * (torch.rsqrt(var + cuda.LN_EPS) * w) + b).to(dt)


def _online_attention(q, k, v, num_heads: int, scale: float, dt, kv_chunk: int | None = None):
    """The Pallas kernels' streamed softmax: q [B, G, H*dh], k f32 and v in
    dt, both [B, H, M, dh] -> [B, G, H*dh] in dt. Per chunk of
    `kv_chunk` tokens (default `_kv_chunk_for(M)`): f32 logits, running max
    and sum, p rounded to dt before an f32-accumulated PV; divided by the
    sum at the end."""
    qh = _heads(q, num_heads).float()
    m = k.shape[2]
    mc = kv_chunk or _kv_chunk_for(m)
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


def attention_kv_ln_plain(q, x_kv, ln_w, ln_b, wk, wv, num_heads: int, scale: float,
                          kv_chunk: int | None = None):
    """q [B, G, H*dh], x_kv raw [B, M, Din], ln_w/ln_b f32 [Din],
    wk/wv [Din, H*dh] -> [B, G, H*dh] in q's dtype: the LayerNorm rounded
    to the compute dtype, then K15's twin, streamed over kv chunks of
    `kv_chunk` tokens (default as the Pallas kernel's; 64 is the
    tensor-core kernel's tile order)."""
    xn = layer_norm_f32(x_kv, ln_w, ln_b, q.dtype)
    return attention_packed_kv_plain(q, xn, wk, wv, num_heads, scale, kv_chunk)


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
    in (K4). Shapes as `attention_kv_ln_plain`; Din <= KV_MAX_DIN, and in
    bf16 (the tensor cores) a multiple of 8. The kv tokens are split over
    blocks as `kv_ln_plan` plans them."""
    if not q.is_cuda:
        return attention_kv_ln_plain(q, x_kv, ln_w, ln_b, wk, wv, num_heads, scale)
    b, g, d = q.shape
    m, din = x_kv.shape[1], x_kv.shape[2]
    dt = q.dtype
    fn = kv_route("attn_kv_ln", dt, d, num_heads, din)
    q, x_kv, wk, wv = q.contiguous(), x_kv.contiguous(), wk.contiguous(), wv.contiguous()
    ln_w = ln_w.float().contiguous()
    ln_b = ln_b.float().contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(x_kv, "x_kv", dt, (b, m, din))
    cuda.require(ln_w, "ln_w", torch.float32, (din,))
    cuda.require(ln_b, "ln_b", torch.float32, (din,))
    cuda.require(wk, "wk", dt, (din, d))
    cuda.require(wv, "wv", dt, (din, d))
    ptrs = dict(q=q.data_ptr(), x_kv=x_kv.data_ptr(), ln_w=ln_w.data_ptr(),
                ln_b=ln_b.data_ptr(), wk=wk.data_ptr(), wv=wv.data_ptr())
    cuda.require_aligned(fn, **ptrs)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    nsplit, psplit = kv_ln_plan(dt, b, g, m, num_heads, din, _sms(q.device))
    nsplit, part_acc, part_ml = _split_scratch(q, b, g, m, num_heads, nsplit)
    scratch = [part_acc.data_ptr(), part_ml.data_ptr()]
    splits = [nsplit]
    if dt == torch.bfloat16:  # the normalised tokens, written once; past a query tile k and v
        xn = torch.empty((b * m, din), dtype=dt, device=q.device)
        kv = torch.empty((2, b * m, d) if g > TC_Q_TILE else (1,), dtype=dt, device=q.device)
        scratch += [xn.data_ptr(), kv.data_ptr()]
        splits.append(psplit)
    KV_LN_LAUNCHES.n += 1
    cuda.launch(fn, q.device, *ptrs.values(), out.data_ptr(), *scratch, b, g, m, din, num_heads,
                *splits, float(scale))
    return out


def kv_route(base: str, dt: torch.dtype, d: int, num_heads: int, din: int) -> str:
    """The entry point of K4 (`attn_kv_ln`) or K15 (`attn_packed_kv`) for
    dtype `dt` (`cuda.tc_route`); raises, before any launch, on a width
    their kernels do not take: a head width other than 64, Din above
    KV_MAX_DIN, and in bf16 (16-byte rows) a Din that is not a multiple of
    8."""
    fn = cuda.tc_route(base, dt)
    require_head_width(base, d, num_heads)
    if din > KV_MAX_DIN:
        raise ValueError(f"{base} kernel needs Din <= {KV_MAX_DIN}; got Din={din}")
    if dt == torch.bfloat16 and din % 8:
        raise ValueError(f"{base} tensor-core kernel needs Din a multiple of 8; got Din={din}")
    return fn


def kv_ln_tc_smem_bytes(din: int) -> int:
    """The bf16 K4's shared memory at Din in its attention pass
    (csrc/attention.cu `kvln_tile_smem`, `KVLN_STREAM_SMEM`): up to
    KV_LN_TC_TILE_DIN the tile kernel's, two blocks an SM (this head's
    [wk|wv] slice, 256 rows of 128 + 8 bf16, and a 64-token tile of xn in
    rows of 256 + 8, then its k|v), up to KV_LN_TC_TILE_DB_DIN the
    double-buffered tile kernel's, one block an SM (384 rows of the slice,
    two tiles in rows of 384 + 8), past it the stream kernel's, two blocks
    an SM (a k|v tile and a ring of KV_LN_TC_STAGES chunks of 64 rows of
    64 + 8 bf16 of xn and 64 rows of the weights' slice; Din does not
    enter). q's 128 rows are staged over them until held in registers."""
    d2, tokens = 2 * KERNEL_HEAD_DIM + 8, TC_TILE_TOKENS
    for tdin, buffers in ((KV_LN_TC_TILE_DIN, 1), (KV_LN_TC_TILE_DB_DIN, 2)):
        if din <= tdin:
            return 2 * (tdin * d2 + buffers * tokens * (tdin + 8))
    slot = tokens * (KV_LN_TC_CHUNK + 8) + KV_LN_TC_CHUNK * d2
    return 2 * (tokens * d2 + KV_LN_TC_STAGES * slot)


def kv_ln_blocks_per_sm(din: int) -> int:
    """Blocks an SM of the bf16 K4's attention kernel at Din (their
    __launch_bounds__): one for the double-buffered tile kernel, else
    TC_BLOCKS_PER_SM."""
    return 1 if KV_LN_TC_TILE_DIN < din <= KV_LN_TC_TILE_DB_DIN else TC_BLOCKS_PER_SM


def kv_ln_splits(dt: torch.dtype, b: int, g: int, m: int, h: int, sms: int,
                 per_sm: int = TC_BLOCKS_PER_SM) -> int:
    """K4's split of its kv tiles over blocks that run `per_sm` to an SM:
    none where its (head, cloud, query tile) blocks fill TC_WAVE_FILL of
    TC_BLOCKS_PER_SM x sms slots (the serving B = 64: 256 of 264; a split
    would add a merge pass, 0.019 ms there). At one block an SM that is two
    waves: past them a split's merge pass and the weights each more block
    loads cost more than a part-empty last wave (PERF.md). Else K13's
    split (`packed_splits`) at `per_sm` blocks an SM."""
    units = b * h * -(-g // TC_Q_TILE)
    if dt == torch.bfloat16 and units >= TC_WAVE_FILL * TC_BLOCKS_PER_SM * sms:
        return 1
    return packed_splits(dt, b, g, m, h, sms, per_sm)


def kv_ln_plan(dt: torch.dtype, b: int, g: int, m: int, h: int, din: int,
               sms: int) -> tuple[int, int]:
    """(nsplit, psplit): K4's kv splits of its attention and of its
    projection pass. Up to one query tile, or in f32, `kv_ln_splits` at
    the attention kernel's blocks an SM (`kv_ln_blocks_per_sm`) and no
    projection pass (psplit 1). Past one query tile in bf16 the attention
    is K13's over k and v written once, split as K13's wrapper splits it
    (`packed_splits`), and the projection's (head, cloud) blocks, two an
    SM, as `kv_ln_splits` splits one query tile's."""
    if dt != torch.bfloat16 or g <= TC_Q_TILE:
        return kv_ln_splits(dt, b, g, m, h, sms, kv_ln_blocks_per_sm(din)), 1
    return packed_splits(dt, b, g, m, h, sms), kv_ln_splits(dt, b, 1, m, h, sms)


def packed_kv_plan(dt: torch.dtype, b: int, g: int, m: int, h: int, din: int,
                   sms: int) -> tuple[int, int, int]:
    """(cluster, nsplit, psplit): K15's kernels. In bf16 past one query
    tile (G > TC_Q_TILE) with G and M at most PKV_MAX_TOKENS (any Din the
    route takes), the cluster kernel: one cluster a (cloud, head) of
    `cluster` = `pkv_cluster(g, m)` blocks, block r projecting tokens and
    attending query rows [PKV_SLICE r, PKV_SLICE (r + 1)), no split (1,
    1). Elsewhere (cluster 0) K4's passes on the tokens as they
    are, split as `kv_ln_plan` splits K4's (up to one query tile one pass
    that projects and attends, which needs no cluster); in f32 the CUDA-core
    kernel's 32-token chunks."""
    if dt == torch.bfloat16 and g > TC_Q_TILE and max(g, m) <= PKV_MAX_TOKENS:
        return pkv_cluster(g, m), 1, 1
    return (0, *kv_ln_plan(dt, b, g, m, h, din, sms))


def pkv_cluster(g: int, m: int) -> int:
    """Blocks a cluster of K15's cluster kernel: PKV_SLICE tokens and
    query rows each."""
    return -(-max(g, m) // PKV_SLICE)


def packed_kv_cluster_smem_bytes() -> int:
    """The bf16 K15's cluster kernel's shared memory (csrc/attention.cu
    `PKV_SMEM`): the cloud's k|v (PKV_MAX_TOKENS rows of 128 + 8 bf16) or,
    while the block projects, in its place the ring of PKV_STAGES Din
    chunks (the slice's PKV_SLICE rows of PKV_KC + 8 bf16 of x and PKV_KC
    rows of 128 + 8 of the weights) and q's staging (PKV_SLICE rows of 64
    + 8), whichever is larger: one block an SM."""
    d2 = 2 * KERNEL_HEAD_DIM + 8
    ring = PKV_STAGES * (PKV_SLICE * (PKV_KC + 8) + PKV_KC * d2)
    return 2 * max(PKV_MAX_TOKENS * d2, ring + PKV_SLICE * (KERNEL_HEAD_DIM + 8))


def kv_splits(blocks: int, nchunks: int, sms: int, per_sm: int = 2) -> int:
    """How many blocks share one (cloud, head, query tile)'s kv chunks in
    K4, K13 and K15: enough for `per_sm` blocks per SM (one full wave),
    with no split left empty."""
    want = max(1, min(nchunks, -(-per_sm * sms // blocks)))
    per = -(-nchunks // want)
    return -(-nchunks // per)


def packed_splits(dt: torch.dtype, b: int, g: int, m: int, h: int, sms: int,
                  per_sm: int = TC_BLOCKS_PER_SM) -> int:
    """K13's and K4's split of their kv tiles over blocks on a card of
    `sms` SMs, in the tiles of the route that dtype `dt` takes. On the CUDA
    cores (f32), 32-token chunks (`kv_splits`). On the tensor cores (bf16),
    64 tokens and 128 query rows a block, `per_sm` to an SM: at least
    one full wave, then more splits (up to 4x) until the last wave's slots
    are TC_WAVE_FILL full, since a block that starts in a part-empty wave
    leaves SMs idle while it runs (no split left empty)."""
    if dt != torch.bfloat16:
        return kv_splits(b * h * -(-g // KV_Q_TILE), -(-m // KV_CHUNK_TOKENS), sms)
    units, tiles = b * h * -(-g // TC_Q_TILE), -(-m // TC_TILE_TOKENS)
    slots = per_sm * sms
    least = kv_splits(units, tiles, sms, per_sm)
    for want in range(least, min(tiles, 4 * least) + 1):
        n = -(-tiles // -(-tiles // want))  # the splits that ceil(tiles / want) tiles make
        blocks = units * n
        if blocks >= TC_WAVE_FILL * slots * -(-blocks // slots):
            return n
    return least


def split_scratch_shapes(b: int, g: int, h: int, nsplit: int) -> tuple[tuple, tuple]:
    """Shapes of the f32 partial states (part_acc, part_ml) that the merge
    pass reads: [B, H, nsplit, G, 64] and [B, H, nsplit, G, 2]; a stub
    when nothing is split."""
    if nsplit == 1:
        return (1,), (1,)
    return (b, h, nsplit, g, KERNEL_HEAD_DIM), (b, h, nsplit, g, 2)


def _sms(device) -> int:
    return cuda.sm_count(torch.device(device).index)


def _split_scratch(q: torch.Tensor, b: int, g: int, m: int, h: int, nsplit: int | None = None):
    """(nsplit, part_acc, part_ml): the split of the kv chunks over blocks
    (the CUDA-core kernels' 32-token chunks unless given) and the f32
    scratch of the partial states the merge pass reads."""
    if nsplit is None:
        nsplit = kv_splits(b * h * -(-g // KV_Q_TILE), -(-m // KV_CHUNK_TOKENS), _sms(q.device))
    f32 = dict(dtype=torch.float32, device=q.device)
    acc_shape, ml_shape = split_scratch_shapes(b, g, h, nsplit)
    return nsplit, torch.empty(acc_shape, **f32), torch.empty(ml_shape, **f32)


def fused_attention_packed_small(q, k, v, *, num_heads: int, scale: float) -> torch.Tensor:
    """Eval small-M attention, the whole key axis per (cloud, head) (K5).
    Shapes as `attention_small_plain`. In bf16 a block takes 64 query rows
    of a (cloud, head); the f32 kernel takes one block per (cloud, head)."""
    if not q.is_cuda:
        return attention_small_plain(q, k, v, num_heads, scale)
    b, g, d = q.shape
    m = k.shape[1]
    dt = v.dtype
    fn = cuda.tc_route("attn_small", dt)
    require_head_width("attn_small", d, num_heads)
    if g > 512 or small_smem_bytes(g, m) > SMALL_SMEM_BYTES:
        raise ValueError(f"attn_small kernel needs G <= 512 and its f32 tiles in shared "
                         f"memory; got G={g}, M={m}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(k, "k", dt, (b, m, d))
    cuda.require(v, "v", dt, (b, m, d))
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    cuda.require_aligned(fn, q=qp, k=kp, v=vp)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    SMALL_LAUNCHES.n += 1
    cuda.launch(fn, q.device, qp, kp, vp, out.data_ptr(), b, g, m, num_heads, float(scale))
    return out


# ------------------------------------------------------------------ K6
# K6 gate: None = auto (on the card at batch >= SA_QKV_LN_MIN_BATCH, the
# JAX package's TPU threshold, kept until the card's numbers set its own:
# PERF.md); True / False force, as the JAX package's USE_SA_QKV_LN.
USE_SA_QKV_LN: bool | None = None
SA_QKV_LN_MIN_BATCH = 128
K6_ROWS_PER_BATCH = 128  # query rows of one attention batch in the f32 kernel
K6_STAGING_FLOATS = 4 * 16 * 68  # the f32 kernel's normalised-row and weight slices
QKV_TC_CHUNK = 32  # Din columns a chunk of the bf16 (tensor-core) K6


def qkv_ln_smem_bytes(g: int) -> int:
    """The f32 K6's shared memory at G rows: q/k/v [G, 65] f32, the LN
    statistics, then the larger of the staging slices and one batch's
    scores. Its G <= 178 is the gate's limit for both dtypes (the bf16
    kernel streams Din and takes G <= 192 in 86,016 bytes)."""
    head = -(-g * (3 * (KERNEL_HEAD_DIM + 1) + 2) // 4) * 4
    return 4 * (head + max(K6_STAGING_FLOATS, min(g, K6_ROWS_PER_BATCH) * (g + 1)))


def packed_small_qkv_ln_enabled(num_heads: int, qk_ch: int, v_ch: int, b: int, g: int,
                                d_in: int, training: bool, on_card: bool) -> bool:
    """Whether a SelfAttention runs K6: the JAX gate's conditions (eval, no
    pad mask, equal q/k/v widths divisible by the heads, G <= 512, Din a
    multiple of 128 and <= 1024; auto only on the card and at
    b >= SA_QKV_LN_MIN_BATCH), with the kernel's shared memory in place of
    the TPU's VMEM budget. JAX turns it off on any mesh of more than one
    device (attention.py:807-812); the port runs it on each rank's heads
    and its slices of wq|wk|wv (the comment above the gates), b being the
    rank's rows."""
    if USE_SA_QKV_LN is not None:
        if not USE_SA_QKV_LN:
            return False
    elif not on_card or b < SA_QKV_LN_MIN_BATCH:
        return False
    if training or qk_ch != v_ch or qk_ch % num_heads or g > 512:
        return False
    return d_in % 128 == 0 and d_in <= 1024 and qkv_ln_smem_bytes(g) <= SMALL_SMEM_BYTES


def attention_small_qkv_ln_plain(x, ln_w, ln_b, wq, wk, wv, num_heads: int, scale: float):
    """x raw [B, G, Din], ln_w/ln_b f32 [Din], wq/wk/wv [Din, H*dh] ->
    [B, G, H*dh] in x's dtype: LN, three projections each rounded to the
    compute dtype, then K5's attention."""
    dt = x.dtype
    xn = layer_norm_f32(x, ln_w, ln_b, dt).float()
    q, k, v = ((xn @ w.float()).to(dt) for w in (wq, wk, wv))
    return attention_small_plain(q, k, v, num_heads, scale)


def fused_attention_packed_small_qkv_ln(x, ln_w, ln_b, wq, wk, wv, *, num_heads: int,
                                        scale: float) -> torch.Tensor:
    """Eval self-attention with the pre-LN and the q/k/v projections folded
    in (K6). Shapes as `attention_small_qkv_ln_plain`."""
    if not x.is_cuda:
        return attention_small_qkv_ln_plain(x, ln_w, ln_b, wq, wk, wv, num_heads, scale)
    b, g, din = x.shape
    d = wq.shape[1]
    dt = x.dtype
    fn = cuda.tc_route("attn_small_qkv_ln", dt)
    require_head_width("attn_small_qkv_ln", d, num_heads)
    if qkv_ln_smem_bytes(g) > SMALL_SMEM_BYTES:
        raise ValueError(f"attn_small_qkv_ln kernel needs its tiles in shared memory "
                         f"(G <= 178); got G={g}")
    if dt == torch.bfloat16 and din % QKV_TC_CHUNK:
        raise ValueError(f"attn_small_qkv_ln tensor-core kernel needs Din a multiple of "
                         f"{QKV_TC_CHUNK}; got Din={din}")
    x, wq, wk, wv = x.contiguous(), wq.contiguous(), wk.contiguous(), wv.contiguous()
    ln_w = ln_w.float().contiguous()
    ln_b = ln_b.float().contiguous()
    cuda.require(x, "x", dt, (b, g, din))
    cuda.require(ln_w, "ln_w", torch.float32, (din,))
    cuda.require(ln_b, "ln_b", torch.float32, (din,))
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        cuda.require(w, name, dt, (din, d))
    ptrs = dict(x=x.data_ptr(), ln_w=ln_w.data_ptr(), ln_b=ln_b.data_ptr(), wq=wq.data_ptr(),
                wk=wk.data_ptr(), wv=wv.data_ptr())
    cuda.require_aligned(fn, **ptrs)
    out = torch.empty((b, g, d), dtype=dt, device=x.device)
    SMALL_QKV_LN_LAUNCHES.n += 1
    cuda.launch(fn, x.device, *ptrs.values(), out.data_ptr(), b, g, din, num_heads, float(scale))
    return out


# ------------------------------------------------------------ K13, K15
def attention_packed_plain(q, k, v, num_heads: int, scale: float, kv_chunk: int | None = None):
    """q [B, G, H*dh], k/v [B, M, H*dh] -> [B, G, H*dh] in v's dtype,
    streamed over kv chunks as `fused_attention_packed` (JAX
    attention.py:156-209)."""
    return _online_attention(q, _heads(k, num_heads).float(), _heads(v, num_heads), num_heads,
                             scale, v.dtype, kv_chunk)


def attention_packed_kv_plain(q, x_kv, wk, wv, num_heads: int, scale: float,
                              kv_chunk: int | None = None):
    """q [B, G, H*dh], x_kv [B, M, Din], wk/wv [Din, H*dh] -> [B, G, H*dh]
    in q's dtype: k and v f32-accumulated and rounded to the compute dtype
    (the Dense numerics, JAX attention.py:283-292), then K13's attention
    (over chunks of `kv_chunk` tokens, as `attention_packed_plain`)."""
    dt = q.dtype
    xf = x_kv.float()
    k = _heads((xf @ wk.float()).to(dt), num_heads).float()
    v = _heads((xf @ wv.float()).to(dt), num_heads)
    return _online_attention(q, k, v, num_heads, scale, dt, kv_chunk)


def fused_attention_packed(q, k, v, *, num_heads: int, scale: float) -> torch.Tensor:
    """Eval flash attention on packed layouts (K13). Shapes as
    `attention_packed_plain`; any G and M."""
    if not q.is_cuda:
        return attention_packed_plain(q, k, v, num_heads, scale)
    nsplit = packed_splits(v.dtype, q.shape[0], q.shape[1], k.shape[1], num_heads,
                           _sms(q.device))
    return fused_attention_packed_split(q, k, v, num_heads=num_heads, scale=scale, nsplit=nsplit)


def fused_attention_packed_split(q, k, v, *, num_heads: int, scale: float,
                                 nsplit: int) -> torch.Tensor:
    """K13 on CUDA tensors with its kv split given: `nsplit` blocks share
    each (cloud, head, query tile)'s kv tiles, and a merge pass combines
    their states (none at 1). `fused_attention_packed` passes the
    planner's split; chip_smoke.py forces 1 to hold the merge."""
    b, g, d = q.shape
    m = k.shape[1]
    dt = v.dtype
    fn = cuda.tc_route("attn_packed", dt)
    require_head_width("attn_packed", d, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(k, "k", dt, (b, m, d))
    cuda.require(v, "v", dt, (b, m, d))
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    cuda.require_aligned(fn, q=qp, k=kp, v=vp)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    nsplit, part_acc, part_ml = _split_scratch(q, b, g, m, num_heads, nsplit)
    PACKED_LAUNCHES.n += 1
    cuda.launch(fn, q.device, qp, kp, vp, out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                b, g, m, num_heads, nsplit, float(scale))
    return out


def fused_attention_packed_kv(q, x_kv, wk, wv, *, num_heads: int, scale: float) -> torch.Tensor:
    """Eval flash attention with the k/v projections folded in (K15).
    Shapes as `attention_packed_kv_plain`; Din <= KV_MAX_DIN, and in bf16
    (the tensor cores) a multiple of 8. The kernels are those that
    `packed_kv_plan` picks."""
    if not q.is_cuda:
        return attention_packed_kv_plain(q, x_kv, wk, wv, num_heads, scale)
    b, g, d = q.shape
    m, din = x_kv.shape[1], x_kv.shape[2]
    dt = q.dtype
    fn = kv_route("attn_packed_kv", dt, d, num_heads, din)
    q, x_kv, wk, wv = q.contiguous(), x_kv.contiguous(), wk.contiguous(), wv.contiguous()
    cuda.require(q, "q", dt, (b, g, d))
    cuda.require(x_kv, "x_kv", dt, (b, m, din))
    cuda.require(wk, "wk", dt, (din, d))
    cuda.require(wv, "wv", dt, (din, d))
    ptrs = dict(q=q.data_ptr(), x_kv=x_kv.data_ptr(), wk=wk.data_ptr(), wv=wv.data_ptr())
    cuda.require_aligned(fn, **ptrs)
    out = torch.empty((b, g, d), dtype=dt, device=q.device)
    cluster, nsplit, psplit = packed_kv_plan(dt, b, g, m, num_heads, din, _sms(q.device))
    nsplit, part_acc, part_ml = _split_scratch(q, b, g, m, num_heads, nsplit)
    scratch = [part_acc.data_ptr(), part_ml.data_ptr()]
    sizes = [b, g, m, din, num_heads, nsplit]
    if dt == torch.bfloat16:  # past a query tile on K4's passes, k and v written once
        kv = torch.empty((2, b * m, d) if not cluster and g > TC_Q_TILE else (1,), dtype=dt,
                         device=q.device)
        scratch.append(kv.data_ptr())
        sizes = [b, g, m, din, num_heads, cluster, nsplit, psplit]
    PACKED_KV_LAUNCHES.n += 1
    cuda.launch(fn, q.device, *ptrs.values(), out.data_ptr(), *scratch, *sizes, float(scale))
    return out


# ------------------------------------------------------------------ K14
HEAD_SPLIT_WIDTHS = (32, 64)  # the head widths dh and dv K14 is built for


def fused_attention_plain(q, k, v, scale: float):
    """q [B, H, G, dh], k [B, H, M, dh], v [B, H, M, dv] -> [B, H, G, dv]
    in v's dtype, as `_mha_kernel` (JAX attention.py:34-50): f32 logits,
    p = exp(logits - max) / sum in f32, rounded to v's dtype, then an
    f32-accumulated PV."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(v.dtype)


def fused_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Head-split eval attention (K14), shapes as `fused_attention_plain`,
    q, k and v in one dtype. The kernel streams k and v, so it takes any G
    and M (in place of the TPU's `fused_attention_fits` VMEM budget); it
    is built for dh and dv in HEAD_SPLIT_WIDTHS, raises at other widths,
    and has no backward, so it refuses inputs that need a gradient."""
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, scale)
    b, h, g, dh = q.shape
    m, dv = k.shape[2], v.shape[3]
    dt = v.dtype
    fn = cuda.tc_route("mha", dt)
    if dh not in HEAD_SPLIT_WIDTHS or dv not in HEAD_SPLIT_WIDTHS:
        raise NotImplementedError(f"the mha kernel is built for dh, dv in {HEAD_SPLIT_WIDTHS}; "
                                  f"got dh={dh}, dv={dv}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the mha kernel is an eval kernel with no backward")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda.require(q, "q", dt, (b, h, g, dh))
    cuda.require(k, "k", dt, (b, h, m, dh))
    cuda.require(v, "v", dt, (b, h, m, dv))
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    cuda.require_aligned(fn, q=qp, k=kp, v=vp)
    out = torch.empty((b, h, g, dv), dtype=dt, device=q.device)
    HEAD_SPLIT_LAUNCHES.n += 1
    cuda.launch(fn, q.device, qp, kp, vp, out.data_ptr(), b * h, g, m, dh, dv, float(scale))
    return out


def fused_attention_enabled(dropout_rate: float, training: bool) -> bool:
    """Whether a head-split attention runs K14: the JAX gate's conditions
    (attention.py:104-122): no dropout in train mode, then
    USE_FUSED_ATTENTION where it is forced, else False (its auto policy,
    measured a tie on the TPU; the port keeps it, on the card too). Its
    other conditions have no counterpart here: its attention sites take no
    padding mask, and where JAX turns it off on any mesh of more than one
    device (attention.py:107-109) the port runs it on each rank's own
    heads (the comment above the gates)."""
    if dropout_rate > 0.0 and training:
        return False
    if USE_FUSED_ATTENTION is not None:
        return USE_FUSED_ATTENTION
    return False


# -------------------------------------------------------------- gates
# Tensor parallelism (parallel/): every gate below is called with the heads
# and widths the calling layer holds, H / T heads and their slices of the
# weights on a model rank where `tp_heads_shardable` let the layer shard
# (JAX runs the same kernels on local heads under shard_map, shard.py:
# 143-216), all H where it did not (JAX falls back to XLA's attention
# there; the port keeps the kernel on whole heads, the same result). JAX
# turns K6 and K14 off on any mesh of more than one device, for want of a
# shard_map wrapper (attention.py:807-812 and :104-109), not of math; the
# port keeps both live on each rank's heads (and, as on the data axis, no
# gate reads the world size). tests/test_torch_tensor_parallel.py holds the
# routes' results against the one-process forward.


def tp_heads_shardable(num_heads: int, packed_dim: int, t: int) -> bool:
    """Whether a packed [B, N, H*dh] attention splits over a model axis of
    T as whole heads (JAX shard.py:143-151): H and the packed width
    divide T."""
    return t == 1 or (num_heads % t == 0 and packed_dim % t == 0)

def small_smem_bytes(g: int, m: int) -> int:
    """The f32 K5's shared memory: q/k/v rows of 65 f32 and the [G, M+1]
    scores. The gate holds both routes to it, and the bf16 kernel takes
    every (G, M) it admits (M < 512)."""
    return 4 * ((g + 2 * m) * (KERNEL_HEAD_DIM + 1) + g * (m + 1))


def packed_attention_enabled(num_heads: int, qk_ch: int, v_ch: int, m: int,
                             dropout_rate: float, training: bool, on_card: bool) -> bool:
    """Whether an attention runs K13 (JAX attention.py:546-576): no
    dropout in train mode, equal q/k and v widths divisible by the heads;
    auto on the card at M >= 512 whose TPU chunk (`_kv_chunk_for`) is at
    least 256 tokens. No condition on the head width: the kernel raises at
    one it is not built for (`require_head_width`). Under tensor
    parallelism the heads and widths are the rank's own (as JAX's
    `attention_sharded_call`; the comment above the gates)."""
    if dropout_rate > 0.0 and training:
        return False
    if qk_ch != v_ch or qk_ch % num_heads:
        return False
    if USE_FUSED_ATTENTION is not None:
        return USE_FUSED_ATTENTION
    return on_card and m >= 512 and _kv_chunk_for(m) >= 256


def packed_attention_kv_enabled(num_heads: int, qk_ch: int, v_ch: int, m: int, d_in: int,
                                dropout_rate: float, training: bool, on_card: bool) -> bool:
    """Whether an eval attention runs with its k/v projections folded in
    (JAX attention.py:515-543): K4 at a CrossAttention, K15 at a
    MultiHeadAttention. K13's gate, eval only, and raw tokens Din a
    multiple of 128 and at most KV_MAX_DIN (the kernels keep a chunk of
    them in shared memory). Under tensor parallelism the heads, widths
    and wk / wv columns are the rank's own (JAX's
    `kv_attention_sharded_call`)."""
    if training:
        return False
    if not packed_attention_enabled(num_heads, qk_ch, v_ch, m, dropout_rate, training, on_card):
        return False
    return d_in % 128 == 0 and d_in <= KV_MAX_DIN


def packed_small_attention_enabled(num_heads: int, qk_ch: int, v_ch: int, g: int, m: int,
                                   dropout_rate: float, training: bool, on_card: bool) -> bool:
    """Whether an eval attention runs K5 (JAX attention.py:826-855): eval,
    equal q/k and v widths divisible by the heads; auto on the card at
    M < 512 and G <= 512, with its tiles in shared memory (in place of the
    TPU's VMEM budget); none on the head width, as for K13. Under tensor
    parallelism the heads and widths are the rank's own."""
    if training or qk_ch != v_ch or qk_ch % num_heads:
        return False
    if USE_FUSED_ATTENTION is not None:
        return USE_FUSED_ATTENTION
    if not on_card:
        return False
    return m < 512 and g <= 512 and small_smem_bytes(g, m) <= SMALL_SMEM_BYTES
