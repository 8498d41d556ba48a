"""K7's bf16 forward and K10's forward as their CUDA kernels cut the
work, mirrored on the CPU (no card, no JAX).

K7's bf16 forward runs K4's tile kernel (csrc/kv_tile.cuh) with the
dropout and the log-sum-exp: per (cloud, head, kv split) it projects each
64-token tile of the normalised tokens onto k|v, rounds them to the
compute dtype, and runs the online softmax over the tile (logits in log2
units, l summing the undropped p, then each p kept times 1 / (1 - rate)
or dropped by its keep bit, rounded, P.V); a split writes its (m, l, acc)
state and the merge pass gives out and lse. The mirror below follows that
order and is held against the twin (`attention_kv_fwd_plain`); the split
plan, the shared memory of the kernel's instances and the wrapper's
refusals are checked as the wrapper computes them.

K10's forward gives a warp a run of consecutive output rows, lane = row;
the mirror stages each run's rows and stores its 16-byte pieces and the
last run's ragged end as the kernel does, so every output element is
written once, with the twin's value.
"""

import math

import numpy as np
import pytest
import torch

from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import flash_train as kf
from vipformer_tpu_torch.ops.cuda import gather as kg

SMS = 132  # the H100 SXM's SMs
SM_SHARED_BYTES = 233472  # an SM's shared memory (228 KB)
BLOCK_RESERVED_BYTES = 1024  # the shared memory the runtime keeps a block
TILE = 64  # tokens a tile (kattn.TC_TILE_TOKENS)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _t(rng, shape, dt=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)


def _k7_args(rng, b, g, m, din, h, dt):
    d = 64 * h
    return (_t(rng, (b, g, d), dt), _t(rng, (b, m, din), dt), _t(rng, (din,), scale=0.2) + 1.0,
            _t(rng, (din,), scale=0.1), _t(rng, (din, d), dt, din ** -0.5),
            _t(rng, (din, d), dt, din ** -0.5))


def _tile_order_kv_fwd(q, x, ln_w, ln_b, wk, wv, seed, h, scale, rate, nsplit):
    """K7's bf16 forward in the tile kernel's order: the tiles of each
    split in turn, each projected on its own (f32 sums rounded to the
    compute dtype), the online softmax in log2 units, the keep bit of
    (b*H + head, query row, key column) after l has summed p, p rounded,
    P.V; one split writes out and lse, more their states for the merge."""
    dt = q.dtype
    b, g, d = q.shape
    m = x.shape[1]
    xn = kf.ln_kv_plain(x, ln_w, ln_b)[2].to(dt).float()
    qh = kf._heads(q, h)  # [B, H, G, 64]
    keep = (kf.keep_mask_plain(seed, b * h, g, m, rate).view(b, h, g, m) if rate > 0
            else torch.ones((b, h, g, m), dtype=torch.bool))
    inv_keep = 1.0 / kf.keep_scale(rate)
    tiles = -(-m // TILE)
    per = -(-tiles // nsplit)
    states = []
    for sp in range(nsplit):
        mx = torch.full((b, h, g), -math.inf)
        l = torch.zeros((b, h, g))
        o = torch.zeros((b, h, g, 64))
        for t in range(sp * per, min(tiles, (sp + 1) * per)):
            lo, hi = t * TILE, min(m, (t + 1) * TILE)
            k = kf._heads((xn[:, lo:hi] @ wk.float()).to(dt), h)
            v = kf._heads((xn[:, lo:hi] @ wv.float()).to(dt), h)
            s = (qh @ k.transpose(-1, -2)) * (scale * LOG2E)
            nm = torch.maximum(mx, s.amax(-1))
            corr = torch.exp2(mx - nm)
            p = torch.exp2(s - nm[..., None])
            l = l * corr + p.sum(-1)
            p = torch.where(keep[..., lo:hi], p * inv_keep, torch.zeros_like(p))
            o = o * corr[..., None] + p.to(dt).float() @ v
            mx = nm
        states.append((mx * LN2, l, o))
    if nsplit == 1:
        m_nat, l, o = states[0]
        return kf._merge(o / l[..., None]).to(dt), m_nat + torch.log(l)
    big = torch.stack([st[0] for st in states]).amax(0)
    w = [torch.exp(st[0] - big) for st in states]
    l = sum(st[1] * wi for st, wi in zip(states, w))
    acc = sum(st[2] * wi[..., None] for st, wi in zip(states, w))
    return kf._merge(acc / l[..., None]).to(dt), big + torch.log(l)


# (B, G, M, Din, H): tokens on and off the 64-token tiles, Din of the
# tile (<= 256), double-buffered (<= 384) and stream (> 384) kernels
K7_MIRROR_CASES = [(2, 37, 200, 64, 2), (1, 16, 128, 128, 1), (2, 20, 130, 384, 2),
                   (1, 9, 257, 512, 1)]


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,din,h", K7_MIRROR_CASES)
def test_k7_tile_order_computes_the_twin(b, g, m, din, h, dt, rate, nsplit):
    """The tile kernel's order, with 1-3 kv splits merged as the merge pass
    merges them, computes the twin's out and lse: lse within 1e-5 (f32
    sums in another order, exp2 of log2 units); out in f32 within 1e-5 of
    its largest value, in bf16 within what rounding p to bf16 against the
    running max rather than the global one can move (2^-8 of each p, so
    2^-8 of max|v| / (1 - rate)) and one rounding of the output (2^-8 of
    max|out|)."""
    rng = np.random.default_rng(17)
    args = _k7_args(rng, b, g, m, din, h, dt)
    seed = torch.tensor([4242], dtype=torch.int32)
    got, lse = _tile_order_kv_fwd(*args, seed, h, 0.125, rate, nsplit)
    want, lse_w = kf.attention_kv_fwd_plain(*args, seed, h, 0.125, rate)
    assert got.shape == want.shape and got.dtype == want.dtype and lse.shape == lse_w.shape
    assert ((lse - lse_w).abs() <= 1e-5 * lse_w.abs().clamp_min(1.0)).all()
    err = (got.float() - want.float()).abs().max().item()
    if dt == torch.float32:
        assert err <= 1e-5 * max(1.0, want.abs().max().item())
    else:
        vmax = kf.kv_project_plain(*args[1:])[1].float().abs().max().item()
        assert err <= 2 ** -8 * (vmax / kf.keep_scale(rate) + want.float().abs().max().item())


# (B, G, M, Din, H) of K7's forward on the driven paths: pretrain's point
# and image branches, ft_cls, partseg, semseg, the Perceiver decoder's one
# query; then token counts off the tiles and the widest Din
K7_PLAN_CASES = [(96, 128, 2048, 256, 4), (48, 128, 144, 256, 4), (330, 128, 1024, 256, 4),
                 (96, 128, 1024, 384, 6), (32, 128, 4096, 384, 6), (330, 1, 128, 256, 4),
                 (7, 100, 1000, 512, 8), (3, 128, 65, 1024, 16), (2, 200, 300, 256, 4)]


@pytest.mark.parametrize("b,g,m,din,h", K7_PLAN_CASES)
def test_k7_forward_split_plan_covers_every_token_once(b, g, m, din, h):
    """K7's bf16 forward splits its 64-token tiles as K4's planner splits
    K4's tile kernel at the same shapes (the same kernels, the same blocks
    an SM; how that plan fills the card is test_k4_tc_plan_covers_every_
    token_once's): ceil(tiles / n) tiles a split, every token in one
    split, none empty. Past one query tile (the projection, then K8's
    forward) nothing is split."""
    fn, nsplit = kf.kv_fwd_plan(torch.bfloat16, b, g, m, din, 64 * h, h, SMS)
    assert fn == "attn_train_kv_fwd_tc_bf16"
    if g > kattn.TC_Q_TILE:
        assert nsplit == 1
        return
    assert nsplit == kattn.kv_ln_plan(torch.bfloat16, b, g, m, h, din, SMS)[0]
    tiles = -(-m // TILE)
    per = -(-tiles // nsplit)
    spans = [(sp * per * TILE, min(m, (sp + 1) * per * TILE)) for sp in range(nsplit)]
    assert spans[0][0] == 0 and spans[-1][1] == m
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    assert kf.kv_fwd_plan(torch.float32, b, g, m, din, 64 * h, h, SMS) == ("attn_train_kv_fwd_f32", 1)


@pytest.mark.parametrize("din", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_k7_forward_instances_fit_their_blocks_an_sm(din):
    """K7's instances of the tile kernel (`<256, false, true, true>`, two
    blocks an SM; `<384, true, true, true>`, one) and of the stream kernel
    (`<true, true>`, two) take K4's shared memory at every Din K7's gate
    admits (multiples of 128 up to 1,024): the dropout and the log-sum-exp
    live in registers. It fits the blocks an SM their launch bounds say,
    and the merge pass uses none."""
    smem = kattn.kv_ln_tc_smem_bytes(din)
    blocks = kattn.kv_ln_blocks_per_sm(din)
    assert blocks == (1 if 256 < din <= 384 else 2)
    assert 48 * 1024 < smem <= 232448
    assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert smem == {128: 103424, 256: 103424, 384: 204800}.get(din, 97280)


@pytest.mark.parametrize("case,exc,match", [
    ("din_above", ValueError, "Din <= 1024"),
    ("din_step", NotImplementedError, "multiple of 32"),
    ("head_width", NotImplementedError, "dh=64"),
    ("empty_split", ValueError, "cannot split"),
    ("too_many_splits", ValueError, "cannot split"),
    ("no_split", ValueError, "cannot split"),
    ("dtype", TypeError, "float32 or bfloat16"),
])
def test_k7_forward_refuses_what_its_kernels_do_not_take(case, exc, match):
    """Before any launch (and before the kernels are built), K7's forward
    plan refuses in bf16 a Din above 1,024 or not a multiple of 32 (the
    backward's projection takes 32-column stages, and its k|v must be the
    tile kernel's), a head width other than 64, and a kv split that leaves
    a split empty (5 tiles in 4: 2, 2, 1 and none) or asks for more splits
    than tiles, or none; another dtype has no kernel."""
    b, g, m, din, d, h, nsplit, dt = 2, 128, 320, 256, 256, 4, 1, torch.bfloat16
    if case == "din_above":
        din = 1152
    elif case == "din_step":
        din = 200
    elif case == "head_width":
        d = 384
    elif case == "empty_split":
        nsplit = 4
    elif case == "too_many_splits":
        nsplit = 6
    elif case == "no_split":
        nsplit = 0
    elif case == "dtype":
        dt = torch.float16
    with pytest.raises(exc, match=match):
        kf.kv_fwd_plan(dt, b, g, m, din, d, h, SMS, nsplit)
    assert kf.kv_fwd_plan(torch.float32, b, g, m, 1152, 256, 4, SMS) == ("attn_train_kv_fwd_f32", 1)
    assert kcuda._lib is None


# ------------------------------------------------------------------ K10
GC_WARPS, GC_ROWS = 8, 2  # csrc/gather.cu


def _slot_bytes(run: int, c: int, s: int, size: int) -> int:
    """csrc/gather.cu gc_slot_bytes: a warp's staged output, then its
    groups' centers (3 floats each, at most run / S + 2 groups)."""
    return (run * c * size + 15) // 16 * 16 + (12 * (run // s + 2) + 15) // 16 * 16


def _warp_run_gather(points, centers, idx, s):
    """K10's forward as its warps cut it: runs of `centered_run_rows`
    output rows, lane = row (2 a lane), each group's center read once into
    the warp's shared memory, the rows' channels gathered 4 (C <= 4) or 8
    at a time and
    staged, then the run's bytes out 16 a lane and the last run's ragged
    end element by element; returns the output and how often each element
    was written."""
    dt = points.dtype
    b, n, c = points.shape
    gnum = centers.shape[1]
    k, size = gnum * s, points.element_size()
    total, u = b * k, 16 // size
    run = kg.centered_run_rows(c, size)
    assert run % 8 == 0 and 8 <= run <= 32 * GC_ROWS and run * c * size <= 4096
    assert GC_WARPS * _slot_bytes(run, c, s, size) <= 48 * 1024  # no opt-in needed
    pts = points.reshape(-1).float()
    cz = centers[..., :3].to(dt).float().reshape(-1)
    flat = idx.reshape(-1).long()
    out = torch.zeros(total * c)
    writes = torch.zeros(total * c, dtype=torch.int64)
    for row0 in range(0, total, run):
        rows = min(run, total - row0)
        assert (row0 * c * size) % 16 == 0  # the run starts on a 16-byte boundary
        g_lo = row0 // s
        ng = (row0 + rows - 1) // s - g_lo + 1
        assert 3 * ng * 4 <= _slot_bytes(run, c, s, size) - (run * c * size + 15) // 16 * 16
        cen = cz[3 * g_lo:3 * (g_lo + ng)]  # each group's center once
        stage = torch.zeros(rows * c)
        for lane in range(32):
            for i in range(GC_ROWS):
                r = lane + 32 * i
                if r >= rows:
                    continue
                row = row0 + r
                pofs = (row // k * n + int(flat[row])) * c
                cj = 3 * (row // s - g_lo)
                chunk = 4 if c <= 4 else 8  # the kernel's CHUNK
                for c0 in range(0, c, chunk):
                    for ch in range(c0, min(c, c0 + chunk)):
                        v = pts[pofs + ch]
                        stage[r * c + ch] = v - cen[cj + ch] if ch < 3 else v
        e0, nel = row0 * c, rows * c
        pieces = nel // u
        for q in range(pieces):  # lane q % 32 stores 16 bytes
            out[e0 + q * u:e0 + (q + 1) * u] = stage[q * u:(q + 1) * u]
            writes[e0 + q * u:e0 + (q + 1) * u] += 1
        for e in range(pieces * u, nel):
            out[e0 + e] = stage[e]
            writes[e0 + e] += 1
    return out.view(b, k, c).to(dt), writes


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 6])
@pytest.mark.parametrize("s", [16, 24, 32, 64])
def test_k10_warp_runs_take_every_row_once(s, c, dt):
    """Every output element of K10's forward lies in one warp's run and is
    written once (a 16-byte piece, or the last run's ragged end), with the
    twin's value bit for bit, at the group sizes around 32 and the driven
    C = 3 (xyz) and 6 (xyz + rgb); the row count (3 clouds of 13 groups)
    leaves the last warp's run and the last block ragged, and runs cross
    group and cloud boundaries."""
    rng = np.random.default_rng(10)
    b, gnum, n = 3, 13, 100
    points, centers = _t(rng, (b, n, c), dt), _t(rng, (b, gnum, 3))
    idx = torch.from_numpy(rng.integers(0, n, (b, gnum * s)).astype(np.int32))
    got, writes = _warp_run_gather(points, centers, idx, s)
    assert (writes == 1).all()
    assert torch.equal(got, kg.gather_centered_plain(points, centers, idx, s))


@pytest.mark.parametrize("c,size,run", [(3, 2, 64), (6, 2, 64), (3, 4, 64), (6, 4, 64),
                                        (17, 4, 56), (64, 2, 32), (128, 2, 16), (128, 4, 8),
                                        (1, 2, 64)])
def test_k10_run_rows(c, size, run):
    """A run's rows: 64 (2 a lane; two groups of the driven 32) where the
    staged output fits 4 KB, else as many as fit, rounded down to a
    multiple of 8; at least 8 for every C up to 128 in either dtype."""
    assert kg.centered_run_rows(c, size) == run


@pytest.mark.parametrize("b,n,c,match", [
    (1, 10, 129, "C <= 128"),
    (2048, 2 ** 20, 3, "32-bit"),
    (2 ** 16, 64, 128, "32-bit"),
])
def test_k10_refuses_what_its_kernel_does_not_take(b, n, c, match):
    """Before any launch, K10's forward refuses more than 128 channels and
    points or outputs of 2^31 elements or more (32-bit offsets); the
    driven shapes pass."""
    with pytest.raises(ValueError, match=match):
        kg.check_centered_sizes(b, n, c, 16384)
    for shape in ((96, 2048, 3, 4096), (330, 1024, 3, 4096), (32, 4096, 6, 4096)):
        kg.check_centered_sizes(*shape)
    assert kcuda._lib is None
