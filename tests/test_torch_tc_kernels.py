"""The tensor-core routes of K5, K6, K7, K8's forward and backward and
K11, on the CPU: which entry point each dtype reaches, and how the
wrappers plan the kernels' grids; and the split plans of K17's and K18's
one-pass backwards.

The bf16 K5 (`tc::attn_small_tc_kernel`), K6
(`tc::attn_small_qkv_ln_tc_kernel`), K8's forward
(`tc::flash_fwd_tc_kernel`) and K11 (`tc::dense_grads_tc_kernel`) run
only on the card, where tests/test_torch_port_cuda.py and chip_smoke.py
hold them against their twins. What decides their launches is Python,
and is checked here: the route is a pure function of the dtype; K11's
split of the rows covers every row once with no split empty and fills one
wave of 132 SMs (two blocks an SM, no second wave) where R has the row
steps; K5's shared memory fits one block at every (G, M) the gate admits,
K6's two blocks an SM at every (G, Din) it admits.
"""

import pytest
import torch

from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import dense as kdense

SMS = 132  # the H100 SXM's SMs


def small_tc_smem_bytes(m: int) -> int:
    """The bf16 K5's shared memory (csrc/attention.cu `small_smem_bytes`):
    64 query rows and the whole k and v, M rounded up to 64-token tiles,
    rows of 64 + 8 bf16."""
    return 2 * (64 + 8) * (64 + 2 * 64 * -(-m // 64))


def qkv_tc_smem_bytes(g: int) -> int:
    """The bf16 K6's shared memory (csrc/attention.cu `qkv_smem_bytes`):
    f32 mean and 1/std of the block's rows (128 at G <= 128, else 192),
    then a 3-stage ring of 32-column chunks of x (rows of 32 + 8 bf16) and
    of [wq|wk|wv] (32 rows of 192 + 8 bf16); Din streams, so it does not
    enter."""
    rows = 128 if g <= 128 else 192
    return 4 * 2 * rows + 2 * 3 * (rows * (32 + 8) + 32 * (192 + 8))


# (base, dtype, entry point): bf16 on the tensor cores, f32 on the CUDA cores
ROUTES = [("dense_grads", torch.bfloat16, "dense_grads_tc_bf16"),
          ("dense_grads", torch.float32, "dense_grads_f32"),
          ("attn_small", torch.bfloat16, "attn_small_tc_bf16"),
          ("attn_small", torch.float32, "attn_small_f32"),
          ("attn_small_qkv_ln", torch.bfloat16, "attn_small_qkv_ln_tc_bf16"),
          ("attn_small_qkv_ln", torch.float32, "attn_small_qkv_ln_f32"),
          ("attn_train_fwd", torch.bfloat16, "attn_train_fwd_tc_bf16"),
          ("attn_train_fwd", torch.float32, "attn_train_fwd_f32"),
          ("attn_train_bwd", torch.bfloat16, "attn_train_bwd_tc_bf16"),
          ("attn_train_bwd", torch.float32, "attn_train_bwd_f32"),
          ("attn_train_kv_fwd", torch.bfloat16, "attn_train_kv_fwd_tc_bf16"),
          ("attn_train_kv_fwd", torch.float32, "attn_train_kv_fwd_f32"),
          ("attn_train_kv_bwd", torch.bfloat16, "attn_train_kv_bwd_tc_bf16"),
          ("attn_train_kv_bwd", torch.float32, "attn_train_kv_bwd_f32")]


@pytest.mark.parametrize("base,dt,want", ROUTES)
def test_dtype_route_of_dense_grads_and_attn_small(base, dt, want):
    """K11, K5, K6 and K8's forward and backward: the dtype picks the entry
    point, which the library declares; the CUDA-core bf16 entry points are
    gone; any other dtype raises."""
    assert kcuda.tc_route(base, dt) == want
    assert want in kcuda.SIGNATURES
    assert f"{base}_bf16" not in kcuda.SIGNATURES
    for other in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kcuda.tc_route(base, other)


def test_tensor_core_operands_must_be_aligned():
    """The 16-byte cp.async of the tensor-core routes: a bf16 operand that
    starts off a 16-byte boundary is refused; the f32 routes take any."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    kcuda.require_aligned("dense_grads_tc_bf16", x=x.data_ptr())
    with pytest.raises(ValueError, match="16-byte boundary"):
        kcuda.require_aligned("dense_grads_tc_bf16", x=x[1:].data_ptr())
    kcuda.require_aligned("dense_grads_f32", x=torch.zeros(64)[1:].data_ptr())


# (R, Cin, Cout): the ft_cls step's sites (42,240 latent rows; the
# Perceiver's ft_cls has the same rows and widths), partseg's (98,304 point
# rows), semseg's (131,072), the odd row count chip_smoke.py checks, and
# forced R below one step and below one wave
DENSE_PLANS = ([(42240, ci, co) for ci, co in ((3, 128), (128, 256), (256, 256), (256, 512),
                                               (512, 256))]
               + [(98304, ci, co) for ci, co in ((3, 64), (64, 384), (1024, 512), (512, 256),
                                                 (256, 50))]
               + [(131072, ci, co) for ci, co in ((6, 64), (64, 384), (1024, 512), (512, 256),
                                                  (256, 13))]
               + [(16411, 3, 128), (16411, 256, 256), (128, 256, 256), (100, 130, 70),
                  (1, 3, 5)])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,cin,cout", DENSE_PLANS)
def test_dense_split_plan_covers_every_row_once(r, cin, cout, dt):
    """K11's row splits on 132 SMs, as the kernel cuts them: whole steps a
    split, every row once, no split empty; one wave of blocks (two an SM,
    within one dW tile row of full, a block on every SM) where R has the
    steps for it, else one split a step."""
    tm, tn, step = kdense.TILES[dt]
    splits = kdense.plan_splits(r, cin, cout, dt, SMS)
    rows = kdense.split_rows(r, splits, step)
    assert len(rows) == splits and rows[0][0] == 0 and rows[-1][1] == r
    assert all(lo < hi and lo % step == 0 for lo, hi in rows)
    assert all(hi == lo for (_, hi), (lo, _) in zip(rows, rows[1:]))
    steps, tiles = -(-r // step), -(-cin // tm) * -(-cout // tn)
    wave = kdense.BLOCKS_PER_SM * SMS
    if tiles * steps >= wave:  # one split a step would fill a wave
        assert wave - tiles < tiles * splits <= wave
        assert tiles * splits >= SMS
    else:
        assert splits == steps


@pytest.mark.parametrize("g", [1, 16, 129, 512])
def test_small_attention_gate_admits_only_what_the_tc_kernel_takes(g):
    """The gate keeps the f32 kernel's shared-memory condition; at the
    largest M it admits for each G, the bf16 kernel's q tile, k and v fit
    one block."""
    m = max(mm for mm in range(1, 512)
            if kattn.small_smem_bytes(g, mm) <= kattn.SMALL_SMEM_BYTES)
    assert small_tc_smem_bytes(m) <= kattn.SMALL_SMEM_BYTES


# the gate's G from one row to its largest (178, the f32 kernel's shared
# memory), about the 128 rows of the bf16 kernel's register-score mode
QKV_GS = (1, 64, 128, 129, 178)
QKV_DINS = (128, 256, 384, 1024)
SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory
BLOCK_RESERVED_BYTES = 1024  # what the card keeps of it for each resident block


@pytest.mark.parametrize("din", QKV_DINS)
@pytest.mark.parametrize("g", QKV_GS)
def test_qkv_ln_tc_kernel_fits_two_blocks_an_sm(g, din):
    """At every (G, Din) the K6 gate admits, the bf16 kernel's shared
    memory lets two blocks share an SM, and at the main paths' G <= 128
    three; the gate's answer there is yes (on the card, in eval, B >= 128)
    and at one row more than 178, no."""
    assert kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, g, din, False, True)
    per_block = qkv_tc_smem_bytes(g) + BLOCK_RESERVED_BYTES
    assert qkv_tc_smem_bytes(g) <= kattn.SMALL_SMEM_BYTES
    assert (3 if g <= 128 else 2) * per_block <= SM_SHARED_BYTES
    assert din % kattn.QKV_TC_CHUNK == 0
    assert not kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, 179, din, False, True)


def flash_bwd_tc_smem_bytes() -> dict[str, int]:
    """The bf16 K8 backward's shared memory (csrc/flash_train.cu
    `bwd_kv_smem`, `TC_BWD_Q_SMEM`), rows of 64 + 8 bf16. The kv-row
    kernel holds its k and v rows (64 at M > 128; all 128 at M <= 128,
    where it also keeps dS^T of a query tile) and a 3-stage ring of 64-row
    q and dO tiles with each query row's lse, delta and dropout key (4
    bytes each); the dQ pass its 64 q and dO rows and a 3-stage ring of k
    and v tiles."""
    row, stages, rows_meta = 2 * (64 + 8), 3, 4 * 3 * 3 * 64
    return {"kv": row * (2 * 64 + 2 * stages * 64) + rows_meta,
            "fused": row * (3 * 128 + 2 * stages * 64) + rows_meta,
            "dq": row * (2 * 64 + 2 * stages * 64)}


def test_flash_bwd_tc_kernels_fit_two_blocks_an_sm():
    """Every kernel of the bf16 K8 backward takes at most half of what a
    block may use (227 KB), so at least two blocks share an SM (the two
    4-warp passes three); the fused kernel serves M up to its 8 warps' 128
    kv rows, and the tiles cover every kv and query row of the shapes the
    port runs, with the last tile ragged where 64 does not divide (G = 1,
    M = 130, 144, 2,048, 20,736)."""
    block_max = 227 * 1024
    smem = flash_bwd_tc_smem_bytes()
    for name, n in smem.items():
        assert n <= block_max // 2
        assert (2 if name == "fused" else 3) * (n + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert smem["kv"] == 76032 and smem["fused"] == 112896 and smem["dq"] == 73728
    for n in (1, 70, 128, 130, 144, 2048, 20736):
        tiles = -(-n // 64)
        assert (tiles - 1) * 64 < n <= tiles * 64


# (R, D): the LN_SHAPES of chip_smoke.py (semseg latents, the input
# adapter, the Fourier tokens), a few rows, widths that share a row between
# warps (up to the JAX gate's widest bf16 1,638 and 2,048), and R below one
# row a slot of a block
LN_PLANS = [(4096, 384), (131072, 64), (995328, 261), (3, 33), (256, 2048), (517, 1638),
            (300, 1024), (1, 7), (20, 600)]


@pytest.mark.parametrize("r,d", LN_PLANS)
def test_layernorm_bwd_split_plan_covers_every_row_once(r, d):
    """K17's backward on 132 SMs: the splits cut the rows into contiguous
    slices that cover every row once, none empty, at most one block an
    SM and no more than the rows fill (a row for each row slot); the groups
    of the two-level sum cover every split once, about sqrt(splits) each,
    and the counters fit the wrapper's buffer."""
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    per, splits, group = kln.bwd_plan(r, d, SMS)
    rows = kln.split_rows(r, per)
    assert len(rows) == splits <= SMS
    assert rows[0][0] == 0 and rows[-1][1] == r
    assert all(lo < hi for lo, hi in rows)
    assert all(hi == lo for (_, hi), (lo, _) in zip(rows, rows[1:]))
    slots = kln.BWD_WARPS // kln.warps_per_row(d)
    assert splits <= -(-r // slots)  # no more blocks than the rows fill
    ngroups = -(-splits // group)
    assert (group - 1) ** 2 < splits <= group * group
    assert sorted(i for g in range(ngroups)
                  for i in range(g * group, min(splits, (g + 1) * group))) == list(range(splits))
    assert ngroups + 1 <= 256
    assert d <= kln.LANE_COLS * 32 * kln.warps_per_row(d)


@pytest.mark.parametrize("d,itemsize,want", [(384, 2, 8), (384, 4, 4), (64, 2, 2), (64, 4, 2),
                                             (261, 2, 1), (261, 4, 1), (33, 4, 1), (7, 2, 1),
                                             (1638, 2, 2), (2048, 4, 4)])
def test_layernorm_bwd_vector_width(d, itemsize, want):
    """The backward's vector: the widest of at most 16 bytes that divides D
    and leaves every lane a vector; a pointer off that boundary narrows
    it."""
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    assert kln.vec_for(d, itemsize, 0, 256) == want
    assert kln.vec_for(d, itemsize, itemsize) == 1


# ----------------------------------------------- K7's bf16 products, K18


# K7's token rows (B * M) on the paths chip_smoke.py runs: the pretrain
# points and partseg (96 x 2,048), the mp image branch (48 x 144), ft_cls
# at B = 330 (330 x 1,024), semseg (32 x 4,096), the Perceiver decoder's
# single query over 128 latents (330 x 128); and a ragged few
K7_ROWS = (196608, 6912, 337920, 131072, 42240, 1000, 1)
K7_DINS = (128, 256, 384, 1024)
K7_DS = (256, 384)  # D = H * 64: the flagship's 4 heads, partseg's and semseg's 6


def _tiles(n: int, tile: int) -> list[tuple[int, int]]:
    """The [lo, hi) of each tile of `tile` over n, the last one masked at n."""
    return [(lo, min(n, lo + tile)) for lo in range(0, n, tile)]


def _covers_once(spans, n: int) -> bool:
    return (spans[0][0] == 0 and spans[-1][1] == n and all(lo < hi for lo, hi in spans)
            and all(hi == lo for (_, hi), (lo, _) in zip(spans, spans[1:])))


@pytest.mark.parametrize("d", K7_DS)
@pytest.mark.parametrize("din", K7_DINS)
@pytest.mark.parametrize("rows", K7_ROWS)
def test_k7_tc_plans_cover_every_row_and_column_once(rows, din, d):
    """The grids of K7's bf16 products (csrc/flash_train.cu tc), as the
    launches lay them out: the k|v projection's blocks tile [rows, 2D] and
    dx's [rows, Din] in 128 x 128 tiles, every row, Din column and 2D
    column once (2D a whole number of tiles, the last row and Din tiles
    masked); their contractions (Din, then 2D, in 32-column stages) a whole
    number of stages; the weight gradients' [Din, 2D] tiles each take the
    token rows in K11's splits (whole 32-row steps, every row once, none
    empty, one wave of two blocks an SM on 132 SMs where the rows allow)."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    tile, step = 128, kf.KV_TC_STEP  # the kernels' output tile (PJ_BM = PJ_BN)
    assert (2 * d) % tile == 0 and din % step == 0 and (2 * d) % step == 0
    for n in (rows, din, 2 * d):
        assert _covers_once(_tiles(n, tile), n)
    assert sum(hi - lo for lo, hi in _tiles(2 * d, tile)) == 2 * d
    splits = kf.wgrad_splits(rows, din, d, SMS)
    spans = kdense.split_rows(rows, splits, step)
    assert len(spans) == splits and _covers_once(spans, rows)
    assert all(lo % step == 0 for lo, _ in spans)
    tiles = len(_tiles(din, tile)) * len(_tiles(2 * d, tile))
    steps = -(-rows // step)
    assert splits <= steps
    if tiles * steps >= kdense.BLOCKS_PER_SM * SMS:
        assert tiles * splits >= SMS
    assert tiles * splits <= max(tiles, kdense.BLOCKS_PER_SM * SMS)


def k7_tc_smem_bytes() -> dict[str, int]:
    """The shared memory of K7's bf16 product kernels (csrc/flash_train.cu
    `PJ_KV_SMEM`, `PJ_DX_SMEM`, `PJ_DW_SMEM`): a 4-stage ring of bf16
    tiles, rows padded by 8: the projection's 128 rows of 32 xn columns
    and 32 weight rows of 128 columns; dx's 128 rows of 32 dk|dv columns
    and 128 weight rows of 32; the weight gradients' 32 token rows of 128
    xn columns and of 128 dk|dv columns."""
    stages, ldk, ldn = 4, 32 + 8, 128 + 8
    return {"kv_proj": 2 * stages * (128 * ldk + 32 * ldn),
            "dxn": 2 * stages * (128 + 128) * ldk,
            "dw": 2 * stages * 32 * 2 * ldn}


@pytest.mark.parametrize("kernel", ["kv_proj", "dxn", "dw"])
def test_k7_tc_kernels_fit_two_blocks_an_sm(kernel):
    """Each of K7's bf16 product kernels takes dynamic shared memory above
    48 KB (so its launch sets cudaFuncAttributeMaxDynamicSharedMemorySize)
    and at most half of an SM's, so that two blocks (its launch bounds)
    share an SM."""
    n = k7_tc_smem_bytes()[kernel]
    assert 48 * 1024 < n <= 227 * 1024
    assert 2 * (n + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert k7_tc_smem_bytes() == {"kv_proj": 75776, "dxn": 81920, "dw": 69632}


def test_k7_projection_alone_takes_bf16_only():
    """`kv_project_kernel` is the bf16 tensor-core projection's own entry
    point (chip_smoke.py holds it against `kv_project_plain`): it refuses
    f32 before it touches the library, and K7's bf16 kernels refuse a Din
    that is not a whole number of 32-column stages."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    assert "kv_project_tc_bf16" in kcuda.SIGNATURES
    x = torch.zeros((1, 4, 128))
    w = torch.zeros((128, 128))
    with pytest.raises(TypeError, match="bfloat16"):
        kf.kv_project_kernel(x, torch.ones(128), torch.zeros(128), w, w)
    with pytest.raises(NotImplementedError, match="multiple of 32"):
        kf._check_tc_din(100)
    assert kcuda._lib is None


def test_k7_bf16_operands_stay_within_the_gradient_bound():
    """Why the card holds K7's bf16 backward to 5e-2 of the f32 twin: the
    reference runs the three projection products at precision DEFAULT, one
    bf16 pass (JAX flash_train.py:478-492, :623-650), so the kernels round
    xn, dk, dv and the weights to bf16 before them. At a small width, on
    the CPU in f32, rounding those operands moves every gradient by far
    less than that bound of max(1, max|ref|), but by more than f32's."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    gen = torch.Generator().manual_seed(7)
    b, g, m, din, h = 2, 16, 96, 128, 2
    d = 64 * h

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    q, x, do = t(b, g, d), t(b, m, din), t(b, g, d)
    ln_w, ln_b = 1.0 + t(din, scale=0.2), t(din, scale=0.1)
    wk, wv = t(din, d, scale=din ** -0.5), t(din, d, scale=din ** -0.5)
    seed = torch.tensor([3], dtype=torch.int32)
    out, lse = kf.attention_kv_fwd_plain(q, x, ln_w, ln_b, wk, wv, seed, h, 0.125, 0.1)
    delta = kf.attention_delta(do, out, h)
    ref = kf.attention_kv_bwd_plain(q, x, ln_w, ln_b, wk, wv, do, lse, delta, seed, h, 0.125, 0.1)

    def r(a):
        return a.to(torch.bfloat16).float()

    k, v = kf.kv_project_plain(x, ln_w, ln_b, wk, wv)
    _, dk, dv = kf.attention_bwd_plain(q, k, v, do, lse, delta, seed, h, 0.125, 0.1,
                                       kv_dtype=torch.float32)
    xhat, rstd, xn = kf.ln_kv_plain(x, ln_w, ln_b)
    dxn = r(dk) @ r(wk).t() + r(dv) @ r(wv).t()
    dxhat = dxn * ln_w
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    xn2 = r(xn).reshape(-1, din)
    got = {"dx": dx, "dln_w": (dxn * xhat).reshape(-1, din).sum(0),
           "dln_b": dxn.reshape(-1, din).sum(0), "dwk": xn2.t() @ r(dk).reshape(-1, d),
           "dwv": xn2.t() @ r(dv).reshape(-1, d)}
    worst = 0.0
    for name, want in zip(("dx", "dln_w", "dln_b", "dwk", "dwv"), ref[1:]):
        rel = ((got[name] - want).abs().max() / max(1.0, want.abs().max().item())).item()
        assert rel <= 5e-2, (name, rel)
        worst = max(worst, rel)
    assert worst > 1e-4  # bf16 rounding shows: above the f32 bound


# K18's backward rows: the semseg decode's 131,072, partseg's 98,304 and
# small and ragged counts (below one row a warp of a block, one row)
BN_ROWS = (131072, 98304, 1000, 513, 17, 16, 7, 1)


@pytest.mark.parametrize("r", BN_ROWS)
def test_batchnorm_bwd_split_plan_covers_every_row_once(r):
    """K18's one-pass backward on 132 SMs: contiguous row splits cover
    every row once, none empty, at most one block an SM and no more than
    the rows fill (a row for each of a block's 16 warps); the groups of
    the two-level sum cover every split once, about sqrt(splits) each,
    and the counters fit the wrapper's buffer."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    per, splits, group = kbn.bwd_plan(r, SMS)
    rows = kln.split_rows(r, per)
    assert len(rows) == splits <= SMS and _covers_once(rows, r)
    assert splits <= -(-r // kbn.GRAD_WARPS)
    ngroups = -(-splits // group)
    assert (group - 1) ** 2 < splits <= group * group
    assert sorted(i for g in range(ngroups)
                  for i in range(g * group, min(splits, (g + 1) * group))) == list(range(splits))
    assert ngroups + 1 <= kcuda.ARRIVE_COUNTERS


@pytest.mark.parametrize("c,itemsize,vec", [(1536, 2, 8), (1024, 2, 8), (512, 2, 8), (256, 2, 8),
                                            (1536, 4, 4), (256, 4, 4), (13, 2, 1), (100, 4, 2)])
def test_batchnorm_bwd_vector_and_shared_memory(c, itemsize, vec):
    """K18's backward loads 16 bytes a lane at the decode's widths (8 bf16
    or 4 f32 columns), narrower where C does not divide; its static shared
    memory (the 16 warps' two sums of a 32-vector tile, f32, and the
    arrival flag) stays under the 48 KB a kernel may take without opting
    in; both dtypes reach the one-pass entry point (x, dy, mean, rstd,
    dscale, dbias, part, arrive; r, c, per, group, vec; stream)."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn

    assert kbn.vec_for(c, itemsize, 0, 256) == vec
    assert kbn.GRAD_WARPS * 2 * 32 * vec * 4 + 4 <= 48 * 1024
    for dt in (torch.float32, torch.bfloat16):
        assert len(kcuda.SIGNATURES[kcuda.entry_point("bn_grad_reduces", dt)]) == 14
