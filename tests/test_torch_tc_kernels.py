"""The tensor-core routes of K3, K4, K5, K6, K7, K8's and K9's forward
and backward and K11, on the CPU: which entry point each dtype reaches,
and how the wrappers plan the kernels' grids; and the split plans of
K17's and K18's one-pass backwards.

The bf16 K5 (`tc::attn_small_tc_kernel`), K6
(`tc::attn_small_qkv_ln_tc_kernel`), K8's forward
(`tc::flash_fwd_tc_kernel`) and K11 (`tc::dense_grads_tc_kernel`) run
only on the card, where tests/test_torch_port_cuda.py and chip_smoke.py
hold them against their twins. What decides their launches is Python,
and is checked here: the route is a pure function of the dtype; K11's
split of the rows covers every row once with no split empty and fills one
wave of 132 SMs (two blocks an SM, no second wave) where R has the row
steps; K5's shared memory fits one block at every (G, M) the gate admits,
K6's two blocks an SM at every (G, Din) it admits. K2's one-pass
threshold select is mirrored on the CPU and held against its twin on
uniform, tied and lane-adversarial clouds.
"""

import pytest
import torch

from _knn_clouds import KNN_CLOUDS, KNN_SHAPES, hard_cloud
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
ROUTES = [("stem", torch.bfloat16, "stem_tc_bf16"),
          ("stem", torch.float32, "stem_f32"),
          ("attn_kv_ln", torch.bfloat16, "attn_kv_ln_tc_bf16"),
          ("attn_kv_ln", torch.float32, "attn_kv_ln_f32"),
          ("dense_grads", torch.bfloat16, "dense_grads_tc_bf16"),
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
          ("attn_train_kv_bwd", torch.float32, "attn_train_kv_bwd_f32"),
          ("g2e_fwd", torch.bfloat16, "g2e_fwd_tc_bf16"),
          ("g2e_fwd", torch.float32, "g2e_fwd_f32"),
          ("g2e_bwd", torch.bfloat16, "g2e_bwd_tc_bf16"),
          ("g2e_bwd", torch.float32, "g2e_bwd_f32"),
          ("attn_packed_kv", torch.bfloat16, "attn_packed_kv_tc_bf16"),
          ("attn_packed_kv", torch.float32, "attn_packed_kv_f32")]


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


# ------------------------------------------------------------------ K9


# group sizes about the bf16 tile plan's limits (one group of 128 a tile, 42
# of 3 in 126 rows, 5 of 24 in 120, one of 100 and 28 rows idle), by group
# counts: one group, a few, the ragged last tile of many, the pretrain
# step's 12,288 and the ft_cls step's 42,240 groups
K9_S = (2, 3, 24, 32, 100, 128)
K9_GROUPS = (1, 5, 43, 4097, 12288, 42240)


def _k9_tile_rows(r: int, s: int) -> list[tuple[int, int]]:
    """The rows [begin, end) of each bf16 K9 tile, as csrc/g2e_train.cu
    `tile_at` cuts them from `tile_plan`."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rows, tiles = kg.tile_plan(r, s)
    return [(t * rows, min(r, (t + 1) * rows)) for t in range(tiles)]


@pytest.mark.parametrize("groups", K9_GROUPS)
@pytest.mark.parametrize("s", K9_S)
def test_k9_tile_plan_holds_whole_groups(s, groups):
    """The bf16 K9's row tiles (csrc/g2e_train.cu `tile_at`): at most 128
    rows, whole groups, every row in one tile and no group across two, the
    last tile holding what is left."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    r = groups * s
    rows, tiles = kg.tile_plan(r, s)
    spans = _k9_tile_rows(r, s)
    assert len(spans) == tiles and _covers_once(spans, r)
    assert rows <= kg.TILE_ROWS and rows % s == 0 and rows + s > kg.TILE_ROWS
    assert all(lo % s == 0 and (hi - lo) % s == 0 and hi - lo <= rows for lo, hi in spans)
    first = {g: lo // rows for g in range(groups) for lo in (g * s,)}
    last = {g: (g * s + s - 1) // rows for g in range(groups)}
    assert first == last  # no group straddles two tiles


# output widths D: the repo's (256, 384), the bf16 kernels' column slices,
# and widths they take padded to a multiple of 64 (32, 96, 320, 512, 768)
K9_WIDTHS = (32, 64, 96, 128, 192, 256, 320, 384, 512, 768)


@pytest.mark.parametrize("d", K9_WIDTHS)
@pytest.mark.parametrize("groups,s", [(12288, 32), (42240, 32), (16384, 24), (3072, 128),
                                      (5, 7), (1, 128), (400, 32)])
def test_k9_persistent_grids_take_every_tile_once(groups, s, d):
    """The persistent grids on 132 SMs, walked as the kernels walk them:
    F2 and P2's second half take every tile once; F3 every (column slice,
    tile) once with its slices N wide (a multiple of 64, at most 256,
    tiling D padded to a multiple of 64), P1 and P2's first half every
    (half of the 256 columns, tile) once; no grid exceeds one block an SM
    or the work."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    r = groups * s
    _, tiles = kg.tile_plan(r, s)
    g = kg.grids(r, s, d, SMS)
    mid = sorted(t for b in range(g["mid"]) for t in range(b, tiles, g["mid"]))
    assert mid == list(range(tiles)) and g["mid"] <= SMS
    dp = kg.tc_width(d)
    assert dp % 64 == 0 and d <= dp < d + 64
    n = kg.out_cols(dp)
    assert n % 64 == 0 and n <= 256 and dp % n == 0
    for key, slices in (("out", dp // n), ("dy3", 2)):
        grid = g[key]
        assert grid % slices == 0 and grid <= max(SMS, slices) and grid <= slices * tiles
        nb = grid // slices
        work = sorted((b % slices, t) for b in range(grid) for t in range(b // slices, tiles, nb))
        assert work == [(c, t) for c in range(slices) for t in range(tiles)]


def k9_tc_smem_bytes(d: int) -> dict[str, int]:
    """The dynamic shared memory of the bf16 K9's kernels (csrc/g2e_train.cu
    `MID_FWD_SMEM`, `MID_BWD_SMEM`, `out_smem`, `dy3_smem`), bf16 rows
    padded by 8: F2 holds W2 [256][264], W1 [64][136] and a tile
    [128][264]; P2's second half also the tile's tie bits [128][4] (u32);
    F3 W3's column slice [256][N + 8] and a tile; P1 / P2's first half
    W3's row slice [128][kc + 8] and the dh4 tile [128][kc + 8] of a chunk
    of kc = min(D, 384) columns (at least the f32 staging [128][132]); D
    padded to a multiple of 64."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    dp = kg.tc_width(d)
    kc = min(dp, kg.DY3_COLS)
    tile = 2 * 128 * (256 + 8)
    mid = 2 * 256 * (256 + 8) + 2 * 64 * (128 + 8) + tile
    return {"mid_fwd": mid, "mid_bwd": mid + 4 * 128 * 4,
            "out": 2 * 256 * (kg.out_cols(dp) + 8) + tile,
            "dy3": 2 * 128 * (kc + 8) + max(2 * 128 * (kc + 8), 4 * 128 * (128 + 4))}


def k9_dw3_smem_bytes() -> int:
    """dW3's static shared memory (csrc/g2e_train.cu `dw3_kernel`): two
    stages of 32 rows of x3 and of dh4, 128 + 8 bf16 a row, and BN1's
    scale and shift of its 128 columns (f32)."""
    return 2 * 2 * 32 * (128 + 8) * 2 + 2 * 128 * 4


@pytest.mark.parametrize("d", K9_WIDTHS)
def test_k9_tc_kernels_fit_an_sm(d):
    """Each bf16 K9 kernel's shared memory fits a block (227 KB) and one
    block an SM, as its __launch_bounds__(512, 1) says; above 48 KB it is
    dynamic (the launches set the attribute). The weight gradient dW3
    takes static shared memory under 48 KB and two blocks an SM. At the
    flagship's D = 256: F2 220,160 B, P2's second half 222,208 B, F3
    202,752 B, P1 135,168 B."""
    block_max = 227 * 1024
    smem = k9_tc_smem_bytes(d)
    for n in smem.values():
        assert 48 * 1024 < n <= block_max
        assert n + BLOCK_RESERVED_BYTES <= SM_SHARED_BYTES
    assert k9_dw3_smem_bytes() <= 48 * 1024
    assert 2 * (k9_dw3_smem_bytes() + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    if d == 256:
        assert smem == {"mid_fwd": 220160, "mid_bwd": 222208, "out": 202752, "dy3": 135168}


def _g2e_operands(r, cin, d, dt):
    shapes = [(cin, 64), (64,), (64,), (64,), (64, 128), (128,), (256, 256), (256,), (256,),
              (256,), (256, d), (d,)]
    return torch.zeros((r, cin), dtype=dt), [torch.zeros(sh) for sh in shapes]


@pytest.mark.parametrize("s,d", [(129, 256), (256, 256), (32, 320), (32, 512), (32, 96)])
def test_k9_bf16_refuses_what_its_tiles_do_not_hold(s, d):
    """A group of more than 128 rows raises ValueError from `_check`, before
    any launch (the library is never built); f32 takes it on the CUDA
    cores. Every D is held: the bf16 kernels take it padded with zero
    columns to a multiple of 64."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    x0, wb = _g2e_operands(2 * s, 3, d, torch.bfloat16)
    if s > kg.TILE_ROWS:
        with pytest.raises(ValueError, match="bf16 g2e kernels"):
            kg._check(x0, wb, s)
    else:
        assert kg._check(x0, wb, s) == (2 * s, 3, d) and kg.tc_width(d) % 64 == 0
    assert kg._check(x0.float(), wb, s) == (2 * s, 3, d)
    assert kcuda._lib is None


@pytest.mark.parametrize("d", (32, 96, 320))
@pytest.mark.parametrize("s", (3, 32))
def test_k9_padded_width_changes_no_output(s, d):
    """The bf16 kernels take the final Dense at D padded with zero columns
    (`tc_width`), its bias too, and the backward the cotangent and argmax
    padded (dy 0, argmax 0): on the twins the padded function gives the
    same out and argmax in its first D columns, the same dx0 and the same
    gradients, dW3 and db3 in their first D columns and zero past them
    (the backward's products over D columns may be summed in another order
    once padded: within f32 sums, and one bf16 rounding of dx0)."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    gen = torch.Generator().manual_seed(7)
    groups, cin = 6, 3
    r, dp = groups * s, kg.tc_width(d)
    x0 = torch.randn((r, cin), generator=gen).to(torch.bfloat16)
    _, wb = _g2e_operands(r, cin, d, torch.float32)
    wb = [torch.randn(w.shape, generator=gen) * (w.shape[0] ** -0.5 if w.dim() == 2 else 0.1)
          for w in wb]
    wb[2], wb[8] = wb[2] + 1.0, wb[8] + 1.0
    wp = wb[:10] + [kg._pad_cols(wb[10], dp), kg._pad_cols(wb[11], dp)]
    out, h3p, amax, stats = kg.g2e_fwd_plain(x0, wb, s)
    outp, h3pp, amaxp, statsp = kg.g2e_fwd_plain(x0, wp, s)
    assert outp.shape == (groups, dp) and torch.equal(outp[:, :d], out)
    assert torch.equal(amaxp[:, :d], amax) and torch.equal(h3pp, h3p)
    assert torch.equal(statsp, stats)
    dy = torch.randn((groups, d), generator=gen).to(torch.bfloat16)
    dx0, grads = kg.g2e_bwd_plain(x0, wb, h3p, amax, stats, dy, s)
    dxp, gradsp = kg.g2e_bwd_plain(x0, wp, h3p, kg._pad_cols(amax, dp), stats,
                                   kg._pad_cols(dy, dp), s)
    assert (dxp.float() - dx0.float()).abs().max() <= 2 ** -7 * dx0.float().abs().max()
    for i, (got, want) in enumerate(zip(gradsp, grads)):
        if i >= 10:
            assert not got[..., d:].any(), i
            got = got[..., :d]
        assert (got - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item()), i


@pytest.mark.parametrize("r,s,d", [(393216, 32, 256), (1351680, 32, 256), (393216, 32, 384),
                                   (131072, 32, 384), (294912, 24, 256), (70, 7, 64)])
def test_k9_bf16_workspace_holds_no_h4_dh4_or_f32_rows(r, s, d):
    """What the bf16 backward allocates (`bwd_workspace`, built on the meta
    device): the bf16 operands of the weight gradients (x1, xc, dh3p, dh2)
    and dy1, no h4, dh4, dy3 or dxc and no f32 or f64 array of R rows; the
    column partials hold every pass's (P1's and P2's f64 sums over 256
    and 64 columns, P2's f32 sums of dh2, db3's over D) and the split
    partials every weight gradient's and P3's. The f32 route keeps its
    CUDA-core intermediates."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    work = kg.bwd_workspace(r, s, 6, d, torch.bfloat16, "meta", SMS)
    assert list(work) == ["x1", "xc", "dh3p", "dh2", "dy1", "gsum", "part", "wpart"]
    assert not {"h4", "dh4", "dy3", "dxc"} & set(work)
    dtypes = {"gsum": torch.float32, "part": torch.float64, "wpart": torch.float32}
    assert tuple(work["gsum"].shape) == (r // s, 256)
    for name, t in work.items():
        assert t.dtype == dtypes.get(name, torch.bfloat16)
        if t.dtype != torch.bfloat16:
            assert t.shape[0] != r
    g = kg.grids(r, s, d, SMS)
    # P1's and P2's f64 sums (over 256 columns; P2's second half's of
    # (dy1, dy1 xhat1) over 64, then its f32 sums of dh2), db3's in f32
    f32_words = 2 * work["part"].numel()
    assert work["part"].numel() >= g["dy3"] // 2 * 2 * 256
    assert f32_words >= max(g["mid"] * (2 * 2 * 64 + 128), kg.DB3_BLOCKS * 2 * d)
    s3, s2, s1 = kg.wgrad_splits(r, d, SMS)
    assert work["wpart"].numel() >= max(kg.COLSUM_BLOCKS * (6 * 64 + 64), s3 * 256 * d,
                                        s2 * (256 * 256 + 256), s1 * (64 * 128 + 128))
    assert {"dh4", "dy3", "dxc"} <= set(kg.bwd_workspace(r, s, 6, d, torch.float32, "meta", SMS))


def _tiled_g2e_bwd_mid(x0f, wb, h3p, stats, dh3p, s):
    """A CPU mirror of P2's second half (csrc/g2e_train.cu
    `bwd_mid_kernel`), tile by tile: h2 and its group max recomputed in the
    tile, dxc = dh3p W2^T, each group's sum of dxc[:, :128] over its rows
    in the tile split among h2's ties, dh2 rounded; -> dh2 [R, 128]."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    dt = x0f.dtype
    out = []
    for lo, hi in _k9_tile_rows(x0f.shape[0], s):
        _, _, h2, gmax, _ = kg._recompute(x0f[lo:hi], wb, stats, s)
        dxc = dh3p[lo:hi].float() @ wb[6].to(dt).float().t()
        eq = (h2.float() == gmax.float().repeat_interleave(s, 0)).float()
        share = dxc[:, :128].view(-1, s, 128).sum(1) / eq.view(-1, s, 128).sum(1)
        out.append((dxc[:, 128:] + share.repeat_interleave(s, 0) * eq).to(dt))
    return torch.cat(out)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [24, 128, 3])
def test_k9_tiles_recompute_what_the_twin_computes(s, dt):
    """The bf16 kernels recompute h2, its group max and the tie split of
    dxc inside each tile of whole groups (5 groups of 24 in 120 rows, one
    of 128, 42 of 3), where the twin takes them over all rows at once: the
    same function, so the tile mirror gives the twin's dh2 (within f32
    summation order; in bf16 within one rounding of dh2), on an input
    whose groups tie in h2 (each group's second row repeats its first)."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    gen = torch.Generator().manual_seed(5)
    groups, cin, d = 11, 3, 64
    r = groups * s
    x0 = torch.randn((r, cin), generator=gen)
    x0.view(groups, s, cin)[:, 1] = x0.view(groups, s, cin)[:, 0]  # a repeated row: ties
    shapes = [(cin, 64), (64,), (64,), (64,), (64, 128), (128,), (256, 256), (256,), (256,),
              (256,), (256, d), (d,)]
    wb = [torch.randn(sh, generator=gen) * (sh[0] ** -0.5 if len(sh) == 2 else 0.1)
          for sh in shapes]
    wb[2], wb[8] = wb[2] + 1.0, wb[8] + 1.0
    x0f = x0.to(dt)
    _, h3p, amax, stats = kg.g2e_fwd_plain(x0f, wb, s)
    dh3p = torch.randn((r, 256), generator=gen).to(dt)
    got = _tiled_g2e_bwd_mid(x0f, wb, h3p, stats, dh3p, s)
    _, _, h2, gmax, _ = kg._recompute(x0f, wb, stats, s)
    dxc = dh3p.float() @ wb[6].to(dt).float().t()
    eq = (h2.float() == gmax.float().repeat_interleave(s, 0)).float()
    assert (eq.view(groups, s, 128).sum(1) > 1).any()  # ties in h2
    share = dxc[:, :128].view(groups, s, 128).sum(1) / eq.view(groups, s, 128).sum(1)
    want = (dxc[:, 128:] + share.repeat_interleave(s, 0) * eq).to(dt)
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= (1e-6 if dt == torch.float32 else 2 ** -7) * scale


# ------------------------------------------------------------- K3, K4
# K3's groups (B x G, G = 128): one cloud's worth and fewer, the serving
# batches (32, 64), the evals (semseg 32, partseg 96, eval_zeroshot 160,
# ft_cls 330), and counts no tile divides; group sizes the gate admits
K3_GROUPS = (1, 7, 165, 32 * 128, 64 * 128, 96 * 128, 160 * 128, 330 * 128)
K3_S = (4, 8, 16, 24, 32)
K3_WIDTHS = (64, 96, 256, 384, 512)


@pytest.mark.parametrize("groups", K3_GROUPS)
@pytest.mark.parametrize("s", K3_S)
def test_k3_tile_plan_takes_every_group_once(s, groups):
    """The bf16 K3's tiles (csrc/stem.cu `tile_at`): at most 16 whole
    groups and 128 rows a tile, as many as fit; walked as the two
    persistent passes walk them on 132 SMs, the mid pass takes every
    group's tile once, the out pass every (column slice, tile) once, at
    the repo's widths and at widths padded to a multiple of 64."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    per, tiles = kstem.tile_plan(groups, s)
    assert per * s <= 128 and per <= 16 and (per == 16 or (per + 1) * s > 128)
    assert _covers_once([(t * per, min(groups, (t + 1) * per)) for t in range(tiles)], groups)
    for d in K3_WIDTHS:
        g = kstem.grids(groups, s, d, SMS)
        mid = sorted(t for b in range(g["mid"]) for t in range(b, tiles, g["mid"]))
        assert mid == list(range(tiles)) and g["mid"] <= SMS
        dp = kg.tc_width(d)
        slices = dp // kg.out_cols(dp)
        grid, nb = g["out"], g["out"] // slices
        assert grid % slices == 0 and grid <= max(SMS, slices)
        work = sorted((b % slices, t) for b in range(grid) for t in range(b // slices, tiles, nb))
        assert work == [(c, t) for c in range(slices) for t in range(tiles)]


def k3_tc_smem_bytes(d: int) -> dict[str, int]:
    """The bf16 K3's dynamic shared memory (csrc/stem.cu `MID_SMEM`,
    `out_smem`), bf16 rows padded by 8: mid holds W2 [64][136], W3
    [256][264] and a tile [128][264]; out W4's column slice [256][N + 8]
    (D padded to a multiple of 64) and a tile."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    tile = 2 * 128 * (256 + 8)
    n = kg.out_cols(kg.tc_width(d))
    return {"mid": 2 * 64 * (128 + 8) + 2 * 256 * (256 + 8) + tile,
            "out": 2 * 256 * (n + 8) + tile}


@pytest.mark.parametrize("d", K3_WIDTHS)
def test_k3_tc_passes_fit_one_block_an_sm(d):
    """Each bf16 K3 pass's shared memory fits a block (227 KB) and one
    block an SM, as its __launch_bounds__(512, 1) says; the wrapper's
    figures are the kernel's. At D = 256: mid 220,160 B, out 202,752 B; at
    D = 384 (slices of 192) out 169,984 B."""
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    smem = kstem.tc_smem(d)
    assert smem == k3_tc_smem_bytes(d)
    for n in smem.values():
        assert 48 * 1024 < n <= 227 * 1024
        assert n + BLOCK_RESERVED_BYTES <= SM_SHARED_BYTES
    if d == 256:
        assert smem == {"mid": 220160, "out": 202752}
    if d == 384:
        assert smem["out"] == 169984


def _tiled_stem(t1ext, idx, w2, b2, w3, b3, w4, b4, n, g, s):
    """A CPU mirror of the bf16 K3's two passes (csrc/stem.cu tc), tile by
    tile over the B*G groups: the neighbour and center rows gathered by
    index, x1, each group's max, the pooled half gmax W3[:128] once a
    group seeding the local half x1 W3[128:], then h = x2 W4 and each
    group's max."""
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    dt = t1ext.dtype
    bsz, _, c1 = t1ext.shape
    table, flat = t1ext.reshape(-1, c1), idx.reshape(-1).long()
    per, tiles = kstem.tile_plan(bsz * g, s)
    out = []
    for t in range(tiles):
        gg = torch.arange(t * per, min(bsz * g, (t + 1) * per))
        rows = (gg[:, None] * s + torch.arange(s)).reshape(-1)
        cloud = gg // g
        nb = table[(cloud * (n + g)).repeat_interleave(s) + flat[rows]]
        cen = table[(cloud * (n + g) + n + gg - cloud * g).repeat_interleave(s)]
        x0 = torch.relu((nb.float() - cen.float()).to(dt))
        x1 = (x0.float() @ w2.float()).to(dt) + b2
        gmax = x1.view(-1, s, x1.shape[-1]).amax(1)
        gpart = gmax.float() @ w3[:128].float()
        acc = gpart.repeat_interleave(s, 0) + x1.float() @ w3[128:].float()
        x2 = torch.relu(acc.to(dt) + b3)
        h = (x2.float() @ w4.float()).to(dt) + b4
        out.append(h.view(-1, s, h.shape[-1]).amax(1))
    return torch.cat(out).view(bsz, g, -1)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,g,s,d", [(2, 300, 40, 24, 96), (3, 128, 16, 8, 64),
                                       (1, 64, 32, 4, 32)])
def test_k3_tiles_compute_what_the_twin_computes(b, n, g, s, d, dt):
    """The bf16 K3 gathers each tile's rows by index across clouds, takes
    the concat product as a pooled half once a group plus a local half,
    and pads D with zero columns: the tile mirror with W4 and b4 so padded
    gives the twin's output in its first D columns (within f32 summation
    order; in bf16 within one rounding), at tiles that cross clouds and
    groups no tile count divides."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    gen = torch.Generator().manual_seed(7)
    t1ext = torch.randn((b, n + g, 64), generator=gen).to(dt)
    idx = torch.randint(0, n, (b, g * s), generator=gen, dtype=torch.int32)
    shapes = ((64, 128), (128,), (256, 256), (256,), (256, d), (d,))
    w2, b2, w3, b3, w4, b4 = (
        (torch.randn(sh, generator=gen) * (sh[0] ** -0.5 if len(sh) == 2 else 0.1)).to(dt)
        for sh in shapes)
    want = kstem.stem_plain(t1ext, idx, w2, b2, w3, b3, w4, b4, n, g, s)
    dp = kg.tc_width(d)
    pad = torch.nn.functional.pad
    got = _tiled_stem(t1ext, idx, w2, b2, w3, b3, pad(w4, (0, dp - d)), pad(b4, (0, dp - d)),
                      n, g, s)
    assert got.shape == (b, g, dp)
    err = (got[..., :d].float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= (1e-5 if dt == torch.float32 else 2 ** -6) * scale


# K4's (B, G, H): the serving batches, the ft_cls eval, partseg's and
# semseg's six heads, more than one query tile (the Perceiver's 512
# latents), a single query
K4_CASES = [(64, 128, 4), (32, 128, 4), (330, 128, 4), (96, 128, 6), (32, 128, 6),
            (2, 200, 4), (64, 512, 4), (1, 1, 2)]


@pytest.mark.parametrize("m", [63, 65, 1024, 4096])
@pytest.mark.parametrize("b,g,h", K4_CASES)
def test_k4_tc_plan_covers_every_token_once(b, g, h, m):
    """The bf16 K4's blocks on 132 SMs as csrc/attention.cu cuts them
    (`kv_ln_plan`; Din = D = 64 H as on every path): 128 query rows a tile,
    the kv tokens in 64-token tiles, ceil(tiles / n) of them a split. Up to
    one query tile, one attention pass of (head, cloud, split) blocks, one
    an SM at 256 < Din <= 384 (the double-buffered kernel), else two; past
    it a projection pass of (head, cloud, split) blocks, two an SM, then
    K13's (head, cloud, query tile, split) blocks. In each pass every
    (cloud, head, query row, token) lies in one block, no split is empty,
    and the blocks fill 90% of a wave at their blocks an SM
    (`TC_WAVE_FILL`) where the tiles allow; where K4's own unsplit blocks
    fill 90% of two blocks an SM already (serving's B = 64), nothing is
    split."""
    din = 64 * h
    nsplit, psplit = kattn.kv_ln_plan(torch.bfloat16, b, g, m, h, din, SMS)
    tiles = -(-m // kattn.TC_TILE_TOKENS)
    nq = -(-g // kattn.TC_Q_TILE)
    assert _covers_once(_tiles(g, kattn.TC_Q_TILE), g)
    per_sm = 1 if 256 < din <= 384 else 2
    assert kattn.kv_ln_blocks_per_sm(din) == per_sm
    # (splits, query tiles a (head, cloud), blocks an SM, K4's own pass)
    passes = ([(nsplit, 1, per_sm, True)] if nq == 1 else
              [(psplit, 1, 2, True), (nsplit, nq, 2, False)])
    if nq == 1:
        assert psplit == 1
    else:
        assert nsplit == kattn.packed_splits(torch.bfloat16, b, g, m, h, SMS)
    for n, q_tiles, blocks_an_sm, own in passes:
        per = -(-tiles // n)
        spans = [(sp * per * 64, min(m, (sp + 1) * per * 64)) for sp in range(n)]
        assert _covers_once(spans, m)  # every token in one split, none empty
        units, slots = h * b * q_tiles, SMS * blocks_an_sm
        assert units * n >= min(kattn.TC_WAVE_FILL * slots, units * tiles)  # a wave, if M allows
        assert q_tiles * n < 65536  # the grid's z
        if own and units >= kattn.TC_WAVE_FILL * SMS * kattn.TC_BLOCKS_PER_SM:
            assert n == 1


@pytest.mark.parametrize("din", [96, 128, 256, 264, 384, 392, 1024])
def test_k4_tc_kernel_fits_its_blocks_an_sm(din):
    """The bf16 K4's shared memory fits the blocks an SM its
    __launch_bounds__ say (`kv_ln_blocks_per_sm`, which the split plan
    takes): up to Din = 256 the tile kernel, two blocks an SM (this head's
    [wk|wv] slice resident and a whole 64-token tile of xn: 103,424 B);
    up to 384 the double-buffered tile kernel, one block an SM (204,800
    B); past it the stream kernel, two blocks an SM (a k|v tile and a ring
    of three 64-column Din chunks with the weights' rows: 97,280 B,
    whatever Din). q's 128 rows are staged over a tile of xn, or over the
    k|v tile and the ring."""
    smem = kattn.kv_ln_tc_smem_bytes(din)
    kv_tile, q_rows = 64 * 136, 128 * 72
    if din <= 256:
        assert smem == 2 * (256 * 136 + 64 * 264) == 103424
        assert q_rows <= 64 * 264 and kv_tile <= 64 * 264  # q, then k|v, over the xn tile
        blocks = 2
    elif din <= 384:
        assert smem == 2 * (384 * 136 + 2 * 64 * 392) == 204800
        blocks = 1
    else:
        ring = 3 * (64 * 72 + 64 * 136)
        assert smem == 2 * (kv_tile + ring) == 97280
        assert q_rows <= kv_tile + ring
        blocks = 2
    assert kattn.kv_ln_blocks_per_sm(din) == blocks
    assert smem <= 227 * 1024
    assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES


def test_k3_k4_refuse_what_their_kernels_do_not_take():
    """Before any launch (and before the kernels are built): K3 refuses a
    group size above 32, other hidden widths and, in bf16, a first layer
    other than 64 wide; K4 a head width other than 64, Din above 1024
    and, in bf16, a Din that is not a multiple of 8 (the f32 kernel takes
    it)."""
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    def ops(c1=64, c2=128, s=4, dt=torch.bfloat16):
        z = lambda *sh: torch.zeros(sh, dtype=dt)  # noqa: E731
        return (z(1, 10, c1), torch.zeros((1, 2 * s), dtype=torch.int32), z(c1, c2), z(c2),
                z(256, 256), z(256), z(256, 64), z(64), 8, 2, s)

    with pytest.raises(ValueError, match="group sizes"):
        kstem.stem_kernel(*ops(s=33))
    with pytest.raises(ValueError, match="hidden widths"):
        kstem.stem_kernel(*ops(c2=96))
    with pytest.raises(ValueError, match="first layer"):
        kstem.stem_kernel(*ops(c1=32))
    assert kattn.kv_route("attn_kv_ln", torch.bfloat16, 256, 4, 256) == "attn_kv_ln_tc_bf16"
    assert kattn.kv_route("attn_kv_ln", torch.float32, 256, 4, 100) == "attn_kv_ln_f32"
    with pytest.raises(ValueError, match="multiple of 8"):
        kattn.kv_route("attn_kv_ln", torch.bfloat16, 256, 4, 100)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="Din <= 1024"):
            kattn.kv_route("attn_kv_ln", dt, 256, 4, 1152)
        with pytest.raises(NotImplementedError, match="dh=64"):
            kattn.kv_route("attn_kv_ln", dt, 384, 4, 256)
    assert kcuda._lib is None


@pytest.mark.parametrize("case", ["same", "near_tie", "two_ulps", "kernel_breaks_tie"])
def test_k9_tie_flip_rule(case):
    """The bf16 K9's rule at a near-tie (`g2e_train.tie_flips`): a (group,
    column) whose tie set h2 == gmax differs between the kernel and the
    twin counts as a flip, and passes only where the two competing h2 lie
    within one bf16 ulp of the group max: a row one ulp above the twin's
    tied max (1 ulp), two ulps above (2: fails the rule), or the kernel's
    row one ulp below a value the twin ties (1 ulp)."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    gen = torch.Generator().manual_seed(9)
    s, groups = 4, 6
    h2 = torch.randn((groups * s, 128), generator=gen).to(torch.bfloat16)
    h2.view(groups, s, 128)[2, 1, 5] = h2.view(groups, s, 128)[2, :, 5].max()  # a tie
    other = h2.clone()
    v = other.view(groups, s, 128)
    top = v[2, :, 5].max().float()
    ulp = 2.0 ** (torch.frexp(top)[1].item() - 8)
    if case == "near_tie":
        v[2, 1, 5] = (top + ulp).to(torch.bfloat16)
    elif case == "two_ulps":
        v[2, 1, 5] = (top + 2 * ulp).to(torch.bfloat16)
    elif case == "kernel_breaks_tie":
        v[2, 1, 5] = (top - ulp).to(torch.bfloat16)
    gmax_of = lambda h: h.view(groups, s, 128).amax(1)  # noqa: E731
    n, ulps = kg.tie_flips(other, gmax_of(other), h2, gmax_of(h2), s)
    want = {"same": (0, 0.0), "near_tie": (1, 1.0), "two_ulps": (1, 2.0),
            "kernel_breaks_tie": (1, 1.0)}[case]
    assert (n, ulps) == want


# ------------------------------------------------------------- K15, K1
K15_TOKENS = (1, 63, 128, 300, 512, 700, 2048)
K15_DINS = (128, 256, 384, 1024)


@pytest.mark.parametrize("m", K15_TOKENS)
@pytest.mark.parametrize("g", K15_TOKENS)
def test_k15_plan_covers_every_row_and_token_once(g, m):
    """The bf16 K15's plan (`packed_kv_plan`) at every Din the gate admits:
    past one query tile with G and M at most 512, the cluster kernel, one
    cluster a (cloud, head) whose blocks (at most 2, none empty) take 256
    query rows and tokens each, so every query row and every
    token lies in one block; elsewhere K4's passes, split as `kv_ln_plan`
    splits K4's (covered by test_k4_tc_plan_covers_every_token_once); in
    f32 always the CUDA-core kernel."""
    b, h = 64, 4
    for din in K15_DINS:
        c, nsplit, psplit = kattn.packed_kv_plan(torch.bfloat16, b, g, m, h, din, SMS)
        if g > kattn.TC_Q_TILE and max(g, m) <= kattn.PKV_MAX_TOKENS:
            rows = kattn.PKV_SLICE
            assert (c, nsplit, psplit) == (-(-max(g, m) // 256), 1, 1) and rows == 256
            assert 1 <= c <= kattn.PKV_MAX_TOKENS // rows
            blocks = [(r * rows, (r + 1) * rows) for r in range(c)]
            for n in (g, m):
                spans = [(lo, min(hi, n)) for lo, hi in blocks if lo < n]
                assert _covers_once(spans, n)
            assert all(lo < g or lo < m for lo, _ in blocks)  # no block without work
        else:
            assert c == 0
            assert (nsplit, psplit) == kattn.kv_ln_plan(torch.bfloat16, b, g, m, h, din, SMS)
        assert kattn.packed_kv_plan(torch.float32, b, g, m, h, din, SMS)[0] == 0


def test_k15_cluster_kernel_fits_one_block_an_sm():
    """The cluster kernel's shared memory (`packed_kv_cluster_smem_bytes`):
    the cloud's k|v, 512 rows of 128 + 8 bf16 (139,264 B), or in its place
    while the block projects the ring of two Din chunks and q's staging
    (145,408 B): one block an SM, whatever Din (it streams), and not two
    (its __launch_bounds__ say one)."""
    smem = kattn.packed_kv_cluster_smem_bytes()
    kv_rows = 512 * 136 * 2
    ring = 2 * (256 * 72 + 64 * 136) * 2
    assert smem == max(kv_rows, ring + 256 * 72 * 2) == 145408
    assert smem <= 227 * 1024 and smem + BLOCK_RESERVED_BYTES <= SM_SHARED_BYTES
    assert 2 * (smem + BLOCK_RESERVED_BYTES) > SM_SHARED_BYTES


def test_k15_refuses_what_its_kernels_do_not_take():
    """Before any launch (and before the kernels are built): K15 refuses a
    head width other than 64, Din above 1024 and, in bf16, a Din that is
    not a multiple of 8 (the f32 kernel takes it); the CUDA-core bf16 entry
    point is gone."""
    assert kattn.kv_route("attn_packed_kv", torch.bfloat16, 256, 4, 256) == "attn_packed_kv_tc_bf16"
    assert kattn.kv_route("attn_packed_kv", torch.float32, 256, 4, 100) == "attn_packed_kv_f32"
    with pytest.raises(ValueError, match="multiple of 8"):
        kattn.kv_route("attn_packed_kv", torch.bfloat16, 256, 4, 100)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="Din <= 1024"):
            kattn.kv_route("attn_packed_kv", dt, 256, 4, 1152)
        with pytest.raises(NotImplementedError, match="dh=64"):
            kattn.kv_route("attn_packed_kv", dt, 384, 4, 256)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kattn.kv_route("attn_packed_kv", torch.float16, 256, 4, 256)
    assert "attn_packed_kv_bf16" not in kcuda.SIGNATURES
    assert kcuda._lib is None


def _cluster_order_attention(q, x, wk, wv, h: int, scale: float):
    """A CPU mirror of the cluster kernel: block r projects its 256
    tokens of x onto k|v (f32 accumulation rounded to the compute dtype),
    the slices make the cloud's k|v, and block r attends its 256 query
    rows over the cloud's 64-token tiles in order (K13's online softmax)."""
    dt = q.dtype
    b, g, d = q.shape
    m = x.shape[1]
    rows = kattn.PKV_SLICE
    c = kattn.pkv_cluster(g, m)
    xf = x.float()
    k = torch.cat([(xf[:, lo:lo + rows] @ wk.float()).to(dt) for lo in range(0, c * rows, rows)], 1)
    v = torch.cat([(xf[:, lo:lo + rows] @ wv.float()).to(dt) for lo in range(0, c * rows, rows)], 1)
    kh = kattn._heads(k, h).float()
    vh = kattn._heads(v, h)
    outs = [kattn._online_attention(q[:, lo:lo + rows], kh, vh, h, scale, dt, kv_chunk=64)
            for lo in range(0, c * rows, rows) if lo < g]
    return torch.cat(outs, 1)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,din", [(2, 300, 300, 96), (1, 130, 33, 64), (2, 200, 512, 128),
                                       (1, 512, 77, 64), (1, 512, 512, 64), (1, 257, 256, 32)])
def test_k15_cluster_order_computes_the_twin(b, g, m, din, dt):
    """The cluster kernel projects each 256-token slice on its own and
    attends each block's query rows over the 64-token tiles in order; its
    CPU mirror equals the twin over 64-token chunks
    (`attention_packed_kv_plain(..., kv_chunk=64)`), within f32 summation
    order (one bf16 rounding of the output in bf16), at ragged slices and
    tiles, G above and below M."""
    gen = torch.Generator().manual_seed(15)
    h, d = 2, 128
    q = torch.randn((b, g, d), generator=gen).to(dt)
    x = torch.randn((b, m, din), generator=gen).to(dt)
    wk, wv = ((torch.randn((din, d), generator=gen) * din ** -0.5).to(dt) for _ in "kv")
    got = _cluster_order_attention(q, x, wk, wv, h, 0.125)
    want = kattn.attention_packed_kv_plain(q, x, wk, wv, h, 0.125, kv_chunk=64)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (1e-6 if dt == torch.float32 else 2 ** -8) * scale


FPS_NS = (1, 37, 256, 1000, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("n", FPS_NS)
def test_k1_warp_plan_holds_every_point_once(n):
    """K1's layout (`fps_warps`): lane l of warp w holds points (w PPL + k)
    32 + l, k < PPL, so every point of the cloud lies in one (warp, lane,
    k), a lane's points increase with k, every warp holds a point (its
    winner is real), and the warps fit the block the kernel is built for
    (MAX_POINTS / PPL threads)."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps

    ppl = kfps.PPL
    w = kfps.fps_warps(n)
    idx = torch.arange(w * ppl * 32).view(w, ppl, 32)
    held = idx[idx < n]
    assert torch.equal(held.sort().values, torch.arange(n))
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    assert all(bool((idx[k] < n).any()) for k in range(w))
    assert 32 * w <= kfps.MAX_POINTS // ppl


def _fps_two_redux(xyz, npoint: int, start):
    """A CPU mirror of K1's step: each lane's best point (the first of its
    largest running min-distance), the warp's by two reductions (the max
    of the distances' f32 bits, then the least index among the lanes that
    hold it), and across warps the largest 64-bit key (bits high, the
    index's complement low) up to 4 warps, past it the same two
    reductions; -> the indices."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps

    b, n, _ = xyz.shape
    ppl = kfps.PPL
    w = kfps.fps_warps(n)
    pos = torch.arange(w * ppl * 32).view(w, ppl, 32)  # (warp, k, lane) -> point
    valid = pos < n
    gather = pos.clamp(max=n - 1)
    dist = torch.where(valid, torch.full((b, w, ppl, 32), 1e10), torch.full((b, w, ppl, 32), -1.0))
    pts = xyz[:, gather]  # [B, W, PPL, 32, 3]
    rows = torch.arange(b)
    far = start.long()
    out = torch.empty((b, npoint), dtype=torch.int32)
    none = 2 ** 32 - 1
    for it in range(npoint):
        out[:, it] = far.int()
        c = xyz[rows, far][:, None, None, None, :]
        dd = pts - c
        d = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2]
        dist = torch.minimum(dist, torch.where(valid, d, dist))
        lane_best = dist.amax(2)  # [B, W, 32]
        first_k = torch.where(dist == lane_best[:, :, None], torch.arange(ppl)[:, None],
                              ppl).amin(2)
        has = lane_best >= 0
        bits = torch.where(has, lane_best.view(torch.int32).long(), 0)
        idx = torch.where(has, (torch.arange(w)[:, None] * ppl + first_k) * 32
                          + torch.arange(32), none)
        wbest = bits.amax(2)  # redux max over the lanes
        wfirst = torch.where(bits == wbest[..., None], idx, none).amin(2)  # redux min
        if w <= 4:
            key = (wbest << 32) | (none - wfirst)
            far = none - (key.amax(1) & none)
        else:
            best = wbest.amax(1)
            far = torch.where(wbest == best[:, None], wfirst, none).amin(1)
    return out


@pytest.mark.parametrize("n", [200, 256, 1000, 1024, 4096, 8192])
def test_k1_two_redux_argmax_gives_the_twins_indices(n):
    """The two-redux argmax over lanes and warps (`_fps_two_redux`: one
    warp up to 256 points, its keys read in turn up to 4 warps, reduced
    past them) picks fps_plain's indices bit for bit on
    clouds with exact ties: every fifth point a copy of the one before it
    (equal distances at distinct indices), and a cloud on a half-unit grid
    (many equal distances, exact zeros once it is covered)."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps

    gen = torch.Generator().manual_seed(1)
    xyz = torch.randn((2, n, 3), generator=gen)
    xyz[:, 1::5] = xyz[:, 0::5][:, :xyz[:, 1::5].shape[1]]
    xyz[1] = torch.round(xyz[1] * 2) / 2
    start = torch.tensor([0, n - 1], dtype=torch.int32)
    npoint = 48
    want, _ = kfps.fps_plain(xyz, npoint, start)
    assert torch.equal(_fps_two_redux(xyz, npoint, start), want)


# ---------------------------------------------------------------- K2
# The selection's mirror at the card tests' (N, k) on their clouds
# (tests/_knn_clouds.py)
KNN_CAP = 512  # csrc/geometry.cuh KNN_CAP: candidate slots a warp


def knn_cloud(gen, kind: str, b: int, n: int) -> torch.Tensor:
    """A [B, N, 3] f32 cloud of `kind` (tests/_knn_clouds.py)."""
    return hard_cloud(torch.rand((b, n, 3), generator=gen) * 2 - 1, kind)


def _knn_threshold_select(k: int, points, queries):
    """A CPU mirror of K2's selection (csrc/geometry.cuh knn_query): lane
    l's key slots hold points l, l+32, ...; each lane keeps its M smallest
    keys (M = 1 to k = 32, 4 to KNN_KMAX); tau is the k-th smallest kept
    key (their maximum at k = 32 M); the keys <= tau are compacted slot by
    slot, lane by lane; candidate c goes to lane c % 32, each lane sorts
    its own, and k rounds take the least head. -> (indices [B, S, k], the
    candidate count of each query [B, S], and how many queries would take
    the exact scan for want of KNN_CAP slots)."""
    from vipformer_tpu_torch.ops.cuda import knn as kknn

    b, n, _ = points.shape
    s = queries.shape[1]
    d = torch.zeros((b, s, n))
    for c in range(3):
        delta = queries[:, :, None, c] - points[:, None, :, c]
        d = d + delta * delta
    mask = (1 << kknn.idx_bits_for(n)) - 1
    keys = (d.view(torch.int32) & ~mask) | torch.arange(n, dtype=torch.int32)
    none = 2 ** 31 - 1
    nk = -(-n // 32)
    slots = torch.full((b, s, nk * 32), none, dtype=torch.int32)
    slots[..., :n] = keys
    slots = slots.view(b, s, nk, 32)  # [.., slot j, lane l]: point 32 j + l
    m = 1 if k <= 32 else 4
    assert k <= kknn.THRESHOLD_KMAX
    kept = slots.sort(dim=2).values[:, :, :m]  # each lane's M smallest
    if k == 32 * m:
        tau = kept[:, :, m - 1].amax(-1)
    else:
        tau = kept.flatten(2).sort(-1).values[..., k - 1]
    take = slots <= tau[..., None, None]
    count = take.sum((2, 3))
    out = torch.empty((b, s, k), dtype=torch.int32)
    for bi in range(b):
        for si in range(s):
            cand = slots[bi, si][take[bi, si]]  # slot-major, lane-minor: the ballot order
            lanes = [sorted(cand[ln::32].tolist()) for ln in range(32)]
            for r in range(k):
                heads = [lst[0] if lst else none for lst in lanes]
                key = min(heads)
                lanes[heads.index(key)].pop(0)
                out[bi, si, r] = key & mask
    return out, count, int((count > KNN_CAP).sum())


@pytest.mark.parametrize("kind", KNN_CLOUDS)
@pytest.mark.parametrize("n,k", KNN_SHAPES)
def test_k2_threshold_select_gives_the_twins_indices(n, k, kind):
    """K2's one-pass threshold and compacted selection (`_knn_threshold_select`)
    gives knn_plain's indices in its order, with at least k candidates a
    query, on uniform, tied and lane-adversarial clouds; queries are points
    of the cloud (as the FPS centers are) and random points. No query of
    the uniform or tied clouds runs out of slots; on the lane-adversarial
    clouds past KNN_CAP points, where tau is the largest kept key (k = 32
    and 128), every query inside the cloud does, so the card runs the
    exact scan on them."""
    from vipformer_tpu_torch.ops.cuda import knn as kknn

    gen = torch.Generator().manual_seed(n + k)
    b, s = 2, 8
    pts = knn_cloud(gen, kind, b, n)
    pick = torch.randint(0, n, (b, s // 2), generator=gen)
    queries = torch.cat([pts[torch.arange(b)[:, None], pick],
                         torch.rand((b, s // 2, 3), generator=gen) * 2 - 1], 1)
    got, count, overflow = _knn_threshold_select(k, pts, queries)
    assert bool((count >= k).all())
    assert torch.equal(got, kknn.knn_plain(k, pts, queries))
    if kind != "lane":
        assert overflow == 0, count.max()
    elif n > KNN_CAP and k % 32 == 0:
        inside = (queries[..., 0] < 2).sum().item()
        assert overflow >= inside > 0, (overflow, inside)
