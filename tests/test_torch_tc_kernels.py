"""The tensor-core routes of K5, K6, K8's forward and backward and K11,
on the CPU: which entry point each dtype reaches, and how the wrappers
plan the kernels' grids; and the split plan of K17's backward.

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
          ("attn_train_bwd", torch.float32, "attn_train_bwd_f32")]


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
