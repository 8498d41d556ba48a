"""The PyTorch port's kernel modules (K1-K5) against the JAX package.

Each kernel's plain PyTorch twin (what `vipformer_tpu_torch` runs on a CPU
tensor) is held against the JAX Pallas kernel it replaces, run in
interpret mode as tests/test_pallas.py runs it, on the same numpy inputs.
The CUDA kernels themselves run only on a card: tests/test_torch_port_cuda.py
holds them against their twins there and skips elsewhere.

Tolerances: FPS indices and centers exactly equal, kNN indices equal in
their nearest-first order (both sides select with the same f32
difference-of-squares keys, also on tied and lane-adversarial clouds);
stem and
attention in f32 within 1e-5 relative (summation order differs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _knn_clouds import hard_cloud
from vipformer_tpu.nn.pointnet import Group2Emb as JaxGroup2Emb
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas.attention import (
    fused_attention_packed_kv_ln,
    fused_attention_packed_small,
)
from vipformer_tpu.ops.pallas.fps import fps_pallas
from vipformer_tpu.ops.pallas.knn import knn_pallas
from vipformer_tpu.ops.pallas.stem import group2emb_fused_apply
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.nn.pointnet import Group2Emb
from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops import geometry
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import fps as kfps
from vipformer_tpu_torch.ops.cuda import knn as kknn
from vipformer_tpu_torch.ops.cuda import stem as kstem

RTOL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("b,n,npoint,with_start", [(2, 256, 16, False), (3, 200, 24, True)])
def test_fps_twin_matches_pallas(rng, b, n, npoint, with_start):
    xyz = _f32(rng, b, n, 3)
    start = rng.integers(0, n, b).astype(np.int32) if with_start else np.zeros(b, np.int32)
    want_idx, want_c = fps_pallas(jnp.asarray(xyz), npoint, jnp.asarray(start),
                                  interpret=True, return_centers=True)
    idx, centers = kfps.fps(torch.from_numpy(xyz), npoint, torch.from_numpy(start))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(want_c))


def test_fps_random_start_from_generator(rng):
    """A torch.Generator draws the start indices (the JAX `key`); the same
    seed gives the same samples, and each row starts at its drawn index."""
    pts = torch.from_numpy(_f32(rng, 3, 64, 3))
    a = geometry.farthest_point_sample(pts, 8, torch.Generator().manual_seed(5))
    b = geometry.farthest_point_sample(pts, 8, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    start = torch.randint(0, 64, (3,), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[:, 0], start.to(torch.int32))
    assert all(len(set(row.tolist())) == 8 for row in a)


def test_fps_twin_matches_lax_loop_with_extra_channels(rng):
    pts = _f32(rng, 2, 128, 6)
    want = jgeo.farthest_point_sample(jnp.asarray(pts), 16)
    got = geometry.farthest_point_sample(torch.from_numpy(pts), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_pts = geometry.fps(torch.from_numpy(pts), 16)
    np.testing.assert_array_equal(got_pts.numpy(), pts[np.arange(2)[:, None], got.numpy()])


def _hard_cloud(rng, kind, b, n):
    """A [B, N, 3] f32 cloud of `kind` (tests/_knn_clouds.py): equal
    distances at distinct indices, or one lane's nearest key setting the
    kernel's threshold."""
    return hard_cloud(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32), kind)


@pytest.mark.parametrize("b,n,s,k,cloud", [
    pytest.param(2, 256, 16, 8, None, id="2-256-16-8"),
    pytest.param(2, 100, 12, 5, None, id="2-100-12-5"),
    pytest.param(2, 256, 16, 8, "tied", id="tied-2-256-16-8"),
    pytest.param(2, 100, 12, 33, "tied", id="tied-2-100-12-33"),
    pytest.param(2, 256, 16, 32, "lane", id="lane-2-256-16-32"),
    pytest.param(1, 96, 8, 4, "lane", id="lane-1-96-8-4"),
])
def test_knn_twin_matches_pallas(rng, b, n, s, k, cloud):
    """The twin equals the Pallas kernel in interpret mode, order included,
    on normal clouds and on the tied and lane-adversarial clouds (the
    queries there half points of the cloud, exact zero distances and ties,
    half random)."""
    if cloud is None:
        pts, queries = _f32(rng, b, n, 3), _f32(rng, b, s, 3)
    else:
        pts = _hard_cloud(rng, cloud, b, n)
        pick = rng.integers(0, n, (b, s // 2))
        queries = np.concatenate([pts[np.arange(b)[:, None], pick],
                                  rng.uniform(-1, 1, (b, s - s // 2, 3)).astype(np.float32)], 1)
    want = np.asarray(knn_pallas(k, jnp.asarray(pts), jnp.asarray(queries), interpret=True))
    got = kknn.knn(k, torch.from_numpy(pts), torch.from_numpy(queries)).numpy()
    assert got.dtype == np.int32 and got.shape == (b, s, k)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    np.testing.assert_array_equal(got, want)  # nearest first, same order


@pytest.mark.parametrize("method", ["exact", "packed"])
def test_knn_square_distance_forms_match_jax(rng, method):
    pts, queries = _f32(rng, 2, 128, 3), _f32(rng, 2, 16, 3)
    want_d = jgeo.square_distance(jnp.asarray(queries), jnp.asarray(pts))
    got_d = geometry.square_distance(torch.from_numpy(queries), torch.from_numpy(pts))
    _close(got_d.numpy(), want_d)
    want = np.asarray(jgeo.knn(8, jnp.asarray(pts), jnp.asarray(queries), method=method))
    got = geometry.knn(8, torch.from_numpy(pts), torch.from_numpy(queries), method=method)
    np.testing.assert_array_equal(np.sort(got.numpy(), -1), np.sort(want, -1))


@pytest.mark.parametrize("compat", [False, True])
def test_divide_patches_matches_jax(rng, monkeypatch, compat):
    monkeypatch.setattr(jgeo, "KNN_METHOD", "pallas")
    pts = _f32(rng, 2, 128, 3)
    want_nb, want_c = jgeo.divide_patches(jnp.asarray(pts), 16, 8, compat=compat)
    nb, c = geometry.divide_patches(torch.from_numpy(pts), 16, 8, compat=compat)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    _close(nb.numpy(), want_nb)
    idx = rng.integers(0, 128, (2, 4, 5))
    want = jgeo.index_points(jnp.asarray(pts), jnp.asarray(idx))
    np.testing.assert_array_equal(
        geometry.index_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy(),
        np.asarray(want))


def _g2e_variables(rng, d):
    jm = JaxGroup2Emb(d)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, 8, 3)))
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), v["batch_stats"])
    return jm, {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
                "batch_stats": stats}


def test_stem_twin_matches_pallas(rng):
    b, n, g, s, d = 2, 128, 16, 8, 32
    assert kstem.fused_stem_supported(g, s, n, True, False)
    jm, variables = _g2e_variables(rng, d)
    pts = _f32(rng, b, n, 3)
    _, centers = jgeo.farthest_point_sample_with_centers(jnp.asarray(pts), g)
    idx = knn_pallas(s, jnp.asarray(pts), centers, interpret=True)
    want = group2emb_fused_apply(variables["params"], variables["batch_stats"],
                                 jnp.asarray(pts), centers, idx, jnp.float32, interpret=True)
    g2e = Group2Emb(3, d).eval()  # the serving stem: running statistics
    g2e.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = kstem.group2emb_fused_apply(
            g2e, torch.from_numpy(pts), torch.from_numpy(np.array(centers)),
            torch.from_numpy(np.array(idx)), torch.float32)
    assert got.shape == (b, g, d)
    _close(got.numpy(), want)
    # the unfused module (the patch_compat stem's path) agrees with the fold
    nb, _ = geometry.divide_patches(torch.from_numpy(pts), g, s)
    with torch.no_grad():
        _close(g2e(nb).numpy(), want)
    _close(np.asarray(jm.apply(variables, jnp.asarray(nb.numpy()), True)), want)


def test_stem_gate_matches_jax():
    from vipformer_tpu.ops.pallas.stem import fused_stem_supported as jax_gate

    for args in [(128, 32, 1024, True, False), (16, 8, 256, True, False),
                 (16, 8, 256, False, False), (16, 8, 256, True, True), (12, 8, 64, True, False),
                 (128, 32, 8192, True, False)]:
        assert kstem.fused_stem_supported(*args) == jax_gate(*args)


def test_attention_kv_ln_twin_matches_pallas(rng):
    b, g, m, d, h = 2, 16, 64, 32, 4
    q, x = _f32(rng, b, g, d), _f32(rng, b, m, d)
    lw, lb = _f32(rng, d, scale=0.2) + 1.0, _f32(rng, d, scale=0.1)
    wk, wv = _f32(rng, d, d, scale=d ** -0.5), _f32(rng, d, d, scale=d ** -0.5)
    scale = (d // h) ** -0.5
    want = fused_attention_packed_kv_ln(*map(jnp.asarray, (q, x, lw, lb, wk, wv)),
                                        num_heads=h, scale=scale, interpret=True)
    got = kattn.fused_attention_packed_kv_ln(*map(torch.from_numpy, (q, x, lw, lb, wk, wv)),
                                             num_heads=h, scale=scale)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dt", [(torch.float32, jnp.float32, 1e-5),
                                (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_attention_kv_ln_twin_in_64_token_tiles_matches_pallas(rng, dt):
    """The tile-order witness of the bf16 K4: its twin streamed over
    64-token chunks (the kernel's tiles) against the Pallas kernel run with
    kv_chunk = 64, over several chunks, at the serving widths (D = 256, 4
    heads); f32 within 1e-5, bf16 within 2e-2 (one rounding of k, v or p
    may flip)."""
    tdt, jdt, tol = dt
    b, g, m, d, h = 2, 8, 256, 256, 4
    q, x = _f32(rng, b, g, d), _f32(rng, b, m, d)
    lw, lb = _f32(rng, d, scale=0.2) + 1.0, _f32(rng, d, scale=0.1)
    wk, wv = _f32(rng, d, d, scale=d ** -0.5), _f32(rng, d, d, scale=d ** -0.5)
    scale = (d // h) ** -0.5
    want = fused_attention_packed_kv_ln(
        jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.asarray(lw), jnp.asarray(lb),
        jnp.asarray(wk, jdt), jnp.asarray(wv, jdt), num_heads=h, scale=scale, kv_chunk=64,
        interpret=True)
    got = kattn.attention_kv_ln_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(lw),
        torch.from_numpy(lb), torch.from_numpy(wk).to(tdt), torch.from_numpy(wv).to(tdt), h,
        scale, kv_chunk=64)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def test_attention_small_twin_matches_pallas(rng):
    b, g, d, h = 2, 16, 32, 4
    q, k, v = (_f32(rng, b, g, d) for _ in range(3))
    scale = (d // h) ** -0.5
    want = fused_attention_packed_small(*map(jnp.asarray, (q, k, v)), num_heads=h,
                                        scale=scale, interpret=True)
    got = kattn.fused_attention_packed_small(*map(torch.from_numpy, (q, k, v)),
                                             num_heads=h, scale=scale)
    _close(got.numpy(), want)


def test_online_softmax_chunks_agree(rng):
    """The twin's multi-chunk online softmax (M above the 2048 chunk cap)
    equals the single-block softmax."""
    b, g, m, d, h = 1, 4, 4096, 8, 2
    q, x = _f32(rng, b, g, d), _f32(rng, b, m, d)
    lw, lb = np.ones(d, np.float32), np.zeros(d, np.float32)
    wk, wv = _f32(rng, d, d, scale=0.3), _f32(rng, d, d, scale=0.3)
    args = tuple(map(torch.from_numpy, (q, x, lw, lb, wk, wv)))
    got = kattn.attention_kv_ln_plain(*args, h, 0.5)
    xn = kattn.layer_norm_f32(args[1], args[2], args[3], torch.float32)
    want = kattn.attention_small_plain(args[0], xn @ args[4], xn @ args[5], h, 0.5)
    _close(got.numpy(), want.numpy())


def test_cpu_tensors_never_reach_the_kernels(rng):
    """The dispatch rule: a CPU tensor runs the plain twin, counts no launch
    and never builds the CUDA library."""
    kcuda.reset_launch_counts()
    pts = torch.from_numpy(_f32(rng, 1, 64, 3))
    _, centers = kfps.fps(pts, 8)
    kknn.knn(4, pts, centers)
    q = torch.from_numpy(_f32(rng, 1, 8, 8))
    kattn.fused_attention_packed_small(q, q, q, num_heads=2, scale=0.5)
    assert kcuda.launch_counts() == dict.fromkeys(kcuda.launch_counts(), 0)
    assert kcuda._lib is None


@pytest.mark.parametrize("batch", [1, 3, 8, 32, 64, 128, 512])
def test_kv_splits_leave_no_split_empty(batch):
    """K4's split of the kv chunks over blocks: 1..nchunks splits, none at
    two blocks per SM already, and the kernel's chunks-per-split partition
    (ceil) leaves no split empty."""
    nchunks, sms = 32, 132
    n = kattn.kv_splits(batch * 4, nchunks, sms)
    assert 1 <= n <= nchunks
    per = -(-nchunks // n)
    assert (n - 1) * per < nchunks
    assert kattn.kv_splits(batch * 8, nchunks, sms) <= n  # more blocks, fewer splits
    if batch * 4 >= 2 * sms:
        assert n == 1


# (B, G, M, H): K13's Fourier image shape, and token counts no 64-token
# tile divides
@pytest.mark.parametrize("b,g,m,h", [(48, 128, 20736, 4), (48, 128, 20735, 4), (8, 100, 1000, 2)])
def test_tensor_core_split_plan_covers_every_token_once(b, g, m, h):
    """The bf16 K13's split of its 64-token tiles over blocks on 132 SMs:
    each split takes the kernel's ceil(tiles / nsplit) tiles in order, so
    every token is covered once and no split is empty; the blocks fill at
    least one wave at the kernel's occupancy where M has the tiles for it;
    the partial states have the
    merge pass's shapes."""
    sms, tile = 132, kattn.TC_TILE_TOKENS
    nsplit = kattn.packed_splits(torch.bfloat16, b, g, m, h, sms)
    tiles = -(-m // tile)
    per = -(-tiles // nsplit)  # tiles per split, as csrc/attention.cu computes it
    covered = np.zeros(m, dtype=np.int64)
    for split in range(nsplit):
        lo, hi = split * per * tile, min(m, (split + 1) * per * tile)
        assert lo < hi, split
        covered[lo:hi] += 1
    assert (covered == 1).all()
    units = h * b * -(-g // kattn.TC_Q_TILE)  # (head, cloud, query tile) triples
    blocks = units * nsplit
    assert blocks >= sms
    assert blocks >= min(sms * kattn.TC_BLOCKS_PER_SM, units * tiles)  # a wave, if M allows
    assert nsplit > 1
    assert kattn.split_scratch_shapes(b, g, h, nsplit) == ((b, h, nsplit, g, 64),
                                                           (b, h, nsplit, g, 2))
    assert kattn.split_scratch_shapes(b, g, h, 1) == ((1,), (1,))


def test_attention_dtype_picks_the_kernel():
    """K13 and K14: bf16 goes to the tensor-core entry points, f32 to the
    CUDA-core ones, any other dtype raises; no CUDA-core bf16 entry point
    is left."""
    for base in ("attn_packed", "mha"):
        assert kcuda.tc_route(base, torch.bfloat16) == f"{base}_tc_bf16"
        assert kcuda.tc_route(base, torch.float32) == f"{base}_f32"
        for dt in (torch.bfloat16, torch.float32):
            assert kcuda.tc_route(base, dt) in kcuda.SIGNATURES
        assert f"{base}_bf16" not in kcuda.SIGNATURES
        for dt in (torch.float16, torch.float64):
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                kcuda.tc_route(base, dt)


def test_wrappers_validate_operands():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kcuda.require(torch.zeros(2), "x", torch.float32)
    assert kknn.idx_bits_for(1024) == 10 and kknn.idx_bits_for(1025) == 11
    assert kknn.idx_bits_for(1) == 1
    for base in ("stem", "attn_kv_ln"):  # K3, K4: bf16 on the tensor cores
        for dt in (torch.float32, torch.bfloat16):
            assert kcuda.tc_route(base, dt) in kcuda.SIGNATURES
        assert f"{base}_bf16" not in kcuda.SIGNATURES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kcuda.tc_route("stem", torch.float16)
