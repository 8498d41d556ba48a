"""The partseg slice's kernel module (K12), geometry, layers, loss, metrics
and data against the JAX package, on the CPU.

K12's plain twin (what `vipformer_tpu_torch` runs on a CPU tensor) is held
against `gather_rows_pallas` run by the JAX package in interpret mode, and
its VJP against `jax.vjp` of it, on the same numpy inputs; the modules
that the slice adds (the 3-NN weights, the implicit-concat Dense, the
feature propagation, the partseg loss, the refined prediction, the IoU
metrics, the synthetic ShapeNetPart) against their JAX counterparts. The
CUDA kernel itself runs only on a card (tests/test_torch_port_cuda.py,
chip_smoke.py).

Tolerances: the gather is a copy, so exactly equal in f32 and bf16; the
scatter (f32 sums in another order) within 1e-6 of max(1, max |jax|);
the modules at f32 within 1e-5 (sums in other orders); the 3-NN weights'
ties resolved to the same (first) index.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipformer_tpu.data import datasets as jds
from vipformer_tpu.data import pipeline as jpipe
from vipformer_tpu.evaluation import iou as jiou
from vipformer_tpu.losses.classification import partseg_smoothed_loss as jax_psl
from vipformer_tpu.nn import layers as jl
from vipformer_tpu.nn import pointnet as jpn
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu.ops.pallas import gather as jgather
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.data import datasets as tds
from vipformer_tpu_torch.data import pipeline as tpipe
from vipformer_tpu_torch.evaluation import iou as tiou
from vipformer_tpu_torch.losses.classification import partseg_smoothed_loss
from vipformer_tpu_torch.nn import layers as tl
from vipformer_tpu_torch.nn import pointnet as tpn
from vipformer_tpu_torch.ops import geometry as tgeo
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.ops.cuda import gather as kgather
from vipformer_tpu_torch.train import trainer as ttrainer

TOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, name=""):
    got = np.asarray((got.detach().float() if isinstance(got, torch.Tensor) else got), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


# ------------------------------------------------------------------ K12


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,n,c,k", [(2, 200, 3, 512), (1, 130, 128, 300), (3, 64, 5, 77)])
def test_gather_rows_twin_matches_pallas(rng, b, n, c, k, dt):
    """K12's twin against gather_rows_pallas (interpret; K off the Pallas
    kernel's 128-row tiles included): the rows equal, and the VJP's
    scatter-add (repeated indices summed) within 1e-6 at f32."""
    tdt, jdt = DTYPES[dt]
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[:, :8] = idx[:, :1]  # one row picked eight times
    g = rng.standard_normal((b, k, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jgather.gather_rows_pallas(p, jnp.asarray(idx), 8, True),
                        jnp.asarray(pts, jdt))
    pt = torch.from_numpy(pts).to(tdt).requires_grad_()
    got = kgather.gather_rows(pt, torch.from_numpy(idx))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, kgather.gather_rows_plain(pt, torch.from_numpy(idx)))
    got.backward(torch.from_numpy(g).to(tdt))
    assert pt.grad.dtype == tdt
    if dt == "float32":  # JAX's bf16 scatter rounds per grid block (gather.py:98)
        _close(pt.grad, vjp(jnp.asarray(g))[0], 1e-6, "d_points")
    dp = kgather.scatter_rows_plain(torch.from_numpy(g).to(tdt), torch.from_numpy(idx), n)
    assert dp.dtype == torch.float32
    assert torch.equal(pt.grad, dp.to(tdt))


def test_row_gather_gate_matches_jax():
    """Auto, the port's gate engages on the card where the JAX gate's shape
    conditions hold (C <= 128, N >= 128, K >= 512): the compat stem's
    [96, 1024, 3] x 4096 gather, not a small or wide one; off the card
    never. Forced, both gates answer the flag."""
    assert kgather.USE_ROW_GATHER is None
    assert kgather.row_gather_enabled(3, 1024, 4096, True)
    assert kgather.row_gather_enabled(128, 128, 512, True)
    for c, n, k in ((129, 1024, 4096), (3, 127, 4096), (3, 1024, 511)):
        assert not kgather.row_gather_enabled(c, n, k, True)
    assert not kgather.row_gather_enabled(3, 1024, 4096, False)
    saved = kgather.USE_ROW_GATHER, jgather.USE_MXU_GATHER
    try:
        for on in (True, False):
            kgather.USE_ROW_GATHER = jgather.USE_MXU_GATHER = on
            pts = jnp.zeros((1, 8, 3))
            assert kgather.row_gather_enabled(3, 8, 4, False) == jgather.mxu_gather_enabled(pts, 4)
    finally:
        kgather.USE_ROW_GATHER, jgather.USE_MXU_GATHER = saved


@pytest.mark.parametrize("forced", [True, None])
def test_index_points_matches_jax(rng, monkeypatch, forced):
    """index_points on a [B, G, S] index, through K12's twin (forced) or
    the plain gather (auto, off the card), equals the JAX one."""
    monkeypatch.setattr(kgather, "USE_ROW_GATHER", forced)
    calls = []
    plain = kgather.gather_rows_plain
    monkeypatch.setattr(kgather, "gather_rows_plain", lambda *a: calls.append(1) or plain(*a))
    pts = rng.standard_normal((2, 150, 4)).astype(np.float32)
    idx = rng.integers(0, 150, (2, 16, 8)).astype(np.int32)
    want = jgeo.index_points(jnp.asarray(pts), jnp.asarray(idx))
    got = tgeo.index_points(torch.from_numpy(pts), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(calls) == (1 if forced else 0)


# --------------------------------------------------------------- 3-NN


@pytest.mark.parametrize("ties", [False, True])
def test_three_nn_weights_match_jax(rng, ties):
    """The 3-NN weights and the interpolation against JAX; with ties
    planted (integer grids: sources at equal distances from a point, and
    duplicated sources) the same first indices win."""
    if ties:
        dst = rng.integers(-2, 3, (2, 40, 3)).astype(np.float32)
        src = rng.integers(-2, 3, (2, 12, 3)).astype(np.float32)
        src[:, 6:] = src[:, :6]  # every source twice
    else:
        dst = rng.standard_normal((2, 40, 3)).astype(np.float32)
        src = rng.standard_normal((2, 12, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 12, 7)).astype(np.float32)
    want = np.asarray(jgeo.three_nn_weights(jnp.asarray(dst), jnp.asarray(src)))
    got = tgeo.three_nn_weights(torch.from_numpy(dst), torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) == 3).all()
    _close(got, want, TOL, "weights")
    _close(tgeo.three_nn_interpolate(torch.from_numpy(dst), torch.from_numpy(src),
                                     torch.from_numpy(feats)),
           jgeo.three_nn_interpolate(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feats)),
           TOL, "interpolated")


# ------------------------------------------------- implicit-concat Dense


def _segments(rng):
    """(skip [2, 128, 3], group feats [2, 8, 10], global [2, 1, 6]) and
    the 3-NN weights [2, 128, 8] of the post-fn segment."""
    skip = rng.standard_normal((2, 128, 3)).astype(np.float32)
    src = rng.standard_normal((2, 8, 10)).astype(np.float32)
    glob = rng.standard_normal((2, 1, 6)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (2, 128, 8)).astype(np.float32)
    return skip, src, glob, w


@pytest.mark.parametrize("layout", ["post_and_broadcast", "post_only", "broadcast_first"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_segments_match_jax(rng, monkeypatch, layout, use_bias):
    """The port's Dense on a tuple against the JAX Dense on the same tuple,
    in train mode with K11 forced on both sides: a post-fn segment (a
    linear operator hoisted through the layer), a broadcast [B, 1, C]
    segment, and the bias on the post-free segment with the most rows (or
    on the sum when every segment has a post-fn). The parameter tree is
    that of Dense over the concat; output, input gradients and parameter
    gradients within 1e-5, and K11's twin ran for the one segment whose
    rows have a feasible block (the skip's 256; forced mode, so the JAX
    kernel's block rule decides)."""
    skip, src, glob, w = _segments(rng)
    monkeypatch.setattr(jdense, "USE_DENSE_GRAD", True)
    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", True)
    jpost = lambda h: jnp.einsum("bns,bsd->bnd", jnp.asarray(w), h)  # noqa: E731
    tpost = lambda h: torch.from_numpy(w) @ h  # noqa: E731
    arrays = {"post_and_broadcast": (skip, src, glob), "post_only": (src,),
              "broadcast_first": (glob, skip, src)}[layout]

    at = next(i for i, a in enumerate(arrays) if a is src)  # the post-fn segment

    def pack(xs, post, conv):
        return tuple((conv(a), post) if i == at else conv(a) for i, a in enumerate(xs))

    jm = jl.Dense(12, use_bias=use_bias)
    params = jm.init(jax.random.key(0), pack(arrays, jpost, jnp.asarray))
    cot = rng.standard_normal((2, 128, 12)).astype(np.float32)

    def loss(p, xs):
        return jnp.sum(jm.apply(p, pack(xs, jpost, lambda a: a)) * cot)

    jxs = tuple(jnp.asarray(a) for a in arrays)
    want_y = jm.apply(params, pack(jxs, jpost, lambda a: a))
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jxs)
    fan_in = sum(a.shape[-1] for a in arrays)
    tm = tl.Dense(fan_in, 12, use_bias=use_bias)
    tm.load_state_dict(from_jax_variables(params), strict=True)
    tm.train()
    calls = []
    grads = kdense.dense_grads
    monkeypatch.setattr(kdense, "dense_grads", lambda *a: calls.append(1) or grads(*a))
    txs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = tm(pack(txs, tpost, lambda a: a))
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y, want_y, TOL, "y")
    for t, g in zip(txs, want_gx):
        _close(t.grad, g, TOL, "dx")
    want = grads_from_jax(want_gp["params"])
    for k, p in tm.named_parameters():
        _close(p.grad, want[k], TOL, k)
    assert len(calls) == (0 if layout == "post_only" else 1)  # 16 and 2 rows: no block


def test_feature_propagation_matches_jax(rng):
    """FeaturePropagation (the first Dense hoisted through the 3-NN
    interpolation, skip features as a segment) against JAX, eval and train
    (batch-statistics BatchNorm): outputs and every gradient within 1e-5."""
    xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
    centers = xyz[:, :16]
    feats = rng.standard_normal((2, 16, 24)).astype(np.float32)
    jm = jpn.FeaturePropagation(mlp=(32, 20))
    args = (jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(xyz), jnp.asarray(feats))
    v = jm.init(jax.random.key(0), *args)
    cot = rng.standard_normal((2, 64, 20)).astype(np.float32)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *args,
                          deterministic=False, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    tm = tpn.FeaturePropagation(3, 24, (32, 20))
    tm.load_state_dict(from_jax_variables(v), strict=True)
    targs = [torch.from_numpy(a) for a in (xyz, centers, xyz, feats)]
    tm.eval()
    with torch.no_grad():
        _close(tm(*targs), jm.apply(v, *args), TOL, "eval")
    tm.train()
    (tm(*targs) * torch.from_numpy(cot)).sum().backward()
    want = grads_from_jax(jax.grad(loss)(v["params"]))
    for k, p in tm.named_parameters():
        _close(p.grad, want[k], TOL, k)


# ------------------------------------------------ loss, metrics, data


@pytest.mark.parametrize("smoothing", [True, False])
def test_partseg_smoothed_loss_matches_jax(rng, smoothing):
    logits = (3.0 * rng.standard_normal((2, 20, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 20))
    want = jax_psl(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = partseg_smoothed_loss(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    _close(got, want, TOL)


def test_refine_and_partseg_metrics_match_jax(rng):
    """The category mask, the refined prediction (ties and -inf-free f32
    minimum fill included) and PartSegMetrics over padded batches (the
    empty-union rule, the predicted/true part-acc ratio) equal JAX's."""
    np.testing.assert_array_equal(ttrainer.category_part_mask(), jtrainer.category_part_mask())
    logits = rng.standard_normal((6, 30, 50)).astype(np.float32)
    logits[0, 0] = 0.0  # a row of ties
    obj = rng.integers(0, 16, 6)
    want = np.asarray(jtrainer.refine_partseg_pred(jnp.asarray(logits), jnp.asarray(obj)))
    got = ttrainer.refine_partseg_pred(torch.from_numpy(logits), torch.from_numpy(obj))
    np.testing.assert_array_equal(got.numpy(), want)
    seg = np.stack([jiou.INDEX_START[c] + rng.integers(0, jiou.SEG_NUM[c], 30) for c in obj])
    seg[1, :] = jiou.INDEX_START[obj[1]]  # parts absent from one shape: empty unions
    mj, mt = jiou.PartSegMetrics(), tiou.PartSegMetrics()
    valid = np.array([True, True, True, True, False, False])
    for m in (mj, mt):
        m.update(want[:4], seg[:4], obj[:4])
        m.update(want[2:], seg[2:], obj[2:], valid=valid[2:])
    assert mt.results() == mj.results()
    np.testing.assert_array_equal(tiou.shape_ious(want, seg, obj), jiou.shape_ious(want, seg, obj))


@pytest.mark.parametrize("class_choice", [None, "chair"])
def test_shapenetpart_and_collate_match_jax(tmp_path, class_choice):
    """The synthetic ShapeNetPart stand-in equals the JAX package's (sizes,
    seeds, class_choice, the trainval point shuffle drawn from the
    sample's generator), and collate_partseg / pad_batch batch it alike."""
    for split in ("trainval", "test"):
        want = jds.ShapeNetPart(str(tmp_path), split, 100, class_choice)
        got = tds.ShapeNetPart(str(tmp_path), split, 100, class_choice)
        assert len(got) == len(want) and got.seg_num_all == want.seg_num_all
        assert got.seg_start_index == want.seg_start_index
        idx = [0, 1, len(want) - 1]
        sj = [want.get(i, np.random.default_rng(i)) for i in idx]
        st = [got.get(i, np.random.default_rng(i)) for i in idx]
        for (pt, lt, gt), (pj, lj, gj) in zip(st, sj):
            assert pt.shape == (100, 3) and lt == lj
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(gt, gj)
        bt, mt = tpipe.pad_batch(tpipe.collate_partseg(st), 5)
        bj, mj = jpipe.pad_batch(jpipe.collate_partseg(sj), 5)
        np.testing.assert_array_equal(mt, mj)
        assert set(bt) == set(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])


def test_warn_patch_compat(tmp_path):
    """A checkpoint whose sidecar records the other stem mode logs one
    WARNING; a matching mode or a missing sidecar logs nothing."""
    from vipformer_tpu_torch.cli.common import warn_patch_compat
    from vipformer_tpu_torch.config import Config

    path = str(tmp_path / "pc.ckpt")
    msgs = []
    warn_patch_compat(path, Config(patch_compat=True), msgs.append)
    assert msgs == []
    with open(path + ".json", "w") as f:
        f.write('{"patch_compat": true}')
    warn_patch_compat(path, Config(patch_compat=True), msgs.append)
    assert msgs == []
    warn_patch_compat(path, Config(patch_compat=False), msgs.append)
    assert len(msgs) == 1 and msgs[0].startswith("WARNING: checkpoint")
    assert "--patch_compat true" in msgs[0] and os.path.exists(path + ".json")


def test_dense_gate_partseg_sites_match_jax(monkeypatch):
    """Every Dense of the partseg step at ft-partseg.sh's shapes (B=96, 1024
    points, 128 latents, D=384, MLP x4, 3 taps): the port's auto gate on
    the card and the JAX gate on its accelerator agree site by site, and
    K11 takes exactly the five sites chip_smoke.py's PARTSEG_DENSE_SITES
    lists (the JAX gate's TPU check answered as on its accelerator)."""
    import chip_smoke

    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", None)
    monkeypatch.setattr(jdense, "USE_DENSE_GRAD", None)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    pts, lat, b, d = 96 * 1024, 96 * 128, 96, 384
    sites = [(pts, 3, 64), (pts, 64, d),  # input adapter
             (lat, 3, 128), (lat, 128, d),  # PositionEmb
             (lat, d, d), (lat, d, d), (lat, d, 4 * d), (lat, 4 * d, d)]  # CA q/o, MLP
    sites += [(lat, d, d)] * 4 * 12 + [(lat, d, 4 * d), (lat, 4 * d, d)] * 12  # SA layers
    sites += [(b, 16, 64),  # LabelConv
              (pts, 3, 4 * d), (lat, 3 * d, 4 * d), (pts, 4 * d, 1024),  # FP
              (pts, 1024, 512), (b, 2 * 3 * d + 64, 512), (pts, 512, 256), (pts, 256, 50)]
    taken = {}
    for r, ci, co in sites:
        port = kdense.dense_grad_enabled(r, ci, co, 2, on_card=True)
        assert port == jdense.dense_grad_enabled(r, ci, co, 2), (r, ci, co)
        if port:
            taken[(ci, co)] = taken.get((ci, co), 0) + 1
    assert taken == chip_smoke.PARTSEG_DENSE_SITES
