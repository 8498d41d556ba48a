"""The port's semantic segmentation (ft_semseg) against the JAX package's,
on the CPU: the eval logits, one train step (with the default kernel flags
and with K17 and K18 forced), the synthetic S3DIS, the metric and the CLI.

A tiny CrossFormerSemSeg (D=32, H=2, 2 SA layers tapped at 1 and 2, 16
groups of 8 among 256 xyz+rgb points, 13 classes) is initialised by flax
and carried to the port with `convert.from_jax_variables` (a strict load
of the whole semseg tree). The JAX side runs its Pallas kernels in
interpret mode with the fused attention, Group2Emb and Dense
weight-gradient kernels forced, the port the same gates, so both run those
kernels (here: twins) at the same sites. Dropout and DropPath are 0, the
head's fixed Dropout(0.5) is off on both sides, FPS starts at index 0.
B=16, so that the latents' LayerNorms (16 x 16 rows) meet the JAX row
blocking of K17 when it is forced.

Tolerances (f32, sums in other orders), relative to max(1, max |jax|):
the eval logits, the loss, every gradient leaf and every batch statistic
within 1e-4; the accuracy equal.
"""

import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipformer_tpu import config as jconfig
from vipformer_tpu.data import datasets as jdatasets
from vipformer_tpu.data import synthetic as jsynthetic
from vipformer_tpu.evaluation import iou as jiou
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import batchnorm as jbn
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu.ops.pallas import g2e_train as jg2e
from vipformer_tpu.ops.pallas import layernorm as jln
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.data import datasets as tdatasets
from vipformer_tpu_torch.data import synthetic as tsynthetic
from vipformer_tpu_torch.evaluation import iou as tiou
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.ops.cuda import layernorm as kln
from vipformer_tpu_torch.train.trainer import create_state, make_semseg_eval, make_semseg_step

TINY = dict(jconfig.decode_arch_name("E1CL2SL-H2D32-L16-MR2"), group_size=8, point_channels=6,
            num_obj_classes=13, layer_idx=(1, 2), compute_dtype="float32", atten_drop=0.0,
            mlp_drop=0.0, max_dpr=0.0, optim="adamw", lr=1e-3)
B, N = 16, 256
TOL = 1e-4
# with both norm flags forced: K18 at the decode's four BatchNorms (16 x
# 256 point rows; Group2Emb's run inside K9), K17 at the adapter's
# LayerNorm (4,096 point rows), the cross-attention's q_norm, kv_norm (at
# D=32 K7's gate leaves it outside the kernel) and MLP LayerNorm, the two
# SA layers' two each, and the shared `norm` once per tap (256 latent rows
# each); every one of them reaches the loss
K18_SITES, K17_SITES = 4, 1 + 3 + 2 * 2 + 2


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def _batch():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (B, N, 6)).astype(np.float32)
    pts[..., :3] += np.arange(B, dtype=np.float32)[:, None, None] * 0.01
    return {"points": pts, "seg": rng.integers(0, 13, (B, N)).astype(np.int64)}


@pytest.fixture(scope="module", params=[False, True], ids=["default", "norms_forced"])
def jax_semseg(request):
    """JAX variables, a batch, and with the norm flags at their default or
    forced: the JAX step's loss, accuracy, gradients and new batch
    statistics, and the JAX eval's logits."""
    forced = request.param
    cfg = jconfig.Config(**TINY)
    batch = _batch()
    model = jfactory.build_ft_semseg(cfg)
    pts = jnp.asarray(batch["points"])
    params, stats = jtrainer.init_variables(model, (pts,), cfg.seed)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(  # nontrivial eval statistics
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32)), stats)
    flags = [(jattn, "USE_FUSED_ATTENTION", True), (jg2e, "USE_G2E_TRAIN", True),
             (jgeo, "USE_PALLAS_FPS", True), (jgeo, "KNN_METHOD", "pallas"),
             (jdense, "USE_DENSE_GRAD", True),
             (jtrainer, "_make_step", lambda loss_fn, tx: loss_fn),
             (jtrainer, "_rngs", lambda key, n=2: {"dropout": jax.random.split(key, n)[0]}),
             # the head's Dropout(0.5) off: no JAX mask can match the port's
             (flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)]
    if forced:
        flags += [(jbn, "USE_BN_TRAIN", True), (jln, "USE_LAYERNORM", True)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in flags]
    fps_fns = (jgeo.farthest_point_sample, jgeo.farthest_point_sample_with_centers)
    try:
        for mod, name, value in flags:
            setattr(mod, name, value)
        for fn in fps_fns:  # the jitted FPS reads its flag while tracing
            fn.clear_cache()
        loss_fn = jtrainer.make_semseg_step(cfg, model, None)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, (new_stats, metrics)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, stats, jbatch, jax.random.key(1))
        logits = model.apply({"params": params, "batch_stats": stats}, pts, deterministic=True)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        for fn in fps_fns:
            fn.clear_cache()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(forced=forced, params=host(params), stats=host(stats), batch=batch,
                loss=float(loss), metrics=host(metrics), grads=host(grads),
                new_stats=host(new_stats), logits=np.asarray(logits))


@pytest.fixture
def port(jax_semseg, monkeypatch):
    """The port's tiny model with the JAX weights, the JAX side's gates
    forced here too, the head's dropout off, and counts of the K11, K17
    and K18 twins."""
    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", True)
    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION", True)
    if jax_semseg["forced"]:
        monkeypatch.setattr(kbn, "USE_BN_TRAIN", True)
        monkeypatch.setattr(kln, "USE_LAYERNORM", True)
    calls = {"dense_grads": 0, "bn_stats": 0, "bn_grad_reduces": 0, "ln_fwd": 0, "ln_bwd": 0}
    for mod, name in ((kdense, "dense_grads"), (kbn, "bn_stats"), (kbn, "bn_grad_reduces"),
                      (kln, "ln_fwd"), (kln, "ln_bwd")):
        def wrapped(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    cfg = tconfig.Config(**TINY)
    model = tfactory.build_ft_semseg(cfg, device="cpu")
    model.seg_head.drop = 0.0
    model.load_state_dict(from_jax_variables({"params": jax_semseg["params"],
                                              "batch_stats": jax_semseg["stats"]}), strict=True)
    return cfg, model, calls


def test_semseg_eval_matches_jax(jax_semseg, port):
    """The eval logits within 1e-4 of the JAX model's (the port's eval stem
    runs K3's twin with every channel of the FPS centers gathered, JAX's
    unfused stem the same function) and make_semseg_eval their argmax."""
    _, model, calls = port
    pts = jax_semseg["batch"]["points"]
    with torch.inference_mode():
        logits = model(torch.from_numpy(pts))
    assert tuple(logits.shape) == (B, N, 13)
    _close(logits, jax_semseg["logits"], TOL, "logits")
    pred = make_semseg_eval(model)(pts)
    assert pred.dtype == torch.int64
    np.testing.assert_array_equal(pred.numpy(), logits.argmax(-1).numpy())
    assert calls["bn_stats"] == 0  # eval uses the running statistics


def test_semseg_step_matches_jax(jax_semseg, port):
    """One make_semseg_step (smoothed CE 0.2 over B*N rows): the loss,
    every gradient leaf and every new batch statistic within 1e-4 and the
    accuracy equal to the JAX step's; with the flags forced, K18's twin
    ran at its 4 sites and K17's at its 10, forward and backward."""
    cfg, model, calls = port
    state = create_state(cfg, {"pc": model})
    captured = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: captured.__setitem__(name, g.detach().clone()))
    state, metrics = make_semseg_step(cfg, model)(state, jax_semseg["batch"], 1e-3)
    assert state.step == 1
    _close(metrics["loss"], jax_semseg["loss"], TOL, "loss")
    assert float(metrics["acc"]) == pytest.approx(float(jax_semseg["metrics"]["acc"]), abs=1e-7)
    want = grads_from_jax(jax_semseg["grads"])
    assert set(captured) == set(want)
    for k in want:
        _close(captured[k], want[k], TOL, k)
    new_stats = from_jax_variables({"batch_stats": jax_semseg["new_stats"]})
    got = model.state_dict()
    assert len(new_stats) == 2 * 6  # Group2Emb's 2, FeaturePropagation's 2, SegHead's 2
    for k, v in new_stats.items():
        _close(got[k], v, TOL, k)
    n18, n17 = (K18_SITES, K17_SITES) if jax_semseg["forced"] else (0, 0)
    assert (calls["bn_stats"], calls["bn_grad_reduces"]) == (n18, n18)
    assert (calls["ln_fwd"], calls["ln_bwd"]) == (n17, n17)
    assert calls["dense_grads"] > 0


def test_synthetic_s3dis_and_miou_match_jax():
    """`synthetic_semseg` and the S3DIS stand-in's splits (200 / 60 blocks
    of 4,096 x 9, seeds 6 / 8) give the JAX package's arrays; `semseg_miou`
    its numbers, an absent class included."""
    d_t, l_t = tsynthetic.synthetic_semseg(3, 512, seed=11)
    d_j, l_j = jsynthetic.synthetic_semseg(3, 512, seed=11)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(l_t, l_j)
    for split, n in (("train", 200), ("test", 60)):
        ours, ref = tdatasets.S3DIS("/nonexistent", split), jdatasets.S3DIS("/nonexistent", split)
        assert len(ours) == len(ref) == n
        for i in (0, n - 1):
            for a, b in zip(ours.get(i), ref.get(i)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 12, (4, 300))  # class 12 never occurs
    pred = np.where(rng.uniform(size=seg.shape) < 0.7, seg, rng.integers(0, 13, seg.shape))
    assert tiou.semseg_miou(pred, seg) == jiou.semseg_miou(pred, seg)


def test_s3dis_hdf5_reader_is_refused(tmp_path):
    """Where the real blocks' listing exists the port reads the files it
    lists and never falls back to the stand-in: a listed file that is
    missing is refused with an error (as the JAX reader's), not replaced
    by synthetic blocks."""
    root = tmp_path / "indoor3d_sem_seg_hdf5_data"
    root.mkdir()
    (root / "all_files.txt").write_text("ply_data_all_0.h5\n")
    (root / "room_filelist.txt").write_text("Area_1_office_1\n")
    for reader in (tdatasets.S3DIS, jdatasets.S3DIS):
        with pytest.raises(OSError):
            reader(str(tmp_path), "train")


def test_ft_semseg_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    """`cli.ft_semseg --resume true` restores the encoder (only) from a
    pretrain checkpoint, trains two epochs on the synthetic S3DIS (cut to 8
    train / 6 test blocks here) with xyz+rgb, writes one metrics line per
    epoch and model_best on a new best mIoU; the unported options raise."""
    from vipformer_tpu_torch.cli import ft_semseg
    from vipformer_tpu_torch.train.checkpoint import load_metadata, save_checkpoint

    monkeypatch.setattr(tdatasets.S3DIS, "sizes", {"train": (8, 6), "test": (6, 8)})
    arch = ["--arch", "E1CL2SL-H2D32-L16-MR2", "--group_size", "8", "--compute_dtype",
            "float32", "--run_dir", str(tmp_path), "--device", "cpu"]
    pcfg = tconfig.Config(**tconfig.decode_arch_name("E1CL2SL-H2D32-L16-MR2"), group_size=8)
    ckpt = tmp_path / "pc_model_best.ckpt"
    save_checkpoint(str(ckpt), tfactory.build_pc_model(pcfg, device="cpu", seed=3),
                    {"epoch": 0, "patch_compat": False})
    argv = ["--synthetic_data", "true", "--batch_size", "4", "--test_batch_size", "4",
            "--layer_idx", "1", "2", "--exp_name", "sem"] + arch
    cfg, dev = ft_semseg.parse_args(argv + ["--epochs", "2", "--resume", "true",
                                            "--pc_model_file", str(ckpt), "--save_freq", "1"])
    assert (cfg.ft_dataset, cfg.point_channels, cfg.num_obj_classes) == ("S3DIS", 6, 13)
    assert cfg.num_sa_layers == 2 and cfg.max_dpr == 0.1 and cfg.layer_idx == (1, 2)
    out = ft_semseg.main(cfg, dev)
    root = tmp_path / cfg.proj_name / "sem"
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1]
    for m in lines:
        assert {"miou", "point_level_acc", "train_loss", "train_acc", "lr"} <= set(m)
        assert np.isfinite(m["train_loss"]) and 0.0 <= m["miou"] <= 1.0
    assert out["best"]["miou"] == max(m["miou"] for m in lines)
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "backbone restore: " in log and "fresh init for ['stem', 'norm', 'propagation', " \
        "'seg_head']" in log
    meta = load_metadata(str(root / "models" / "model_best.ckpt"))
    assert meta["kind"] == "ft_semseg" and meta["epoch"] == out["best_epoch"]
    # --resume_training continues from the rolling model_last at epoch 2
    resumed = ft_semseg.main(*ft_semseg.parse_args(argv + ["--epochs", "3",
                                                           "--resume_training", "true"]))
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1, 2]
    assert resumed["best"]["miou"] >= out["best"]["miou"]
    assert "resumed training from" in "".join(p.read_text() for p in root.glob("*.log"))
