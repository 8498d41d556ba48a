"""The port's part segmentation (ft_partseg) against the JAX package's, on
the CPU: the eval logits, one train step's loss and gradients, the
backbone restore and the CLI.

A tiny CrossFormerPartSeg (D=128, H=2, 3 SA layers tapped at 1, 2 and 3,
16 groups of 8 among 128 points, FP widths (256, 1024)) is initialised by
flax and carried to the port with `convert.from_jax_variables` (a strict
load of the whole partseg tree: `norm`, `label_conv`, `propagation`,
`seg_head`). The JAX side runs its Pallas kernels in interpret mode with
the gather (USE_MXU_GATHER, so `patch_compat` runs K12) and the Dense
weight-gradient kernel (USE_DENSE_GRAD) forced; the port forces the same
gates, so it runs those kernels' twins at the same sites. Dropout is 0,
DropPath 0, the head's fixed Dropout(0.5) is switched off on both sides
and FPS starts at index 0, because the frameworks' random streams differ.

Tolerances (f32, sums in other orders), relative to max(1, max |jax|):
the eval logits, the loss and every gradient leaf within 1e-4; the
refined predictions equal.
"""

import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipformer_tpu import config as jconfig
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu.ops.pallas import g2e_train as jg2e
from vipformer_tpu.ops.pallas import gather as jgather
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.ops.cuda import gather as kgather
from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step

TINY = dict(jconfig.decode_arch_name("E1CL3SL-H2D128-L16-MR2"), group_size=8,
            num_ft_points=128, layer_idx=(1, 2, 3), compute_dtype="float32", atten_drop=0.0,
            mlp_drop=0.0, max_dpr=0.0, optim="adamw", lr=1e-3, grad_clip_norm=10.0)
# B=8: LabelConv's batch-statistics BatchNorm normalises over the B rows;
# over 4 the step is ill-conditioned (gradients 4e-3 apart at f32 between
# two summation orders, the loss 1e-7), over 8 they agree to 4e-6
B, N = 8, 128
TOL = 1e-4
# K11's sites at B=8 (forced; the JAX kernel needs a row count that a
# power of two >= 128 divides): at 1,024 point rows the adapter's two
# Denses, FP's xyz segment and its second Dense, SegHead's f0 segment and
# its two later Denses (7); at 128 latent rows PositionEmb (2), the CA
# layer's q_proj, o_proj and MLP (4), each SA layer's q/k/v/o_proj and MLP
# (3 x 6) and FP's group segment (1). LabelConv and the global segment (8
# rows) have no feasible row block.
K11_SITES = 7 + 2 + 4 + 3 * 6 + 1


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def _batch():
    rng = np.random.default_rng(0)
    obj = rng.integers(0, 16, B).astype(np.int64)
    return {"points": rng.standard_normal((B, N, 3)).astype(np.float32), "obj_labels": obj,
            "seg": rng.integers(0, 50, (B, N)).astype(np.int64)}


@pytest.fixture(scope="module", params=[False, True], ids=["intent", "compat"])
def jax_partseg(request):
    """JAX variables, a batch, and for one `patch_compat` setting the JAX
    step's loss, accuracy and gradients and the JAX eval's logits and
    refined predictions."""
    cfg = jconfig.Config(**TINY, patch_compat=request.param)
    batch = _batch()
    model = jfactory.build_ft_partseg(cfg)
    pts, onehot = jnp.asarray(batch["points"]), jax.nn.one_hot(batch["obj_labels"], 16)
    params, stats = jtrainer.init_variables(model, (pts, onehot), cfg.seed)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(  # nontrivial eval statistics
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32)), stats)
    flags = [(jattn, "USE_FUSED_ATTENTION", True), (jg2e, "USE_G2E_TRAIN", True),
             (jgather, "USE_MXU_GATHER", True), (jgeo, "USE_PALLAS_FPS", True),
             (jgeo, "KNN_METHOD", "pallas"), (jdense, "USE_DENSE_GRAD", True),
             (jtrainer, "_make_step", lambda loss_fn, tx: loss_fn),
             (jtrainer, "_rngs", lambda key, n=2: {"dropout": jax.random.split(key, n)[0]}),
             # the head's Dropout(0.5) off: no JAX mask can match the port's
             (flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in flags]
    fps_fns = (jgeo.farthest_point_sample, jgeo.farthest_point_sample_with_centers)
    try:
        for mod, name, value in flags:
            setattr(mod, name, value)
        for fn in fps_fns:  # the jitted FPS reads its flag while tracing
            fn.clear_cache()
        loss_fn = jtrainer.make_partseg_step(cfg, model, None)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, (_, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, jbatch, jax.random.key(1))
        logits, refined = jtrainer.make_partseg_eval(model)(params, stats, pts,
                                                            jbatch["obj_labels"])
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        for fn in fps_fns:
            fn.clear_cache()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(compat=request.param, params=host(params), stats=host(stats), batch=batch,
                loss=float(loss), metrics=host(metrics), grads=host(grads),
                logits=np.asarray(logits), refined=np.asarray(refined))


@pytest.fixture
def port(jax_partseg, monkeypatch):
    """The port's tiny model with the JAX weights, the gather and K11
    forced, the head's dropout off, and counts of the K11 and K12 twins."""
    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", True)
    monkeypatch.setattr(kgather, "USE_ROW_GATHER", True)
    # the attention gates forced as on the JAX side (USE_FUSED_ATTENTION), so
    # the k/v projections stay inside K7 there and here
    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION", True)
    calls = {"dense_grads": 0, "gather_rows": 0}

    def count(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    count(kdense, "dense_grads", "dense_grads")
    count(kgather, "gather_rows_plain", "gather_rows")
    cfg = tconfig.Config(**TINY, patch_compat=jax_partseg["compat"])
    model = tfactory.build_ft_partseg(cfg, device="cpu")
    model.seg_head.drop = 0.0
    model.load_state_dict(from_jax_variables({"params": jax_partseg["params"],
                                              "batch_stats": jax_partseg["stats"]}), strict=True)
    return cfg, model, calls


def test_partseg_eval_matches_jax(jax_partseg, port):
    """make_partseg_eval: logits within 1e-4 of the JAX eval's and the
    category-refined predictions equal; with patch_compat the neighbour
    gather ran through K12's twin once, without it not at all."""
    _, model, calls = port
    batch = jax_partseg["batch"]
    logits, refined = make_partseg_eval(model)(batch["points"], batch["obj_labels"])
    assert tuple(logits.shape) == (B, N, 50) and refined.dtype == torch.int64
    _close(logits, jax_partseg["logits"], TOL, "logits")
    np.testing.assert_array_equal(refined.numpy(), jax_partseg["refined"])
    assert calls["gather_rows"] == int(jax_partseg["compat"])


def test_partseg_step_matches_jax(jax_partseg, port):
    """One make_partseg_step (smoothed CE 0.2 over B*N rows, clip 10): the
    loss and every gradient leaf within 1e-4 and the refined accuracy equal
    to the JAX step's; K11's twin ran at its 32 sites and K12's (compat)
    once."""
    cfg, model, calls = port
    state = create_state(cfg, {"pc": model})
    captured = {}
    for name, p in model.named_parameters():  # the gradients before the clip
        p.register_hook(lambda g, name=name: captured.__setitem__(name, g.detach().clone()))
    state, metrics = make_partseg_step(cfg, model)(state, jax_partseg["batch"], 1e-3)
    assert state.step == 1
    _close(metrics["loss"], jax_partseg["loss"], TOL, "loss")
    assert float(metrics["acc"]) == pytest.approx(float(jax_partseg["metrics"]["acc"]), abs=1e-7)
    assert calls["dense_grads"] == K11_SITES
    assert calls["gather_rows"] == int(jax_partseg["compat"])
    want = grads_from_jax(jax_partseg["grads"])
    assert set(captured) == set(want)
    for k in want:
        _close(captured[k], want[k], TOL, k)


def test_partseg_tree_restores_from_a_pretrain_checkpoint(tmp_path):
    """The partseg model's stem and encoder load key by key from a pretrain
    checkpoint of the same widths; its norm, label_conv, propagation and
    seg_head keep their fresh init."""
    from vipformer_tpu_torch.train.checkpoint import (
        branch_state,
        load_checkpoint,
        restore_backbone,
        save_checkpoint,
    )

    cfg = tconfig.Config(**TINY)
    pc = tfactory.build_pc_model(cfg, device="cpu", seed=3)
    path = str(tmp_path / "pc_model_best.ckpt")
    save_checkpoint(path, pc, {"epoch": 0, "patch_compat": False})
    seg = tfactory.build_ft_partseg(cfg, device="cpu", seed=4)
    fresh = {k: v.clone() for k, v in seg.state_dict().items()}
    msg = restore_backbone(seg, branch_state(load_checkpoint(path)))
    assert "fresh init for ['norm', 'label_conv', 'propagation', 'seg_head']" in msg
    pre = pc.state_dict()
    for k, v in seg.state_dict().items():
        if k.split(".")[0] in ("stem", "encoder"):
            assert torch.equal(v, pre[k]), k
        else:
            assert torch.equal(v, fresh[k]), k


def test_ft_partseg_cli_runs_on_the_cpu(tmp_path):
    """`cli.pretrain` writes a pc checkpoint (recording patch_compat=False);
    `cli.ft_partseg --resume true --patch_compat true` restores its stem
    and encoder with the stem-mode WARNING, trains two epochs on the
    synthetic ShapeNetPart (one metrics line each, the IoU suite, model_best
    saved); `--resume_training` raises."""
    from vipformer_tpu_torch.cli import ft_partseg, pretrain

    arch = ["--arch", "E1CL2SL-H2D128-L16-MR2", "--group_size", "8", "--compute_dtype",
            "float32", "--run_dir", str(tmp_path), "--device", "cpu"]
    pcfg, dev = pretrain.parse_args(["--synthetic_data", "true", "--synthetic_size", "8",
                                     "--epochs", "1", "--batch_size", "4", "--num_pt_points",
                                     "128", "--img_height", "24", "--img_width", "24",
                                     "--exp_name", "pt"] + arch)
    pretrain.main(pcfg, dev)
    ckpt = tmp_path / pcfg.proj_name / "pt" / "models" / "pc_model_best.ckpt"
    argv = ["--synthetic_data", "true", "--batch_size", "200", "--test_batch_size", "128",
            "--num_ft_points", "128", "--layer_idx", "1", "2", "--exp_name", "seg"] + arch
    cfg, dev = ft_partseg.parse_args(argv + ["--epochs", "2", "--resume", "true",
                                             "--pc_model_file", str(ckpt), "--patch_compat",
                                             "true", "--save_freq", "1"])
    assert cfg.ft_dataset == "ShapeNetPart" and cfg.num_sa_layers == 2 and cfg.max_dpr == 0.1
    assert cfg.layer_idx == (1, 2) and cfg.patch_compat and cfg.grad_clip_norm is None
    out = ft_partseg.main(cfg, dev)
    root = tmp_path / cfg.proj_name / "seg"
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1]
    keys = {"mean_part_iou", "mean_category_iou", "mean_part_acc", "point_level_acc"}
    for m in lines:
        assert keys | {"train_loss", "train_acc", "lr", "train_time"} <= set(m)
        assert np.isfinite(m["train_loss"]) and 0.0 <= m["mean_category_iou"] <= 1.0
    assert out["best"]["mean_category_iou"] == max(m["mean_category_iou"] for m in lines)
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "backbone restore: " in log and "'seg_head'" in log
    assert "WARNING: checkpoint" in log and "patch_compat=False" in log
    assert "grad clip 10.0" in log
    assert (root / "models" / "model_best.ckpt").exists()
    # --resume_training continues from the rolling model_last at epoch 2
    cfg, dev = ft_partseg.parse_args(argv + ["--epochs", "3", "--patch_compat", "true",
                                             "--resume_training", "true"])
    resumed = ft_partseg.main(cfg, dev)
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1, 2]
    assert resumed["best"]["mean_category_iou"] >= out["best"]["mean_category_iou"]
    assert "resumed training from" in "".join(p.read_text() for p in root.glob("*.log"))


def test_unreached_layers_decay_as_in_jax():
    """The SA layers after the last tap get no gradient. The JAX step hands
    optax zero gradients for them, so AdamW's decoupled decay still moves
    them; the port's step gives them zero gradients too (torch.optim would
    skip a parameter whose gradient is None): after one step they equal
    the JAX optimizer's update of zero gradients, within 1e-7."""
    import optax

    from vipformer_tpu.train.optim import build_optimizer

    over = dict(TINY, layer_idx=(1, 2))
    cfg = tconfig.Config(**over)
    model = tfactory.build_ft_partseg(cfg, device="cpu")
    model.seg_head.drop = 0.0
    before = {k: p.detach().clone() for k, p in model.named_parameters()
              if k.startswith("encoder.sa_2.")}
    assert len(before) == 13
    make_partseg_step(cfg, model)(create_state(cfg, {"pc": model}), _batch(), 1e-3)
    tx = build_optimizer(jconfig.Config(**over))
    params = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params),
                           params)
    want = optax.apply_updates(params, updates)
    after = dict(model.named_parameters())
    for k, v in before.items():
        assert torch.equal(after[k], v) == (not v.any()), k  # zeros (LN biases) stay zero
        _close(after[k], want[k], 1e-7, k)


@pytest.mark.parametrize("cli", ["ft_partseg", "ft_cls"])
def test_finetune_restore_matches_the_jax_cli(tmp_path, cli):
    """`--resume` of the two finetunes that restore the stem, from one
    seed-made pretrain checkpoint whose BatchNorm statistics are far from
    their init: JAX through its own trees, as its CLIs do (ft_partseg
    restores `params` alone, vipformer_tpu/cli/ft_partseg.py:82-85; ft_cls
    also the statistics, ft_cls.py:83-91), the port through the bridged
    weights and each CLI's `restore_backbone_from`, which its `--resume`
    calls.
    Afterwards every stem and encoder tensor, parameters and statistics
    alike, equals JAX's: ft_partseg's stem statistics keep their init (0
    and 1), ft_cls's come from the checkpoint."""
    from vipformer_tpu.cli import common as jcommon
    from vipformer_tpu.train.checkpoint import restore_backbone as jrestore

    from vipformer_tpu_torch.cli import ft_cls, ft_partseg
    from vipformer_tpu_torch.train.checkpoint import save_checkpoint

    cfg_j = jconfig.Config(**TINY)
    cfg = tconfig.Config(**TINY).replace(pc_model_file=str(tmp_path / "pc_model_best.ckpt"))
    batch = _batch()
    pts = jnp.asarray(batch["points"][:2])
    rng = np.random.default_rng(5)
    # the pretrain point branch, its statistics drawn away from 0 and 1
    pre_params, pre_stats = jtrainer.init_variables(jfactory.build_pc_model(cfg_j), (pts,), 7)
    pre_stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32), pre_stats)
    raw = {"params": jax.tree_util.tree_map(np.asarray, pre_params), "batch_stats": pre_stats}
    pc = tfactory.build_pc_model(cfg, device="cpu")
    pc.load_state_dict(from_jax_variables(raw), strict=True)
    save_checkpoint(cfg.pc_model_file, pc, {"epoch": 0, "patch_compat": False})
    # the finetune model's fresh init, the same on both sides
    if cli == "ft_partseg":
        model_j = jfactory.build_ft_partseg(cfg_j)
        args = (pts, jax.nn.one_hot(jnp.asarray(batch["obj_labels"][:2]), 16))
        model = tfactory.build_ft_partseg(cfg, device="cpu")
    else:
        model_j = jfactory.build_ft_cls(cfg_j)
        args = (pts,)
        model = tfactory.build_ft_cls(cfg, device="cpu")
    params, stats = jtrainer.init_variables(model_j, args, 3)
    model.load_state_dict(from_jax_variables({"params": params, "batch_stats": stats}),
                          strict=True)
    # JAX's CLI restore
    pre_p, pre_s = jcommon.pc_checkpoint_trees(raw)
    params = jrestore(params, pre_p, ("stem", "encoder"))
    if cli == "ft_cls" and pre_s:
        stats = jrestore(stats, pre_s, ("stem", "encoder"))
    want = from_jax_variables({"params": params, "batch_stats": stats})
    # the port's CLI restore
    log = []
    {"ft_partseg": ft_partseg, "ft_cls": ft_cls}[cli].restore_backbone_from(model, cfg,
                                                                            log.append)
    assert log and log[-1].startswith("backbone restore: ")
    got = model.state_dict()
    stem_stats = [k for k in got if k.startswith("stem.") and "running_" in k]
    assert stem_stats
    for k in got:
        if k.split(".")[0] in ("stem", "encoder"):
            assert torch.equal(got[k], want[k]), k
    for k in stem_stats:
        init = 0.0 if k.endswith("running_mean") else 1.0
        if cli == "ft_partseg":
            assert torch.all(got[k] == init), k
        else:
            assert not torch.all(got[k] == init), k
