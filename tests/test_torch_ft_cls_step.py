"""The port's classification finetune (ft_cls) against the JAX package's,
on the CPU: the train step, the eval, the backbone restore and the CLI.

A tiny CrossFormerPCFT (2 SA layers, D=128, H=2, 16 groups of 8 among 64
points, 5 classes) is initialised by flax and carried to the port with
`convert.from_jax_variables`. The JAX step and eval run their Pallas
kernels in interpret mode, with K11 (USE_DENSE_GRAD) forced on both sides
so the latent Denses (8 clouds x 16 latents = 128 rows, the JAX kernel's
smallest row block) and the per-point adapter take their (dW, db) from
K11 (its twin on the port's side), and K6 (USE_SA_QKV_LN) forced in the
eval; dropout is 0 and FPS starts at index 0 on both sides, because the
frameworks' random streams differ.

Tolerances (f32, sums in other orders), relative to max(1, max |jax|):
the loss within 1e-5; every gradient leaf within 1e-4, the BatchNorm
statistics within 1e-4, the eval logits within 1e-4 (the whole-model
tolerance of tests/test_torch_port_model.py); the accuracy and the eval's
predictions equal.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
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
from vipformer_tpu_torch.train.checkpoint import (
    branch_state,
    load_checkpoint,
    restore_backbone,
    save_checkpoint,
)
from vipformer_tpu_torch.train.trainer import (
    create_state,
    make_cls_eval,
    make_cls_step,
    make_feats_fn,
)

TINY = dict(jconfig.decode_arch_name("E1CL2SL-H2D128-L16-MR2"), group_size=8,
            num_ft_points=64, num_obj_classes=5, compute_dtype="float32", atten_drop=0.0,
            mlp_drop=0.0, max_dpr=0.0, optim="adamw", lr=1e-3)
B, N = 8, 64
LR = 1e-3
# K11's sites at B=8: rows 8 x 16 = 128 for PositionEmb (2), the CA
# layer's q_proj, o_proj and MLP (4) and each SA layer's q/k/v/o_proj and
# MLP (2 x 6); 8 x 64 = 512 rows for the adapter (2); the head's 8 rows
# have no feasible row block
K11_SITES = 2 + 4 + 2 * 6 + 2


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.fixture(scope="module")
def jax_cls():
    """JAX variables, a batch, the JAX step's loss, accuracy, gradients and
    new BatchNorm statistics, and the JAX eval's logits and predictions."""
    cfg = jconfig.Config(**TINY)
    rng = np.random.default_rng(0)
    batch = {"points": rng.standard_normal((B, N, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, B).astype(np.int64)}
    model = jfactory.build_ft_cls(cfg)
    params, stats = jtrainer.init_variables(model, (jnp.asarray(batch["points"]),), cfg.seed)
    stats = jax.tree_util.tree_map(  # nontrivial eval statistics for the head
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32)), stats)
    flags = [(jattn, "USE_FUSED_ATTENTION", True), (jg2e, "USE_G2E_TRAIN", True),
             (jgather, "USE_MXU_GATHER", True), (jgeo, "USE_PALLAS_FPS", True),
             (jgeo, "KNN_METHOD", "pallas"), (jdense, "USE_DENSE_GRAD", True),
             (jattn, "USE_SA_QKV_LN", True),
             (jtrainer, "_make_step", lambda loss_fn, tx: loss_fn),
             (jtrainer, "_rngs", lambda key, n=2: {"dropout": jax.random.split(key, n)[0]})]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in flags]
    fps_fns = (jgeo.farthest_point_sample, jgeo.farthest_point_sample_with_centers)
    try:
        for mod, name, value in flags:
            setattr(mod, name, value)
        for fn in fps_fns:  # the jitted FPS reads its flag while tracing
            fn.clear_cache()
        loss_fn = jtrainer.make_cls_step(cfg, model, None)
        pts = jnp.asarray(batch["points"])
        (loss, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, {"points": pts, "labels": jnp.asarray(batch["labels"])},
            jax.random.key(1))
        logits, _ = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x))(
            params, stats, pts)
        pred = jtrainer.make_cls_eval(model)(params, stats, pts)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        for fn in fps_fns:
            fn.clear_cache()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=host(params), stats=host(stats), batch=batch, loss=float(loss),
                metrics=host(metrics), grads=host(grads), new_stats=host(new_stats),
                logits=np.asarray(logits), pred=np.asarray(pred))


@pytest.fixture
def port(jax_cls, monkeypatch):
    """The port's tiny model with the JAX weights, K11 and K6 forced (the
    flags restored after the test), and a count of K11's twin calls."""
    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", True)
    monkeypatch.setattr(kattn, "USE_SA_QKV_LN", True)
    # the attention gates forced as on the JAX side (USE_FUSED_ATTENTION), so
    # the k/v projections stay inside K7 there and here
    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION", True)
    calls = {"dense_grads": 0, "qkv_ln": 0}
    grads, attn = kdense.dense_grads, kattn.fused_attention_packed_small_qkv_ln

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kdense, "dense_grads", count("dense_grads", grads))
    monkeypatch.setattr(kattn, "fused_attention_packed_small_qkv_ln", count("qkv_ln", attn))
    cfg = tconfig.Config(**TINY)
    model = tfactory.build_ft_cls(cfg, device="cpu")
    model.load_state_dict(from_jax_variables({"params": jax_cls["params"],
                                              "batch_stats": jax_cls["stats"]}), strict=True)
    return cfg, model, calls


def test_cls_step_matches_jax(jax_cls, port):
    """Loss, accuracy, every gradient leaf and the new BatchNorm statistics
    of one port step equal the JAX step's; K11's twin ran at every
    qualifying Dense."""
    cfg, model, calls = port
    state = create_state(cfg, {"pc": model})
    state, metrics = make_cls_step(cfg, model)(state, jax_cls["batch"], LR)
    assert state.step == 1
    _close(metrics["loss"], jax_cls["metrics"]["loss"], 1e-5, "loss")
    assert float(metrics["acc"]) == float(jax_cls["metrics"]["acc"])
    assert calls["dense_grads"] == K11_SITES and calls["qkv_ln"] == 0
    want = grads_from_jax(jax_cls["grads"])
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-4, k)
    want_stats = from_jax_variables({"batch_stats": jax_cls["new_stats"]})
    buffers = dict(model.named_buffers())
    assert want_stats
    for k, v in want_stats.items():
        _close(buffers[k], v, 1e-4, k)


def test_cls_eval_matches_jax(jax_cls, port):
    """The eval forward through K6 (forced, 2 SA layers): logits within
    1e-4 and make_cls_eval's predictions equal to the JAX eval's."""
    _, model, calls = port
    pts = jax_cls["batch"]["points"]
    model.eval()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(pts))
    _close(logits, jax_cls["logits"], 1e-4, "logits")
    assert calls["qkv_ln"] == 2
    pred = make_cls_eval(model)(pts)
    assert pred.dtype == torch.int64
    np.testing.assert_array_equal(pred.numpy(), jax_cls["pred"])
    feats = make_feats_fn(model)(pts)
    assert tuple(feats.shape) == (B, 2 * 128)
    with torch.no_grad():
        assert torch.equal(feats, model(torch.from_numpy(pts))[1])


@pytest.mark.parametrize("name", ["ModelNet40SVM", "ScanObjectNNSVM"])
def test_datasets_and_padding_match_jax(tmp_path, name):
    """The synthetic ModelNet40 / ScanObjectNN stand-ins equal the JAX
    package's (sizes, seeds, clouds cut to num_points), and collate_cls /
    pad_batch batch them as its pipeline does."""
    from vipformer_tpu.data import datasets as jds
    from vipformer_tpu.data import pipeline as jpipe
    from vipformer_tpu_torch.data import datasets as tds
    from vipformer_tpu_torch.data import pipeline as tpipe

    for split in ("train", "test"):
        want = getattr(jds, name)(str(tmp_path), split, 100)
        got = getattr(tds, name)(str(tmp_path), split, 100)
        assert len(got) == len(want) and got.num_classes == want.num_classes
        idx = [0, 3, len(want) - 1]
        samples_t, samples_j = [got.get(i) for i in idx], [want.get(i) for i in idx]
        for (pt, lt), (pj, lj) in zip(samples_t, samples_j):
            assert pt.shape == (100, 3) and lt == lj
            np.testing.assert_array_equal(pt, pj)
        bt, mt = tpipe.pad_batch(tpipe.collate_cls(samples_t), 5)
        bj, mj = jpipe.pad_batch(jpipe.collate_cls(samples_j), 5)
        np.testing.assert_array_equal(mt, mj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])


def _pc_and_ft(**over):
    cfg = tconfig.Config(**dict(TINY, **over))
    return cfg, tfactory.build_pc_model(cfg, device="cpu", seed=3)


@pytest.mark.parametrize("case", ["same_depth", "deeper_finetune", "shape_mismatch"])
def test_restore_backbone_from_a_pretrain_checkpoint(tmp_path, case):
    """A pretrain checkpoint of the port's CLI layout ({"model": state dict})
    restores the finetune model's stem and encoder key by key: the
    finetune head and layers beyond the pretrain depth keep their fresh
    init, a shape mismatch is kept fresh and reported."""
    cfg, pc = _pc_and_ft()
    pre = {k: v.clone() for k, v in pc.state_dict().items()}
    bad = "encoder.sa_0.MLP_0.Dense_0.bias"
    if case == "shape_mismatch":
        pre[bad] = torch.zeros(7)
    path = str(tmp_path / "models" / "pc_model_best.ckpt")
    save_checkpoint(path, pc, {"epoch": 0})
    if case == "shape_mismatch":
        torch.save({"model": pre}, path)
    ft_cfg = cfg.replace(num_sa_layers=3) if case == "deeper_finetune" else cfg
    ft = tfactory.build_ft_cls(ft_cfg, device="cpu", seed=4)
    fresh = {k: v.clone() for k, v in ft.state_dict().items()}
    msgs = []
    msg = restore_backbone(ft, branch_state(load_checkpoint(path)), log=msgs.append)
    assert msgs == [msg]
    after = ft.state_dict()
    taken = [k for k in after if k.split(".")[0] in ("stem", "encoder") and k in pre
             and tuple(pre[k].shape) == tuple(after[k].shape)]
    assert msg.startswith(f"backbone restore: {len(taken)} tensors from checkpoint; "
                          "fresh init for [")
    assert "'finetune_head'" in msg
    for k, v in after.items():
        if k in taken:
            assert torch.equal(v, pre[k]), k
        else:
            assert torch.equal(v, fresh[k]), k
    if case == "deeper_finetune":
        assert "encoder.sa_2.MLP_0.Dense_0.weight" in msg
        assert not any(k.startswith("encoder.sa_2.") for k in taken)
    if case == "shape_mismatch":
        assert f"SHAPE MISMATCH (kept fresh): ['{bad}: ckpt(7,) != model(256,)']" in msg
    else:
        assert "SHAPE MISMATCH" not in msg


def test_ft_cls_cli_runs_on_the_cpu(tmp_path):
    """`cli.pretrain` writes a pc checkpoint; `cli.ft_cls --resume true`
    bootstraps from it, trains two epochs on synthetic ModelNet40 (one
    metrics line each, model_best saved), and `--eval_only` reproduces the
    best test accuracy from model_best."""
    from vipformer_tpu_torch.cli import ft_cls, pretrain

    arch = ["--arch", "E1CL1SL-H2D128-L16-MR2", "--group_size", "8", "--compute_dtype",
            "float32", "--run_dir", str(tmp_path), "--device", "cpu"]
    pcfg, dev = pretrain.parse_args(["--synthetic_data", "true", "--synthetic_size", "8",
                                     "--epochs", "1", "--batch_size", "4", "--num_pt_points",
                                     "64", "--img_height", "24", "--img_width", "24",
                                     "--exp_name", "pt"] + arch)
    pretrain.main(pcfg, dev)
    ckpt = tmp_path / pcfg.proj_name / "pt" / "models" / "pc_model_best.ckpt"
    ft_argv = ["--synthetic_data", "true", "--batch_size", "100", "--test_batch_size", "128",
               "--num_ft_points", "64", "--optim", "adamw", "--exp_name", "ft"] + arch
    cfg, dev = ft_cls.parse_args(ft_argv + ["--epochs", "2", "--resume", "true",
                                            "--pc_model_file", str(ckpt)])
    assert cfg.ft_dataset == "ModelNet40" and cfg.resume and dev == "cpu"
    out = ft_cls.main(cfg, dev)
    root = tmp_path / cfg.proj_name / "ft"
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1]
    for m in lines:
        assert {"train_loss", "train_acc", "test_acc", "best_acc", "lr", "train_time"} <= set(m)
        assert np.isfinite(m["train_loss"]) and 0.0 <= m["test_acc"] <= 1.0
    assert out["best_acc"] == max(m["test_acc"] for m in lines) == lines[-1]["best_acc"]
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "backbone restore: " in log and "fresh init for ['finetune_head']" in log
    assert (root / "models" / "model_best.ckpt").exists()
    cfg, dev = ft_cls.parse_args(ft_argv + ["--eval_only", "true"])
    assert ft_cls.main(cfg, dev) == {"best_acc": out["best_acc"], "best_epoch": -1}
    for flag in ("--resume_training", "--dump_feats"):
        cfg, dev = ft_cls.parse_args(ft_argv + [flag, "true"])
        with pytest.raises(NotImplementedError, match="not ported"):
            ft_cls.main(cfg, dev)
