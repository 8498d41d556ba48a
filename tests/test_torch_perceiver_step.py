"""The port's generic Perceiver family (`--mp false`) against the JAX
package's, on the CPU: the pretrain step over both branches, the ft_cls
step and eval, the feature forward of both branches, the optimizer update
of the shared blocks, the backbone restore and both CLIs.

Tiny models (D=64, 2 heads, 16 latents, two cross-attention layers and
two SA blocks of one layer, so the encoder has a separate first
cross-attention and a shared SA block used twice; 64 points; 24x24 images
with 4 Fourier bands: 576 tokens of 21 channels) are initialised by flax
and carried to the port with `convert.from_jax_variables`. The JAX step
and eval run with the attention kernels forced (USE_FUSED_ATTENTION, in
interpret mode), and so does the port (their twins); the port is also run
with the flags at auto, which on the CPU is the plain attention path.
Dropout is 0 on both sides, because the frameworks' random streams
differ. Each pretrain cloud and image gets its own offset: the projection
heads normalise with train-mode BatchNorm over 6 and 3 rows, and the
pooled latents of plain noise inputs are so alike that those few rows'
variances amplify the f32 rounding of either side to 2e-5 of the loss.

Tolerances (f32, sums in other orders), relative to max(1, max |jax|):
losses within 1e-5; the eval logits and features within 1e-4 (the
whole-model bound of tests/test_torch_port_model.py); every ft_cls
gradient leaf and BatchNorm statistic within 1e-4; every pretrain
gradient leaf within 2e-4, the bound tests/test_torch_pretrain_step.py
states for the projection heads' train-mode BatchNorm over 3 and 6 rows;
one optimizer update fed the same gradients within 1e-6.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu import config as jconfig
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu.train import optim as joptim
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.models import perceiver_models as tpm
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.train import optim as toptim
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
    make_pretrain_step,
)

TINY = dict(jconfig.decode_arch_name("E1CL2SL-H2D64-L16-MR2"), mp=False, num_img_latents=16,
            num_ca_layers=2, num_sa_blocks=2, num_sa_layers_per_block=1, num_pt_points=64,
            num_ft_points=64, img_height=24, img_width=24, num_frequency_bands=4,
            num_obj_classes=5, compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0,
            max_dpr=0.0, optim="adamw", lr=1e-3)
PB, B, N = 3, 8, 64  # pretrain batch, ft_cls batch, points
LR = 1e-3
ROUTES = ["kernels", "plain"]


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def _jax_run(flags, fn):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in flags]
    try:
        for mod, name, value in flags:
            setattr(mod, name, value)
        return fn()
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _host(t):
    return jax.tree_util.tree_map(np.asarray, t)


STEP_FLAGS = [(jattn, "USE_FUSED_ATTENTION", True),
              # the raw loss function instead of its jitted optimizer step
              (jtrainer, "_make_step", lambda loss_fn, tx: loss_fn),
              (jtrainer, "_rngs", lambda key, n=2: {"dropout": jax.random.split(key, n)[0]})]


@pytest.fixture(scope="module")
def jax_pretrain():
    """JAX variables of both branches, a batch, and the JAX pretrain step's
    loss, gradients and new BatchNorm statistics, and the eval features."""
    cfg = jconfig.Config(**TINY)
    rng = np.random.default_rng(0)
    batch = {"pc_t1": (rng.standard_normal((PB, N, 3))
                       + 2.0 * rng.standard_normal((PB, 1, 3))).astype(np.float32),
             "pc_t2": (rng.standard_normal((PB, N, 3))
                       + 2.0 * rng.standard_normal((PB, 1, 3))).astype(np.float32),
             "imgs": (rng.standard_normal((PB, 24, 24, 3))
                      + 2.0 * rng.standard_normal((PB, 1, 1, 3))).astype(np.float32)}
    pc_model, img_model = jfactory.build_pc_model(cfg), jfactory.build_img_model(cfg)
    params, stats = {}, {}
    params["pc"], stats["pc"] = jtrainer.init_variables(pc_model, (jnp.asarray(batch["pc_t1"]),),
                                                        cfg.seed)
    params["img"], stats["img"] = jtrainer.init_variables(
        img_model, (jnp.asarray(batch["imgs"]),), cfg.seed + 10)

    def run():
        loss_fn = jtrainer.make_pretrain_step(cfg, pc_model, img_model, None, 1)
        out = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.key(1))
        feats = {name: jtrainer.make_feats_fn(m)(params[name], stats[name], jnp.asarray(x))
                 for name, m, x in (("pc", pc_model, batch["pc_t1"]),
                                    ("img", img_model, batch["imgs"]))}
        return out, feats

    ((loss, (new_stats, metrics)), grads), feats = _jax_run(STEP_FLAGS, run)
    return dict(params=_host(params), stats=_host(stats), batch=batch, loss=float(loss),
                metrics=_host(metrics), grads=_host(grads), new_stats=_host(new_stats),
                feats=_host(feats))


def _port_models(js, optim="adamw"):
    cfg = tconfig.Config(**dict(TINY, optim=optim))
    models = {"pc": tfactory.build_pc_model(cfg, device="cpu"),
              "img": tfactory.build_img_model(cfg, device="cpu")}
    for name, m in models.items():
        m.load_state_dict(from_jax_variables({"params": js["params"][name],
                                              "batch_stats": js["stats"][name]}), strict=True)
    return cfg, models


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's attention route: the kernels' twins forced as on the JAX
    side, or the flags at auto (the plain attention on the CPU)."""
    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION",
                        True if request.param == "kernels" else None)
    return request.param


def test_pretrain_step_matches_jax(jax_pretrain, route):
    """Loss, every gradient leaf (both branches, the shared SA block's
    summed over its two uses) and the new BatchNorm statistics of one port
    step equal the JAX step's."""
    js = jax_pretrain
    cfg, models = _port_models(js)
    assert isinstance(models["img"], tpm.PerceiverFeatsModel)
    state = create_state(cfg, models)
    state, metrics = make_pretrain_step(cfg, models["pc"], models["img"])(state, js["batch"], LR)
    for k in ("loss", "loss_imid", "loss_cmid"):
        _close(metrics[k], js["metrics"][k], 1e-5, k)
    for name, m in models.items():
        want = grads_from_jax(js["grads"][name])
        got = {k: p.grad for k, p in m.named_parameters()}
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 2e-4, f"{name}.{k}")
        want_stats = from_jax_variables({"batch_stats": js["new_stats"][name]})
        buffers = dict(m.named_buffers())
        for k, v in want_stats.items():
            _close(buffers[k], v, 1e-4, f"{name}.{k}")


def test_feats_of_both_branches_match_jax(jax_pretrain, route):
    """make_feats_fn on points [B, N, 3] and on images [B, H, W, 3]."""
    js = jax_pretrain
    _, models = _port_models(js)
    for name, x in (("pc", js["batch"]["pc_t1"]), ("img", js["batch"]["imgs"])):
        feats = make_feats_fn(models[name])(x)
        assert tuple(feats.shape) == (PB, 2 * 64)
        _close(feats, js["feats"][name], 1e-4, name)


def test_shared_blocks_update_once_as_optax(jax_pretrain):
    """The shared SA block's parameters are in the state dict, the
    optimizer and the update once: one AdamW update fed the JAX gradients
    equals optax's (weight decay included)."""
    js = jax_pretrain
    jcfg = jconfig.Config(**TINY)
    tx = joptim.build_optimizer(jcfg)
    opt_state = joptim.set_learning_rate(tx.init(js["params"]), LR)
    updates, _ = tx.update(js["grads"], opt_state, js["params"])
    new = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), js["params"], updates)
    cfg, models = _port_models(js)
    state = create_state(cfg, models)
    enc = models["pc"].encoder
    assert enc.share_sa and not enc.share_ca
    params = list(state.parameters())
    assert len(params) == len({id(p) for p in params})
    assert not any(k.startswith("self_attn_1") for k in enc.state_dict())
    toptim.set_learning_rate(state.optimizer, LR)
    for name, m in models.items():
        g = grads_from_jax(js["grads"][name])
        for k, p in m.named_parameters():
            p.grad = g[k].clone()
    state.optimizer.step()
    for name, m in models.items():
        want = from_jax_variables({"params": new[name]})
        for k, p in m.named_parameters():
            _close(p, want[k], 1e-6, f"{name}.{k}")


# --------------------------------------------------------------- ft_cls


@pytest.fixture(scope="module")
def jax_cls():
    """JAX variables, a batch, the JAX ft_cls step's loss, accuracy,
    gradients and new BatchNorm statistics (K11 forced), and the eval's
    logits and predictions."""
    cfg = jconfig.Config(**TINY)
    rng = np.random.default_rng(1)
    batch = {"points": rng.standard_normal((B, N, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, B).astype(np.int64)}
    model = jfactory.build_ft_cls(cfg)
    params, stats = jtrainer.init_variables(model, (jnp.asarray(batch["points"]),), cfg.seed)
    pts = jnp.asarray(batch["points"])

    def run():
        loss_fn = jtrainer.make_cls_step(cfg, model, None)
        out = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, {"points": pts, "labels": jnp.asarray(batch["labels"])},
            jax.random.key(1))
        logits, _ = model.apply({"params": params, "batch_stats": stats}, pts)
        return out, logits, jtrainer.make_cls_eval(model)(params, stats, pts)

    ((loss, (new_stats, metrics)), grads), logits, pred = _jax_run(
        STEP_FLAGS + [(jdense, "USE_DENSE_GRAD", True)], run)
    return dict(params=_host(params), stats=_host(stats), batch=batch, loss=float(loss),
                metrics=_host(metrics), grads=_host(grads), new_stats=_host(new_stats),
                logits=np.asarray(logits), pred=np.asarray(pred))


def _port_cls(jc):
    cfg = tconfig.Config(**TINY)
    model = tfactory.build_ft_cls(cfg, device="cpu")
    model.load_state_dict(from_jax_variables({"params": jc["params"],
                                              "batch_stats": jc["stats"]}), strict=True)
    return cfg, model


def test_cls_step_matches_jax(jax_cls, route, monkeypatch):
    """The ft_cls step (K11 forced on both sides: the latent and adapter
    Denses take their weight gradients from it, the decoder's 8 rows have
    no feasible row block): loss, accuracy, every gradient leaf and the
    new BatchNorm statistics."""
    monkeypatch.setattr(kdense, "USE_DENSE_GRAD", True)
    cfg, model = _port_cls(jax_cls)
    assert isinstance(model, tpm.PerceiverClassifier)
    state = create_state(cfg, {"pc": model})
    state, metrics = make_cls_step(cfg, model)(state, jax_cls["batch"], LR)
    _close(metrics["loss"], jax_cls["metrics"]["loss"], 1e-5, "loss")
    assert float(metrics["acc"]) == float(jax_cls["metrics"]["acc"])
    want = grads_from_jax(jax_cls["grads"])
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-4, k)
    for k, v in from_jax_variables({"batch_stats": jax_cls["new_stats"]}).items():
        _close(dict(model.named_buffers())[k], v, 1e-4, k)


def test_cls_eval_matches_jax(jax_cls, route):
    """The eval forward's logits and make_cls_eval's predictions."""
    _, model = _port_cls(jax_cls)
    pts = jax_cls["batch"]["points"]
    with torch.inference_mode():
        logits, feats = model(torch.from_numpy(pts))
    _close(logits, jax_cls["logits"], 1e-4, "logits")
    assert tuple(feats.shape) == (B, 2 * 64)
    np.testing.assert_array_equal(make_cls_eval(model)(pts).numpy(), jax_cls["pred"])


# -------------------------------------------------------- restore, CLIs


def test_restore_backbone_takes_the_encoder_only(tmp_path):
    """A non-mp pretrain checkpoint restores the classifier's `encoder`
    key by key, as JAX's ft_cls restores ("stem", "encoder"); the input
    adapter (not in that list), the decoder and the output adapter keep
    their fresh init."""
    cfg = tconfig.Config(**TINY)
    pc = tfactory.build_pc_model(cfg, device="cpu", seed=3)
    path = str(tmp_path / "pc_model_best.ckpt")
    save_checkpoint(path, pc, {"epoch": 0})
    ft = tfactory.build_ft_cls(cfg, device="cpu", seed=4)
    fresh = {k: v.clone() for k, v in ft.state_dict().items()}
    msg = restore_backbone(ft, branch_state(load_checkpoint(path)), ("stem", "encoder"))
    pre = pc.state_dict()
    taken = [k for k in ft.state_dict() if k.startswith("encoder.")]
    assert msg == (f"backbone restore: {len(taken)} tensors from checkpoint; fresh init for "
                   "['input_adapter', 'output_adapter', 'decoder']")
    for k, v in ft.state_dict().items():
        assert torch.equal(v, pre[k] if k in taken else fresh[k]), k


def test_non_mp_clis_run_on_the_cpu(tmp_path):
    """`cli.pretrain --mp false` trains both Perceiver branches and writes
    their checkpoints; `cli.ft_cls --mp false --resume true` restores the
    encoder from the point branch's, logs the restore, trains and saves
    model_best; ft_partseg keeps refusing mp=False."""
    from vipformer_tpu_torch.cli import ft_cls as ft_cli
    from vipformer_tpu_torch.cli import ft_partseg as seg_cli
    from vipformer_tpu_torch.cli import pretrain as pre_cli

    tiny = ["--mp", "false", "--arch", "E1CL1SL-H2D64-L16-MR2", "--num_img_latents", "16",
            "--num_sa_layers_per_block", "1", "--compute_dtype", "float32",
            "--run_dir", str(tmp_path), "--device", "cpu", "--synthetic_data", "true",
            "--epochs", "1"]
    cfg, device = pre_cli.parse_args(tiny + [
        "--synthetic_size", "4", "--batch_size", "2", "--num_pt_points", "64",
        "--img_height", "16", "--img_width", "16", "--num_frequency_bands", "4",
        "--exp_name", "pre"])
    assert not cfg.mp and device == "cpu"
    out = pre_cli.main(cfg, device)
    assert np.isfinite(out["best_loss"])
    ckpt = tmp_path / cfg.proj_name / "pre" / "models" / "pc_model_best.ckpt"
    assert ckpt.exists()
    cfg, device = ft_cli.parse_args(tiny + [
        "--batch_size", "64", "--test_batch_size", "100", "--num_ft_points", "64",
        "--resume", "true", "--pc_model_file", str(ckpt), "--exp_name", "ft"])
    out = ft_cli.main(cfg, device)
    root = tmp_path / cfg.proj_name / "ft"
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "backbone restore:" in log and "fresh init for ['input_adapter'" in log
    assert json.loads((root / "metrics.jsonl").read_text().splitlines()[0])["test_acc"] >= 0
    assert (root / "models" / "model_best.ckpt").exists() or out["best_epoch"] == -1
    with pytest.raises(NotImplementedError, match="mp family"):
        seg_cli.main(*seg_cli.parse_args(tiny + ["--exp_name", "seg"]))
