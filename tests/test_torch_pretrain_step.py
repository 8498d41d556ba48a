"""The port's pretrain train step against the JAX package's, on the CPU.

A tiny CrossFormerPC + CrossFormerImg (2 SA layers, D=32, 16 groups of 8
among 128 points, 24x24 images in 12x12 patches) is initialised by flax and
carried to the port with `convert.from_jax_variables`. The JAX step runs
its Pallas kernels in interpret mode (the kernel flags are forced for the
test and restored after it); dropout is 0 and FPS starts at index 0 on
both sides (the JAX step without an `fps` rng, the port's without a
generator), because the two frameworks' random streams differ.

Tolerances (f32, sums in other orders): the loss within 1e-5 relative;
every new BatchNorm statistic within 1e-4 of max(1, max |jax|), the
whole-model tolerance of tests/test_torch_port_model.py; every gradient
leaf within 2e-4 of max(1, max |jax|). The gradients get the wider bound
because the projection heads normalise with train-mode BatchNorm over 3
(image) and 6 (point) rows: the fast variance E[x^2] - E[x]^2 of so few
rows cancels, and its f32 rounding, different on the two sides, reaches
every gradient through the head's backward. Each image gets its own
colour offset, so the rows differ enough that this stays near 1e-4 (with
plain noise images it reaches 2e-3 on both sides of a float64 value).
One optimizer update fed the same gradients within 1e-6 of
max(1, |param|).
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu import config as jconfig
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import g2e_train as jg2e
from vipformer_tpu.ops.pallas import gather as jgather
from vipformer_tpu.train import optim as joptim
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.models import crossformer as tcf
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.train import optim as toptim
from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(jconfig.decode_arch_name("E1CL2SL-H4D32-L16-MR2"), group_size=8, num_pt_points=128,
            img_height=24, img_width=24, patch_size=12, compute_dtype="float32",
            atten_drop=0.0, mlp_drop=0.0, max_dpr=0.0, optim="adamw", lr=1e-3)
LR = 1e-3


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.fixture(scope="module")
def jax_step():
    """JAX variables of both branches, a batch, and the JAX step's loss,
    gradients and new BatchNorm statistics, with the kernels in interpret
    mode."""
    cfg = jconfig.Config(**TINY)
    rng = np.random.default_rng(0)
    b = 3
    batch = {"pc_t1": rng.standard_normal((b, 128, 3)).astype(np.float32),
             "pc_t2": rng.standard_normal((b, 128, 3)).astype(np.float32),
             "imgs": (rng.standard_normal((b, 24, 24, 3))
                      + 2.0 * rng.standard_normal((b, 1, 1, 3))).astype(np.float32)}
    pc_model, img_model = jfactory.build_pc_model(cfg), jfactory.build_img_model(cfg)
    params, stats = {}, {}
    params["pc"], stats["pc"] = jtrainer.init_variables(pc_model, (jnp.asarray(batch["pc_t1"]),),
                                                        cfg.seed)
    params["img"], stats["img"] = jtrainer.init_variables(
        img_model, (jnp.asarray(batch["imgs"]),), cfg.seed + 10)
    flags = [(jattn, "USE_FUSED_ATTENTION", True), (jg2e, "USE_G2E_TRAIN", True),
             (jgather, "USE_MXU_GATHER", True), (jgeo, "USE_PALLAS_FPS", True),
             (jgeo, "KNN_METHOD", "pallas"),
             # the raw loss function instead of its jitted optimizer step, and
             # no "fps" rng, so FPS starts at index 0
             (jtrainer, "_make_step", lambda loss_fn, tx: loss_fn),
             (jtrainer, "_rngs", lambda key, n=2: {"dropout": jax.random.split(key, n)[0]})]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in flags]
    fps_fns = (jgeo.farthest_point_sample, jgeo.farthest_point_sample_with_centers)
    try:
        for mod, name, value in flags:
            setattr(mod, name, value)
        for fn in fps_fns:  # the jitted FPS reads its flag while tracing
            fn.clear_cache()
        loss_fn = jtrainer.make_pretrain_step(cfg, pc_model, img_model, None, 1)
        (loss, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.key(1))
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        for fn in fps_fns:
            fn.clear_cache()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=host(params), stats=host(stats), batch=batch, loss=float(loss),
                metrics=host(metrics), grads=host(grads), new_stats=host(new_stats))


def _port_models(js, optim="adamw"):
    cfg = tconfig.Config(**dict(TINY, optim=optim))
    models = {"pc": tfactory.build_pc_model(cfg, device="cpu"),
              "img": tfactory.build_img_model(cfg, device="cpu")}
    for name, m in models.items():
        m.load_state_dict(from_jax_variables({"params": js["params"][name],
                                              "batch_stats": js["stats"][name]}), strict=True)
    return cfg, models


def test_pretrain_step_matches_jax(jax_step):
    """Loss, every gradient leaf and the new BatchNorm statistics of one
    port step equal the JAX step's."""
    js = jax_step
    cfg, models = _port_models(js)
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    state, metrics = step(state, js["batch"], LR)
    assert state.step == 1
    for k in ("loss", "loss_imid", "loss_cmid"):
        _close(metrics[k], js["metrics"][k], 1e-5, k)
    for name, m in models.items():
        want = grads_from_jax(js["grads"][name])
        got = {k: p.grad for k, p in m.named_parameters()}
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 2e-4, f"{name}.{k}")
        want_stats = from_jax_variables({"batch_stats": js["new_stats"][name]})
        assert want_stats, name
        buffers = dict(m.named_buffers())
        for k, v in want_stats.items():
            _close(buffers[k], v, 1e-4, f"{name}.{k}")


@pytest.mark.parametrize("optim", ["sgd", "adam", "adamw"])
def test_optimizer_update_matches_optax(jax_step, optim):
    """One update of each optimizer, fed the JAX gradients, equals the
    optax chain's (torch's rules equal the JAX package's, train/optim.py)."""
    js = jax_step
    jcfg = jconfig.Config(**dict(TINY, optim=optim))
    tx = joptim.build_optimizer(jcfg)
    opt_state = joptim.set_learning_rate(tx.init(js["params"]), LR)
    updates, _ = tx.update(js["grads"], opt_state, js["params"])
    new = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), js["params"], updates)
    cfg, models = _port_models(js, optim)
    params = [p for m in models.values() for p in m.parameters()]
    opt = toptim.build_optimizer(cfg, params)
    toptim.set_learning_rate(opt, LR)
    for name, m in models.items():
        g = grads_from_jax(js["grads"][name])
        for k, p in m.named_parameters():
            p.grad = g[k].clone()
    opt.step()
    for name, m in models.items():
        want = from_jax_variables({"params": new[name]})
        for k, p in m.named_parameters():
            _close(p, want[k], 1e-6, f"{optim} {name}.{k}")


def test_config_matches_the_jax_package():
    """The port's Config copy: same fields, defaults and arch decoding."""
    jf = {f.name: f.default for f in jconfig.dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in tconfig.dataclasses.fields(tconfig.Config)}
    assert tf == jf
    for arch in ("E1CL8SL-H4D256-L128-MR2", "E1CL6SL-H6D384-L64-MR4"):
        assert tconfig.decode_arch_name(arch) == jconfig.decode_arch_name(arch)
    argv = ["--arch", "E1CL2SL-H4D32-L16-MR2", "--optim", "adamw", "--lr", "0.002",
            "--synthetic_data", "true", "--layer_idx", "1", "2"]
    assert tconfig.config_from_args(argv) == tconfig.Config(
        **vars(jconfig.config_from_args(argv)))
    with pytest.raises(ValueError, match="not an arch name"):
        tconfig.decode_arch_name("E1CL8SL")


def test_builders_default_to_the_card():
    """Every build function and model constructor defaults to device "cuda"; a
    build without a card raises instead of falling back to the CPU."""
    for fn in (tfactory.build_pc_model, tfactory.build_img_model, tfactory.build_ft_cls,
               tcf.CrossFormerPC, tcf.CrossFormerPCFT, tcf.CrossFormerImg):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        cfg = tconfig.Config(**TINY)
        with pytest.raises((RuntimeError, AssertionError)):
            tfactory.build_pc_model(cfg)


def test_port_and_chip_smoke_import_no_jax():
    """Importing every module of vipformer_tpu_torch (the ft_cls slice's
    cli.ft_cls, ops.cuda.dense and losses.classification, and the data
    layer's augment_device, ply, pipeline and datasets among them), and
    chip_smoke.py as a module, loads nothing of jax, flax, optax or
    vipformer_tpu, and neither PIL nor h5py, which the readers import only
    where they need them (run in a subprocess: this process has them
    loaded already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vipformer_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vipformer_tpu_torch.__path__,\n"
        "                                               'vipformer_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'vipformer_tpu'))\n"
        "assert not bad, bad\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('PIL', 'h5py')]\n"
        "assert len(names) >= 20, names\n"
        "for name in ('cli.ft_cls', 'cli.common', 'ops.cuda.dense', 'losses.classification',\n"
        "             'train.meters', 'data.augment_device', 'data.ply', 'data.pipeline',\n"
        "             'data.datasets'):\n"
        "    assert 'vipformer_tpu_torch.' + name in names, name\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "VIPFORMER_PLATFORM"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_pretrain_cli_runs_on_the_cpu(tmp_path):
    """`python -m vipformer_tpu_torch.cli.pretrain ... --device cpu` on the
    synthetic set: two epochs of the tiny model write one metrics line each
    and the best checkpoints of both branches, which load back."""
    from vipformer_tpu_torch.cli import pretrain as cli
    from vipformer_tpu_torch.train.checkpoint import branch_state, load_checkpoint, load_metadata

    argv = ["--synthetic_data", "true", "--synthetic_size", "8", "--epochs", "2",
            "--batch_size", "4", "--arch", "E1CL1SL-H2D128-L16-MR2", "--group_size", "8",
            "--num_pt_points", "128", "--img_height", "24", "--img_width", "24",
            "--compute_dtype", "float32", "--optim", "adamw", "--scheduler", "cos",
            "--run_dir", str(tmp_path), "--exp_name", "tiny", "--device", "cpu"]
    cfg, device = cli.parse_args(argv)
    assert device == "cpu" and cfg.num_latent_channels == 128 and cfg.atten_drop == 0.1
    out = cli.main(cfg, device)
    root = tmp_path / cfg.proj_name / "tiny"
    lines = (root / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert all(np.isfinite(json.loads(line)["pretrain_loss"]) for line in lines)
    assert out["best_epoch"] in (0, 1)
    for name in ("pc", "img"):
        path = str(root / "models" / f"{name}_model_best.ckpt")
        assert load_metadata(path)["epoch"] == out["best_epoch"]
        assert set(branch_state(load_checkpoint(path), name)) == set(
            (tfactory.build_pc_model if name == "pc" else tfactory.build_img_model)(
                cfg, device="cpu").state_dict())


def test_pretrain_cli_refuses_multi_card_runs(tmp_path):
    """`--num_devices 2` raises before anything is built: JAX trains one
    NT-Xent group per device there (vipformer_tpu/cli/pretrain.py:145,
    neg_groups=data_axis_size(mesh)), which one card cannot reproduce."""
    from vipformer_tpu_torch.cli import pretrain as cli

    cfg, device = cli.parse_args(["--synthetic_data", "true", "--num_devices", "2",
                                  "--run_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-card runs are not ported"):
        cli.main(cfg, device)
    assert not any(tmp_path.iterdir())  # refused before the run directory was made
