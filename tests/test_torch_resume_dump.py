"""Crash-resume and `--dump_feats` of the port's training CLIs against the
JAX package's, on the CPU.

The JAX CLI and the port's CLI run the same way at tests/test_cli.py's
TINY widths: ft_cls and pretrain with `save_freq` 1, killed after epoch 1
of 2 and resumed to 4 (`--resume_training` / `--resume`), with
`--dump_feats`. Both sides must write the same snapshot names with the
same metadata keys, continue the epochs without a repeat, keep best
trackers that never fall, and dump artifacts of the same layout. The
synthetic classification splits are cut to 64 / 32 clouds and the
pretrain set to 16 on both sides, to keep the runs short; the two sides'
numbers differ (other random streams) and are not compared.

The port alone: a restored snapshot equals the saved weights and
optimizer moments bit for bit, and one step from it equals the step the
killed run would have taken; partseg's and semseg's `--resume_training`
restore the epoch and the best tracker.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_cli import TINY
from vipformer_tpu import config as jconfig
from vipformer_tpu.cli import ft_cls as jft_cls
from vipformer_tpu.cli import pretrain as jpretrain
from vipformer_tpu.data import synthetic as jsynthetic
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.cli import ft_cls as tft_cls
from vipformer_tpu_torch.cli import ft_partseg as tft_partseg
from vipformer_tpu_torch.cli import ft_semseg as tft_semseg
from vipformer_tpu_torch.cli import pretrain as tpretrain
from vipformer_tpu_torch.data import datasets as tdatasets
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_metadata,
    restore_state,
    save_state,
)
from vipformer_tpu_torch.train.trainer import create_state, make_cls_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = {800: 64, 200: 32}  # the synthetic classification splits, cut
PORT_ONLY_FILES = {"img_model_best.ckpt", "img_model_best.ckpt.json"}  # the port's image branch
PORT_ONLY_META = {"pc_model_best": {"patch_compat"}}  # the port records the stem mode
BEST_KEY = {"ft_cls": "best_acc", "pretrain": "svm_best_acc"}
CLIS = {"ft_cls": (jft_cls, tft_cls, "resume_training", "ft"),
        "pretrain": (jpretrain, tpretrain, "resume", "pt")}


def _read_run(root) -> dict:
    models = os.path.join(root, "models")
    names = sorted(os.listdir(models))
    meta = {n[:-len(".ckpt.json")]: json.load(open(os.path.join(models, n)))
            for n in names if n.endswith(".ckpt.json")}
    rows = [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]
    files = os.path.join(root, "files")
    dumps = {n: os.path.join(files, n) for n in (os.listdir(files) if os.path.isdir(files) else ())}
    logs = "".join(open(os.path.join(root, n)).read() for n in os.listdir(root)
                   if n.endswith(".log"))
    return {"names": names, "meta": meta, "rows": rows, "dumps": dumps, "log": logs,
            "models": models}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{cli: {"jax": run, "port": run}}: each run killed after epoch 1 of 2
    and resumed to 4, its models/, metadata, metrics rows, dumps and log
    read back, and both mains' returns."""
    tmp = tmp_path_factory.mktemp("resume")
    mp = pytest.MonkeyPatch()
    orig = jsynthetic.synthetic_classification
    mp.setattr(jsynthetic, "synthetic_classification",
               lambda n, *a, **kw: orig(SPLITS.get(n, n), *a, **kw))
    mp.setattr(tdatasets.ModelNet40SVM, "sizes",
               {"train": (SPLITS[800], 0), "test": (SPLITS[200], 1)})
    out = {}
    try:
        for cli, (jmod, tmod, flag, _) in CLIS.items():
            kw = dict(TINY, data_dir=str(tmp / "data"), synthetic_data=True, save_freq=1,
                      synthetic_size=16, dump_feats=True, exp_name=cli)
            if cli == "ft_cls":
                kw["num_obj_classes"] = 40
            out[cli] = {}
            for side, config, run in (("jax", jconfig.Config, jmod.main),
                                      ("port", tconfig.Config, lambda c, m=tmod: m.main(c, "cpu"))):
                cfg = config(**kw, run_dir=str(tmp / side))
                killed = run(cfg)
                resumed = run(cfg.replace(epochs=4, **{flag: True}))
                out[cli][side] = dict(_read_run(tmp / side / cfg.proj_name / cli),
                                      killed=killed, resumed=resumed)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("cli", list(CLIS))
def test_resume_writes_the_jax_snapshots(runs, cli):
    """The same snapshot names (pretrain: pc_model_best, pc_model_epoch0-3,
    pc_model_last; ft_cls: model_best, model_last), each with JAX's
    metadata keys; the rolling snapshot ends at the last epoch; every
    resume snapshot of the port holds the optimizer's state."""
    jax_run, port = runs[cli]["jax"], runs[cli]["port"]
    assert sorted(set(port["names"]) - PORT_ONLY_FILES) == jax_run["names"]
    last = "pc_model_last" if cli == "pretrain" else "model_last"
    assert last in jax_run["meta"]
    for name, meta in jax_run["meta"].items():
        assert set(port["meta"][name]) - PORT_ONLY_META.get(name, set()) == set(meta), name
        assert port["meta"][name]["kind"] == meta["kind"]
    assert port["meta"][last]["epoch"] == jax_run["meta"][last]["epoch"] == 3
    if cli == "pretrain":
        for e in range(4):
            assert port["meta"][f"pc_model_epoch{e}"]["epoch"] == e
    for name in port["meta"]:
        ckpt = load_checkpoint(os.path.join(port["models"], name + ".ckpt"))
        resumable = name != "model_best" and name != "img_model_best"
        assert ("optimizer" in ckpt and "step" in ckpt) == resumable, name
        if resumable:
            assert set(ckpt) - {"optimizer", "step"} == ({"pc", "img"} if cli == "pretrain"
                                                         else {"pc"})


@pytest.mark.parametrize("cli", list(CLIS))
def test_resume_continues_the_epochs_as_jax(runs, cli):
    """Epoch rows 0, 1, 2, 3 on both sides (no epoch run twice), the port's
    rows with every key of JAX's, and best trackers that never fall, across
    the kill too."""
    for side in ("jax", "port"):
        run = runs[cli][side]
        assert [r["step"] for r in run["rows"]] == [0, 1, 2, 3], side
        bests = [r[BEST_KEY[cli]] for r in run["rows"]]
        assert bests == sorted(bests), side
        assert run["resumed"]["best_acc"] >= run["killed"]["best_acc"], side
        assert run["resumed"]["best_acc"] == bests[-1], side
    for jrow, prow in zip(runs[cli]["jax"]["rows"], runs[cli]["port"]["rows"]):
        assert set(jrow) <= set(prow)
    log = runs[cli]["port"]["log"]
    assert "resumed training from" in log if cli == "ft_cls" else "resumed from" in log


@pytest.mark.parametrize("cli", list(CLIS))
def test_dump_feats_matches_the_jax_artifact(runs, cli):
    """`files/<tag>_test_feats_labels.npz` with JAX's keys, shapes [N, 2D]
    and [N] and row count (the whole test split)."""
    name = f"{CLIS[cli][3]}_test_feats_labels.npz"
    jblob, pblob = (dict(np.load(runs[cli][side]["dumps"][name])) for side in ("jax", "port"))
    assert set(pblob) == set(jblob) == {"feats", "labels"}
    assert pblob["feats"].shape == jblob["feats"].shape == (SPLITS[200], 2 * TINY[
        "num_latent_channels"])
    assert pblob["labels"].shape == jblob["labels"].shape == (SPLITS[200],)
    assert pblob["feats"].dtype == np.float32 and np.isfinite(pblob["feats"]).all()
    assert pblob["labels"].dtype.kind == jblob["labels"].dtype.kind == "i"


def test_show_feats_reads_the_port_artifact(runs, monkeypatch):
    """JAX's tools/visualization/show_feats.py --feats_file takes the port's
    ft_cls artifact unchanged: what it hands its t-SNE plot is the
    artifact's features and labels (the plot itself is test_cli.py's)."""
    spec = importlib.util.spec_from_file_location(
        "show_feats", os.path.join(REPO, "tools", "visualization", "show_feats.py"))
    show = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(show)
    path = runs["ft_cls"]["port"]["dumps"]["ft_test_feats_labels.npz"]
    plotted = []
    monkeypatch.setattr(show, "_plot", lambda feats, labels, title, out: plotted.append(
        (feats, labels, out)))
    monkeypatch.setattr(sys, "argv", ["show_feats.py", "--feats_file", path, "--out", "x.png",
                                      "--max_samples", "100"])
    show.main()
    blob = np.load(path)
    ((feats, labels, out),) = plotted
    assert out == "x.png"
    np.testing.assert_array_equal(feats, blob["feats"])
    np.testing.assert_array_equal(labels, blob["labels"])


def _tiny_cls(optim: str, seed: int):
    cfg = tconfig.Config(**dict(TINY, num_obj_classes=40, optim=optim, seed=seed))
    model = tfactory.build_ft_cls(cfg, device="cpu")
    return cfg, model, create_state(cfg, {"pc": model})


@pytest.mark.parametrize("optim", ["adamw", "adam", "sgd"])
def test_restore_is_bitwise_and_steps_as_before_the_kill(tmp_path, optim):
    """After two steps the state is saved; the run takes a third step on a
    batch with its generator in some state. A fresh state (other init)
    restored from the snapshot holds the saved weights, BatchNorm
    statistics, optimizer moments and step counts bit for bit, and the same
    third step from it (the same batch, a generator in the same state)
    gives the killed run's parameters and moments bit for bit."""
    rng = np.random.default_rng(3)

    def batch():
        return {"points": rng.standard_normal((8, 64, 3)).astype(np.float32),
                "labels": rng.integers(0, 40, 8)}

    cfg, model, state = _tiny_cls(optim, seed=1)
    step = make_cls_step(cfg, model)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        step(state, batch(), 1e-3, gen)
    path = str(tmp_path / "model_last.ckpt")
    save_state(path, state, {"epoch": 1})
    b3, gen_state = batch(), gen.get_state()
    step(state, b3, 1e-3, gen)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    moments = state.optimizer.state_dict()["state"]

    cfg2, model2, state2 = _tiny_cls(optim, seed=2)
    assert not all(torch.equal(v, after[k]) for k, v in model2.state_dict().items())
    assert restore_state(path, state2) == {"epoch": 1}
    saved = load_checkpoint(path)
    for k, v in model2.state_dict().items():
        assert torch.equal(v, saved["pc"][k]), k
    got = state2.optimizer.state_dict()
    assert got["param_groups"] == saved["optimizer"]["param_groups"]
    for i, entry in saved["optimizer"]["state"].items():
        for name, t in entry.items():
            assert torch.equal(got["state"][i][name], t), (i, name)
    assert state2.step == 2
    make_cls_step(cfg2, model2)(state2, b3, 1e-3, torch.Generator().set_state(gen_state))
    for k, v in model2.state_dict().items():
        assert torch.equal(v, after[k]), k
    for i, entry in state2.optimizer.state_dict()["state"].items():
        for name, t in entry.items():
            assert torch.equal(t, moments[i][name]), (i, name)
    assert state2.step == state.step == 3


def test_restore_refuses_a_weights_only_checkpoint(tmp_path):
    """A checkpoint without the optimizer's state (a finetune's
    model_best, a converted reference checkpoint) is not a snapshot a run
    resumes from: restore_state says so instead of half-restoring."""
    from vipformer_tpu_torch.train.checkpoint import save_checkpoint

    cfg, model, state = _tiny_cls("adamw", seed=1)
    path = str(tmp_path / "model_best.ckpt")
    save_checkpoint(path, model, {"epoch": 0})
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_state(path, state)


SEG = {
    "ft_partseg": (tft_partseg, "ShapeNetPart", {"trainval": (16, 4), "test": (8, 5)},
                   ["--num_ft_points", "128", "--batch_size", "8", "--test_batch_size", "8"],
                   "mean_category_iou"),
    "ft_semseg": (tft_semseg, "S3DIS", {"train": (8, 6), "test": (6, 8)},
                  ["--batch_size", "4", "--test_batch_size", "4"], "miou"),
}


@pytest.mark.parametrize("cli", list(SEG))
def test_segmentation_resume_restores_epoch_and_best(tmp_path, monkeypatch, cli):
    """partseg's and semseg's `--resume_training`: a run killed after epoch
    1 of 2 resumes at epoch 2 from model_last (JAX's metadata keys:
    epoch, best, best_epoch, kind) and takes its best tracker from the
    snapshot: a best of 1.0 at epoch 1 written into it stands (no IoU
    beats it), so the tracker was restored, not recomputed."""
    mod, ds, sizes, extra, key = SEG[cli]
    monkeypatch.setattr(getattr(tdatasets, ds), "sizes", sizes)
    argv = ["--synthetic_data", "true", "--arch", "E1CL2SL-H2D32-L16-MR2", "--group_size", "8",
            "--layer_idx", "1", "2", "--compute_dtype", "float32", "--save_freq", "1",
            "--run_dir", str(tmp_path), "--exp_name", "seg", "--device", "cpu"] + extra
    killed = mod.main(*mod.parse_args(argv + ["--epochs", "2"]))
    root = tmp_path / "ViPFormerTPU" / "seg"
    path = str(root / "models" / "model_last.ckpt")
    meta = load_metadata(path)
    assert set(meta) == {"epoch", "best", "best_epoch", "kind"}
    assert (meta["epoch"], meta["kind"], meta["best_epoch"]) == (1, cli, killed["best_epoch"])
    assert meta["best"] == killed["best"]
    meta.update(best=dict(meta["best"], **{key: 1.0}), best_epoch=1)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    out = mod.main(*mod.parse_args(argv + ["--epochs", "3", "--resume_training", "true"]))
    rows = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert out["best"][key] == 1.0 and out["best_epoch"] == 1
    assert load_metadata(path)["epoch"] == 2
    assert "resumed training from" in "".join(p.read_text() for p in root.glob("*.log"))
