"""Shared CLI plumbing (counterpart of vipformer_tpu/cli/common.py: `setup`,
`warn_patch_compat`, `extract_features`, `dump_feats_artifact`,
`resume_training_state` and `save_rolling`): the run directory, its log and
its metrics stream, the stem-mode check of a restored checkpoint, the eval
CLIs' checkpoint restore, the batched feature extraction of the SVM
probes, the `--dump_feats` artifact, and the finetunes' crash-resume. The port runs on one card, so there is no mesh and the batch
needs no rounding."""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import torch

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.data.pipeline import Loader, collate_cls, pad_batch
from vipformer_tpu_torch.train.checkpoint import (
    branch_state,
    load_checkpoint,
    load_metadata,
    restore_state,
    save_state,
)


class Run:
    """The run directory `<run_dir>/<proj_name>/<exp_name>` with the resolved
    `config.json`, a log file beside stdout, and metrics.jsonl."""

    def __init__(self, cfg: Config):
        self.root = os.path.join(cfg.run_dir, cfg.proj_name, cfg.exp_name)
        os.makedirs(os.path.join(self.root, "models"), exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.log_path = os.path.join(self.root, f"{stamp}.log") if cfg.log_to_file else None
        with open(os.path.join(self.root, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    def model_path(self, name: str) -> str:
        return os.path.join(self.root, "models", name + ".ckpt")

    def write(self, msg: str) -> None:
        line = f"{datetime.datetime.now():%Y-%m-%d %H:%M:%S} {msg}"
        print(line, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(line + "\n")

    def metrics(self, step: int, **kv) -> None:
        with open(os.path.join(self.root, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **kv}) + "\n")


def warn_patch_compat(ckpt_path: str, cfg: Config, log) -> None:
    """Log a WARNING when the checkpoint's recorded `patch_compat` (its JSON
    sidecar; the pretrain CLI and converted reference checkpoints record
    it) differs from the config's: a stem run in the other mode than it was
    trained in silently loses accuracy (JAX cli/common.py:54-74)."""
    try:
        want = load_metadata(ckpt_path).get("patch_compat")
    except (OSError, ValueError):
        return
    if want is not None and bool(want) != cfg.patch_compat:
        log(f"WARNING: checkpoint {ckpt_path} was trained with patch_compat={want} but config "
            f"has patch_compat={cfg.patch_compat}; pass --patch_compat "
            f"{str(bool(want)).lower()} to match its stem (see ops/geometry.py:divide_patches)")


def require_single_card(cfg: Config) -> None:
    """The port runs on one card (multi-card runs are ROADMAP Queue 1,
    item 16)."""
    if cfg.num_devices > 1:
        raise NotImplementedError("multi-card runs are not ported yet (ROADMAP Queue 1, "
                                  "item 16): the port runs on one card")


def restore_eval_model(model, cfg: Config, run: Run) -> str:
    """The eval CLIs' restore of the whole model (JAX cli/eval_fewshot.py:
    43-57, eval_zeroshot.py:42-56) from `pc_model_file` (a path, or a name
    under the run's models/): the point branch of the pretrain CLI's
    checkpoint (`pc_model_best`), or the single model of an ft_cls one
    (`model_best`, for `--fewshot_model ft`), loaded strictly. A missing
    file leaves the random init, with JAX's warning. Returns the path."""
    path = cfg.pc_model_file if "/" in cfg.pc_model_file else run.model_path(cfg.pc_model_file)
    warn_patch_compat(path, cfg, run.write)
    if not os.path.exists(path):
        run.write(f"WARNING: no checkpoint at {path}; evaluating raw init")
        return path
    model.load_state_dict(branch_state(load_checkpoint(path)))
    run.write(f"loaded pretrained model from {path}")
    return path


def extract_features(feats_fn, dataset, batch_size: int):
    """Backbone features of a (points, label) dataset, batch by batch (JAX
    cli/common.py:106-128; its `collate_points_labels`, :154-157, is the
    port's `collate_cls`): every batch has `batch_size` samples (the last
    one padded) and the padding is masked out. -> (features [N, 2D] on the
    device feats_fn returns them on, labels numpy [N])."""
    feats, labels = [], []
    for batch in Loader(dataset, batch_size, collate_cls, shuffle=False):
        batch, mask = pad_batch(batch, batch_size)
        out = feats_fn(batch["points"])
        feats.append(out[torch.as_tensor(mask, device=out.device)])
        labels.append(batch["labels"][mask])
    return torch.cat(feats), np.concatenate(labels)


def dump_feats_artifact(run: Run, tag: str, feats, labels) -> str:
    """`--dump_feats` (JAX cli/common.py:131-151): the test split's backbone
    features [N, 2D] (f32) and labels [N] as
    `<run>/files/<tag>_test_feats_labels.npz` (keys `feats`, `labels`),
    which `tools/visualization/show_feats.py --feats_file` renders.
    Returns the path."""
    path = os.path.join(run.root, "files", f"{tag}_test_feats_labels.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    labels = np.asarray(labels)
    np.savez(path, feats=torch.as_tensor(feats).float().cpu().numpy(), labels=labels)
    run.write(f"dumped {len(labels)} test feature vectors -> {path}")
    return path


def resume_training_state(run: Run, state, cfg: Config) -> tuple[int, dict]:
    """Crash-resume of the finetune loops (JAX cli/common.py:160-188): with
    `--resume_training`, put the rolling `model_last` snapshot back into
    `state` (train/checkpoint.py:restore_state: weights, BatchNorm
    statistics, the optimizer's moments and step counts) and return (the
    epoch after its own, its metadata). Without the flag, or where no
    snapshot was written yet (a run killed before its first save), (0, {})
    and a fresh start."""
    if not cfg.resume_training:
        return 0, {}
    path = run.model_path("model_last")
    if not os.path.exists(path):
        run.write(f"resume_training requested but {path} missing: fresh start")
        return 0, {}
    meta = restore_state(path, state)
    start = meta.get("epoch", -1) + 1
    run.write(f"resumed training from {path} at epoch {start}")
    return start, meta


def save_rolling(run: Run, state, epoch: int, cfg: Config, extra: dict) -> None:
    """The rolling `model_last` snapshot every `save_freq` epochs (JAX
    cli/common.py:191-201), with {"epoch": epoch, **extra}; the write is
    atomic, so a kill during it leaves the previous snapshot."""
    if cfg.save_freq and (epoch + 1) % cfg.save_freq == 0:
        save_state(run.model_path("model_last"), state, {"epoch": epoch, **extra})
