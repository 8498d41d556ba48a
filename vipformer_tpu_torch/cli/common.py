"""Shared CLI plumbing (counterpart of vipformer_tpu/cli/common.py: `setup`,
`warn_patch_compat` and `extract_features`): the run directory, its log and
its metrics stream, the stem-mode check of a restored checkpoint, the eval
CLIs' checkpoint restore, and the batched feature extraction of the SVM
probes. The port runs on one card, so there is no mesh and the batch
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
from vipformer_tpu_torch.train.checkpoint import branch_state, load_checkpoint, load_metadata


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
