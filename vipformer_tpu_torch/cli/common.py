"""Shared CLI plumbing (counterpart of vipformer_tpu/cli/common.py: `setup`,
`warn_patch_compat` and `extract_features`): the run directory, its log and
its metrics stream, the stem-mode check of a restored checkpoint, and the
batched feature extraction of the SVM probe. The port runs on one card, so
there is no mesh and the batch needs no rounding."""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import torch

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.data.pipeline import Loader, collate_cls, pad_batch
from vipformer_tpu_torch.train.checkpoint import load_metadata


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
