"""Checkpoints: a state dict per branch plus a JSON sidecar of metadata
(counterpart of vipformer_tpu/train/checkpoint.py, which snapshots flax
pytrees). The write is atomic (temporary file, then os.replace)."""

from __future__ import annotations

import json
import os

import torch
from torch import nn


def save_checkpoint(path: str, models: dict[str, nn.Module] | nn.Module,
                    metadata: dict | None = None) -> None:
    """Save `models` ({name: module}, or one module) as CPU state dicts."""
    if isinstance(models, nn.Module):
        models = {"model": models}
    state = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
             for name, m in models.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def load_checkpoint(path: str) -> dict[str, dict[str, torch.Tensor]]:
    """{name: state dict} on the CPU; `model.load_state_dict(ckpt[name])`."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)
