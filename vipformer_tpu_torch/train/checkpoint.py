"""Checkpoints: a state dict per branch plus a JSON sidecar of metadata
(counterpart of vipformer_tpu/train/checkpoint.py, which snapshots flax
pytrees). The write is atomic (temporary file, then os.replace).
`restore_backbone` is the explicit backbone restore of the finetune entry
points: it reports which tensors came from the checkpoint and which kept
their fresh init, instead of a silent `load_state_dict(strict=False)`."""

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


def branch_state(ckpt: dict, name: str = "pc") -> dict[str, torch.Tensor]:
    """The state dict of one branch of a loaded checkpoint: `name` in a
    checkpoint of several branches, else its single module's."""
    if name in ckpt:
        return ckpt[name]
    if "model" in ckpt:
        return ckpt["model"]
    raise KeyError(f"checkpoint has no {name!r} or 'model' entry: {sorted(ckpt)}")


def restore_backbone(model: nn.Module, pretrained: dict[str, torch.Tensor],
                     submodules=("stem", "encoder"), log=None) -> str:
    """Copy the tensors of the named top-level submodules from a pretrain
    state dict into `model`, key by key (JAX checkpoint.py:113-147): keys
    present in both with equal shapes are taken; the model's other tensors
    keep their fresh init (the finetune head, layers deeper than the
    pretrain); a shape mismatch is kept fresh and reported. Returns (and
    hands `log`) the message "backbone restore: N tensors from checkpoint;
    fresh init for [...]"; N counts parameters and BatchNorm statistics."""
    state = model.state_dict()
    have = {k.split(".", 1)[0] for k in pretrained}
    new, restored, fresh, mismatched = dict(state), [], [], []
    for key, value in state.items():
        top = key.split(".", 1)[0]
        if top not in submodules or top not in have:
            if top not in fresh:
                fresh.append(top)
        elif key not in pretrained:
            fresh.append(key)
        elif tuple(pretrained[key].shape) != tuple(value.shape):
            mismatched.append(f"{key}: ckpt{tuple(pretrained[key].shape)} != "
                              f"model{tuple(value.shape)}")
        else:
            new[key] = pretrained[key]
            restored.append(key)
    model.load_state_dict(new, strict=True)
    msg = f"backbone restore: {len(restored)} tensors from checkpoint; fresh init for {fresh}"
    if mismatched:
        msg += f"; SHAPE MISMATCH (kept fresh): {mismatched}"
    if log is not None:
        log(msg)
    return msg
