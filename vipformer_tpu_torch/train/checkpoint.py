"""Checkpoints: a state dict per branch plus a JSON sidecar of metadata
(counterpart of vipformer_tpu/train/checkpoint.py, which snapshots flax
pytrees). The write is atomic (temporary file, then os.replace). A
snapshot a run resumes from (`save_state`: the pretrain CLI's
`pc_model_best`, `pc_model_epoch{N}` and `pc_model_last`, the finetunes'
`model_last`) also holds the optimizer's state dict under "optimizer" and
the step count under "step"; `restore_state` puts it back, the moments on
the parameters' device. Every reader of a branch (`branch_state`) takes
both layouts.
`restore_backbone` is the explicit backbone restore of the finetune entry
points: it reports which tensors came from the checkpoint and which kept
their fresh init, instead of a silent `load_state_dict(strict=False)`."""

from __future__ import annotations

import json
import os

import torch
from torch import nn


def _cpu(tree):
    """A copy of `tree` (dicts, lists, tuples) with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, models: dict[str, nn.Module] | nn.Module,
                    metadata: dict | None = None, extra: dict | None = None) -> None:
    """Save `models` ({name: module}, or one module) as CPU state dicts, and
    the entries of `extra` beside them (tensors moved to the CPU)."""
    if isinstance(models, nn.Module):
        models = {"model": models}
    state = {name: _cpu(m.state_dict()) for name, m in models.items()}
    state.update(_cpu(extra or {}))
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


def save_state(path: str, state, metadata: dict) -> None:
    """A snapshot a run resumes from (JAX saves its whole TrainState,
    checkpoint.py:43-61): every branch of `state` (a train.trainer
    TrainState), the optimizer's state dict and the step count."""
    save_checkpoint(path, state.models, metadata,
                    {"optimizer": state.optimizer.state_dict(), "step": state.step})


def restore_state(path: str, state) -> dict:
    """Put a `save_state` snapshot back into `state`, in place: each
    branch's tensors (parameters and BatchNorm statistics, strictly), the
    optimizer's moments and step counts (`Optimizer.load_state_dict` moves
    them onto the parameters' device) and the step count. Returns the
    snapshot's metadata."""
    ckpt = load_checkpoint(path)
    if "optimizer" not in ckpt:
        raise ValueError(f"{path} holds no optimizer state: it is not a snapshot a run "
                         "resumes from")
    for name, m in state.models.items():
        m.load_state_dict(ckpt[name])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return load_metadata(path)


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
