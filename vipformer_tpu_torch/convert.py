"""Weight bridge from the JAX package's variables to the port's state dict.

State-dict keys are the flax tree paths with `/` replaced by `.`; leaves
map as

  params/.../kernel       -> ....weight (transposed: flax [in, out], torch [out, in])
  params/.../scale        -> ....weight (LayerNorm, BatchNorm)
  params/.../bias         -> ....bias
  params/.../position_emb -> ....position_emb (the image branch's, as it is)
  batch_stats/.../mean    -> ....running_mean
  batch_stats/.../var     -> ....running_var

so `model.load_state_dict(from_jax_variables(variables), strict=True)`
loads a flax checkpoint of the same architecture. Reference `.pth` files
reach the port through `tools/convert_torch_ckpt.py` and then this bridge.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "position_emb": "position_emb"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """`{"params": ..., "batch_stats": ...}` as nested dicts of numpy arrays
    -> the port's state dict (f32 tensors)."""
    out: dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, value in _walk(variables.get(collection, {})):
            leaf = path[-1]
            if leaf not in names:
                raise KeyError(f"unexpected {collection} leaf {'/'.join(path)}")
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                arr = arr.T
            key = ".".join(path[:-1] + (names[leaf],))
            out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def grads_from_jax(grads: Mapping) -> dict[str, torch.Tensor]:
    """A JAX gradient tree over `params` (nested dicts of arrays) -> the
    same gradients under the port's parameter names and layouts."""
    return from_jax_variables({"params": grads})
