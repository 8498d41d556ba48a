"""Optimizers with the reference's update rules (counterpart of
vipformer_tpu/train/optim.py), on torch's own optimizers, whose rules equal
the JAX package's optax chains:

* sgd   -- torch SGD(lr, momentum=0.9): heavy ball, update = -lr * buf;
* adam  -- torch Adam(lr, weight_decay=1e-6): COUPLED L2 (the decay is
  added to the gradient before the Adam transform);
* adamw -- torch AdamW(lr, weight_decay=0.01): decoupled decay.

`set_learning_rate` changes the rate in place between steps without
rebuilding anything (the JAX package's injected hyperparameter).
`clip_grad_global_norm` is optax's clip_by_global_norm (scale by
max_norm / norm when the norm exceeds max_norm), the norm of the full
parameters under tensor parallelism: the squares of the sharded gradients
summed over the model group, the replicated ones counted once.
"""

from __future__ import annotations

from typing import Iterable

import torch

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.parallel.mesh import MODEL_AXIS, all_reduce_, model_axis_size
from vipformer_tpu_torch.parallel.sharding import sharded


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    params = list(params)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum)
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8, weight_decay=1e-6)
    if cfg.optim == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, eps=1e-8, weight_decay=0.01)
    raise ValueError(cfg.optim)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@torch.no_grad()
def clip_grad_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients to a global norm of at most `max_norm`; returns
    the norm before the scaling."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if model_axis_size() == 1:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    else:
        sq = [sum(((p.grad.float() ** 2).sum() for p in params if sharded(p) == s),
                  torch.zeros((), device=grads[0].device)) for s in (True, False)]
        norm = torch.sqrt(all_reduce_(sq[0], MODEL_AXIS) + sq[1])
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
