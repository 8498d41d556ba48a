"""The pretrain train step and its state (counterpart of
vipformer_tpu/train/trainer.py: `create_state`, `make_pretrain_step`).

One optimizer spans both branches, as in the reference (pretrain.py:106).
The step runs both point views concatenated through the point branch, the
images through the image branch, IMID + cmid_weight * CMID (NT-Xent,
temperature 0.1), one backward and one optimizer update; the BatchNorm
running statistics update inside the train-mode forward. The state is
updated in place and returned, so a loop reads like the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.losses.contrastive import nt_xent_grouped
from vipformer_tpu_torch.train.optim import build_optimizer, clip_grad_global_norm, set_learning_rate


@dataclass
class TrainState:
    """The branches ({"pc": ..., "img": ...}; "img" absent for imc-only),
    the optimizer over all their parameters, and the step count."""

    models: dict[str, nn.Module]
    optimizer: torch.optim.Optimizer
    step: int = 0

    def parameters(self):
        for m in self.models.values():
            yield from m.parameters()


def create_state(cfg: Config, models: dict[str, nn.Module]) -> TrainState:
    params = [p for m in models.values() for p in m.parameters()]
    return TrainState(models=dict(models), optimizer=build_optimizer(cfg, params))


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=torch.float32)


def make_pretrain_step(cfg: Config, pc_model: nn.Module, img_model: nn.Module | None = None,
                       neg_groups: int = 1):
    """Returns step(state, batch, lr, generator=None) -> (state, metrics).

    batch: {"pc_t1", "pc_t2": [B, N, 3], "imgs": [B, H, W, 3]} as numpy
    arrays or tensors (moved to the point branch's device). `generator`
    draws FPS's random starts and every dropout / DropPath mask; without
    one FPS starts at 0 and every dropout rate must be 0. Metrics (loss,
    loss_imid, loss_cmid) stay on the device, so the step does not wait
    for the card.
    """
    if cfg.device_augs:
        raise NotImplementedError(
            "--device_augs (on-device augmentation, data/augment_device.py) is not "
            "ported yet (ROADMAP Queue 1)")
    modality = cfg.modality
    groups = 1 if cfg.global_negatives else neg_groups
    use_img = modality != "imc-only"
    if use_img and img_model is None:
        raise ValueError(f"modality {modality!r} needs the image branch")
    models = [pc_model] + ([img_model] if use_img else [])
    device = next(pc_model.parameters()).device

    def loss_fn(batch, generator):
        t1, t2 = _on(batch["pc_t1"], device), _on(batch["pc_t2"], device)
        b = t1.shape[0]
        pc_proj, _ = pc_model(torch.cat([t1, t2], dim=0), generator)
        z1, z2 = pc_proj[:b], pc_proj[b:]
        zero = torch.zeros((), device=device)
        loss_imid = nt_xent_grouped(z1, z2, groups) if modality != "cmc-only" else zero
        loss_cmid = zero
        if use_img:
            img_proj, _ = img_model(_on(batch["imgs"], device), generator)
            loss_cmid = nt_xent_grouped((z1 + z2) / 2.0, img_proj, groups)
        total = loss_imid + cfg.cmid_weight * loss_cmid
        return total, {"loss": total, "loss_imid": loss_imid, "loss_cmid": loss_cmid}

    def step(state: TrainState, batch, lr: float, generator: torch.Generator | None = None):
        for m in models:
            m.train()
        opt = state.optimizer
        set_learning_rate(opt, lr)
        opt.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, generator)
        total.backward()
        if cfg.grad_clip_norm is not None:
            clip_grad_global_norm(state.parameters(), cfg.grad_clip_norm)
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
