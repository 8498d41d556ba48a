"""Train and eval steps and their state (counterpart of
vipformer_tpu/train/trainer.py: `create_state`, `make_pretrain_step`,
`make_feats_fn`, `make_cls_step`, `make_cls_eval`, `make_partseg_step`,
`make_partseg_eval`, `refine_partseg_pred`, `make_semseg_step`,
`make_semseg_eval`). The pretrain, classification and feature functions
take either model family (the mp CrossFormers or the generic Perceivers):
both return the same tuples.

One optimizer spans every model of the state, as in the reference
(pretrain.py:106). A train step runs the train-mode forward (the BatchNorm
running statistics update inside it), the loss, one backward and one
optimizer update. The pretrain step runs both point views concatenated
through the point branch, the images through the image branch, and IMID +
cmid_weight * CMID (NT-Xent, temperature 0.1); the classification step
runs label-smoothed cross-entropy (0.2) on the finetune model's logits,
the part- and semantic-segmentation steps the same over every point's
logits (B*N rows). The state is updated in place and returned, so a loop
reads like the JAX one.

Data parallelism (`parallel/`, a process group of W > 1 ranks): each rank
runs the step on its contiguous slice of the global batch; BatchNorm is
sync-BN over the ranks (nn/layers.py, K9, K18); after the backward and the
zero-gradient rule, the gradients of every parameter of the state are
averaged over the ranks in one all-reduce of their flattened
concatenation, before the global-norm clip, so every rank applies the same
update; the metrics are means over the ranks. A rank's loss is the mean
over its rows, so the average is the gradient of the global batch's mean
loss (its sync-BN backward sums every rank's rows).

Tensor parallelism (a model axis T > 1, parallel/sharding.py): the
averages above run over the data group (the W / T ranks of one model
index, which hold disjoint rows); a rank's gradients of its shards are
those of its slices, complete after the model group's exchanges
(parallel/tp.py), and its replicated parameters' gradients equal the
other model ranks', so every model rank of a data index applies the same
update to its replicated parameters. The clip takes the norm of the full
parameters (train/optim.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vipformer_tpu_torch.config import Config
from vipformer_tpu_torch.data.augment_device import (
    pretrain_two_views,
    random_image_chain,
)
from vipformer_tpu_torch.data.synthetic import INDEX_START, SEG_NUM
from vipformer_tpu_torch.losses.classification import smoothed_cross_entropy
from vipformer_tpu_torch.losses.contrastive import nt_xent_data_parallel
from vipformer_tpu_torch.parallel.mesh import all_reduce_, data_axis_size
from vipformer_tpu_torch.train.optim import build_optimizer, clip_grad_global_norm, set_learning_rate


NUM_OBJ_CLASSES = 16  # ShapeNetPart's categories


def category_part_mask() -> np.ndarray:
    """[16, 50] bool: which part ids belong to each object category."""
    mask = np.zeros((NUM_OBJ_CLASSES, 50), dtype=bool)
    for c in range(NUM_OBJ_CLASSES):
        mask[c, INDEX_START[c]:INDEX_START[c] + SEG_NUM[c]] = True
    return mask


def refine_partseg_pred(logits: torch.Tensor, obj_labels: torch.Tensor) -> torch.Tensor:
    """Category-masked prediction (JAX trainer.py:49-63): the argmax of
    logits [B, N, 50] over the parts of each sample's object category, the
    others set to the f32 minimum -> int64 [B, N]."""
    mask = torch.as_tensor(category_part_mask(), device=logits.device)[obj_labels.long()]
    neg = torch.finfo(torch.float32).min
    return torch.where(mask[:, None, :], logits.float(), neg).argmax(-1)


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
    arrays or tensors (moved to the point branch's device). With
    `cfg.device_augs` (JAX trainer.py:143-157) it is {"pc_raw": [B, N, 3],
    "imgs": [B, H, W, 3] uint8}: both point views come from
    `pretrain_two_views` on the device and, where the images have an
    integer dtype, the image chain runs there too, in f32 (the model casts
    after), their draws taken from `generator` before the model's.
    `generator` draws FPS's random starts and every dropout / DropPath
    mask; without one FPS starts at 0 and every dropout rate must be 0
    (and `device_augs`, which draws from it, raises). Metrics (loss,
    loss_imid, loss_cmid) stay on the device, so the step does not wait
    for the card. `neg_groups` counts the NT-Xent groups over the global
    batch (the CLI passes the data-axis size W, JAX's per-device groups);
    under data parallelism each rank holds the rows of its own groups
    (`nt_xent_data_parallel`), and `cfg.global_negatives` takes one group
    over the whole global batch.
    """
    modality = cfg.modality
    groups = 1 if cfg.global_negatives else neg_groups
    use_img = modality != "imc-only"
    if use_img and img_model is None:
        raise ValueError(f"modality {modality!r} needs the image branch")
    models = [pc_model] + ([img_model] if use_img else [])
    device = next(pc_model.parameters()).device

    def views(batch, generator):
        """(view 1, view 2) on the device in f32, and the images (the
        chain's f32 output where it runs, else as the batch holds them)."""
        imgs = batch.get("imgs")
        if not cfg.device_augs:
            return _on(batch["pc_t1"], device), _on(batch["pc_t2"], device), imgs
        if generator is None:
            raise ValueError("--device_augs draws the augmentations from the step's generator")
        t1, t2 = pretrain_two_views(_on(batch["pc_raw"], device), generator)
        if imgs is not None:
            imgs = torch.as_tensor(imgs, device=device)
            if not imgs.is_floating_point():
                imgs = random_image_chain(imgs, generator)
        return t1, t2, imgs

    def loss_fn(batch, generator):
        t1, t2, imgs = views(batch, generator)
        b = t1.shape[0]
        pc_proj, _ = pc_model(torch.cat([t1, t2], dim=0), generator)
        z1, z2 = pc_proj[:b], pc_proj[b:]
        zero = torch.zeros((), device=device)
        loss_imid = nt_xent_data_parallel(z1, z2, groups) if modality != "cmc-only" else zero
        loss_cmid = zero
        if use_img:
            img_proj, _ = img_model(_on(imgs, device), generator)
            loss_cmid = nt_xent_data_parallel((z1 + z2) / 2.0, img_proj, groups)
        total = loss_imid + cfg.cmid_weight * loss_cmid
        return total, {"loss": total, "loss_imid": loss_imid, "loss_cmid": loss_cmid}

    return _make_step(cfg, models, loss_fn)


def _make_step(cfg: Config, models: list[nn.Module], loss_fn):
    """step(state, batch, lr, generator=None) -> (state, metrics) around
    loss_fn(batch, generator) -> (loss, metrics): train mode, the lr, one
    backward, the gradients averaged over the ranks (with W > 1), the
    optional global-norm clip, one optimizer update of every parameter of
    the state; metrics averaged over the ranks."""

    def step(state: TrainState, batch, lr: float, generator: torch.Generator | None = None):
        for m in models:
            m.train()
        opt = state.optimizer
        set_learning_rate(opt, lr)
        opt.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, generator)
        total.backward()
        for p in state.parameters():
            # a parameter the loss does not reach (partseg's layers after
            # the last tap) gets a zero gradient, as optax's does in the
            # JAX step: AdamW still decays it, where torch.optim would skip
            # a parameter whose gradient is None
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        world = data_axis_size()
        if world > 1:
            _average_over_ranks([p.grad for p in state.parameters()], world)
        if cfg.grad_clip_norm is not None:
            clip_grad_global_norm(state.parameters(), cfg.grad_clip_norm)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if world > 1:
            vals = [v.float().reshape(1) for v in metrics.values()]
            _average_over_ranks(vals, world)
            metrics = dict(zip(metrics, (v[0] for v in vals)))
        return state, metrics

    return step


def _average_over_ranks(tensors: list[torch.Tensor], world: int) -> None:
    """Each tensor (same device and dtype) replaced in place by its mean
    over the data group's `world` ranks: one all-reduce of their flattened
    concatenation."""
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
    flat /= world
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def make_cls_step(cfg: Config, model: nn.Module):
    """Returns step(state, batch, lr, generator=None) -> (state, metrics)
    for the classification finetune (reference ft_cls.py:151-213).

    batch: {"points": [B, N, 3], "labels": [B] int} as numpy arrays or
    tensors; `state` from `create_state(cfg, {"pc": model})`. Metrics (the
    label-smoothed loss and the argmax accuracy) stay on the device."""
    device = next(model.parameters()).device

    def loss_fn(batch, generator):
        labels = torch.as_tensor(batch["labels"], device=device, dtype=torch.int64)
        logits, _ = model(_on(batch["points"], device), generator)
        loss = smoothed_cross_entropy(logits, labels, 0.2)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss, "acc": acc}

    return _make_step(cfg, [model], loss_fn)


def make_cls_eval(model: nn.Module):
    """Returns eval_step(points [B, N, 3]) -> predicted labels [B] (int64,
    on the model's device): the eval-mode forward's argmax."""
    device = next(model.parameters()).device

    def eval_step(points):
        model.eval()
        with torch.inference_mode():
            logits, _ = model(_on(points, device))
        return logits.argmax(-1)

    return eval_step


def make_partseg_step(cfg: Config, model: nn.Module):
    """Returns step(state, batch, lr, generator=None) -> (state, metrics)
    for the part-segmentation finetune (JAX trainer.py:249-272, reference
    ft_partseg.py:135-247): label-smoothed cross-entropy (0.2) over the B*N
    point rows, and the point accuracy of the category-refined argmax.

    batch: {"points": [B, N, 3], "obj_labels": [B] int, "seg": [B, N] int}
    as numpy arrays or tensors; `state` from `create_state(cfg, {"pc":
    model})`; `cfg.grad_clip_norm` (the CLI sets 10) clips the global
    gradient norm."""
    device = next(model.parameters()).device

    def loss_fn(batch, generator):
        obj = torch.as_tensor(batch["obj_labels"], device=device, dtype=torch.int64)
        seg = torch.as_tensor(batch["seg"], device=device, dtype=torch.int64)
        onehot = torch.nn.functional.one_hot(obj, NUM_OBJ_CLASSES).float()
        logits = model(_on(batch["points"], device), onehot, generator)
        loss = smoothed_cross_entropy(logits.reshape(-1, logits.shape[-1]), seg.reshape(-1), 0.2)
        acc = (refine_partseg_pred(logits.detach(), obj) == seg).float().mean()
        return loss, {"loss": loss, "acc": acc}

    return _make_step(cfg, [model], loss_fn)


def make_partseg_eval(model: nn.Module):
    """Returns eval_step(points [B, N, 3], obj_labels [B]) -> (logits
    [B, N, parts], refined predictions int64 [B, N]) on the model's device
    (JAX trainer.py:275-290)."""
    device = next(model.parameters()).device

    def eval_step(points, obj_labels):
        model.eval()
        obj = torch.as_tensor(obj_labels, device=device, dtype=torch.int64)
        with torch.inference_mode():
            onehot = torch.nn.functional.one_hot(obj, NUM_OBJ_CLASSES).float()
            logits = model(_on(points, device), onehot)
        return logits, refine_partseg_pred(logits, obj)

    return eval_step


def make_semseg_step(cfg: Config, model: nn.Module):
    """Returns step(state, batch, lr, generator=None) -> (state, metrics)
    for the semantic-segmentation finetune (JAX trainer.py:296-316):
    label-smoothed cross-entropy (0.2) over the B*N point rows, and the
    point accuracy of the argmax.

    batch: {"points": [B, N, point_channels], "seg": [B, N] int} as numpy
    arrays or tensors; `state` from `create_state(cfg, {"pc": model})`."""
    device = next(model.parameters()).device

    def loss_fn(batch, generator):
        seg = torch.as_tensor(batch["seg"], device=device, dtype=torch.int64)
        logits = model(_on(batch["points"], device), generator)
        loss = smoothed_cross_entropy(logits.reshape(-1, logits.shape[-1]), seg.reshape(-1), 0.2)
        acc = (logits.detach().argmax(-1) == seg).float().mean()
        return loss, {"loss": loss, "acc": acc}

    return _make_step(cfg, [model], loss_fn)


def make_semseg_eval(model: nn.Module):
    """Returns eval_step(points [B, N, point_channels]) -> predicted
    classes int64 [B, N] on the model's device: the eval forward's argmax
    (JAX trainer.py:319-330)."""
    device = next(model.parameters()).device

    def eval_step(points):
        model.eval()
        with torch.inference_mode():
            return model(_on(points, device)).argmax(-1)

    return eval_step


def make_feats_fn(model: nn.Module):
    """Returns feats(x) -> backbone features [B, 2D] of the eval forward:
    x is a point batch [B, N, 3] for a point model, an image batch
    [B, H, W, 3] for an image branch (the mp CrossFormerImg or the
    Perceiver's Fourier branch)."""
    device = next(model.parameters()).device

    def feats(x):
        model.eval()
        with torch.inference_mode():
            return model(_on(x, device))[1]

    return feats
