"""Semantic-segmentation finetune entry point on S3DIS (counterpart of
vipformer_tpu/cli/ft_semseg.py), on the card by default.

    python -m vipformer_tpu_torch.cli.ft_semseg --synthetic_data true \\
        --batch_size 32 --test_batch_size 32 --epochs 100 \\
        --num_latent_channels 384 --num_ca_heads 6 --num_sa_heads 6 \\
        --num_sa_layers 12 --mlp_widen_factor 4 --layer_idx 2 6 10 \\
        --num_pc_latents 128 --group_size 32 --point_channels 6 \\
        --num_obj_classes 13 --num_ft_points 4096 --test_area 5 \\
        --optim adamw --lr 0.001 --scheduler cos \\
        --max_dpr 0.1 --atten_drop 0.0 --mlp_drop 0.0 \\
        [--resume true --pc_model_file <run>/models/pc_model_best.ckpt] \\
        [--device cpu]

(scripts/finetune/ft-semseg.sh's flags.) The model reads the first
`point_channels` of the blocks' 9 channels (xyz + rgb by default). With
`--resume true` the encoder comes from the pretrain checkpoint that
`cli.pretrain` writes (the stem stays fresh: the pretrain stem takes 3
channels, semseg's 6), as JAX ft_semseg.py:66-75 restores it. Each epoch
runs `make_semseg_step` over the shuffled train split (the HDF5 blocks
under `--data_dir` with Area `test_area` held out, else the synthetic
stand-in), evaluates
the test split at `test_batch_size` (the last batch padded, its padding
masked out), writes one line to `<run_dir>/<proj_name>/<exp_name>/
metrics.jsonl` and saves `models/model_best.ckpt` on a new best mIoU, and
every `save_freq` epochs the rolling `model_last` (weights, the
optimizer's moments and the step count, with {"epoch", "best",
"best_epoch", "kind"}). `--resume_training true` continues a killed run
from `model_last` at the epoch after its own, the best tracker restored
(`cli/common.py:resume_training_state`; no snapshot: a fresh start).

Not ported yet (each raises or is logged): wandb and multi-card runs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vipformer_tpu_torch.cli.common import (
    Run,
    require_single_card,
    resume_training_state,
    save_rolling,
    warn_patch_compat,
)
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import S3DIS
from vipformer_tpu_torch.data.pipeline import Loader, collate_semseg, pad_batch
from vipformer_tpu_torch.evaluation.iou import semseg_miou
from vipformer_tpu_torch.models.factory import build_ft_semseg
from vipformer_tpu_torch.train.checkpoint import (
    branch_state,
    load_checkpoint,
    restore_backbone,
    save_checkpoint,
)
from vipformer_tpu_torch.train.meters import AverageMeter
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import create_state, make_semseg_eval, make_semseg_step


class _SliceChannels:
    """A semseg dataset that exposes only the first `c` point channels
    (JAX ft_semseg.py:147-160)."""

    def __init__(self, ds, c: int):
        self.ds, self.c = ds, c

    def __len__(self) -> int:
        return len(self.ds)

    def get(self, i: int, rng=None):
        pts, seg = self.ds.get(i, rng)
        return pts[..., :self.c], seg


def evaluate(eval_step, test_set, batch_size: int) -> dict:
    """Point accuracy and mIoU over the whole test split; every batch has
    `batch_size` blocks (the last one padded, its padding not counted)."""
    preds, segs = [], []
    for batch in Loader(test_set, batch_size, collate_semseg, shuffle=False):
        batch, mask = pad_batch(batch, batch_size)
        preds.append(eval_step(batch["points"]).cpu().numpy()[mask])
        segs.append(batch["seg"][mask])
    return semseg_miou(np.concatenate(preds), np.concatenate(segs))


def main(cfg: Config, device: str = "cuda") -> dict:
    require_single_card(cfg)
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    pc = cfg.point_channels
    train_set = _SliceChannels(S3DIS(cfg.data_dir, "train", cfg.test_area), pc)
    test_set = _SliceChannels(S3DIS(cfg.data_dir, "test", cfg.test_area), pc)
    train_loader = Loader(train_set, cfg.batch_size, collate_semseg, shuffle=True,
                          seed=cfg.seed, drop_last=True, num_workers=cfg.num_workers)
    model = build_ft_semseg(cfg, device=device)
    if cfg.resume:
        path = (cfg.pc_model_file if "/" in cfg.pc_model_file
                else run.model_path(cfg.pc_model_file))
        warn_patch_compat(path, cfg, run.write)
        restore_backbone(model, branch_state(load_checkpoint(path)), ("encoder",),
                         log=run.write)
    state = create_state(cfg, {"pc": model})
    start_epoch, last_meta = resume_training_state(run, state, cfg)
    step = make_semseg_step(cfg, model)
    eval_step = make_semseg_eval(model)
    run.write(f"ft_semseg on {device}: S3DIS {len(train_set)} train / "
              f"{len(test_set)} test blocks of 4096 points x {pc} channels, "
              f"{len(train_loader)} batches of {cfg.batch_size}, {cfg.compute_dtype}")

    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    best = last_meta.get("best", {"miou": 0.0})
    best_epoch = last_meta.get("best_epoch", -1)
    epoch_metric = None  # the plateau schedule's metric: none before an epoch of this run
    for epoch in range(start_epoch, cfg.epochs):
        # the plateau schedule reads last epoch's mean train loss
        lr = schedule.lr(epoch, epoch_metric)
        train_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        metrics = [step(state, batch, lr, generator)[1] for batch in train_loader]
        loss_m, acc_m = AverageMeter(), AverageMeter()
        for m in metrics:  # the first read waits for the card
            loss_m.update(float(m["loss"]), cfg.batch_size)
            acc_m.update(float(m["acc"]), cfg.batch_size)
        train_time = time.perf_counter() - t0
        epoch_metric = loss_m.avg
        results = evaluate(eval_step, test_set, cfg.test_batch_size)
        if results["miou"] > best["miou"]:
            best, best_epoch = results, epoch
            save_checkpoint(run.model_path("model_best"), model,
                            {"epoch": epoch, **results, "kind": "ft_semseg"})
        run.write(f"epoch {epoch}/{cfg.epochs}: loss {loss_m.avg:.4f} train acc {acc_m.avg:.4f} "
                  f"| test acc {results['point_level_acc']:.4f} miou {results['miou']:.4f} "
                  f"(best {best['miou']:.4f}@{best_epoch}) lr {lr:.5f} {train_time:.1f}s")
        run.metrics(epoch, lr=lr, train_loss=loss_m.avg, train_acc=acc_m.avg,
                    train_time=train_time,
                    clouds_per_s=len(metrics) * cfg.batch_size / max(train_time, 1e-9),
                    **results)
        save_rolling(run, state, epoch, cfg,
                     {"best": best, "best_epoch": best_epoch, "kind": "ft_semseg"})
    run.write(f"final best mIoU {best['miou']:.4f} at epoch {best_epoch}")
    return {"best": best, "best_epoch": best_epoch}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer semantic-segmentation finetune "
                                                 "(PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns, ft_dataset="S3DIS", point_channels=6, num_obj_classes=13,
                                 num_sa_layers=12, max_dpr=0.1, atten_drop=0.0,
                                 mlp_drop=0.0), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
