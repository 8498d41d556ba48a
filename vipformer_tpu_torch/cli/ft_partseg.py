"""Part-segmentation finetune entry point (counterpart of
vipformer_tpu/cli/ft_partseg.py), on the card by default.

    python -m vipformer_tpu_torch.cli.ft_partseg --synthetic_data true \\
        --batch_size 96 --test_batch_size 96 --epochs 300 \\
        --num_latent_channels 384 --num_ca_heads 6 --num_sa_heads 6 \\
        --num_sa_layers 12 --mlp_widen_factor 4 --layer_idx 2 6 10 \\
        --num_pc_latents 128 --group_size 32 --num_ft_points 1024 \\
        --optim adamw --lr 0.001 --scheduler coswarm --step_size 100 \\
        --max_lr 0.001 --min_lr 0.0 --warm_epochs 5 --gamma 0.6 \\
        --max_dpr 0.1 --atten_drop 0.0 --mlp_drop 0.0 \\
        [--resume true --pc_model_file <run>/models/pc_model_best.ckpt] \\
        [--patch_compat true] [--device cpu]

(scripts/finetune/ft-partseg.sh's flags.) The gradient is clipped to
global norm 10 unless `--grad_clip_norm` says otherwise (reference
ft_partseg.py:175). With `--resume true` the stem and the encoder come
from the pretrain checkpoint that `cli.pretrain` writes, and a WARNING is
logged when its recorded `patch_compat` differs from the flag. Each epoch
runs `make_partseg_step` over the shuffled trainval split (the HDF5
files under `--data_dir`, else the synthetic stand-in),
evaluates the test split at `test_batch_size` (the last batch padded, its
padding masked out of the metrics), writes one line to
`<run_dir>/<proj_name>/<exp_name>/metrics.jsonl` and saves
`models/model_best.ckpt` on a new best mean category IoU, and every
`save_freq` epochs the rolling `model_last` (weights, the optimizer's
moments and the step count, with {"epoch", "best", "best_epoch",
"kind"}). `--resume_training true` continues a killed run from
`model_last` at the epoch after its own, the best tracker restored
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
from vipformer_tpu_torch.data.datasets import ShapeNetPart
from vipformer_tpu_torch.data.pipeline import Loader, collate_partseg, pad_batch
from vipformer_tpu_torch.evaluation.iou import PartSegMetrics
from vipformer_tpu_torch.models.factory import build_ft_partseg
from vipformer_tpu_torch.train.checkpoint import (
    branch_state,
    load_checkpoint,
    restore_backbone,
    save_checkpoint,
)
from vipformer_tpu_torch.train.meters import AverageMeter
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step


def evaluate(eval_step, test_set, batch_size: int) -> dict:
    """The IoU suite over the whole test split; every batch has
    `batch_size` clouds (the last one padded, its padding not counted)."""
    metrics = PartSegMetrics()
    for batch in Loader(test_set, batch_size, collate_partseg, shuffle=False):
        batch, mask = pad_batch(batch, batch_size)
        _, refined = eval_step(batch["points"], batch["obj_labels"])
        metrics.update(refined.cpu().numpy(), batch["seg"], batch["obj_labels"], valid=mask)
    return metrics.results()


def main(cfg: Config, device: str = "cuda") -> dict:
    require_single_card(cfg)
    if cfg.grad_clip_norm is None:
        cfg = cfg.replace(grad_clip_norm=10.0)  # reference ft_partseg.py:175
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    train_set = ShapeNetPart(cfg.data_dir, "trainval", cfg.num_ft_points, cfg.class_choice)
    test_set = ShapeNetPart(cfg.data_dir, "test", cfg.num_ft_points, cfg.class_choice)
    train_loader = Loader(train_set, cfg.batch_size, collate_partseg, shuffle=True,
                          seed=cfg.seed, drop_last=True, num_workers=cfg.num_workers)
    model = build_ft_partseg(cfg, device=device)
    if cfg.resume:
        path = (cfg.pc_model_file if "/" in cfg.pc_model_file
                else run.model_path(cfg.pc_model_file))
        warn_patch_compat(path, cfg, run.write)
        restore_backbone(model, branch_state(load_checkpoint(path)), ("stem", "encoder"),
                         log=run.write)
    state = create_state(cfg, {"pc": model})
    start_epoch, last_meta = resume_training_state(run, state, cfg)
    step = make_partseg_step(cfg, model)
    eval_step = make_partseg_eval(model)
    run.write(f"ft_partseg on {device}: ShapeNetPart {len(train_set)} trainval / "
              f"{len(test_set)} test clouds of {cfg.num_ft_points} points, {len(train_loader)} "
              f"batches of {cfg.batch_size}, {cfg.compute_dtype}, patch_compat "
              f"{cfg.patch_compat}, grad clip {cfg.grad_clip_norm}")

    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    best = last_meta.get("best", {"mean_category_iou": 0.0})
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
        if results["mean_category_iou"] > best["mean_category_iou"]:
            best, best_epoch = results, epoch
            save_checkpoint(run.model_path("model_best"), model,
                            {"epoch": epoch, **results, "kind": "ft_partseg",
                             "patch_compat": cfg.patch_compat})
        run.write(f"epoch {epoch}/{cfg.epochs}: loss {loss_m.avg:.4f} train acc {acc_m.avg:.4f} | "
                  + " ".join(f"{k} {v:.4f}" for k, v in results.items())
                  + f" (best catIoU {best['mean_category_iou']:.4f}@{best_epoch}) lr {lr:.5f} "
                  f"{train_time:.1f}s")
        run.metrics(epoch, lr=lr, train_loss=loss_m.avg, train_acc=acc_m.avg,
                    train_time=train_time,
                    clouds_per_s=len(metrics) * cfg.batch_size / max(train_time, 1e-9),
                    **results)
        save_rolling(run, state, epoch, cfg,
                     {"best": best, "best_epoch": best_epoch, "kind": "ft_partseg"})
    run.write(f"final best mean-category IoU {best['mean_category_iou']:.4f} at epoch "
              f"{best_epoch}")
    return {"best": best, "best_epoch": best_epoch}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer part-segmentation finetune "
                                                 "(PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns, ft_dataset="ShapeNetPart", num_sa_layers=12, max_dpr=0.1,
                                 atten_drop=0.0, mlp_drop=0.0), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
