"""Classification finetune entry point (counterpart of
vipformer_tpu/cli/ft_cls.py), on the card by default.

    python -m vipformer_tpu_torch.cli.ft_cls --synthetic_data true \\
        --arch E1CL8SL-H4D256-L128-MR2 --batch_size 330 --test_batch_size 330 \\
        --optim adamw --lr 0.001 --scheduler coswarm --step_size 100 \\
        --max_lr 0.001 --warm_epochs 5 --gamma 0.6 --num_ft_points 1024 \\
        --max_dpr 0.0 --atten_drop 0.1 --mlp_drop 0.5 \\
        [--resume true --pc_model_file <run>/models/pc_model_best.ckpt] [--device cpu]

The flags are the JAX package's (`vipformer_tpu_torch.config`), plus
`--device`; `--mp false` finetunes the Perceiver classifier (output-query
decoder). With `--resume true` the backbone (stem and encoder, as the JAX
CLI lists them: a Perceiver's encoder, its input adapter stays fresh)
comes from the pretrain checkpoint that `cli.pretrain` writes (`train/checkpoint.py:
restore_backbone` logs what it took and what stayed fresh). Each epoch runs
`make_cls_step` over the shuffled training split (the HDF5 split
under `--data_dir`, else the synthetic stand-in) at the epoch's
learning rate, evaluates the test split at `test_batch_size` (the last
batch padded, its padding masked out), writes one line to
`<run_dir>/<proj_name>/<exp_name>/metrics.jsonl` and saves
`models/model_best.ckpt` on a new best test accuracy, and every
`save_freq` epochs the rolling `model_last` (weights, the optimizer's
moments and the step count, with {"epoch", "test_acc", "best_acc",
"best_epoch", "kind"}). `--resume_training true` continues a killed run
from `model_last` at the epoch after its own, the best tracker restored
(`cli/common.py:resume_training_state`; no snapshot: a fresh start).
`--eval_only` loads `model_best` and reports its test accuracy.
`--dump_feats true` writes the trained backbone's test-split features to
`files/ft_test_feats_labels.npz` (`cli/common.py:dump_feats_artifact`).

Not ported yet (each raises or is logged): wandb and multi-card runs.
"""

from __future__ import annotations

import argparse
import time

import torch

from vipformer_tpu_torch.cli.common import (
    Run,
    dump_feats_artifact,
    extract_features,
    require_single_card,
    resume_training_state,
    save_rolling,
)
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import ModelNet40SVM, ScanObjectNNSVM
from vipformer_tpu_torch.data.pipeline import Loader, collate_cls, pad_batch
from vipformer_tpu_torch.models.factory import build_ft_cls
from vipformer_tpu_torch.train.checkpoint import (
    branch_state,
    load_checkpoint,
    restore_backbone,
    save_checkpoint,
)
from vipformer_tpu_torch.train.meters import AverageMeter
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import (
    create_state,
    make_cls_eval,
    make_cls_step,
    make_feats_fn,
)


def datasets(cfg: Config):
    ds = {"ModelNet40": ModelNet40SVM, "ScanObjectNN": ScanObjectNNSVM}[cfg.ft_dataset]
    return ds(cfg.data_dir, "train", cfg.num_ft_points), ds(cfg.data_dir, "test", cfg.num_ft_points)


def evaluate(eval_step, test_set, batch_size: int) -> float:
    """Test accuracy over the whole split; every batch has `batch_size`
    clouds (the last one padded, its padding not counted)."""
    correct = total = 0
    for batch in Loader(test_set, batch_size, collate_cls, shuffle=False):
        batch, mask = pad_batch(batch, batch_size)
        pred = eval_step(batch["points"]).cpu().numpy()
        correct += int((pred[mask] == batch["labels"][mask]).sum())
        total += int(mask.sum())
    return correct / max(total, 1)


def main(cfg: Config, device: str = "cuda") -> dict:
    require_single_card(cfg)
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    train_set, test_set = datasets(cfg)
    train_loader = Loader(train_set, cfg.batch_size, collate_cls, shuffle=True, seed=cfg.seed,
                          drop_last=True, num_workers=cfg.num_workers)
    model = build_ft_cls(cfg, device=device)
    if cfg.resume:
        path = (cfg.pc_model_file if "/" in cfg.pc_model_file
                else run.model_path(cfg.pc_model_file))
        restore_backbone(model, branch_state(load_checkpoint(path)), ("stem", "encoder"),
                         log=run.write)
    state = create_state(cfg, {"pc": model})
    start_epoch, last_meta = resume_training_state(run, state, cfg)
    step = make_cls_step(cfg, model)
    eval_step = make_cls_eval(model)
    run.write(f"ft_cls on {device}: {cfg.ft_dataset} {len(train_set)} train / "
              f"{len(test_set)} test clouds of {cfg.num_ft_points} points, {len(train_loader)} "
              f"batches of {cfg.batch_size}, {cfg.compute_dtype}")

    if cfg.eval_only:
        model.load_state_dict(branch_state(load_checkpoint(run.model_path("model_best"))))
        acc = evaluate(eval_step, test_set, cfg.test_batch_size)
        run.write(f"eval-only: test acc {acc:.4f}")
        return {"best_acc": acc, "best_epoch": -1}

    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    best_acc, best_epoch = last_meta.get("best_acc", 0.0), last_meta.get("best_epoch", -1)
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
        test_acc = evaluate(eval_step, test_set, cfg.test_batch_size)
        if test_acc > best_acc:
            best_acc, best_epoch = test_acc, epoch
            save_checkpoint(run.model_path("model_best"), model,
                            {"epoch": epoch, "test_acc": test_acc, "kind": "ft_cls"})
        run.write(f"epoch {epoch}/{cfg.epochs}: train loss {loss_m.avg:.4f} acc {acc_m.avg:.4f} "
                  f"| test acc {test_acc:.4f} (best {best_acc:.4f}@{best_epoch}) lr {lr:.5f} "
                  f"{train_time:.1f}s")
        run.metrics(epoch, lr=lr, train_loss=loss_m.avg, train_acc=acc_m.avg, test_acc=test_acc,
                    best_acc=best_acc, train_time=train_time,
                    clouds_per_s=len(metrics) * cfg.batch_size / train_time)
        save_rolling(run, state, epoch, cfg, {"test_acc": test_acc, "best_acc": best_acc,
                                              "best_epoch": best_epoch, "kind": "ft_cls"})
    run.write(f"final best test acc {best_acc:.4f} at epoch {best_epoch}")
    if cfg.dump_feats:
        feats, labels = extract_features(make_feats_fn(model), test_set, cfg.test_batch_size)
        dump_feats_artifact(run, "ft", feats, labels)
    return {"best_acc": best_acc, "best_epoch": best_epoch}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer classification finetune "
                                                 "(PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns, ft_dataset="ModelNet40"), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
