"""Contrastive pretraining entry point (counterpart of
vipformer_tpu/cli/pretrain.py), on the card by default.

    python -m vipformer_tpu_torch.cli.pretrain --synthetic_data true \\
        --arch E1CL8SL-H4D256-L128-MR2 --modality both --batch_size 48 \\
        --optim adamw --lr 0.001 --epochs 2 --num_pt_points 2048 \\
        --img_height 144 --img_width 144 --max_dpr 0.0 --atten_drop 0.1 \\
        --mlp_drop 0.5 [--device cpu]

The flags are the JAX package's (`vipformer_tpu_torch.config`), plus
`--device`; `--mp false` trains the generic Perceiver family (the point
branch over the per-point adapter, the image branch over the Fourier pixel
adapter, `--num_frequency_bands`). Each epoch runs `make_pretrain_step` over the shuffled
synthetic ShapeNetRender set, writes `<run_dir>/<proj_name>/<exp_name>/
metrics.jsonl` (one JSON line per epoch) beside a log file and the
resolved `config.json`, and saves `models/pc_model_best.ckpt` and
`models/img_model_best.ckpt` (train/checkpoint.py) on the lowest mean
epoch loss. Not ported yet, and said so in the log: the per-epoch SVM
probe that gates "best" in the JAX CLI (it needs evaluation/svm.py), the
real ShapeNet reader, `--resume`, `--device_augs`, wandb and multi-card
runs.
"""

from __future__ import annotations

import argparse
import time

import torch

from vipformer_tpu_torch.cli.common import Run
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import ShapeNetRender
from vipformer_tpu_torch.data.pipeline import Loader, collate_pretrain
from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
from vipformer_tpu_torch.train.checkpoint import save_checkpoint
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step


def main(cfg: Config, device: str = "cuda") -> dict:
    if not cfg.synthetic_data:
        raise NotImplementedError("only --synthetic_data true is ported: the real ShapeNet "
                                  "reader comes with a later slice (ROADMAP Queue 1)")
    if cfg.resume:
        raise NotImplementedError("--resume is not ported yet (ROADMAP Queue 1)")
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    train_set = ShapeNetRender(cfg.img_height, cfg.img_width, cfg.num_pt_points,
                               synthetic_size=cfg.synthetic_size)
    loader = Loader(train_set, cfg.batch_size, collate_pretrain, shuffle=True, seed=cfg.seed,
                    drop_last=True, num_workers=cfg.num_workers)
    models = {"pc": build_pc_model(cfg, device=device)}
    if cfg.modality != "imc-only":
        models["img"] = build_img_model(cfg, device=device)
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models.get("img"))
    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    run.write(f"pretrain on {device}: {len(train_set)} synthetic samples, {len(loader)} "
              f"batches of {cfg.batch_size}, modality {cfg.modality}, {cfg.compute_dtype}")
    run.write("the per-epoch SVM probe is skipped (evaluation/svm.py is not ported yet): "
              "the best checkpoint is the one of the lowest mean epoch loss")

    best_loss, best_epoch, epoch_loss = float("inf"), -1, None
    for epoch in range(cfg.epochs):
        lr = schedule.lr(epoch, epoch_loss)
        loader.set_epoch(epoch)
        sums = {k: torch.zeros((), device=device) for k in ("loss", "loss_imid", "loss_cmid")}
        t0 = time.perf_counter()
        n = 0
        for i, batch in enumerate(loader):
            state, metrics = step(state, batch, lr, generator)
            for k in sums:
                sums[k] += metrics[k]
            n += 1
            if i % cfg.print_freq == 0:
                run.write(f"epoch {epoch}/{cfg.epochs} batch {i}/{len(loader)} <{cfg.modality}> "
                          f"imid {float(metrics['loss_imid']):.4f} "
                          f"cmid {float(metrics['loss_cmid']):.4f} "
                          f"total {float(metrics['loss']):.4f}")
        means = {k: float(v) / max(n, 1) for k, v in sums.items()}  # waits for the card
        train_time = time.perf_counter() - t0
        epoch_loss = means["loss"]
        if epoch_loss < best_loss:
            best_loss, best_epoch = epoch_loss, epoch
            meta = {"epoch": epoch, "pretrain_loss": epoch_loss, "kind": "pretrain",
                    "gate": "lowest mean epoch loss (the SVM probe is not ported)",
                    "patch_compat": cfg.patch_compat}
            for name, m in models.items():
                save_checkpoint(run.model_path(f"{name}_model_best"), m, meta)
        run.write(f"epoch {epoch}: loss {epoch_loss:.4f} (best {best_loss:.4f}@{best_epoch}) "
                  f"lr {lr:.5f} train {train_time:.1f}s")
        run.metrics(epoch, lr=lr, pretrain_loss=epoch_loss, imid_loss=means["loss_imid"],
                    cmid_loss=means["loss_cmid"], train_time=train_time,
                    clouds_per_s=2 * n * cfg.batch_size / train_time)
    return {"best_loss": best_loss, "best_epoch": best_epoch}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer pretraining (PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
