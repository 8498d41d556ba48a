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
adapter, `--num_frequency_bands`). The sets come from `--data_dir` where
their files are (ShapeNet PLY clouds and PNG renderings; the probe's HDF5
splits), else from the synthetic stand-ins. Each epoch runs
`make_pretrain_step` over the shuffled ShapeNetRender set through
`prefetch_to_device` (batches assembled ahead, copied from pinned buffers
on a side stream); with `--device_augs true` the loader ships the raw
clouds and uint8 images and the step augments them on the card
(`data/augment_device.py`). Then the linear SVM probe (JAX
cli/pretrain.py:183-202): the point branch's eval features of the
`pt_dataset` probe's train and test splits (ModelNet40 or ScanObjectNN,
`num_test_points` points, batches of `test_batch_size`), an SVM fitted on
the train split (`fit_svm`, C = `svm_coff`) and scored on the test
split. On a new best test accuracy it saves
`models/pc_model_best.ckpt` (every branch, the optimizer's moments and
the step count: train/checkpoint.py `save_state`) and
`models/img_model_best.ckpt` (the image branch alone) with {"epoch",
"svm_test_acc", "kind", "patch_compat"}; every `save_freq` epochs it saves
`pc_model_epoch{N}` and the rolling `pc_model_last` the same way, with
{"epoch", "svm_test_acc", "best_acc", "best_epoch", "kind"}. `--resume
true` continues a killed run (JAX cli/pretrain.py:102-141): from
`pc_model_last` where `--pc_model_file` is `pc_model_best` and it exists,
else from the named snapshot under the run's models/, at the epoch after
its own, with the best-probe tracker restored (from `pc_model_best`'s
metadata where an older snapshot lacks it); no snapshot means a fresh
start. `--dump_feats true` writes the last probe epoch's test features
to `files/pt_test_feats_labels.npz` (`cli/common.py:dump_feats_artifact`).
Each epoch writes one JSON line to
`<run_dir>/<proj_name>/<exp_name>/metrics.jsonl` (losses, svm_test_acc,
svm_best_acc, times) beside a log file and the resolved `config.json`.
`--num_devices N` (0: every visible card) trains data-parallel over N
ranks (`parallel/`: spawned here, or joined from torchrun's environment):
each takes its contiguous slice of the global `--batch_size`, its own
NT-Xent group (JAX's per-device groups; one over the global batch with
`--global_negatives`), sync-BN, and the ranks' gradients averaged; the
probe's features are split over the ranks and gathered, the SVM fitted on
the chief and its accuracy broadcast; the chief writes the files.
Not ported yet: wandb.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from vipformer_tpu_torch.cli.common import (
    Run,
    check_batches,
    dump_feats_artifact,
    extract_features,
    layout,
)
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import ModelNet40SVM, ScanObjectNNSVM, ShapeNetRender
from vipformer_tpu_torch.data.pipeline import (
    Loader,
    collate_pretrain,
    collate_pretrain_raw,
    prefetch_to_device,
)
from vipformer_tpu_torch.evaluation.svm import fit_svm
from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
from vipformer_tpu_torch.parallel import (
    broadcast_object,
    data_axis_size,
    data_index,
    is_chief,
    model_axis_size,
    place_state,
    rank_seed,
    run_ranks,
    shard_model,
    world_size,
)
from vipformer_tpu_torch.train.checkpoint import (
    load_metadata,
    restore_state,
    save_checkpoint,
    save_state,
)
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import create_state, make_feats_fn, make_pretrain_step


def probe_sets(cfg: Config):
    """The SVM probe's (train, test) splits of `pt_dataset` (JAX
    cli/pretrain.py:49-55)."""
    ds_cls = {"ModelNet40": ModelNet40SVM, "ScanObjectNN": ScanObjectNNSVM}[cfg.pt_dataset]
    return (ds_cls(cfg.data_dir, "train", cfg.num_test_points),
            ds_cls(cfg.data_dir, "test", cfg.num_test_points))


def train_loader(cfg: Config) -> Loader:
    """The shuffled ShapeNetRender batches of the pretrain loop (JAX
    cli/pretrain.py:62-72): raw clouds and uint8 images with
    `device_augs`, host-augmented views otherwise; each rank's slice of
    every global batch."""
    train_set = ShapeNetRender(cfg.data_dir, cfg.img_height, cfg.img_width, cfg.num_pt_points,
                               synthetic_size=cfg.synthetic_size, raw_views=cfg.device_augs)
    return Loader(train_set, cfg.batch_size,
                  collate_pretrain_raw if cfg.device_augs else collate_pretrain, shuffle=True,
                  seed=cfg.seed, drop_last=True, num_workers=cfg.num_workers, rank=data_index(),
                  world=data_axis_size())


def run_epoch(step, state, loader: Loader, lr: float, generator, device, log=None,
              print_freq: int = 0) -> tuple[dict, int]:
    """One epoch of the pretrain loop: every batch of `loader`, through
    `prefetch_to_device`, one step each. Returns (the metrics' sums, on the
    device; the number of steps). `log(i, metrics)` runs every
    `print_freq` steps."""
    sums = {k: torch.zeros((), device=device) for k in ("loss", "loss_imid", "loss_cmid")}
    n = 0
    for i, batch in enumerate(prefetch_to_device(iter(loader), device)):
        state, metrics = step(state, batch, lr, generator)
        for k in sums:
            sums[k] += metrics[k]
        n += 1
        if log is not None and print_freq and i % print_freq == 0:
            log(i, metrics)
    return sums, n


def resume(run: Run, state, cfg: Config) -> tuple[int, float, int]:
    """`--resume` (JAX cli/pretrain.py:102-141): the snapshot to continue
    from is `pc_model_last` where `pc_model_file` is `pc_model_best` and
    the rolling one exists, else the named one; it is put back into
    `state`. Returns (start epoch, best probe accuracy, its epoch): the
    tracker from the snapshot's metadata, or, for an older snapshot
    without it, from `pc_model_best`'s; (0, 0.0, -1) without a snapshot."""
    path = run.model_path(cfg.pc_model_file)
    last = run.model_path("pc_model_last")
    if cfg.pc_model_file == "pc_model_best" and os.path.exists(last):
        path = last
    if not os.path.exists(path):
        run.write(f"resume requested but {path} missing: fresh start")
        return 0, 0.0, -1
    meta = restore_state(path, state)
    start = meta.get("epoch", -1) + 1
    best_acc, best_epoch = float(meta.get("best_acc", 0.0)), int(meta.get("best_epoch", -1))
    best_path = run.model_path("pc_model_best")
    if best_epoch < 0 and os.path.exists(best_path):
        best = load_metadata(best_path)
        best_acc, best_epoch = float(best.get("svm_test_acc", 0.0)), int(best.get("epoch", -1))
    run.write(f"resumed from {path} at epoch {start} (best probe {best_acc:.4f}@{best_epoch})")
    return start, best_acc, best_epoch


def main(cfg: Config, device: str = "cuda") -> dict:
    """The pretrain loop on every rank of `--num_devices` (parallel.run_ranks);
    returns the chief's {"best_acc", "best_epoch"}."""
    return run_ranks(train, cfg, device)


def train(cfg: Config, device: str) -> dict:
    check_batches(cfg)
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    loader = train_loader(cfg)
    train_set = loader.dataset
    probe_train, probe_test = probe_sets(cfg)
    models = {"pc": build_pc_model(cfg, device=device)}
    if cfg.modality != "imc-only":
        models["img"] = build_img_model(cfg, device=device)
    for m in models.values():
        shard_model(m, run.write)
    state = create_state(cfg, models)
    world = data_axis_size()
    step = make_pretrain_step(cfg, models["pc"], models.get("img"), neg_groups=world)
    feats_fn = make_feats_fn(models["pc"])
    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(rank_seed(cfg.seed))
    kind = "synthetic" if train_set.synthetic else "real"
    run.write(f"pretrain on {device} x {world_size()}: {len(train_set)} {kind} samples, "
              f"{len(loader)} batches of {cfg.batch_size}, modality {cfg.modality}, "
              f"{cfg.compute_dtype}, {'device' if cfg.device_augs else 'host'} augmentation; "
              f"probe: {cfg.pt_dataset} {len(probe_train)}/{len(probe_test)}; {layout()}")

    start_epoch, best_acc, best_epoch = resume(run, state, cfg) if cfg.resume else (0, 0.0, -1)
    place_state(state)
    epoch_loss = None  # the plateau schedule's metric: none before an epoch of this run
    for epoch in range(start_epoch, cfg.epochs):
        lr = schedule.lr(epoch, epoch_loss)
        loader.set_epoch(epoch)
        t0 = time.perf_counter()

        def log(i, metrics, epoch=epoch):
            run.write(f"epoch {epoch}/{cfg.epochs} batch {i}/{len(loader)} <{cfg.modality}> "
                      f"imid {float(metrics['loss_imid']):.4f} "
                      f"cmid {float(metrics['loss_cmid']):.4f} "
                      f"total {float(metrics['loss']):.4f}")

        sums, n = run_epoch(step, state, loader, lr, generator, device, log, cfg.print_freq)
        means = {k: float(v) / max(n, 1) for k, v in sums.items()}  # waits for the card
        train_time = time.perf_counter() - t0
        epoch_loss = means["loss"]

        # the linear SVM probe: the gate of the best checkpoint
        t0 = time.perf_counter()
        tr_feats, tr_labels = extract_features(feats_fn, probe_train, cfg.test_batch_size)
        te_feats, te_labels = extract_features(feats_fn, probe_test, cfg.test_batch_size)
        test_acc = None
        if is_chief():
            test_acc = fit_svm(tr_feats, tr_labels, c=cfg.svm_coff).score(te_feats, te_labels)
        test_acc = broadcast_object(test_acc)
        test_time = time.perf_counter() - t0
        if test_acc > best_acc:
            best_acc, best_epoch = test_acc, epoch
            run.write(f"new best probe acc {best_acc:.4f} at epoch {epoch}; saving")
            meta = {"epoch": epoch, "svm_test_acc": test_acc, "kind": "pretrain",
                    "patch_compat": cfg.patch_compat}
            save_state(run.model_path("pc_model_best"), state, meta)
            if "img" in models:
                save_checkpoint(run.model_path("img_model_best"), models["img"], meta)
        if cfg.save_freq and (epoch + 1) % cfg.save_freq == 0:
            # the rolling snapshot --resume continues from (atomic writes)
            meta = {"epoch": epoch, "svm_test_acc": test_acc, "best_acc": best_acc,
                    "best_epoch": best_epoch, "kind": "pretrain"}
            save_state(run.model_path(f"pc_model_epoch{epoch}"), state, meta)
            save_state(run.model_path("pc_model_last"), state, meta)
        run.write(f"epoch {epoch}: loss {epoch_loss:.4f} probe acc {test_acc:.4f} (best "
                  f"{best_acc:.4f}@{best_epoch}) lr {lr:.5f} train {train_time:.1f}s probe "
                  f"{test_time:.1f}s")
        run.metrics(epoch, lr=lr, pretrain_loss=epoch_loss, imid_loss=means["loss_imid"],
                    cmid_loss=means["loss_cmid"], svm_test_acc=test_acc, svm_best_acc=best_acc,
                    train_time=train_time, test_time=test_time,
                    clouds_per_s=2 * n * cfg.batch_size / train_time, ranks=world_size(),
                    model_axis=model_axis_size())
    run.write(f"final best probe acc {best_acc:.4f} at epoch {best_epoch}")
    if cfg.dump_feats and cfg.epochs > start_epoch:
        # the last probe epoch's test-split features
        dump_feats_artifact(run, "pt", te_feats, te_labels)
    return {"best_acc": best_acc, "best_epoch": best_epoch}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer pretraining (PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
