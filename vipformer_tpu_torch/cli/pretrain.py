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
adapter, `--num_frequency_bands`). Each epoch runs `make_pretrain_step`
over the shuffled synthetic ShapeNetRender set, then the linear SVM probe
(JAX cli/pretrain.py:183-202): the point branch's eval features of the
`pt_dataset` probe's train and test splits (synthetic ModelNet40 or
ScanObjectNN, `num_test_points` points, batches of `test_batch_size`), an
SVM fitted on the train split (`fit_svm`, C = `svm_coff`) and scored on
the test split. On a new best test accuracy it saves
`models/pc_model_best.ckpt` and `models/img_model_best.ckpt`
(train/checkpoint.py) with {"epoch", "svm_test_acc", "kind"}. Each epoch
writes one JSON line to `<run_dir>/<proj_name>/<exp_name>/metrics.jsonl`
(losses, svm_test_acc, svm_best_acc, times) beside a log file and the
resolved `config.json`. Not ported yet: the real ShapeNet reader,
`--resume`, `--device_augs`, wandb and multi-card runs.
"""

from __future__ import annotations

import argparse
import time

import torch

from vipformer_tpu_torch.cli.common import Run, extract_features
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import ModelNet40SVM, ScanObjectNNSVM, ShapeNetRender
from vipformer_tpu_torch.data.pipeline import Loader, collate_pretrain
from vipformer_tpu_torch.evaluation.svm import fit_svm
from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
from vipformer_tpu_torch.train.checkpoint import save_checkpoint
from vipformer_tpu_torch.train.schedules import Schedule
from vipformer_tpu_torch.train.trainer import create_state, make_feats_fn, make_pretrain_step


def probe_sets(cfg: Config):
    """The SVM probe's (train, test) splits of `pt_dataset` (JAX
    cli/pretrain.py:49-55)."""
    ds_cls = {"ModelNet40": ModelNet40SVM, "ScanObjectNN": ScanObjectNNSVM}[cfg.pt_dataset]
    return ds_cls("train", cfg.num_test_points), ds_cls("test", cfg.num_test_points)


def main(cfg: Config, device: str = "cuda") -> dict:
    if not cfg.synthetic_data:
        raise NotImplementedError("only --synthetic_data true is ported: the real ShapeNet "
                                  "reader comes with a later slice (ROADMAP Queue 1)")
    if cfg.resume:
        raise NotImplementedError("--resume is not ported yet (ROADMAP Queue 1)")
    if cfg.num_devices > 1:
        # JAX trains per-device NT-Xent groups (neg_groups = the data axis
        # size); one card with neg_groups=1 would train another loss
        raise NotImplementedError("multi-card runs are not ported yet (ROADMAP Queue 1, "
                                  "item 16): the port runs on one card")
    run = Run(cfg)
    if cfg.wandb:
        run.write("wandb is not ported: metrics.jsonl is the only metrics channel")
    train_set = ShapeNetRender(cfg.img_height, cfg.img_width, cfg.num_pt_points,
                               synthetic_size=cfg.synthetic_size)
    loader = Loader(train_set, cfg.batch_size, collate_pretrain, shuffle=True, seed=cfg.seed,
                    drop_last=True, num_workers=cfg.num_workers)
    probe_train, probe_test = probe_sets(cfg)
    models = {"pc": build_pc_model(cfg, device=device)}
    if cfg.modality != "imc-only":
        models["img"] = build_img_model(cfg, device=device)
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models.get("img"))
    feats_fn = make_feats_fn(models["pc"])
    schedule = Schedule(cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    run.write(f"pretrain on {device}: {len(train_set)} synthetic samples, {len(loader)} "
              f"batches of {cfg.batch_size}, modality {cfg.modality}, {cfg.compute_dtype}; "
              f"probe: {cfg.pt_dataset} (synthetic) {len(probe_train)}/{len(probe_test)}")

    best_acc, best_epoch, epoch_loss = 0.0, -1, None
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

        # the linear SVM probe: the gate of the best checkpoint
        t0 = time.perf_counter()
        tr_feats, tr_labels = extract_features(feats_fn, probe_train, cfg.test_batch_size)
        te_feats, te_labels = extract_features(feats_fn, probe_test, cfg.test_batch_size)
        test_acc = fit_svm(tr_feats, tr_labels, c=cfg.svm_coff).score(te_feats, te_labels)
        test_time = time.perf_counter() - t0
        if test_acc > best_acc:
            best_acc, best_epoch = test_acc, epoch
            run.write(f"new best probe acc {best_acc:.4f} at epoch {epoch}; saving")
            meta = {"epoch": epoch, "svm_test_acc": test_acc, "kind": "pretrain",
                    "patch_compat": cfg.patch_compat}
            for name, m in models.items():
                save_checkpoint(run.model_path(f"{name}_model_best"), m, meta)
        run.write(f"epoch {epoch}: loss {epoch_loss:.4f} probe acc {test_acc:.4f} (best "
                  f"{best_acc:.4f}@{best_epoch}) lr {lr:.5f} train {train_time:.1f}s probe "
                  f"{test_time:.1f}s")
        run.metrics(epoch, lr=lr, pretrain_loss=epoch_loss, imid_loss=means["loss_imid"],
                    cmid_loss=means["loss_cmid"], svm_test_acc=test_acc, svm_best_acc=best_acc,
                    train_time=train_time, test_time=test_time,
                    clouds_per_s=2 * n * cfg.batch_size / train_time)
    run.write(f"final best probe acc {best_acc:.4f} at epoch {best_epoch}")
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
