"""Linear-probe and model-complexity evaluation entry point (counterpart of
vipformer_tpu/cli/eval_zeroshot.py; the reference's eval_zeroshot.py), on
the card by default.

    python -m vipformer_tpu_torch.cli.eval_zeroshot --synthetic_data true \\
        --arch E1CL8SL-H4D256-L128-MR2 --pt_dataset ModelNet40 --test_batch_size 160 \\
        --pc_model_file <run>/models/pc_model_best.ckpt [--device cpu]

Restores the point model from `--pc_model_file` (the pretrain CLI's
`pc_model_best`; a missing file leaves the random init with a WARNING),
logs its complexity (parameters, and the FLOPs of one forward at
`test_batch_size` clouds of `num_test_points`: `evaluation/flops.py`,
which counts the matmul family where the JAX CLI reports XLA's cost
model), extracts the backbone features of the `pt_dataset` train and test
splits (the HDF5 splits under `--data_dir`, else the synthetic
stand-ins), then fits the reference protocol's three
probes on the train features and scores them on the test features: the
linear SVM (C = `svm_coff`), the RBF SVM and the {linear, rbf} x C grid
search with 3-fold cross-validation (`evaluation/svm.py`), each logged
with its seconds. Returns linear_acc, rbf_acc, grid_acc, grid_best,
params and flops_per_batch. `--num_devices N` splits each feature batch
over N ranks (`parallel/`) and gathers the features; the chief fits the
probes and writes the log.
"""

from __future__ import annotations

import argparse
import time

import torch

from vipformer_tpu_torch.cli.common import Run, check_batches, extract_features, restore_eval_model
from vipformer_tpu_torch.cli.eval_fewshot import DATASETS
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.evaluation.flops import complexity_report
from vipformer_tpu_torch.evaluation.svm import fit_rbf_svm, fit_svm, grid_search_svm
from vipformer_tpu_torch.models.factory import build_pc_model
from vipformer_tpu_torch.parallel import is_chief, run_ranks, shard_model
from vipformer_tpu_torch.train.trainer import make_feats_fn


def main(cfg: Config, device: str = "cuda") -> dict:
    """The evaluation on every rank of `--num_devices` (parallel.run_ranks);
    returns the chief's results."""
    return run_ranks(evaluate, cfg, device)


def evaluate(cfg: Config, device: str) -> dict | None:
    check_batches(cfg, ("test_batch_size",))
    run = Run(cfg)
    ds = DATASETS[cfg.pt_dataset]
    train_set = ds(cfg.data_dir, "train", cfg.num_test_points)
    test_set = ds(cfg.data_dir, "test", cfg.num_test_points)
    model = build_pc_model(cfg, device=device)
    restore_eval_model(model, cfg, run)

    # complexity (the reference records params + fvcore FLOPs per test batch)
    report = complexity_report(model, torch.zeros((cfg.test_batch_size, cfg.num_test_points, 3)))
    run.write(f"total parameters: {report['params']:,}; FLOPs per {cfg.test_batch_size}-batch: "
              f"{report['flops_per_batch']:,.0f}")
    shard_model(model, run.write)  # after the counts, which are the whole model's

    feats_fn = make_feats_fn(model)
    tr_feats, tr_labels = extract_features(feats_fn, train_set, cfg.test_batch_size)
    te_feats, te_labels = extract_features(feats_fn, test_set, cfg.test_batch_size)
    if not is_chief():
        return None

    t0 = time.time()
    linear_acc = fit_svm(tr_feats, tr_labels, c=cfg.svm_coff).score(te_feats, te_labels)
    run.write(f"linear SVM acc: {linear_acc:.4f} ({time.time() - t0:.1f}s)")
    out = {"linear_acc": linear_acc, **report}

    t0 = time.time()
    out["rbf_acc"] = fit_rbf_svm(tr_feats, tr_labels, c=cfg.svm_coff).score(te_feats, te_labels)
    run.write(f"rbf SVM acc: {out['rbf_acc']:.4f} ({time.time() - t0:.1f}s)")
    t0 = time.time()
    grid_model, best, best_val = grid_search_svm(tr_feats, tr_labels)
    out["grid_acc"] = grid_model.score(te_feats, te_labels)
    out["grid_best"] = best
    run.write(f"grid-search best {best} (val {best_val:.4f}) acc {out['grid_acc']:.4f} "
              f"({time.time() - t0:.1f}s)")
    return out


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer linear-probe and complexity "
                                                 "evaluation (PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
