"""Few-shot episodic evaluation entry point (counterpart of
vipformer_tpu/cli/eval_fewshot.py; the reference's eval_fewshot.py), on
the card by default.

    python -m vipformer_tpu_torch.cli.eval_fewshot --synthetic_data true \\
        --arch E1CL8SL-H4D256-L128-MR2 --ft_dataset ScanObjectNN \\
        --n_runs 10 --k_way 5 --n_shot 10 --n_query 20 --test_batch_size 160 \\
        --pc_model_file <run>/models/pc_model_best.ckpt [--device cpu]

Restores the point model (`--fewshot_model pretrain`, the pretrain CLI's
`pc_model_best`) or the finetuned classifier (`ft`, ft_cls's
`model_best`) from `--pc_model_file` (`cli/common.py:restore_eval_model`;
a missing file leaves the random init with a WARNING), extracts the
backbone features of the whole `ft_dataset` train split (ModelNet40 or
ScanObjectNN: the HDF5 split under `--data_dir`, else the synthetic
stand-in) once, batch by batch at
`test_batch_size`, then runs `n_runs` K-way N-shot episodes, each a
linear probe on standardised support features scored on its queries
(`evaluation/fewshot.py`), and logs "acc: <mean> +/- <std> over <n_runs>
runs". The synthetic ModelNet40 train split has about 20 clouds a class,
so an episode that needs 30 raises, as in JAX. `--num_devices N` splits
each feature batch over N ranks (`parallel/`) and gathers the features;
the chief runs the episodes and writes the log.
"""

from __future__ import annotations

import argparse

from vipformer_tpu_torch.cli.common import Run, check_batches, extract_features, restore_eval_model
from vipformer_tpu_torch.config import Config, add_config_args, config_from_namespace
from vipformer_tpu_torch.data.datasets import ModelNet40SVM, ScanObjectNNSVM
from vipformer_tpu_torch.evaluation.fewshot import fewshot_eval
from vipformer_tpu_torch.models.factory import build_ft_cls, build_pc_model
from vipformer_tpu_torch.parallel import is_chief, run_ranks, shard_model
from vipformer_tpu_torch.train.trainer import make_feats_fn

DATASETS = {"ModelNet40": ModelNet40SVM, "ScanObjectNN": ScanObjectNNSVM}


def main(cfg: Config, device: str = "cuda") -> dict:
    """The evaluation on every rank of `--num_devices` (parallel.run_ranks);
    returns the chief's results."""
    return run_ranks(evaluate, cfg, device)


def evaluate(cfg: Config, device: str) -> dict | None:
    check_batches(cfg, ("test_batch_size",))
    run = Run(cfg)
    run.write(f"fewshot eval on {cfg.ft_dataset}: n_runs={cfg.n_runs} k_way={cfg.k_way} "
              f"n_shot={cfg.n_shot} n_query={cfg.n_query}")
    pool = DATASETS[cfg.ft_dataset](cfg.data_dir, "train", cfg.num_test_points)
    if cfg.fewshot_model == "ft":
        model = build_ft_cls(cfg, device=device)  # the finetuned model's backbone features
    else:
        model = build_pc_model(cfg, device=device)
    restore_eval_model(model, cfg, run)
    shard_model(model, run.write)
    feats, labels = extract_features(make_feats_fn(model), pool, cfg.test_batch_size)
    if not is_chief():
        return None
    mean, std, accs = fewshot_eval(feats, labels, cfg.k_way, cfg.n_shot, cfg.n_query,
                                   cfg.n_runs, c=cfg.svm_coff, seed=cfg.seed)
    run.write(f"acc: {mean:.2f} +/- {std:.2f} over {cfg.n_runs} runs")
    return {"mean": mean, "std": std, "accs": accs}


def parse_args(argv=None) -> tuple[Config, str]:
    parser = argparse.ArgumentParser(description="ViPFormer few-shot evaluation "
                                                 "(PyTorch + CUDA)")
    add_config_args(parser)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = parser.parse_args(argv)
    return config_from_namespace(ns), ns.device


if __name__ == "__main__":
    cfg, device = parse_args()
    main(cfg, device)
