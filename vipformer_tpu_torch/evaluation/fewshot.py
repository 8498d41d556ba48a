"""K-way N-shot episodic evaluation (the port's own copy of
vipformer_tpu/evaluation/fewshot.py, the reference's eval_fewshot.py:
45-126): each episode samples `k_way` classes and `n_shot` support plus
`n_query` query rows of each from precomputed features, standardises on
the support set, fits the linear probe and scores the queries; the result
is the mean and std of the accuracies (in %) over `n_runs` episodes. The
episodes come from one `np.random.default_rng(seed)` stream drawn in JAX's
order, so both packages sample the same rows."""

from __future__ import annotations

import numpy as np
import torch

from vipformer_tpu_torch.evaluation.svm import fit_svm


def _episode_indices(rng: np.random.Generator, labels: np.ndarray, k_way: int, n_shot: int,
                     n_query: int):
    """-> (support rows, support labels 0..k_way-1, query rows, query
    labels) of one episode; only classes with n_shot + n_query rows can
    host one, and too few such classes raise."""
    classes = np.array([c for c in np.unique(labels) if (labels == c).sum() >= n_shot + n_query])
    if len(classes) < k_way:
        raise ValueError(f"only {len(classes)} classes have >= {n_shot + n_query} samples; "
                         f"cannot sample {k_way}-way episodes")
    chosen = rng.choice(classes, size=k_way, replace=False)
    sup_idx, qry_idx, sup_y, qry_y = [], [], [], []
    for new_label, c in enumerate(chosen):
        picked = rng.choice(np.flatnonzero(labels == c), size=n_shot + n_query, replace=False)
        sup_idx.extend(picked[:n_shot])
        qry_idx.extend(picked[n_shot:])
        sup_y.extend([new_label] * n_shot)
        qry_y.extend([new_label] * n_query)
    return np.array(sup_idx), np.array(sup_y), np.array(qry_idx), np.array(qry_y)


def fewshot_eval(feats, labels, k_way: int, n_shot: int, n_query: int, n_runs: int,
                 c: float = 1.0, seed: int = 0, backend: str = "torch"):
    """Episodes over features [N, D] (numpy, or a tensor on the device the
    probes fit on) -> (mean %, std %, per-episode accuracies %)."""
    x = torch.as_tensor(feats, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels).reshape(-1)
    accs = []
    for _ in range(n_runs):
        si, sy, qi, qy = _episode_indices(rng, labels, k_way, n_shot, n_query)
        rows = torch.as_tensor(si, device=x.device)
        svm = fit_svm(x[rows], sy, c=c, num_classes=k_way, standardize=True, backend=backend)
        accs.append(svm.score(x[torch.as_tensor(qi, device=x.device)], qy) * 100.0)
    return float(np.mean(accs)), float(np.std(accs)), accs
