"""SVM probes (the port's own copy of vipformer_tpu/evaluation/svm.py),
fitted on the features' device: the linear probe, the RBF-kernel probe
and the small grid search over both.

The reference's per-epoch probe is sklearn's `SVC(C, kernel='linear')`
(pretrain.py:252). The JAX package replaces it by a one-vs-rest
L2-regularised squared-hinge linear classifier, min 0.5 |w|^2 + C sum
max(0, 1 - y f)^2 over all K binary problems at once (w is [D, K]), fitted
full-batch by Adam for 300 steps with the learning rate cosine-decayed
from 0.05 to 0; this module is that fit in PyTorch, with the gradient and
Adam written out (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected moments). `fit_svm(..., backend="sklearn")`
hands the fit to sklearn where it is installed, imported only then.

`fit_rbf_svm` is JAX's kernel-primal RBF probe (svm.py:143-260): the
kernel matrix exp(-gamma |a - b|^2) over the training rows (gamma
sklearn's "scale", `scale_gamma`), then min 0.5 alpha^T K alpha + C sum
max(0, 1 - t (K alpha + b))^2 over all classes at once by 500 full-batch
Adam steps, the learning rate cosine-decayed from 0.02. `grid_search_svm`
is its GridSearchCV (svm.py:263-326): stratified 3-fold accuracy over
{linear, rbf} x C, refit on all rows with the best. The kernel matrix and
the Adam loop are plain torch products on the fit's device, as JAX leaves
them to XLA; no kernel of the port is involved.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LR0 = 0.05  # optax.cosine_decay_schedule(0.05, steps) of JAX svm.py:91
STEPS = 300  # full-batch Adam steps (JAX svm.py:62)
RBF_LR0 = 0.02  # the RBF fit's schedule (JAX svm.py:181)
RBF_STEPS = 500  # and its steps (JAX svm.py:240)
RBF_CHUNK = 4096  # test rows per kernel block when scoring (JAX svm.py:208)


@dataclass
class LinearSVM:
    """The fitted probe: w [D, K], b [K] (f32 tensors on the fit's device),
    and the standardisation it applies to features first (or None)."""

    w: torch.Tensor | None
    b: torch.Tensor | None
    mean: torch.Tensor | None = None
    scale: torch.Tensor | None = None
    _sk: object = None  # sklearn SVC when backend="sklearn"

    def _standardize(self, feats) -> torch.Tensor:
        dev = self.w.device if self.w is not None else torch.device("cpu")
        x = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        if self.mean is not None:
            x = (x - self.mean.to(dev)) / self.scale.to(dev)
        return x

    def decision(self, feats):
        """Scores [N, K]: a tensor on the probe's device (sklearn: numpy)."""
        if self._sk is not None:
            return self._sk.decision_function(self._standardize(feats).cpu().numpy())
        return self._standardize(feats) @ self.w + self.b

    def predict(self, feats) -> np.ndarray:
        if self._sk is not None:
            return self._sk.predict(self._standardize(feats).cpu().numpy())
        return self.decision(feats).argmax(-1).cpu().numpy()

    def score(self, feats, labels) -> float:
        return float(np.mean(self.predict(feats) == np.asarray(labels).reshape(-1)))


def cosine_lr(i: int, steps: int, lr0: float = LR0) -> float:
    """optax.cosine_decay_schedule(lr0, steps) at step i."""
    return lr0 * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))


def _targets(y: torch.Tensor, num_classes: int, like: torch.Tensor) -> torch.Tensor:
    """+1 at each row's class, -1 elsewhere: [N, K] f32."""
    one_hot = torch.nn.functional.one_hot(y.long(), num_classes) > 0
    return torch.where(one_hot, 1.0, -1.0).to(like)


def _adam(params, grads_of, steps: int, lr0: float) -> None:
    """Full-batch Adam from the given params, in place (optax.adam over
    optax.cosine_decay_schedule(lr0, steps)); grads_of(params) -> grads."""
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    for i in range(steps):
        grads = grads_of(params)
        lr = cosine_lr(i, steps, lr0)
        bc1, bc2 = 1.0 - ADAM_B1 ** (i + 1), 1.0 - ADAM_B2 ** (i + 1)
        for p, g, (m, v) in zip(params, grads, moments):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))


def _train_ovr(x: torch.Tensor, y: torch.Tensor, num_classes: int, c: float,
               steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-vs-rest squared hinge, all K problems at once, full-batch Adam
    from zero: x f32 [N, D], y int [N] -> (w [D, K], b [K])."""
    targets = _targets(y, num_classes, x)
    params = [torch.zeros((x.shape[1], num_classes), dtype=torch.float32, device=x.device),
              torch.zeros((num_classes,), dtype=torch.float32, device=x.device)]

    def grads_of(params):
        w, b = params
        margin = torch.clamp_min(1.0 - targets * (x @ w + b), 0.0)
        df = (-2.0 * c) * targets * margin  # d loss / d f
        return w + x.t() @ df, df.sum(0)

    _adam(params, grads_of, steps, LR0)
    return params[0], params[1]


def fit_svm(feats, labels, c: float = 1.0, num_classes: int | None = None,
            standardize: bool = False, backend: str = "torch", steps: int = STEPS) -> LinearSVM:
    """Fit the probe on feats [N, D] (numpy, or a tensor on the device to
    fit on) and labels [N] over classes 0..num_classes-1 (default
    0..max(labels)); `standardize` divides each feature by its population
    std after centering (+1e-8), as JAX svm.py:105-138."""
    x = torch.as_tensor(feats, dtype=torch.float32)
    labels = np.asarray(labels).reshape(-1)
    num_classes = num_classes or int(labels.max()) + 1
    mean = scale = None
    if standardize:
        mean = x.mean(0)
        scale = x.std(0, correction=0) + 1e-8
        x = (x - mean) / scale
    if backend == "sklearn":
        from sklearn.svm import SVC

        sk = SVC(C=c, kernel="linear")
        sk.fit(x.cpu().numpy(), labels)
        return LinearSVM(w=None, b=None, mean=mean, scale=scale, _sk=sk)
    if backend != "torch":
        raise ValueError(f"unknown SVM backend {backend!r}")
    w, b = _train_ovr(x, torch.as_tensor(labels, device=x.device), num_classes, c, steps)
    return LinearSVM(w=w, b=b, mean=mean, scale=scale)


# ------------------------------------------------------------------ RBF
def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [N, M] by the matmul identity, clamped at
    0 (JAX svm.py:143-148)."""
    aa = (a * a).sum(1, keepdim=True)
    bb = (b * b).sum(1, keepdim=True).t()
    return torch.clamp_min(aa + bb - 2.0 * (a @ b.t()), 0.0)


def _rbf_matrix(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    return torch.exp(-gamma * _sq_dists(a, b))


def _train_ovr_rbf(kmat: torch.Tensor, y: torch.Tensor, num_classes: int, c: float,
                   steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel primal, one-vs-rest squared hinge, all classes at once:
    min 0.5 alpha^T K alpha + C sum max(0, 1 - t (K alpha + b))^2 by
    full-batch Adam from zero (JAX svm.py:156-191). K [N, N] symmetric, so
    the regulariser's gradient is K alpha. -> (alpha [N, K], b [K])."""
    targets = _targets(y, num_classes, kmat)
    params = [torch.zeros((kmat.shape[0], num_classes), dtype=torch.float32,
                          device=kmat.device),
              torch.zeros((num_classes,), dtype=torch.float32, device=kmat.device)]

    def grads_of(params):
        alpha, b = params
        ka = kmat @ alpha
        margin = torch.clamp_min(1.0 - targets * (ka + b), 0.0)
        df = (-2.0 * c) * targets * margin  # d loss / d f
        return ka + kmat @ df, df.sum(0)

    _adam(params, grads_of, steps, RBF_LR0)
    return params[0], params[1]


@dataclass
class RBFSVM:
    """The fitted RBF probe: the training rows x_train [N, D], alpha [N, K]
    and b [K] (f32 tensors on the fit's device) and gamma."""

    x_train: torch.Tensor
    alpha: torch.Tensor | None
    b: torch.Tensor | None
    gamma: float
    _sk: object = None  # sklearn SVC when backend="sklearn"

    def decision(self, feats):
        """Scores [N, K]: a tensor on the probe's device (sklearn: numpy),
        the kernel rows taken RBF_CHUNK test rows at a time."""
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.x_train.device)
        if self._sk is not None:
            return self._sk.decision_function(x.cpu().numpy())
        out = [_rbf_matrix(x[i:i + RBF_CHUNK], self.x_train, self.gamma) @ self.alpha
               for i in range(0, x.shape[0], RBF_CHUNK)]
        return torch.cat(out) + self.b

    def predict(self, feats) -> np.ndarray:
        if self._sk is not None:
            return self._sk.predict(np.asarray(torch.as_tensor(feats, dtype=torch.float32).cpu()))
        return self.decision(feats).argmax(-1).cpu().numpy()

    def score(self, feats, labels) -> float:
        return float(np.mean(self.predict(feats) == np.asarray(labels).reshape(-1)))


def scale_gamma(feats) -> float:
    """sklearn's gamma="scale": 1 / (n_features * X.var()), as JAX
    svm.py:225-228 computes it (numpy's f32 variance, + 1e-12)."""
    feats = np.asarray(torch.as_tensor(feats, dtype=torch.float32).cpu())
    return float(1.0 / (feats.shape[1] * feats.var() + 1e-12))


def fit_rbf_svm(feats, labels, c: float = 1.0, gamma: float | None = None,
                num_classes: int | None = None, backend: str = "torch",
                steps: int = RBF_STEPS) -> RBFSVM:
    """Fit the RBF probe on feats [N, D] (numpy, or a tensor on the device
    to fit on) and labels [N] (JAX svm.py:231-260)."""
    x = torch.as_tensor(feats, dtype=torch.float32)
    labels = np.asarray(labels).reshape(-1)
    num_classes = num_classes or int(labels.max()) + 1
    gamma = scale_gamma(x) if gamma is None else gamma
    if backend == "sklearn":
        from sklearn.svm import SVC

        sk = SVC(C=c, kernel="rbf", gamma=gamma).fit(x.cpu().numpy(), labels)
        return RBFSVM(x_train=x, alpha=None, b=None, gamma=gamma, _sk=sk)
    if backend != "torch":
        raise ValueError(f"unknown SVM backend {backend!r}")
    kmat = _rbf_matrix(x, x, gamma)
    alpha, b = _train_ovr_rbf(kmat, torch.as_tensor(labels, device=x.device), num_classes, c,
                              steps)
    return RBFSVM(x_train=x, alpha=alpha, b=b, gamma=gamma)


def _stratified_folds(labels, cv: int, seed: int = 0) -> list[np.ndarray]:
    """Stratified k-fold index lists (JAX svm.py:263-273): each class's
    rows shuffled by one numpy stream from `seed`, then dealt round-robin
    to the folds."""
    labels = np.asarray(labels).reshape(-1)
    rng = np.random.default_rng(seed)
    fold_of = np.zeros(len(labels), dtype=np.int64)
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % cv
    return [np.flatnonzero(fold_of == f) for f in range(cv)]


def grid_search_svm(feats, labels, cs=(0.01, 0.1, 1.0, 10.0), kernels=("linear", "rbf"),
                    cv: int = 3, backend: str = "torch", seed: int = 0, steps: int = STEPS):
    """The reference's GridSearchCV over {kernel} x {C} with cv=3
    (eval_zeroshot.py:97-115; JAX svm.py:276-326): the mean stratified
    fold accuracy of each pair, the first best kept on ties, then a refit
    on all rows. Every fit takes `steps` Adam steps, the RBF ones too (300,
    where `fit_rbf_svm` alone takes 500), as JAX's. -> (fitted probe, {"kernel", "C"}, best mean fold
    accuracy). `backend="sklearn"` runs sklearn's GridSearchCV."""
    x = torch.as_tensor(feats, dtype=torch.float32)
    labels = np.asarray(labels).reshape(-1)
    if backend == "sklearn":
        from sklearn.model_selection import GridSearchCV
        from sklearn.svm import SVC

        grid = GridSearchCV(SVC(), {"kernel": list(kernels), "C": list(cs)}, cv=cv,
                            n_jobs=-1).fit(x.cpu().numpy(), labels)
        return grid, dict(grid.best_params_), float(grid.best_score_)
    if backend != "torch":
        raise ValueError(f"unknown SVM backend {backend!r}")
    folds = _stratified_folds(labels, cv, seed)
    num_classes = int(labels.max()) + 1

    def fit(kernel, c, rows):
        fitter = fit_svm if kernel == "linear" else fit_rbf_svm
        return fitter(x[rows], labels[rows], c=c, num_classes=num_classes, steps=steps)

    best = (-1.0, None, None)
    for kernel in kernels:
        for c in cs:
            accs = []
            for f in range(cv):
                tr = np.concatenate([folds[g] for g in range(cv) if g != f])
                val = folds[f]
                accs.append(fit(kernel, c, tr).score(x[val], labels[val]))
            mean_acc = float(np.mean(accs))
            if mean_acc > best[0]:
                best = (mean_acc, kernel, c)
    mean_acc, kernel, c = best
    return fit(kernel, c, np.arange(len(labels))), {"kernel": kernel, "C": c}, mean_acc
