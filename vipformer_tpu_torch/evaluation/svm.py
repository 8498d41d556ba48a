"""Linear SVM probe (the port's own copy of vipformer_tpu/evaluation/
svm.py:37-141), fitted on the features' device.

The reference's per-epoch probe is sklearn's `SVC(C, kernel='linear')`
(pretrain.py:252). The JAX package replaces it by a one-vs-rest
L2-regularised squared-hinge linear classifier, min 0.5 |w|^2 + C sum
max(0, 1 - y f)^2 over all K binary problems at once (w is [D, K]), fitted
full-batch by Adam for 300 steps with the learning rate cosine-decayed
from 0.05 to 0; this module is that fit in PyTorch, with the gradient and
Adam written out (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected moments). `fit_svm(..., backend="sklearn")`
hands the fit to sklearn where it is installed, imported only then.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LR0 = 0.05  # optax.cosine_decay_schedule(0.05, steps) of JAX svm.py:91
STEPS = 300  # full-batch Adam steps (JAX svm.py:62)


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


def cosine_lr(i: int, steps: int) -> float:
    """optax.cosine_decay_schedule(LR0, steps) at step i."""
    return LR0 * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))


def _train_ovr(x: torch.Tensor, y: torch.Tensor, num_classes: int,
               c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One-vs-rest squared hinge, all K problems at once, full-batch Adam
    from zero: x f32 [N, D], y int [N] -> (w [D, K], b [K])."""
    d = x.shape[1]
    targets = torch.where(torch.nn.functional.one_hot(y.long(), num_classes) > 0, 1.0, -1.0)
    targets = targets.to(x)
    params = [torch.zeros((d, num_classes), dtype=torch.float32, device=x.device),
              torch.zeros((num_classes,), dtype=torch.float32, device=x.device)]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    for i in range(STEPS):
        w, b = params
        margin = torch.clamp_min(1.0 - targets * (x @ w + b), 0.0)
        df = (-2.0 * c) * targets * margin  # d loss / d f
        grads = (w + x.t() @ df, df.sum(0))
        lr = cosine_lr(i, STEPS)
        bc1, bc2 = 1.0 - ADAM_B1 ** (i + 1), 1.0 - ADAM_B2 ** (i + 1)
        for p, g, (m, v) in zip(params, grads, moments):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    return params[0], params[1]


def fit_svm(feats, labels, c: float = 1.0, standardize: bool = False,
            backend: str = "torch") -> LinearSVM:
    """Fit the probe on feats [N, D] (numpy, or a tensor on the device to
    fit on) and labels [N] over classes 0..max(labels); `standardize`
    divides each feature by its population std after centering (+1e-8),
    as JAX svm.py:114-117."""
    x = torch.as_tensor(feats, dtype=torch.float32)
    labels = np.asarray(labels).reshape(-1)
    num_classes = int(labels.max()) + 1
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
    w, b = _train_ovr(x, torch.as_tensor(labels, device=x.device), num_classes, c)
    return LinearSVM(w=w, b=b, mean=mean, scale=scale)
