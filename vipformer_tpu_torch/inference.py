"""Serving-oriented inference wrapper (counterpart of vipformer_tpu/inference.py).

Requests arrive with ragged sizes. `Predictor` pads each request to the
smallest fitting bucket (powers of two up to `max_batch`) with copies of
its last sample, runs the model eagerly under `torch.inference_mode`, and
strips the padding, so every batch the model sees has one of a few fixed
shapes.
"""

from __future__ import annotations

import bisect
from typing import Callable

import numpy as np
import torch


class Predictor:
    """Bucketed batch predictor.

    Args:
      apply_fn: batch tensor -> dict of output tensors (eval mode).
      device: where the batch tensor is placed.
      max_batch: largest supported request size (also the largest bucket).
    """

    def __init__(self, apply_fn: Callable, device, max_batch: int = 256):
        buckets = []
        b = 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        self.buckets = buckets + [max_batch]
        self.device = torch.device(device)
        self._fn = apply_fn

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise ValueError(f"request of {n} exceeds max bucket {self.buckets[-1]}")
        return self.buckets[i]

    def __call__(self, batch: np.ndarray) -> dict:
        """batch [n, ...] -> dict of numpy outputs with the padding stripped."""
        n = batch.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        b = self._bucket(n)
        if b != n:
            batch = np.concatenate([batch, np.repeat(batch[-1:], b - n, axis=0)], axis=0)
        with torch.inference_mode():
            out = self._fn(torch.as_tensor(batch, device=self.device))
        return {k: v[:n].float().cpu().numpy() for k, v in out.items()}


def classifier_predictor(model, max_batch: int = 256) -> Predictor:
    """Predictor over a classification model (CrossFormerPCFT): outputs
    `logits` and `backbone_feats`."""
    model.eval()
    device = next(model.parameters()).device

    def apply_fn(x):
        logits, feats = model(x)
        return {"logits": logits, "backbone_feats": feats}

    return Predictor(apply_fn, device, max_batch)
