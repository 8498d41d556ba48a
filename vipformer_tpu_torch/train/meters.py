"""Running meters (counterpart of vipformer_tpu/train/meters.py, reference
utils.py:54-91)."""

from __future__ import annotations


class AverageMeter:
    """The last value and the n-weighted running mean."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
