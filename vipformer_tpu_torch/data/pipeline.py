"""Host-side input pipeline (the port's own copy of the `Loader`,
`collate_pretrain`, `collate_cls` and `pad_batch` parts of
vipformer_tpu/data/pipeline.py): epoch-seeded shuffling, a thread pool over
the dataset's `get`, and fixed-shape numpy batches (`drop_last` when
shuffling, a padded last batch in evaluation)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


class Loader:
    """Deterministic batch loader over a dataset with `__len__` and
    `get(i, rng)`; epoch e shuffles with seed + e (`set_epoch`), and each
    sample gets its own child generator."""

    def __init__(self, dataset, batch_size: int, collate: Callable, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None
        try:
            for start in range(0, n, self.batch_size):
                idx = order[start:start + self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    break
                seeds = rng.integers(0, 2**63 - 1, size=len(idx))

                def get(t):
                    return self.dataset.get(int(t[0]), np.random.default_rng(int(t[1])))

                pairs = list(zip(idx, seeds))
                samples = list(pool.map(get, pairs)) if pool else [get(t) for t in pairs]
                yield self.collate(samples)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def collate_pretrain(samples):
    t1 = np.stack([s[0] for s in samples])
    t2 = np.stack([s[1] for s in samples])
    imgs = np.stack([s[2] for s in samples])
    return {"pc_t1": t1, "pc_t2": t2, "imgs": imgs}


def collate_cls(samples):
    pts = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], dtype=np.int64)
    return {"points": pts, "labels": labels}


def pad_batch(batch: dict, batch_size: int) -> tuple[dict, np.ndarray]:
    """Pad a trailing partial batch up to `batch_size` by repeating its last
    sample; returns (padded batch, valid mask [batch_size]), so every
    evaluation batch has one shape and the metrics skip the padding."""
    n = len(next(iter(batch.values())))
    mask = np.zeros(batch_size, dtype=bool)
    mask[:n] = True
    if n == batch_size:
        return batch, mask
    return {k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)], axis=0)
            for k, v in batch.items()}, mask
