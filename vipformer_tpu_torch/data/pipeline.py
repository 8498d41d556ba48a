"""Host-side input pipeline (counterpart of vipformer_tpu/data/pipeline.py):
epoch-seeded shuffling, a thread pool over the dataset's `get`,
fixed-shape numpy batches (`drop_last` when shuffling, a padded last batch
in evaluation), and `prefetch_to_device`, which assembles batches ahead of
the train step and starts their host-to-device copies."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch


class Loader:
    """Deterministic batch loader over a dataset with `__len__` and
    `get(i, rng)`; epoch e shuffles with seed + e (`set_epoch`), and each
    sample gets its own child generator. With `world` > 1 ranks, every rank
    draws the global order and the global batch's per-sample seeds, and
    builds only its own contiguous slice of `batch_size` / `world` samples
    (rows [rank B / W, (rank + 1) B / W)): the ranks' batches stacked in
    rank order are the one-process batch, bit for bit."""

    def __init__(self, dataset, batch_size: int, collate: Callable, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 0, rank: int = 0,
                 world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} not divisible by data-axis size {world}")
        if world > 1 and not drop_last:
            raise ValueError("a rank's slices need full global batches (drop_last)")
        self.dataset = dataset
        self.rank, self.world = rank, world
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
                if self.world > 1:
                    per = self.batch_size // self.world
                    pairs = pairs[self.rank * per:(self.rank + 1) * per]
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


def collate_pretrain_raw(samples):
    """`ShapeNetRender(raw_views=True)` samples -> {"pc_raw" [B, N, 3] f32,
    "imgs" [B, H, W, 3] uint8}: the `--device_augs` batch."""
    raw = np.stack([s[0] for s in samples])
    imgs = np.stack([s[1] for s in samples])
    return {"pc_raw": raw, "imgs": imgs}


def collate_cls(samples):
    pts = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], dtype=np.int64)
    return {"points": pts, "labels": labels}


def collate_partseg(samples):
    pts = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], dtype=np.int64)
    seg = np.stack([s[2] for s in samples])
    return {"points": pts, "obj_labels": labels, "seg": seg}


def collate_semseg(samples):
    pts = np.stack([s[0] for s in samples])
    seg = np.stack([s[1] for s in samples])
    return {"points": pts, "seg": seg}


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


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


def prefetch_to_device(iterator, device, depth: int = 2) -> Iterator[dict]:
    """Yields the batches of `iterator` (dicts of numpy arrays) as dicts of
    tensors on `device`, in order, while a background thread assembles up
    to `depth` batches ahead (JAX pipeline.py:170-199).

    On a CUDA device the thread copies each batch into pinned host buffers
    and starts its host-to-device copy (`non_blocking`) on a side stream,
    records an event after it, and queues the batch: the consumer's stream
    waits on that event before the batch is used, and each tensor is
    recorded on the consumer's stream, so the allocator keeps its memory
    until the consumer's work on it is done. A pinned buffer is written
    again only after the copy out of it has finished (its own event). On
    the CPU the thread only runs ahead: the arrays become tensors that
    share their memory.

    An exception in the loader is raised again here, in the consumer, where
    JAX's producer ends the epoch silently. Leaving the loop early stops
    the thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
                side = torch.cuda.Stream(device)
                # depth batches queued, one being consumed, one being filled
                slots = [{"pinned": {}, "copied": None} for _ in range(depth + 2)]
            for i, batch in enumerate(iterator):
                if not cuda:
                    out = {k: torch.as_tensor(v) for k, v in batch.items()}
                    if not put((out, None)):
                        return
                    continue
                slot = slots[i % len(slots)]
                if slot["copied"] is not None:
                    slot["copied"].synchronize()  # the last copy out of these buffers
                pinned = slot["pinned"]
                out = {}
                with torch.cuda.stream(side):
                    for k, v in batch.items():
                        src = torch.as_tensor(v)
                        buf = pinned.get(k)
                        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                            buf = pinned[k] = torch.empty(src.shape, dtype=src.dtype,
                                                          pin_memory=True)
                        buf.copy_(src)
                        out[k] = buf.to(device, non_blocking=True)
                    slot["copied"] = torch.cuda.Event()
                    slot["copied"].record(side)
                if not put((out, slot["copied"])):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            put(_Failed(e))
            return
        put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise item.error
            out, copied = item
            if copied is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(copied)
                for t in out.values():
                    t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        thread.join()
