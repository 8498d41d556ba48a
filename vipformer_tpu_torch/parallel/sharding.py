"""Batches over the data axis, state from the chief (counterpart of
vipformer_tpu/parallel/sharding.py:73-90 and cli/common.py:95-103; the
model axis's rules are not ported).

A rank holds the contiguous rows [r B / W, (r + 1) B / W) of a global batch
of B, so the per-rank NT-Xent groups are JAX's `nt_xent_grouped(., W)`
over the global batch, and every rank starts from rank 0's parameters,
BatchNorm statistics and optimizer state.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vipformer_tpu_torch.parallel.mesh import data_axis_size, rank


def round_up_batch(batch_size: int, world: int, name: str = "batch_size") -> int:
    """A global batch must split evenly over the ranks (the reference
    asserts batch_size % world_size == 0, pretrain.py:58-59): raises
    otherwise, returns it unchanged."""
    if batch_size % world:
        raise ValueError(f"{name} {batch_size} not divisible by data-axis size {world}")
    return batch_size


def rank_rows(n: int, rank_: int | None = None, world: int | None = None) -> slice:
    """This rank's contiguous slice of n global rows (n divisible by W)."""
    world = data_axis_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    round_up_batch(n, world)
    per = n // world
    return slice(rank_ * per, (rank_ + 1) * per)


def shard_batch(batch: dict, rank_: int | None = None, world: int | None = None) -> dict:
    """This rank's slice of a global batch (a dict of arrays or tensors whose
    leading axis is the batch)."""
    rows = rank_rows(len(next(iter(batch.values()))), rank_, world)
    return {k: v[rows] for k, v in batch.items()}


def _state_tensors(state):
    for m in state.models.values():
        yield from m.parameters()
        yield from m.buffers()
    for per_param in state.optimizer.state.values():
        for v in per_param.values():
            if isinstance(v, torch.Tensor):
                yield v


def place_state(state) -> None:
    """Every rank's train state (train.trainer.TrainState: parameters,
    BatchNorm statistics, the optimizer's moments and step counts) from
    rank 0's, in place, and the step count; a no-op with one rank."""
    if data_axis_size() == 1:
        return
    nccl = dist.get_backend() == "nccl"
    with torch.no_grad():
        for t in _state_tensors(state):
            t = t.data if isinstance(t, torch.nn.Parameter) else t
            if nccl and not t.is_cuda:  # NCCL moves card memory only (Adam's step counts)
                on_card = t.cuda()
                dist.broadcast(on_card, src=0)
                t.copy_(on_card)
            else:
                dist.broadcast(t, src=0)
    box = [state.step]
    dist.broadcast_object_list(box, src=0)
    state.step = box[0]

