"""Data parallelism over torch.distributed (counterpart of
vipformer_tpu/parallel/, its data axis; the model axis is not ported)."""

from vipformer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    broadcast_object,
    check_model_axis,
    data_axis_size,
    is_chief,
    maybe_initialize_distributed,
    rank,
    rank_seed,
    run_ranks,
)
from vipformer_tpu_torch.parallel.sharding import place_state, round_up_batch, shard_batch

__all__ = [
    "DATA_AXIS",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "check_model_axis",
    "data_axis_size",
    "is_chief",
    "maybe_initialize_distributed",
    "place_state",
    "rank",
    "rank_seed",
    "round_up_batch",
    "run_ranks",
    "shard_batch",
]
