"""Data parallelism over torch.distributed (counterpart of
vipformer_tpu/parallel/mesh.py, its data axis only).

One process a card, as the reference ran (DDP over NCCL): the global batch
is split contiguously over the ranks, each rank runs the step on its
slice, and the gradients are averaged over the ranks after the backward
(train/trainer.py). A job comes from one of two launchers:

* torchrun (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR and MASTER_PORT): `maybe_initialize_distributed` joins it;
* a plain `python -m vipformer_tpu_torch.cli.X --num_devices N`, N > 1:
  `run_ranks` spawns the N ranks itself (`torch.multiprocessing`), as the
  reference's `mp.spawn` did, on a free localhost port.

NCCL on the cards (`torch.cuda.set_device(local_rank)` first, before
anything touches a card), gloo on the CPU. `num_devices` 0 means every
visible card, as in JAX; on the CPU one rank. The model axis (tensor
parallelism) is not ported: `check_model_axis` refuses it.

Collectives: `all_reduce_sum` (differentiable: its gradient is the
all-reduced gradient) and `all_gather_rows` (the ranks' tensors stacked
along the leading axis; its gradient is the all-reduced gradient's slice
of this rank), both built on all-reduce alone, which every backend takes
on every device; `broadcast_object` hands the chief's value to every rank,
so that control flow (best epochs, saves, early exits) is the same
everywhere.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def data_axis_size() -> int:
    """The number of data-parallel ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_chief() -> bool:
    """Rank 0: the one process that writes the run's files."""
    return rank() == 0


def rank_seed(seed: int) -> int:
    """A rank's generator seed from `--seed` (the seed itself on rank 0), so
    that dropout masks and FPS starts differ across ranks."""
    return seed + 1_000_003 * rank()


def check_model_axis(model_axis: int) -> None:
    """Refuse tensor parallelism over a model axis: the port runs the data
    axis only (ROADMAP Queue 1, item 16, its TP part)."""
    if model_axis > 1:
        raise NotImplementedError(
            f"--model_axis {model_axis}: tensor parallelism over the model axis is not ported "
            "(ROADMAP Queue 1, item 16, its TP part); the port runs data parallelism only, "
            "--model_axis 1")


def resolve_num_devices(num_devices: int, device: str) -> int:
    """`--num_devices`: 0 means every visible card (one rank on the CPU)."""
    if num_devices < 0:
        raise ValueError(f"--num_devices must be >= 0, got {num_devices}")
    if num_devices:
        return num_devices
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def init_group(rank_: int, world: int, local_rank: int, device: str, init_method: str,
               backend: str | None = None) -> None:
    """Join the process group: NCCL on the cards (after setting this rank's
    card), gloo on the CPU, unless `backend` names one (two ranks on one
    card need gloo: NCCL refuses a duplicate card). Raises on a failed
    bring-up."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if local_rank >= torch.cuda.device_count() and backend != "gloo":
            raise RuntimeError(f"rank {rank_} needs card {local_rank}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"), init_method=init_method,
                            world_size=world, rank=rank_)


def maybe_initialize_distributed(device: str = "cuda") -> bool:
    """Join a job from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) if it is set and no group is active yet.
    Returns True when this process is one rank of a job of more than one."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_group(rank_, world, int(os.environ.get("LOCAL_RANK", rank_)), device, "env://")
    return world > 1


def free_port() -> int:
    """A free localhost TCP port for a spawned group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, world: int, device: str, port: int, backend, fn, args, results):
    init_group(rank_, world, rank_, device, f"tcp://127.0.0.1:{port}", backend)
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        out = fn(*args)
        if rank_ == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device: str, args=(), backend: str | None = None):
    """Run fn(*args) on `world` spawned ranks joined in one group; returns
    the chief's return value. A rank's exception ends every rank and is
    raised here (torch.multiprocessing's ProcessRaisedException)."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main,
                             args=(world, device, free_port(), backend, fn, args, results),
                             nprocs=world, join=False, start_method="spawn")
    out = None
    while not ctx.join(timeout=0.2):
        if not results.empty():
            out = results.get()
    if not results.empty():
        out = results.get()
    return out


def run_ranks(fn, cfg, device: str):
    """A CLI's `main`: fn(cfg, device) on every rank of `cfg.num_devices`.
    Under torchrun this process is one rank; a single rank runs in this
    process; more are spawned (the kernels built first, in this process,
    so that the ranks do not all compile the same sources)."""
    check_model_axis(cfg.model_axis)
    if maybe_initialize_distributed(device) or dist.is_initialized():
        return fn(cfg, device)
    world = resolve_num_devices(cfg.num_devices, device)
    if world == 1:
        return fn(cfg, device)
    if torch.device(device).type == "cuda":
        from vipformer_tpu_torch.ops import cuda

        cuda.lib()
    return spawn(fn, world, device, (cfg, device))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks (x itself with one rank), differentiable:
    the gradient of a rank's x is the sum of the ranks' gradients of the
    result, which is the gradient of the sum of the ranks' losses."""
    if data_axis_size() == 1:
        return x
    return _AllReduceSum.apply(x)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        world, r = data_axis_size(), rank()
        buf = torch.zeros((world,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        buf[r] = x
        dist.all_reduce(buf)
        return buf.reshape((world * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        world, r = data_axis_size(), rank()
        g = g.reshape((world, g.shape[0] // world) + tuple(g.shape[1:])).clone()
        dist.all_reduce(g)
        return g[r]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x [n, ...] stacked in rank order into [W n, ...] (x itself
    with one rank), built on all-reduce into a zeroed [W, n, ...] buffer
    (every backend takes all-reduce on every device); differentiable, a
    rank's gradient being the summed gradient's rows of this rank."""
    if data_axis_size() == 1:
        return x
    return _AllGatherRows.apply(x)


def broadcast_object(obj):
    """The chief's `obj` on every rank (picklable values)."""
    if data_axis_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (a no-op outside a group)."""
    if data_axis_size() > 1:
        dist.barrier()
