"""The process group and its 2-D mesh (counterpart of
vipformer_tpu/parallel/mesh.py:65-99): W ranks as (W / T) data indices x T
model indices, the model index varying fastest (JAX's reshape of the
device list to (n / T, T)).

One process a card, as the reference ran (DDP over NCCL). A job comes
from one of two launchers:

* torchrun (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR and MASTER_PORT): `maybe_initialize_distributed` joins it;
* a plain `python -m vipformer_tpu_torch.cli.X --num_devices N`, N > 1:
  `run_ranks` spawns the N ranks itself (`torch.multiprocessing`), as the
  reference's `mp.spawn` did, on a free localhost port.

NCCL on the cards (`torch.cuda.set_device(local_rank)` first, before
anything touches a card), gloo on the CPU. `num_devices` 0 means every
visible card, as in JAX; on the CPU one rank. `--model_axis T` must
divide W (`check_mesh`, JAX's message), checked before anything runs.

Rank r has data index r // T and model index r % T. The **data group**
(the ranks of one model index) splits the global batch: a rank holds the
rows of its data index, and the data group carries sync-BN, K9's and
K18's seams, the NT-Xent groups, the gradient mean and the gathers of
evaluation outputs; `data_axis_size()` is W / T. The **model group** (the
ranks of one data index, which hold the same rows) splits the attention
heads and the MLP's hidden units (parallel/tp.py, parallel/sharding.py).
Every rank creates every group, in the same order (`init_mesh`). At T = 1
the data group is the whole world and there is no model group.

Collectives: `all_reduce_` (in place, no gradient) sums over the group
along either axis (DATA_AXIS or MODEL_AXIS); the model axis's
differentiable exchanges are parallel/tp.py's. Over the data group,
`all_reduce_sum` (differentiable: its gradient is the all-reduced
gradient) and `all_gather_rows` (the group's tensors stacked in index
order; its gradient is the all-reduced gradient's slice of this rank),
both built on all-reduce alone, which every backend takes on every device
(gloo takes no all-gather of card tensors); `broadcast_object` hands the
chief's value to every rank, so that control flow (best epochs, saves,
early exits) is the same everywhere.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the mesh of this process's group at T > 1: (T, data group, model group);
# None outside a group and at T = 1
_MESH: tuple | None = None


def world_size() -> int:
    """The number of ranks (1 outside a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def model_axis_size() -> int:
    """T: the ranks that split one batch row's heads and hidden units."""
    return _MESH[0] if _MESH is not None and dist.is_initialized() else 1


def data_axis_size() -> int:
    """W / T: the ranks that split the global batch (1 outside a group)."""
    return world_size() // model_axis_size()


def data_index() -> int:
    """This rank's index on the data axis, r // T: its rows of a batch."""
    return rank() // model_axis_size()


def model_index() -> int:
    """This rank's index on the model axis, r % T: its heads' shard."""
    return rank() % model_axis_size()


def axis_size(axis: str) -> int:
    return data_axis_size() if axis == DATA_AXIS else model_axis_size()


def axis_group(axis: str):
    """The process group of this rank along `axis` (None: the default
    group, the data axis at T = 1)."""
    if _MESH is None:
        if axis == MODEL_AXIS:
            raise ValueError("no model group at model_axis 1")
        return None
    return _MESH[1] if axis == DATA_AXIS else _MESH[2]


def is_chief() -> bool:
    """Rank 0: the one process that writes the run's files."""
    return rank() == 0


def rank_seed(seed: int) -> int:
    """A rank's generator seed from `--seed` (the seed itself on data index
    0), keyed on the data index, so that dropout masks and FPS starts
    differ across the data axis and the model ranks of one data index draw
    the same (their replicated activations must not diverge)."""
    return seed + 1_000_003 * data_index()


def check_mesh(world: int, model_axis: int) -> None:
    """W ranks must split into (W / T) x T (JAX parallel/mesh.py:70-71)."""
    if model_axis < 1:
        raise ValueError(f"--model_axis must be >= 1, got {model_axis}")
    if world % model_axis:
        raise ValueError(f"{world} devices not divisible by model_axis={model_axis}")


def init_mesh(model_axis: int) -> None:
    """Lay this process's group out as (W / T) x T: every rank creates
    every data group and every model group, in the same order (new_group
    is collective); a no-op where the mesh is already this one."""
    global _MESH
    world = world_size()
    check_mesh(world, model_axis)
    if model_axis == 1:
        _MESH = None
        return
    if _MESH is not None and _MESH[0] == model_axis:
        return
    d, t, r = world // model_axis, model_axis, rank()
    data = [dist.new_group([m + t * i for i in range(d)]) for m in range(t)]
    model = [dist.new_group([t * i + m for m in range(t)]) for i in range(d)]
    _MESH = (t, data[r % t], model[r // t])


def reset_mesh() -> None:
    """Forget the mesh (its groups die with the process group)."""
    global _MESH
    _MESH = None


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


def _rank_main(rank_: int, world: int, device: str, port: int, backend, model_axis: int, fn,
               args, results):
    init_group(rank_, world, rank_, device, f"tcp://127.0.0.1:{port}", backend)
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        init_mesh(model_axis)
        out = fn(*args)
        if rank_ == 0:
            results.put(out)
    finally:
        reset_mesh()
        dist.destroy_process_group()


def spawn(fn, world: int, device: str, args=(), backend: str | None = None,
          model_axis: int = 1):
    """Run fn(*args) on `world` spawned ranks joined in one group, laid out
    as (world / model_axis) x model_axis; returns the chief's return value.
    A rank's exception ends every rank and is raised here
    (torch.multiprocessing's ProcessRaisedException)."""
    import torch.multiprocessing as mp

    check_mesh(world, model_axis)
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main,
                             args=(world, device, free_port(), backend, model_axis, fn, args,
                                   results),
                             nprocs=world, join=False, start_method="spawn")
    out = None
    while not ctx.join(timeout=0.2):
        if not results.empty():
            out = results.get()
    if not results.empty():
        out = results.get()
    return out


def run_ranks(fn, cfg, device: str):
    """A CLI's `main`: fn(cfg, device) on every rank of `cfg.num_devices`,
    laid out over `cfg.model_axis` (which must divide the ranks: raises
    before fn runs, so before any run directory exists). Under torchrun
    this process is one rank; a single rank runs in this process; more are
    spawned (the kernels built first, in this process, so that the ranks
    do not all compile the same sources)."""
    if maybe_initialize_distributed(device) or dist.is_initialized():
        init_mesh(cfg.model_axis)
        return fn(cfg, device)
    world = resolve_num_devices(cfg.num_devices, device)
    check_mesh(world, cfg.model_axis)
    if world == 1:
        return fn(cfg, device)
    if torch.device(device).type == "cuda":
        from vipformer_tpu_torch.ops import cuda

        cuda.lib()
    return spawn(fn, world, device, (cfg, device), model_axis=cfg.model_axis)


def all_reduce_(t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """t summed over this rank's group along `axis`, in place (no
    gradient); t itself where the group has one rank."""
    if axis_size(axis) > 1:
        dist.all_reduce(t, group=axis_group(axis))
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the data group (x itself with one data index),
    differentiable: the gradient of a rank's x is the sum of the group's
    gradients of the result, which is the gradient of the sum of the
    group's losses."""
    if data_axis_size() == 1:
        return x
    return _AllReduceSum.apply(x)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, i = data_axis_size(), data_index()
        buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        buf[i] = x
        all_reduce_(buf)
        return buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n, i = data_axis_size(), data_index()
        g = g.reshape((n, g.shape[0] // n) + tuple(g.shape[1:])).clone()
        all_reduce_(g)
        return g[i]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data group's x [n, ...] stacked in data-index order into [D n,
    ...] (x itself with one data index), built on all-reduce into a zeroed
    [D, n, ...] buffer (every backend takes all-reduce on every device);
    differentiable, a rank's gradient being the summed gradient's rows of
    this rank."""
    if data_axis_size() == 1:
        return x
    return _AllGatherRows.apply(x)


def broadcast_object(obj):
    """The chief's `obj` on every rank (picklable values)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (a no-op outside a group)."""
    if world_size() > 1:
        dist.barrier()
