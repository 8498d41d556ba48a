"""Batches over the data axis, parameters over the model axis, state from
the chief (counterpart of vipformer_tpu/parallel/sharding.py:23-90,
ops/pallas/dense.py:104-124 and cli/common.py:95-103).

A rank holds the contiguous rows [i B / D, (i + 1) B / D) of a global batch
of B, i its data index and D the data-axis size, so the per-rank NT-Xent
groups are JAX's `nt_xent_grouped(., D)` over the global batch.

Tensor parallelism (model_axis T > 1) follows JAX's `_TP_RULES`, matched
on each Dense's flax path (the port's state-dict key with `/` for `.`):
q/k/v projections and the MLP's first Dense are column-sharded (a rank
holds its T-th of the output features: rows of the torch weight [out, in]
and of the bias), o_proj and the MLP's second Dense row-sharded (the
matching columns; the bias whole, added once after the model all-reduce).
A kernel shards only where its sharded axis divides T
(`effective_tp_role`). Parameters are stored sharded: `shard_model`
replaces each such weight by this rank's slice (marked `tp_dim`, the torch
axis it is split on), so the optimizer's moments follow them. Where an
attention's heads do not divide T (`tp_heads_shardable`), the port keeps
its four projections whole on every model rank (the attention runs on all
heads there, its kernels too) and logs one line; JAX shards those kernels
mid-head and runs XLA's attention, with the same result.

Checkpoints stay one-rank files: `full_state_dict` and
`full_optimizer_state` gather the shards over the model group,
`shard_state_dict` and `shard_optimizer_state` slice a full file for this
rank, and `place_state` hands every rank the chief's model group's state
(each shard from the member of its model index).
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from vipformer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_,
    axis_group,
    data_axis_size,
    data_index,
    model_axis_size,
    model_index,
    world_size,
)

# (path regex, role): JAX parallel/sharding.py:26-32; first match wins
_TP_RULES = [
    (re.compile(r"(q_proj|k_proj|v_proj)/kernel$"), "col"),
    (re.compile(r"o_proj/kernel$"), "row"),
    # MLP: first Dense widens (shard out), second projects back (shard in)
    (re.compile(r"MLP_\d+/Dense_0/kernel$"), "col"),
    (re.compile(r"MLP_\d+/Dense_1/kernel$"), "row"),
]


def tp_role_for_path(path: str) -> str | None:
    """Megatron role of a Dense kernel at a flax path ('.../kernel'):
    'col' (output features sharded), 'row' (input features sharded) or
    None (replicated); JAX sharding.py:42-53."""
    for rx, role in _TP_RULES:
        if rx.search(path):
            return role
    return None


def effective_tp_role(role: str | None, cin: int, cout: int, t: int) -> str | None:
    """A declared role against a model axis of T (JAX dense.py:104-124): a
    role holds only where the sharded feature axis divides T."""
    if t <= 1 or role is None:
        return None
    if role == "col" and cout % t == 0:
        return "col"
    if role == "row" and cin % t == 0:
        return "row"
    return None


def round_up_batch(batch_size: int, world: int, name: str = "batch_size") -> int:
    """A global batch must split evenly over the ranks (the reference
    asserts batch_size % world_size == 0, pretrain.py:58-59): raises
    otherwise, returns it unchanged."""
    if batch_size % world:
        raise ValueError(f"{name} {batch_size} not divisible by data-axis size {world}")
    return batch_size


def rank_rows(n: int, rank_: int | None = None, world: int | None = None) -> slice:
    """The contiguous slice of n global rows of data index `rank_` (this
    rank's) of `world` (the data-axis size; n divisible by it)."""
    world = data_axis_size() if world is None else world
    rank_ = data_index() if rank_ is None else rank_
    round_up_batch(n, world)
    per = n // world
    return slice(rank_ * per, (rank_ + 1) * per)


def shard_batch(batch: dict, rank_: int | None = None, world: int | None = None) -> dict:
    """This rank's slice of a global batch (a dict of arrays or tensors whose
    leading axis is the batch)."""
    rows = rank_rows(len(next(iter(batch.values()))), rank_, world)
    return {k: v[rows] for k, v in batch.items()}


# ------------------------------------------------------------ the model axis
def shard_model(model: torch.nn.Module, log=None) -> torch.nn.Module:
    """Shard `model` over the model axis in place (a no-op at T = 1): each
    attention whose heads divide T runs its local H / T heads, and every
    Dense whose path has a role that divides T keeps this rank's slice.
    An attention whose heads do not divide T stays whole, with one line to
    `log`. Returns the model. Call it after any full-size restore and
    before the optimizer is built."""
    from vipformer_tpu_torch.nn.layers import Dense, MultiHeadAttention
    from vipformer_tpu_torch.ops.cuda.attention import tp_heads_shardable

    t = model_axis_size()
    if t == 1:
        return model
    whole = set()
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention) and mod.model_axis == 1:
            if tp_heads_shardable(mod.num_heads, mod.qk_channels, t):
                mod.shard_heads(t, model_index())
            else:
                whole.update(id(d) for d in (mod.q_proj, mod.k_proj, mod.v_proj, mod.o_proj))
                if log is not None:
                    log(f"tensor parallel: {name or 'attention'} keeps its {mod.num_heads} "
                        f"heads whole on each of the {t} model ranks (its heads or widths "
                        f"{mod.qk_channels} / {mod.v_channels} do not divide model_axis {t}); "
                        "its MLP still shards")
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and id(mod) not in whole and mod.tp_role is None:
            cout, cin = mod.weight.shape
            path = name.replace(".", "/") + "/kernel"  # the flax path of its kernel
            role = effective_tp_role(tp_role_for_path(path), cin, cout, t)
            if role is not None:
                mod.shard(role, t, model_index())
    return model


def sharded(p: torch.Tensor) -> bool:
    """Whether a parameter holds this rank's slice of a larger tensor."""
    return getattr(p, "tp_dim", None) is not None


def _slice(full: torch.Tensor, dim: int, t: int, i: int) -> torch.Tensor:
    n = full.shape[dim] // t
    return full.narrow(dim, i * n, n)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's slices of a tensor concatenated along `dim`, on
    every member (built on all-reduce into a zeroed buffer)."""
    t, i = model_axis_size(), model_index()
    shape = list(x.shape)
    shape[dim] *= t
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    _slice(full, dim, t, i).copy_(x)
    return all_reduce_(full, MODEL_AXIS)


def _params(optimizer) -> list:
    """The optimizer's parameters in its state dict's index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_state_dict(model: torch.nn.Module) -> dict:
    """The model's state dict with every shard gathered into its full
    tensor (collective over the model group at T > 1)."""
    sd = model.state_dict()
    if model_axis_size() == 1:
        return sd
    for name, p in model.named_parameters():
        if sharded(p):
            sd[name] = gather_model(p.detach(), p.tp_dim)
    return sd


def shard_state_dict(model: torch.nn.Module, sd: dict) -> dict:
    """A full state dict (a one-rank file, or `from_jax_variables`' output)
    sliced for this rank's shards of `model`; other entries as they are."""
    if model_axis_size() == 1:
        return sd
    out = dict(sd)
    t, i = model_axis_size(), model_index()
    for name, p in model.named_parameters():
        v = sd.get(name)
        if sharded(p) and v is not None and v.shape[p.tp_dim] == p.shape[p.tp_dim] * t:
            out[name] = _slice(v, p.tp_dim, t, i).contiguous()
    return out


def load_full_state(model: torch.nn.Module, sd: dict, strict: bool = True):
    """`model.load_state_dict` of a full state dict, sliced for its shards."""
    return model.load_state_dict(shard_state_dict(model, sd), strict=strict)


def _moments(optimizer, sd: dict, fn) -> dict:
    """The optimizer state dict `sd` with fn(v, p) in place of each tensor
    of a sharded parameter p's state that has p's shape or its full one."""
    out = {**sd, "state": {k: dict(v) for k, v in sd["state"].items()}}
    for idx, p in enumerate(_params(optimizer)):
        if not sharded(p):
            continue
        for key, v in out["state"].get(idx, {}).items():
            if isinstance(v, torch.Tensor) and v.ndim == p.ndim:
                out["state"][idx][key] = fn(v, p)
    return out


def full_optimizer_state(optimizer) -> dict:
    """The optimizer's state dict with the moments of sharded parameters
    gathered into full tensors (collective over the model group)."""
    sd = optimizer.state_dict()
    if model_axis_size() == 1:
        return sd
    return _moments(optimizer, sd, lambda v, p: gather_model(v, p.tp_dim))


def shard_optimizer_state(optimizer, sd: dict) -> dict:
    """A full optimizer state dict sliced for this rank's shards."""
    if model_axis_size() == 1:
        return sd
    t, i = model_axis_size(), model_index()

    def cut(v, p):
        full = v.shape[p.tp_dim] == p.shape[p.tp_dim] * t
        return _slice(v, p.tp_dim, t, i).contiguous() if full else v

    return _moments(optimizer, sd, cut)


def _broadcast(t: torch.Tensor, nccl: bool, src: int = 0, group=None) -> None:
    if nccl and not t.is_cuda:  # NCCL moves card memory only (Adam's step counts)
        on_card = t.cuda()
        dist.broadcast(on_card, src=src, group=group)
        t.copy_(on_card)
    else:
        dist.broadcast(t, src=src, group=group)


def _place(t: torch.Tensor, is_shard: bool, nccl: bool) -> None:
    """t from the chief's; a shard from the one of its model index in the
    chief's model group (global rank = model index), over the data group."""
    if is_shard:
        _broadcast(t, nccl, src=model_index(), group=axis_group(DATA_AXIS))
    else:
        _broadcast(t, nccl)


def place_state(state) -> None:
    """Every rank's train state (train.trainer.TrainState: parameters,
    BatchNorm statistics, the optimizer's moments and step counts) from
    the chief's, in place, and the step count; a sharded tensor (and its
    moments) from the rank of its model index in the chief's model group,
    which holds the same slice. A no-op with one rank."""
    if world_size() == 1:
        return
    nccl = dist.get_backend() == "nccl"
    with torch.no_grad():
        for m in state.models.values():
            for p in m.parameters():
                _place(p.data, sharded(p), nccl)
            for b in m.buffers():
                _broadcast(b, nccl)
        for p in _params(state.optimizer):
            for v in state.optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    _place(v, sharded(p) and v.shape == p.shape, nccl)
    box = [state.step]
    dist.broadcast_object_list(box, src=0)
    state.step = box[0]
