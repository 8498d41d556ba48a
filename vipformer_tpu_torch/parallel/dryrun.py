"""A multi-card dry run (counterpart of __graft_entry__.py:61-83
`dryrun_multichip`, its pure data-parallel mesh only).

    python -m vipformer_tpu_torch.parallel.dryrun 2 [--device cpu]

`dryrun_multicard(n)` spawns n ranks (`parallel.mesh.spawn`: NCCL over n
cards, gloo on the CPU), places the pretrain state from rank 0 and runs
one dual-branch pretrain step at tiny widths on each rank's slice of a
global batch of 4 n clouds, one NT-Xent group a rank. Every rank checks
that its loss is finite and that its parameters after the step equal
rank 0's bit for bit (the averaged gradients give every rank the same
update); the chief's {"world", "backend", "loss"} comes back.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from vipformer_tpu_torch.config import Config, decode_arch_name
from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
from vipformer_tpu_torch.parallel.mesh import all_reduce_sum, data_axis_size, rank_seed, spawn
from vipformer_tpu_torch.parallel.sharding import place_state, shard_batch
from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

TINY = dict(decode_arch_name("E1CL1SL-H2D128-L16-MR2"), group_size=8, num_pt_points=128,
            img_height=24, img_width=24, patch_size=12, optim="adamw", lr=1e-3)


def _dryrun_rank(device: str) -> dict:
    world = data_axis_size()
    cfg = Config(**TINY, compute_dtype="bfloat16" if device == "cuda" else "float32")
    models = {"pc": build_pc_model(cfg, device=device), "img": build_img_model(cfg, device=device)}
    state = create_state(cfg, models)
    place_state(state)
    step = make_pretrain_step(cfg, models["pc"], models["img"], neg_groups=world)
    rng = np.random.default_rng(cfg.seed)
    b = 4 * world
    batch = {"pc_t1": rng.standard_normal((b, 128, 3)).astype(np.float32),
             "pc_t2": rng.standard_normal((b, 128, 3)).astype(np.float32),
             "imgs": rng.standard_normal((b, 24, 24, 3)).astype(np.float32)}
    gen = torch.Generator(device=device).manual_seed(rank_seed(cfg.seed))
    _, metrics = step(state, shard_batch(batch), cfg.lr, gen)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dry run: non-finite loss {loss}")
    flat = torch.cat([p.detach().reshape(-1).float() for p in state.parameters()])
    chief = flat.clone()
    dist.broadcast(chief, src=0)
    differ = all_reduce_sum(torch.tensor([float(not torch.equal(flat, chief))], device=device))
    if float(differ) != 0.0:
        raise RuntimeError(f"dry run: {int(differ)} ranks' parameters differ from rank 0's")
    return {"world": world, "backend": dist.get_backend(), "loss": loss}


def dryrun_multicard(n: int, device: str = "cuda") -> dict:
    """One data-parallel pretrain step on n spawned ranks (module
    docstring); raises if a rank fails."""
    return spawn(_dryrun_rank, n, device, (device,))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="data-parallel dry run")
    parser.add_argument("n", type=int, help="ranks (cards, on the card)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    print(dryrun_multicard(args.n, args.device))
