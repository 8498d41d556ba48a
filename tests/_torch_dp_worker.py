"""The ranks' side of tests/test_torch_parallel.py: importable by the
spawned ranks (which must not import JAX, as the test files do).

`run_checks(d)` runs on each rank of a two-rank gloo group on the CPU
(`vipformer_tpu_torch.parallel.mesh.spawn`): it reads `d/inputs.pt` (the
test's seed-made weights and global batches), runs every data-parallel
check on this rank's slice and saves what it got to `d/rank{r}.pt` for the
test process to hold against JAX's mesh step and the port's one-process
run. The same helpers build the one-process references in the test.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vipformer_tpu_torch.cli.common import extract_features
from vipformer_tpu_torch.data.pipeline import Loader, collate_cls
from vipformer_tpu_torch.models import factory
from vipformer_tpu_torch.nn.layers import BatchNorm
from vipformer_tpu_torch.ops.cuda.batchnorm import bn_train_apply
from vipformer_tpu_torch.ops.cuda.g2e_train import g2e_train_apply
from vipformer_tpu_torch.parallel import dryrun
from vipformer_tpu_torch.parallel import (
    all_gather_rows,
    all_reduce_sum,
    data_axis_size,
    rank,
    shard_batch,
)
from vipformer_tpu_torch.parallel.sharding import rank_rows
from vipformer_tpu_torch.train import trainer

STEPS = ("pretrain", "ft_cls", "partseg", "semseg", "global_negatives")


def build(kind: str, cfg, states: dict, neg_groups: int = 1):
    """(TrainState, step) of one kind of train step on the CPU, the models
    loaded from `states` ({branch: state dict}); the segmentation heads'
    fixed dropout off (the step runs without a generator)."""
    if kind in ("pretrain", "global_negatives"):
        models = {"pc": factory.build_pc_model(cfg, device="cpu"),
                  "img": factory.build_img_model(cfg, device="cpu")}
    else:
        build_fn = {"ft_cls": factory.build_ft_cls, "partseg": factory.build_ft_partseg,
                    "semseg": factory.build_ft_semseg}[kind]
        models = {"pc": build_fn(cfg, device="cpu")}
    if kind in ("partseg", "semseg"):
        models["pc"].seg_head.drop = 0.0
    for name, m in models.items():
        m.load_state_dict(states[name], strict=True)
    state = trainer.create_state(cfg, models)
    if kind in ("pretrain", "global_negatives"):
        step = trainer.make_pretrain_step(cfg, models["pc"], models["img"], neg_groups)
    else:
        step = {"ft_cls": trainer.make_cls_step, "partseg": trainer.make_partseg_step,
                "semseg": trainer.make_semseg_step}[kind](cfg, models["pc"])
    return state, step


def run_step(kind: str, case: dict) -> dict:
    """One step of `kind` on this rank's slice of case["batch"] (the whole
    batch outside a group): metrics, the models' new tensors (parameters
    and BatchNorm statistics) and the gradients the update used."""
    state, step = build(kind, case["cfg"], case["states"], case.get("neg_groups", 1))
    state, metrics = step(state, shard_batch(case["batch"]), case["lr"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "tensors": {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
                        for n, m in state.models.items()},
            "grads": {n: {k: p.grad.detach().clone() for k, p in m.named_parameters()}
                      for n, m in state.models.items()}}


def run_norms(case: dict) -> dict:
    """K9's and K18's twins and the plain BatchNorm, forward and backward,
    on this rank's rows: outputs, statistics, the input gradient of this
    rank's rows and the parameter gradients (this rank's sums)."""
    rows = rank_rows(case["x0"].shape[0])
    x0 = torch.tensor(case["x0"][rows], requires_grad=True)
    wb = [torch.tensor(w, requires_grad=True) for w in case["wb"]]
    out, stats = g2e_train_apply(x0, wb, case["x0"].shape[2])
    (out * torch.tensor(case["dy"][rows])).sum().backward()
    k9 = {"out": out.detach(), "stats": [t.detach() for t in stats], "dx": x0.grad,
          "grads": [w.grad for w in wb]}
    x = torch.tensor(case["x"][rows], requires_grad=True)
    scale = torch.tensor(case["scale"], requires_grad=True)
    bias = torch.tensor(case["bias"], requires_grad=True)
    y, mean, var = bn_train_apply(x, scale, bias, 1e-5)
    (y * torch.tensor(case["dx_out"][rows])).sum().backward()
    k18 = {"y": y.detach(), "mean": mean.detach(), "var": var.detach(), "dx": x.grad,
           "grads": [scale.grad, bias.grad]}
    bn = BatchNorm(case["x"].shape[-1]).train()
    x = torch.tensor(case["x"][rows], requires_grad=True)
    (bn(x) * torch.tensor(case["dx_out"][rows])).sum().backward()
    plain = {"dx": x.grad, "grads": [bn.weight.grad, bn.bias.grad],
             "running": [bn.running_mean.clone(), bn.running_var.clone()]}
    return {"k9": k9, "k18": k18, "bn": plain}


class Draws:
    """A dataset whose samples are draws from the per-sample generator the
    Loader hands them, so a batch shows both the order and the seeds."""

    def __init__(self, n: int, points: int = 4):
        self.n, self.points = n, points

    def __len__(self) -> int:
        return self.n

    def get(self, i: int, rng):
        pts = (rng.standard_normal((self.points, 3)) + i).astype(np.float32)
        return pts, i % 7


def loader_batches(world: int = 1, rank_: int = 0) -> list[dict]:
    """Two epochs of a shuffled, seeded Loader over Draws(24) at a global
    batch of 8: this rank's slices."""
    loader = Loader(Draws(24), 8, collate_cls, shuffle=True, seed=3, drop_last=True,
                    rank=rank_, world=world)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def features(case: dict):
    """`extract_features` over 10 fixed clouds at test batches of 4 (the
    last padded): every rank's (features, labels)."""
    model = factory.build_pc_model(case["cfg"], device="cpu")
    model.load_state_dict(case["state"], strict=True)
    feats, labels = extract_features(trainer.make_feats_fn(model), Draws(10, 128), 4)
    return feats, labels


def collectives() -> dict:
    """all_reduce_sum and all_gather_rows with their gradients on this rank:
    x = rank + 1 (2 values)."""
    x = torch.full((2,), float(rank() + 1), requires_grad=True)
    y = all_reduce_sum(x)
    (y * torch.tensor([1.0, 2.0])).sum().backward()
    g = torch.full((1, 2), float(rank() + 1), requires_grad=True)
    rows = all_gather_rows(g)
    (rows * torch.arange(1.0, 1.0 + rows.numel()).reshape(rows.shape)).sum().backward()
    return {"sum": y.detach(), "sum_grad": x.grad, "rows": rows.detach(), "rows_grad": g.grad}


def run_checks(d: str) -> None:
    """Every check on this rank, then the two CLI runs (pretrain, and again
    with --resume; ft_cls --resume_training after the test's own spawned
    run), saved to d/rank{r}.pt."""
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {kind: run_step(kind, inp[kind]) for kind in STEPS}
    out["norms"] = run_norms(inp["norms"])
    out["loader"] = loader_batches(data_axis_size(), rank())
    out["features"] = features(inp["features"])
    out["collectives"] = collectives()
    out["dryrun"] = dryrun._dryrun_rank("cpu")
    from vipformer_tpu_torch.cli import ft_cls, pretrain

    for cfg in inp["clis"]["pretrain"]:
        out.setdefault("pretrain_cli", []).append(pretrain.main(cfg, "cpu"))
    out["ft_cls_cli"] = ft_cls.main(inp["clis"]["ft_cls_resume"], "cpu")
    torch.save(out, os.path.join(d, f"rank{rank()}.pt"))
