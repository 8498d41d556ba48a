"""The ranks' side of tests/test_torch_parallel.py: importable by the
spawned ranks (which must not import JAX, as the test files do).

`run_checks(d)` runs on each rank of a two-rank gloo group on the CPU
(`vipformer_tpu_torch.parallel.mesh.spawn`): it reads `d/inputs.pt` (the
test's seed-made weights and global batches), runs every data-parallel
check on this rank's slice and saves what it got to `d/rank{r}.pt` for the
test process to hold against JAX's mesh step and the port's one-process
run. The same helpers build the one-process references in the test.

`run_tp_checks(d)` and `run_tp_clis(cfgs)` are the ranks' side of
tests/test_torch_tensor_parallel.py (four ranks as 2 data x 2 model
indices; two ranks at model_axis 2 for the CLIs).
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
    data_index,
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


# ----------------------------------------------------- tensor parallelism
# The ranks' side of tests/test_torch_tensor_parallel.py: `run_tp_checks`
# runs on each rank of a four-rank gloo group laid out as 2 data x 2 model
# indices (`spawn(..., model_axis=2)`), `run_tp_clis` on a two-rank group
# at model_axis 2 (the CLIs' `main`, as under torchrun).
ROUTES = ("flash_attention_train_kv", "flash_attention_train", "fused_attention_packed_kv_ln",
          "fused_attention_packed_small_qkv_ln", "fused_attention_packed_kv", "dense_apply")


def force_kernels(on: bool | None) -> None:
    """Every attention, K6 and K11 gate forced on (their twins on the CPU),
    or back to auto."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense

    kattn.USE_FUSED_ATTENTION = kattn.USE_SA_QKV_LN = kdense.USE_DENSE_GRAD = on


def spy_routes(calls: list):
    """Record (route, heads, packed width) of each call of the kernels'
    wrappers that nn/layers.py makes (K11: its weight's [Cin, Cout])."""
    from vipformer_tpu_torch.nn import layers

    def wrap(mod, name):
        fn = getattr(mod, name)

        def spy(*a, **k):
            if name == "dense_apply":
                calls.append((name, None, tuple(a[1].shape)))
            else:
                heads = k.get("num_heads", a[7] if "kv" in name and "train" in name else
                              a[4] if name == "flash_attention_train" else None)
                width = a[3 if "qkv" in name else 0].shape[-1]  # q's (K6: wq's)
                calls.append((name, heads, width))
            return fn(*a, **k)

        setattr(mod, name, spy)

    for name in ROUTES:
        wrap(layers.kdense if name == "dense_apply" else
             layers.kflash if "train" in name else layers.kattn, name)


def build_tp(kind: str, cfg, states: dict, neg_groups: int = 1, log=None):
    """`build` with every model sharded over the model axis after its full
    state is loaded, and the state placed from the chief."""
    from vipformer_tpu_torch.parallel import place_state, shard_model

    state, step = build(kind, cfg, states, neg_groups)
    for m in state.models.values():
        shard_model(m, log)
    state = trainer.create_state(cfg, state.models)
    place_state(state)
    models = state.models
    if kind == "pretrain":
        step = trainer.make_pretrain_step(cfg, models["pc"], models["img"], neg_groups)
    else:
        step = trainer.make_cls_step(cfg, models["pc"])
    return state, step


def run_steps(state, step, case: dict, n: int = 2, generator=None) -> list:
    return [{k: float(v) for k, v in step(state, shard_batch(case["batch"]), case["lr"],
                                          generator)[1].items()} for _ in range(n)]


def shards_of(state) -> dict:
    """{model: {name: (tensor, tp_dim or None)}} of this rank's parameters,
    every sharded parameter's optimizer moments' shapes, and the rank's
    parameter bytes."""
    from vipformer_tpu_torch.parallel.sharding import sharded

    out = {n: {k: (p.detach().clone(), getattr(p, "tp_dim", None))
               for k, p in m.named_parameters()} for n, m in state.models.items()}
    moments = [(tuple(p.shape), {k: tuple(v.shape) for k, v in state.optimizer.state[p].items()
                                 if isinstance(v, torch.Tensor)})
               for p in state.parameters() if sharded(p) and p in state.optimizer.state]
    nbytes = sum(p.numel() * p.element_size() for p in state.parameters())
    return {"params": out, "moments": moments, "bytes": nbytes}


def tp_whole_heads(case: dict) -> dict:
    """Two ft_cls steps of a model whose 3 heads do not divide the model
    axis (K7's and K8's twins forced on all of them): its log lines, Dense
    roles, losses and full parameters."""
    from vipformer_tpu_torch.nn.layers import Dense
    from vipformer_tpu_torch.parallel import full_state_dict

    lines: list = []
    state, step = build_tp("ft_cls", case["cfg"], case["states"], log=lines.append)
    model = state.models["pc"]
    return {"log": lines, "metrics": run_steps(state, step, case),
            "roles": {k: d.tp_role for k, d in model.named_modules() if isinstance(d, Dense)},
            "full": {k: v.clone() for k, v in full_state_dict(model).items()}}


def tp_step_case(kind: str, case: dict) -> dict:
    """Two steps of `kind` over this rank's rows and heads: losses, the
    gathered full tensors, this rank's shards, the Dense roles and the
    pre-clip gradient norm of the last step."""
    from vipformer_tpu_torch.nn.layers import Dense
    from vipformer_tpu_torch.parallel import full_state_dict
    from vipformer_tpu_torch.train.optim import clip_grad_global_norm

    from vipformer_tpu_torch.convert import jax_state_for

    state, step = build_tp(kind, case["cfg"], case["states"], case.get("neg_groups", 1))
    # each shard placed from the chief is this rank's slice of JAX's array
    wrong = [f"{n}.{k}" for n, m in state.models.items()
             for k, v in jax_state_for(m, case["variables"][n]).items()
             if not torch.equal(m.state_dict()[k], v)]
    metrics = run_steps(state, step, case)
    out = {"metrics": metrics, **shards_of(state), "not_jax_slices": wrong,
           "full": {n: {k: v.clone() for k, v in full_state_dict(m).items()}
                    for n, m in state.models.items()},
           "roles": {f"{n}.{k}": d.tp_role for n, m in state.models.items()
                     for k, d in m.named_modules() if isinstance(d, Dense)}}
    if case["cfg"].grad_clip_norm is None:
        out["norm"] = float(clip_grad_global_norm(state.parameters(), float("inf")))
    return out


def tp_eval(case: dict) -> dict:
    """The ft_cls model's eval logits on this rank's rows: K4 + K6, then K4
    + K15 (K6 off), through the twins on local heads."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    state, _ = build_tp("ft_cls", case["cfg"], case["states"])
    model = state.models["pc"]
    model.eval()
    pts = torch.as_tensor(shard_batch(case["batch"])["points"])
    out = {}
    for name, qkv_ln in (("k6", True), ("k15", False)):
        kattn.USE_SA_QKV_LN = qkv_ln
        with torch.inference_mode():
            out[name] = model(pts)[0].clone()
    kattn.USE_SA_QKV_LN = True
    return out


def tp_dropout(case: dict) -> dict:
    """Two steps with dropout and DropPath on, the generator keyed on the
    data index: every parameter after them."""
    from vipformer_tpu_torch.parallel import rank_seed

    state, step = build_tp("ft_cls", case["cfg"], case["states"])
    gen = torch.Generator().manual_seed(rank_seed(case["cfg"].seed))
    run_steps(state, step, case, generator=gen)
    return shards_of(state)["params"]


def tp_snapshots(case: dict, d: str) -> dict:
    """The one-process snapshot restored at model_axis 2 (shards and
    moments as restored), then one step and a snapshot of this layout
    (d/t2.ckpt) with its gathered tensors and moments."""
    from vipformer_tpu_torch.parallel import full_optimizer_state, full_state_dict
    from vipformer_tpu_torch.train.checkpoint import restore_state, save_state

    state, step = build_tp("ft_cls", case["cfg"], case["states"])
    restore_state(case["t1"], state)

    def moments():
        return [{k: v.clone() for k, v in state.optimizer.state[p].items()}
                for p in state.parameters()]

    out = {"restored": shards_of(state)["params"], "restored_moments": moments(),
           "restored_step": state.step}
    run_steps(state, step, case, n=1)
    save_state(os.path.join(d, "t2.ckpt"), state, {"epoch": 0})
    out["full"] = {k: v.clone() for k, v in full_state_dict(state.models["pc"]).items()}
    out["full_optimizer"] = full_optimizer_state(state.optimizer)
    return out


class HeadSplitBlock(torch.nn.Module):
    """One SelfAttentionLayer whose v width (256) differs from its q/k
    width (128), so that no packed kernel takes its attention: K14's site
    (and, forced, K17 at its LayerNorms), under the flax-style names the
    sharding rules match."""

    def __init__(self):
        super().__init__()
        from vipformer_tpu_torch.nn.layers import SelfAttentionLayer

        torch.manual_seed(11)
        self.SelfAttentionLayer_0 = SelfAttentionLayer(128, 4, 2, v_channels=256)

    def forward(self, x):
        return self.SelfAttentionLayer_0(x)


def head_split_eval(x) -> tuple:
    """HeadSplitBlock's eval output at K14's and K17's sites, forced (their
    twins on the CPU), sharded over the model axis where there is one, and
    the heads K14 took a call."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln
    from vipformer_tpu_torch.parallel import shard_model

    block = shard_model(HeadSplitBlock()).eval()
    heads, fused = [], kattn.fused_attention

    def spy(q, k, v, **kw):
        heads.append((q.shape[1], v.shape[-1]))
        return fused(q, k, v, **kw)

    kattn.fused_attention, kattn.USE_FUSED_ATTENTION, kln.USE_LAYERNORM = spy, True, True
    try:
        with torch.inference_mode():
            return block(x).clone(), heads
    finally:
        kattn.fused_attention, kattn.USE_FUSED_ATTENTION, kln.USE_LAYERNORM = fused, None, None


def tp_collectives() -> dict:
    """The collectives on this rank of the 2 x 2 layout, x = rank + 1:
    all_reduce_sum and its gradient and all_gather_rows over the data
    group, all_reduce_ along each axis, and broadcast_object's value."""
    from vipformer_tpu_torch.parallel.mesh import (MODEL_AXIS, all_reduce_, broadcast_object,
                                                   model_index)

    out = {"index": (data_index(), model_index())}
    x = torch.full((1,), float(rank() + 1), requires_grad=True)
    y = all_reduce_sum(x)
    (2.0 * y).sum().backward()
    rows = all_gather_rows(torch.full((1,), float(rank() + 1)))
    out["data"] = (float(y), float(x.grad), rows.tolist())
    out["sums"] = {axis: float(all_reduce_(torch.full((1,), float(rank() + 1)), axis))
                   for axis in ("data", MODEL_AXIS)}
    out["broadcast"] = broadcast_object(rank())
    return out


def run_tp_checks(d: str) -> None:
    """Every tensor-parallel check on this rank, saved to d/tp{r}.pt."""
    inp = torch.load(os.path.join(d, "tp_inputs.pt"), weights_only=False)
    force_kernels(True)
    calls: list = []
    spy_routes(calls)
    out = {kind: tp_step_case("pretrain" if kind == "pretrain" else "ft_cls", inp[kind])
           for kind in ("ft_cls", "pretrain", "clip")}
    out["train_routes"] = list(calls)
    calls.clear()
    out["eval"] = tp_eval(inp["ft_cls"])
    out["eval_routes"] = list(calls)
    out["dropout"] = tp_dropout(inp["dropout"])
    calls.clear()
    out["whole_heads"] = tp_whole_heads(inp["whole_heads"])
    out["whole_heads"]["routes"] = list(calls)
    out["whole_heads_dropout"] = tp_dropout(inp["whole_heads_dropout"])
    out["snapshots"] = tp_snapshots(inp["snapshots"], d)
    force_kernels(None)
    out["head_split"] = head_split_eval(inp["head_split"])
    out["collectives"] = tp_collectives()
    torch.save(out, os.path.join(d, f"tp{rank()}.pt"))


def run_tp_clis(cfgs: list) -> list:
    """Each CLI's `main` on this two-rank group at model_axis 2."""
    import importlib

    return [importlib.import_module(f"vipformer_tpu_torch.cli.{cli}").main(cfg, "cpu")
            for cli, cfg in cfgs]
