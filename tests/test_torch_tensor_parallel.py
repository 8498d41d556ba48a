"""The port's tensor parallelism (`--model_axis T`, vipformer_tpu_torch/
parallel/) on the CPU: four gloo ranks laid out as 2 data x 2 model indices
against JAX's `make_mesh(4, model_axis=2)` step and against the port's one
process over the same global batch.

One spawn of four ranks (`_torch_dp_worker.run_tp_checks`) runs every
multi-rank check with every attention, K6 and K11 gate forced (their plain
twins on the CPU, on each rank's H / T heads) and saves what it got; one
spawn of two ranks at model_axis 2 runs the ft_cls and pretrain CLIs'
`main` (the torchrun launch; `--num_devices 2 --model_axis 2`). The JAX
side runs XLA's attention on its mesh (no "fps" rng: FPS starts at 0, as
the port's without a generator); the initial weights are the port's
seed-made ones written as flax trees, and JAX's results cross back with
`convert.from_jax_variables`. The model is E1CL1SL-H4D128 (128 channels, so
that K4's, K6's and K7's gates take their sites; 2 heads of 32 a rank).

Bounds (f32, two SGD steps at lr 1e-3, no dropout; tests/test_parallel.py
:306-317's rate and bounds): losses rtol 1e-4 and parameters atol 2e-5 against JAX's mesh
and against one process; the eval logits atol 1e-4 against the replicated
forward; the clip's norm rtol 1e-4; shards, snapshots and the replicated
parameters under dropout bitwise.
"""

import concurrent.futures
import json

import jax
import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from vipformer_tpu import config as jconfig
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.parallel import make_mesh, param_shardings, place_state, shard_batch
from vipformer_tpu.parallel.sharding import tp_role_for_path as jax_tp_role_for_path
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.parallel import mesh as tmesh
from vipformer_tpu_torch.parallel import sharding as tsharding
from vipformer_tpu_torch.train import checkpoint as tckpt
from vipformer_tpu_torch.train.optim import clip_grad_global_norm

TINY = dict(jconfig.decode_arch_name("E1CL1SL-H4D128-L16-MR2"), group_size=8,
            num_pt_points=128, num_ft_points=128, img_height=24, img_width=24, patch_size=12,
            compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0, max_dpr=0.0)
W, T = 4, 2
LR = 1e-3  # tests/test_parallel.py:306-317's rate for these bounds
CLI = ["--synthetic_data", "true", "--arch", "E1CL1SL-H2D64-L16-MR2", "--group_size", "8",
       "--compute_dtype", "float32", "--device", "cpu", "--num_devices", "2", "--model_axis",
       "2", "--epochs", "1", "--save_freq", "1"]


_PARAM_NAMES = {"bias": "bias", "position_emb": "position_emb", "latent": "latent",
                "output_query": "output_query"}


def _to_jax(sd):
    """The port's state dict as flax (params, batch_stats) trees of numpy
    arrays: `convert.from_jax_variables` undone (a weight of two or more
    axes a kernel, transposed back; of one axis a scale)."""
    params, stats = {}, {}
    for key, v in sd.items():
        *path, leaf = key.split(".")
        v = v.detach().numpy()
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, leaf[len("running_"):]
        elif leaf == "weight":
            tree, name = params, "kernel" if v.ndim > 1 else "scale"
            v = v.T if v.ndim > 1 else v
        else:
            tree, name = params, _PARAM_NAMES[leaf]
        for k in path:
            tree = tree.setdefault(k, {})
        tree[name] = np.array(v, copy=True)
    return params, stats


def _init(models):
    """Seed-made port weights of each branch as JAX's (params, stats) trees
    ({branch: tree} each)."""
    params, stats = {}, {}
    for name, m in models.items():
        params[name], stats[name] = _to_jax(m.state_dict())
    return params, stats


def _jax_steps(kind, cfg, models, init, batch):
    """JAX's two SGD steps on make_mesh(4, model_axis=2): (losses, the
    parameters after them as the port's state dicts)."""
    params, stats = init
    if kind == "ft_cls":
        params, stats = params["pc"], stats["pc"]
    saved = jtrainer._rngs
    try:
        jtrainer._rngs = lambda key, n=2: {"dropout": jax.random.split(key, n)[0]}
        state, tx = jtrainer.create_state(cfg, params, stats)
        if kind == "pretrain":
            step = jtrainer.make_pretrain_step(cfg, models["pc"], models["img"], tx,
                                               neg_groups=W // T)
        else:
            step = jtrainer.make_cls_step(cfg, models["pc"], tx)
        mesh = make_mesh(W, model_axis=T)
        state, placed = place_state(state, mesh), shard_batch(batch, mesh)
        losses = []
        for _ in range(2):
            state, metrics = step(state, placed, LR, jax.random.key(1))
            losses.append(float(metrics["loss"]))
    finally:
        jtrainer._rngs = saved
        make_mesh(8, model_axis=1)
    new = jax.tree_util.tree_map(np.asarray, state.params)
    new = new if kind == "pretrain" else {"pc": new}
    return losses, {n: from_jax_variables({"params": p}) for n, p in new.items()}


def _variables(init):
    params, stats = init
    return {n: {"params": params[n], "batch_stats": stats[n]} for n in params}


def _states(init):
    params, stats = init
    return {n: from_jax_variables({"params": params[n], "batch_stats": stats[n]})
            for n in params}


def _one_process(kind, case):
    """The port's two steps in this process at model_axis 1 (plain routes):
    losses, parameters, and the last step's gradient norm."""
    state, step = worker.build("pretrain" if kind == "pretrain" else "ft_cls", case["cfg"],
                               case["states"], case.get("neg_groups", 1))
    losses = [float(step(state, case["batch"], case["lr"])[1]["loss"]) for _ in range(2)]
    norm = (float(clip_grad_global_norm(state.parameters(), float("inf")))
            if case["cfg"].grad_clip_norm is None else None)
    return losses, {n: m.state_dict() for n, m in state.models.items()}, norm


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The inputs, JAX's mesh steps, the one-process references, the four
    ranks' results and the two-rank CLI runs."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    inputs, jax_args = {}, {}
    jcfg = jconfig.Config(**TINY, optim="sgd", lr=LR, num_obj_classes=4)
    batch = {"points": rng.standard_normal((16, 128, 3)).astype(np.float32),
             "labels": (np.arange(16) % 4).astype(np.int64)}
    models = {"pc": jfactory.build_ft_cls(jcfg)}
    cfg = tconfig.Config(**TINY, optim="sgd", lr=LR, num_obj_classes=4)
    init = _init({"pc": tfactory.build_ft_cls(cfg, device="cpu", seed=5)})
    inputs["ft_cls"] = dict(cfg=cfg, states=_states(init), batch=batch, lr=LR,
                            variables=_variables(init))
    jax_args["ft_cls"] = (jcfg, models, init, batch)
    inputs["clip"] = dict(inputs["ft_cls"], cfg=cfg.replace(grad_clip_norm=0.1))
    inputs["dropout"] = dict(inputs["ft_cls"], cfg=cfg.replace(atten_drop=0.2, mlp_drop=0.2,
                                                                 max_dpr=0.2))
    jcfg = jconfig.Config(**TINY, optim="sgd", lr=LR)
    b = 8  # images offset per render: the image head's BatchNorms stay well conditioned
    pbatch = {"pc_t1": rng.standard_normal((b, 128, 3)).astype(np.float32),
              "pc_t2": rng.standard_normal((b, 128, 3)).astype(np.float32),
              "imgs": (rng.standard_normal((b, 24, 24, 3))
                       + 2.0 * rng.standard_normal((b, 1, 1, 3))).astype(np.float32)}
    models = {"pc": jfactory.build_pc_model(jcfg), "img": jfactory.build_img_model(jcfg)}
    pcfg = tconfig.Config(**TINY, optim="sgd", lr=LR)
    init = _init({"pc": tfactory.build_pc_model(pcfg, device="cpu", seed=6),
                  "img": tfactory.build_img_model(pcfg, device="cpu", seed=7)})
    inputs["pretrain"] = dict(cfg=pcfg, states=_states(init), batch=pbatch, lr=LR,
                              neg_groups=W // T, variables=_variables(init))
    jax_args["pretrain"] = (jcfg, models, init, pbatch)
    # a one-process AdamW snapshot (after one step, so its moments exist)
    snap = dict(inputs["ft_cls"], cfg=cfg.replace(optim="adamw", lr=1e-3), lr=1e-3,
                t1=str(d / "t1.ckpt"))
    state, step = worker.build("ft_cls", snap["cfg"], snap["states"])
    step(state, batch, snap["lr"])
    tckpt.save_state(snap["t1"], state, {"epoch": 0})
    inputs["snapshots"] = snap
    # 3 heads of 128 at D = 384: they do not divide T, and the raw tokens'
    # width takes K7's gate (K8 at the self-attention); at a rate of 0.1, so
    # that a wrong gradient (K7's LayerNorm's summed over the model group)
    # moves the parameters well past the bound
    wcfg = tconfig.Config(**dict(TINY, **tconfig.decode_arch_name("E1CL1SL-H3D384-L16-MR2")),
                          optim="sgd", lr=0.1, num_obj_classes=4)
    inputs["whole_heads"] = dict(
        cfg=wcfg, batch=batch, lr=0.1,
        states={"pc": tfactory.build_ft_cls(wcfg, device="cpu", seed=8).state_dict()})
    inputs["whole_heads_dropout"] = dict(
        inputs["whole_heads"], cfg=wcfg.replace(atten_drop=0.2, mlp_drop=0.2, max_dpr=0.2))
    inputs["head_split"] = torch.tensor(rng.standard_normal((16, 16, 128)), dtype=torch.float32)
    torch.save(inputs, d / "tp_inputs.pt")
    from vipformer_tpu_torch.cli import ft_cls, pretrain

    runs = str(d / "runs")
    clis = [("ft_cls", ft_cls.parse_args(CLI + [
                "--batch_size", "64", "--test_batch_size", "100", "--num_ft_points", "128",
                "--run_dir", runs, "--exp_name", "ft"])[0]),
            ("pretrain", pretrain.parse_args(CLI + [
                "--synthetic_size", "8", "--batch_size", "4", "--num_pt_points", "128",
                "--img_height", "24", "--img_width", "24", "--num_test_points", "128",
                "--run_dir", runs, "--exp_name", "pt"])[0])]

    def ranks_side():
        tmesh.spawn(worker.run_tp_checks, W, "cpu", (str(d),), model_axis=T)
        return tmesh.spawn(worker.run_tp_clis, 2, "cpu", (clis,), model_axis=2)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks_side)
        jax_out = {kind: _jax_steps(kind, *args) for kind, args in jax_args.items()}
        one = {kind: _one_process(kind, inputs[kind])
               for kind in ("ft_cls", "pretrain", "clip", "whole_heads")}
        cli_out = ranks_done.result()
    ranks = [torch.load(d / f"tp{r}.pt", weights_only=False) for r in range(W)]
    return dict(inputs=inputs, jax=jax_out, one=one, ranks=ranks, clis=dict(zip(
        ("ft_cls", "pretrain"), cli_out)), runs=d / "runs", dir=d,
        jax_params={k: a[2][0] for k, a in jax_args.items()})


def _close(got, want, atol, name):
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    assert got.shape == want.shape and err <= atol, (name, tuple(got.shape), err)


@pytest.mark.parametrize("kind", ["ft_cls", "pretrain"])
def test_tp_steps_match_jax_mesh_and_one_process(tp, kind):
    """Two f32 SGD steps on 2 data x 2 model ranks, the kernels' twins on
    each rank's heads, from each rank's slices of JAX's global arrays
    (`convert.jax_state_for`): every rank's losses and full parameters
    against JAX's make_mesh(4, model_axis=2) step and the port's one
    process."""
    jax_losses, jax_params = tp["jax"][kind]
    one_losses, one_params, _ = tp["one"][kind]
    for got in (r[kind] for r in tp["ranks"]):
        assert got["not_jax_slices"] == [], got["not_jax_slices"]
        losses = [m["loss"] for m in got["metrics"]]
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
        np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
        for n, params in jax_params.items():
            for k, v in params.items():
                _close(got["full"][n][k], v, 2e-5, f"jax {n}.{k}")
                _close(got["full"][n][k], one_params[n][k], 2e-5, f"one {n}.{k}")


def test_clip_matches_one_process(tp):
    """The clip's global norm is the full parameters' (the sharded squares
    summed over the model group, the replicated ones once): the norm of
    the last step's gradients and two steps clipped at 0.1 as one
    process's."""
    want = tp["one"]["ft_cls"][2]
    assert want > 0.1  # the clipped case below clips
    losses, params, _ = tp["one"]["clip"]
    for r in tp["ranks"]:
        np.testing.assert_allclose(r["ft_cls"]["norm"], want, rtol=1e-4)
        np.testing.assert_allclose([m["loss"] for m in r["clip"]["metrics"]], losses, rtol=1e-4)
        for k, v in params["pc"].items():
            _close(r["clip"]["full"]["pc"][k], v, 2e-5, k)


def test_tp_eval_forward_matches_replicated(tp):
    """The eval forward on each rank's heads (K4 and K6, then K4 and K15,
    through their twins) against the replicated forward of its rows."""
    case = tp["inputs"]["ft_cls"]
    model = tfactory.build_ft_cls(case["cfg"], device="cpu")
    model.load_state_dict(case["states"]["pc"])
    with torch.inference_mode():
        want = model(torch.as_tensor(case["batch"]["points"]))[0]
    for r, got in enumerate(tp["ranks"]):
        rows = tsharding.rank_rows(16, r // T, W // T)
        for route in ("k6", "k15"):
            _close(got["eval"][route], want[rows], 1e-4, route)


def test_kernels_run_on_local_heads(tp):
    """Each rank's K7 and K8 (train), K4, K6 and K15 (eval) calls carry H / T
    heads and their widths, and K11 the local slices of the sharded
    Denses, at the one process's number of sites."""
    heads, width = TINY["num_ca_heads"] // T, TINY["num_latent_channels"] // T
    for r in tp["ranks"]:
        train, evals = r["train_routes"], r["eval_routes"]
        names = {c[0] for c in train + evals}
        assert names == set(worker.ROUTES), names
        for name, h, w in train + evals:
            if name != "dense_apply":
                assert (h, w) == (heads, width), (name, h, w)
        dense = {c[2] for c in train if c[0] == "dense_apply"}
        # the MLPs' 128 -> 256 and 256 -> 128 Denses as (128, 128) slices,
        # the q/k/v projections' (128, 64) and o_proj's (64, 128); no Dense
        # of those full shapes takes K11 (the heads' Denses see 8 rows)
        assert {(128, 128), (128, 64), (64, 128)} <= dense, dense
        assert not dense & {(128, 256), (256, 128)}, dense


def test_dense_roles_match_jax_placement(tp):
    """Every Dense's role equals JAX's: its path's rule (`tp_role_for_path`)
    and the spec `param_shardings` gives its kernel on make_mesh(4,
    model_axis=2), for every branch of both steps."""
    for kind in ("ft_cls", "pretrain"):
        roles = tp["ranks"][0][kind]["roles"]
        checked = 0
        for n, p in tp["jax_params"][kind].items():
            try:
                specs = param_shardings(p, make_mesh(W, model_axis=T))
            finally:
                make_mesh(8, model_axis=1)
            flat = jax.tree_util.tree_flatten_with_path(specs)[0]
            for path, sh in flat:
                keys = "/".join(str(getattr(k, "key", k)) for k in path)
                if not keys.endswith("/kernel") or sh.spec == jax.sharding.PartitionSpec():
                    want = None
                else:
                    want = "col" if sh.spec[1] is not None else "row"
                name = f"{n}." + keys[:-len("/kernel")].replace("/", ".")
                if name in roles:
                    assert roles[name] == want, (name, roles[name], want)
                    assert tsharding.tp_role_for_path(keys) == jax_tp_role_for_path(keys), keys
                    checked += 1
        assert checked == len(roles) and any(roles.values()), (checked, len(roles))


def test_shards_hold_a_Tth_and_concatenate_to_the_full_state(tp):
    """Each rank stores 1/T of every sharded weight (and of its optimizer
    moments): its parameter bytes are the full model's less (1 - 1/T) of
    the sharded tensors'; the two model ranks' shards concatenated along
    the split axis equal the gathered full tensor bitwise; the data ranks
    of one model index hold equal shards."""
    for kind in ("ft_cls", "pretrain"):
        got = [r[kind] for r in tp["ranks"]]
        full = got[0]["full"]
        full_bytes = sum(v.numel() * 4 for n in got[0]["params"] for k, v in full[n].items()
                         if k in got[0]["params"][n])
        saved = 0
        for n, params in got[0]["params"].items():
            for k, (shard, dim) in params.items():
                if dim is None:
                    continue
                assert shard.shape[dim] * T == full[n][k].shape[dim], (k, shard.shape)
                saved += full[n][k].numel() * 4 * (T - 1) // T
                cat = torch.cat([got[m]["params"][n][k][0] for m in range(T)], dim)
                assert torch.equal(cat, full[n][k]), k
                assert torch.equal(shard, got[T]["params"][n][k][0]), k
        assert saved > 0 and all(g["bytes"] == full_bytes - saved for g in got), kind
        for shape, moments in got[0]["moments"]:
            assert moments and all(s == shape for s in moments.values()), (shape, moments)


def test_replicated_parameters_bitwise_equal_with_dropout(tp):
    """Two steps with attention dropout, residual dropout and DropPath on
    (K7's and K8's seeds offset per shard, the generator keyed on the data
    index): every replicated parameter is bitwise equal on all four ranks,
    and every shard on the ranks of its model index."""
    got = [r["dropout"] for r in tp["ranks"]]
    for n, params in got[0].items():
        for k, (v, dim) in params.items():
            same = range(W) if dim is None else range(0, W, T)
            assert all(torch.equal(v, got[r][n][k][0]) for r in same), k
    ref = tp["inputs"]["dropout"]["states"]["pc"]
    moved = [k for k, (v, dim) in got[0]["pc"].items() if dim is None and not torch.equal(
        v, ref[k])]
    assert moved, "no replicated parameter moved"


def test_snapshot_from_one_process_resumes_at_model_axis_2(tp):
    """A one-process snapshot (AdamW, after a step) restored at T = 2: each
    rank's shards and moments are the file's slices, bitwise."""
    ckpt = tckpt.load_checkpoint(tp["inputs"]["snapshots"]["t1"])
    params = [k for k, _ in tfactory.build_ft_cls(
        tp["inputs"]["snapshots"]["cfg"], device="cpu").named_parameters()]
    for r, got in enumerate(tp["ranks"]):
        snap = got["snapshots"]
        assert snap["restored_step"] == ckpt["step"]
        for i, k in enumerate(params):
            shard, dim = snap["restored"]["pc"][k]
            want = ckpt["pc"][k]
            moments = ckpt["optimizer"]["state"][i]
            if dim is not None:
                n = want.shape[dim] // T
                cut = lambda t: t.narrow(dim, (r % T) * n, n)  # noqa: E731
                want, moments = cut(want), {m: cut(v) if v.ndim else v
                                            for m, v in moments.items()}
            assert torch.equal(shard, want), k
            for m, v in moments.items():
                assert torch.equal(snap["restored_moments"][i][m], v), (k, m)


def test_snapshot_from_model_axis_2_resumes_in_one_process(tp):
    """The ranks' T = 2 snapshot (written by the chief, the shards and
    moments gathered) restored in one process: the parameters and moments
    are the ranks' gathered ones, bitwise."""
    snap = tp["ranks"][0]["snapshots"]
    case = tp["inputs"]["snapshots"]
    state, _ = worker.build("ft_cls", case["cfg"], case["states"])
    tckpt.restore_state(str(tp["dir"] / "t2.ckpt"), state)
    for k, v in state.models["pc"].state_dict().items():
        assert torch.equal(v, snap["full"][k]), k
    want = snap["full_optimizer"]["state"]
    for i, p in enumerate(state.parameters()):
        for m, v in state.optimizer.state[p].items():
            assert torch.equal(v, want[i][m]), (i, m)


def _lines(root):
    return [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("cli", ["ft_cls", "pretrain"])
def test_model_axis_runs(tp, cli):
    """`--num_devices 2 --model_axis 2` runs the CLI to its end on two
    ranks (one data index, the heads split): the chief writes one metrics
    line and each log line once, the log names W = 2 = 1 x 2, and the
    best checkpoint is full-layout (it loads strictly into a one-process
    model)."""
    root = tp["runs"] / "ViPFormerTPU" / ("ft" if cli == "ft_cls" else "pt")
    assert [m["step"] for m in _lines(root)] == [0]
    log = "".join(p.read_text() for p in sorted(root.glob("*.log")))
    assert log.count(f"{cli} on cpu x 2:") == 1 and "W = 2 = 1 x 2 (data x model)" in log
    assert np.isfinite(tp["clis"][cli]["best_acc"])
    name = "model_best" if cli == "ft_cls" else "pc_model_best"
    cfg = tconfig.Config(**tconfig.decode_arch_name("E1CL1SL-H2D64-L16-MR2"), group_size=8,
                         num_obj_classes=40)
    model = (tfactory.build_ft_cls if cli == "ft_cls" else tfactory.build_pc_model)(
        cfg, device="cpu")
    model.load_state_dict(tckpt.branch_state(tckpt.load_checkpoint(
        str(root / "models" / f"{name}.ckpt"))), strict=True)


def test_head_split_and_layernorm_kernels_on_local_heads(tp):
    """K14 (a v width other than q/k's) and K17 (forced) stay live under
    tensor parallelism, where JAX turns them off on a mesh (attention.py
    :104-109, layernorm.py:154-158): each rank's K14 takes its 2 of 4
    heads, and the block's eval output is the one-process output."""
    want, heads = worker.head_split_eval(tp["inputs"]["head_split"])
    assert heads == [(4, 64)]
    for r in tp["ranks"]:
        got, heads = r["head_split"]
        assert heads == [(4 // T, 64)], heads
        _close(got, want, 1e-5, "head-split block")


def test_collectives_along_each_axis(tp):
    """Rank r is data index r // 2, model index r % 2; all_reduce_sum (its
    gradient summed over the same group) and all_gather_rows run over its
    data group (ranks of one model index), all_reduce_ over either group
    (the model group: ranks of one data index), and broadcast_object hands
    every rank the chief's value."""
    for r, got in enumerate(c["collectives"] for c in tp["ranks"]):
        i, m = r // T, r % T
        assert got["index"] == (i, m)
        data = [m + T * j + 1.0 for j in range(W // T)]
        model = [T * i + k + 1.0 for k in range(T)]
        assert got["data"] == (sum(data), 2.0 * (W // T), data)
        assert got["sums"] == {"data": sum(data), "model": sum(model)}
        assert got["broadcast"] == 0


def test_heads_that_do_not_divide_stay_whole(tp):
    """3 heads at model_axis 2 (JAX shards such kernels mid-head and runs
    XLA's attention): each attention stays whole on every model rank, with
    one log line naming it, its MLP still shards, K7 and K8 run all 3
    heads with no model-group sum of K7's LayerNorm gradients, and two
    steps match one process."""
    losses, params, _ = tp["one"]["whole_heads"]
    for r in tp["ranks"]:
        got = r["whole_heads"]
        if r is tp["ranks"][0]:
            assert len(got["log"]) == 2 and all("keeps its 3 heads whole" in line
                                                for line in got["log"]), got["log"]
        for k, role in got["roles"].items():
            want = ({"MLP_0.Dense_0": "col", "MLP_0.Dense_1": "row"}.get(k[-13:])
                    if "MLP_0" in k else None)
            assert role == want, (k, role)
        attn = {(name, h, w) for name, h, w in got["routes"] if name != "dense_apply"}
        assert attn == {("flash_attention_train_kv", 3, 384),
                        ("flash_attention_train", 3, 384)}, attn
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], losses, rtol=1e-4)
        for k, v in params["pc"].items():
            _close(got["full"][k], v, 2e-5, k)


def test_whole_attention_replicated_bitwise_with_dropout(tp):
    """The 3-head model with attention dropout, residual dropout and DropPath
    on: K7 and K8 draw the same masks on the model ranks of a data index
    (their seed offset by the data index alone), so after two steps every
    replicated parameter, the whole attentions' among them, is bitwise
    equal on all four ranks, and every shard on the ranks of its model
    index."""
    got = [r["whole_heads_dropout"] for r in tp["ranks"]]
    for n, params in got[0].items():
        for k, (v, dim) in params.items():
            same = range(W) if dim is None else range(0, W, T)
            assert all(torch.equal(v, got[r][n][k][0]) for r in same), k
    ref = tp["inputs"]["whole_heads_dropout"]["states"]["pc"]
    moved = [k for k, (v, dim) in got[0]["pc"].items()
             if dim is None and "attention.k_proj" in k and not torch.equal(v, ref[k])]
    assert moved, "no whole attention's k_proj moved"
