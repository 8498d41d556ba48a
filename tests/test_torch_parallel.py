"""The port's data parallelism (vipformer_tpu_torch/parallel/) on the CPU:
two gloo ranks against JAX's two-device mesh and against the port's own
one-process run over the same global batch.

One spawn of two ranks (`_torch_dp_worker.run_checks`) runs every check on
its slice and saves what it got; a second one is the ft_cls CLI's own
(`--num_devices 2`). The JAX side builds its step on `make_mesh(2)` with
`shard_batch` / `place_state` (tests/test_parallel.py:61-118) on the
conftest's virtual CPU devices, with no "fps" rng (FPS starts at 0, as the
port's without a generator); the weights cross with
`convert.from_jax_variables`. Both JAX-compared steps use SGD at lr 1, so
each parameter's update is its gradient.

Tolerances (f32, sums in other orders), relative to max(1, max |ref|):
metrics 1e-5, parameters 2e-4 and BatchNorm statistics 1e-4 against JAX
(the bounds of tests/test_torch_pretrain_step.py); against the port's one
process, SGD at lr 1e-2 and the parameters within 2e-5 (JAX's own DP
test), the gradients within 2e-4, the statistics within 1e-4; the kernel
twins' outputs within 1e-5 and their gradients within 1e-4; the Loader's
rank slices bitwise; the running statistics equal on both ranks.
"""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from vipformer_tpu import config as jconfig
from vipformer_tpu.models import factory as jfactory
from vipformer_tpu.parallel import make_mesh, place_state, shard_batch
from vipformer_tpu.train import trainer as jtrainer
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.data.pipeline import Loader, collate_cls
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.models.crossformer import init_weights
from vipformer_tpu_torch.nn.pointnet import Group2Emb
from vipformer_tpu_torch.parallel import mesh as tmesh
from vipformer_tpu_torch.parallel import sharding as tsharding

TINY = dict(jconfig.decode_arch_name("E1CL1SL-H4D32-L16-MR2"), group_size=8, num_pt_points=128,
            num_ft_points=128, img_height=24, img_width=24, patch_size=12,
            compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0, max_dpr=0.0)
SEG = dict(jconfig.decode_arch_name("E1CL3SL-H2D128-L16-MR2"), group_size=8, num_ft_points=128,
           layer_idx=(1, 2, 3), compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0,
           max_dpr=0.0)
CLI = ["--synthetic_data", "true", "--arch", "E1CL1SL-H2D64-L16-MR2", "--group_size", "8",
       "--compute_dtype", "float32", "--device", "cpu", "--num_devices", "2", "--save_freq",
       "1"]
JAX_LR, PORT_LR = 1.0, 1e-2
W = 2


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor) else want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max() if want.size else 0.0), (name, err)


def _pretrain_batch(rng, b):
    # each image its own colour offset, and b = 8: the projection heads'
    # batch-statistics BatchNorms over b (image) and 2b (point) rows stay
    # well conditioned (at b = 4 two f32 summation orders of the fast
    # variance move the loss by 3e-5; test_torch_pretrain_step.py)
    return {"pc_t1": rng.standard_normal((b, 128, 3)).astype(np.float32),
            "pc_t2": rng.standard_normal((b, 128, 3)).astype(np.float32),
            "imgs": (rng.standard_normal((b, 24, 24, 3))
                     + 2.0 * rng.standard_normal((b, 1, 1, 3))).astype(np.float32)}


def _jax_init(models, args, seeds):
    """JAX's initial variables of each branch, as (params, stats) trees."""
    params, stats = {}, {}
    for (name, model), a, seed in zip(models.items(), args, seeds):
        params[name], stats[name] = jtrainer.init_variables(model, a, seed)
    return params, stats


def _jax_mesh_step(kind, cfg, models, init, batch):
    """JAX's optimizer step on make_mesh(2) over the global batch from the
    variables `init`: (metrics, new variables), as host arrays."""
    params, stats = init
    if kind == "ft_cls":
        params, stats = params["pc"], stats["pc"]
    saved = jtrainer._rngs
    try:
        jtrainer._rngs = lambda key, n=2: {"dropout": jax.random.split(key, n)[0]}
        state, tx = jtrainer.create_state(cfg, params, stats)
        if kind == "pretrain":
            step = jtrainer.make_pretrain_step(cfg, models["pc"], models["img"], tx, neg_groups=W)
        else:
            step = jtrainer.make_cls_step(cfg, models["pc"], tx)
        mesh = make_mesh(W)
        state, metrics = step(place_state(state, mesh), shard_batch(batch, mesh), JAX_LR,
                              jax.random.key(1))
    finally:
        jtrainer._rngs = saved
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    new = (host(state.params), host(state.batch_stats))
    if kind == "ft_cls":
        new = ({"pc": new[0]}, {"pc": new[1]})
    return {k: float(v) for k, v in metrics.items()}, new


def _states(init):
    params, stats = init
    return {n: from_jax_variables({"params": params[n], "batch_stats": stats[n]})
            for n in params}


def _port_states(kind, cfg):
    if kind in ("pretrain", "global_negatives"):
        return {"pc": tfactory.build_pc_model(cfg, device="cpu", seed=5).state_dict(),
                "img": tfactory.build_img_model(cfg, device="cpu", seed=6).state_dict()}
    build = {"partseg": tfactory.build_ft_partseg, "semseg": tfactory.build_ft_semseg}[kind]
    return {"pc": build(cfg, device="cpu", seed=7).state_dict()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """JAX's mesh steps, the inputs, the ranks' results and the ft_cls CLI's
    own two-rank run."""
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    inputs, jax_steps = {}, {}
    # the pretrain and ft_cls steps against JAX's mesh: the initial
    # variables here, the mesh steps while the ranks run
    jcfg = jconfig.Config(**TINY, optim="sgd", lr=JAX_LR)
    batch = _pretrain_batch(rng, 8)
    models = {"pc": jfactory.build_pc_model(jcfg), "img": jfactory.build_img_model(jcfg)}
    init = jax.tree_util.tree_map(np.asarray, _jax_init(
        models, ((jnp.asarray(batch["pc_t1"]),), (jnp.asarray(batch["imgs"]),)),
        (jcfg.seed, jcfg.seed + 10)))
    inputs["pretrain"] = dict(cfg=tconfig.Config(**TINY, optim="sgd", lr=JAX_LR),
                              states=_states(init), batch=batch, lr=JAX_LR, neg_groups=W)
    jax_steps["pretrain"] = (jcfg, models, init, batch)
    jcfg = jconfig.Config(**TINY, optim="sgd", lr=JAX_LR, num_obj_classes=4)
    batch = {"points": rng.standard_normal((16, 128, 3)).astype(np.float32),
             "labels": (np.arange(16) % 4).astype(np.int64)}
    models = {"pc": jfactory.build_ft_cls(jcfg)}
    init = jax.tree_util.tree_map(np.asarray, _jax_init(
        models, ((jnp.asarray(batch["points"]),),), (jcfg.seed,)))
    inputs["ft_cls"] = dict(cfg=tconfig.Config(**TINY, optim="sgd", lr=JAX_LR,
                                               num_obj_classes=4),
                            states=_states(init), batch=batch, lr=JAX_LR)
    jax_steps["ft_cls"] = (jcfg, models, init, batch)
    # partseg, semseg and --global_negatives against the port's one process
    cfg = tconfig.Config(**TINY, optim="sgd", lr=PORT_LR, global_negatives=True)
    inputs["global_negatives"] = dict(cfg=cfg, states=_port_states("pretrain", cfg),
                                      batch=_pretrain_batch(rng, 8), lr=PORT_LR, neg_groups=W)
    cfg = tconfig.Config(**SEG, optim="sgd", lr=PORT_LR, grad_clip_norm=10.0)
    inputs["partseg"] = dict(cfg=cfg, states=_port_states("partseg", cfg), lr=PORT_LR, batch={
        "points": rng.standard_normal((8, 128, 3)).astype(np.float32),
        "obj_labels": rng.integers(0, 16, 8).astype(np.int64),
        "seg": rng.integers(0, 50, (8, 128)).astype(np.int64)})
    cfg = tconfig.Config(**dict(SEG, num_ft_points=256), optim="sgd", lr=PORT_LR,
                         point_channels=6, num_obj_classes=13)
    inputs["semseg"] = dict(cfg=cfg, states=_port_states("semseg", cfg), lr=PORT_LR, batch={
        "points": rng.uniform(0, 1, (8, 256, 6)).astype(np.float32),
        "seg": rng.integers(0, 13, (8, 256)).astype(np.int64)})
    # K9's and K18's twins and the plain BatchNorm
    m = init_weights(Group2Emb(3, 32), 0)
    affine = [1 + 0.2 * rng.standard_normal(64), 0.1 * rng.standard_normal(64),
              1 + 0.2 * rng.standard_normal(256), 0.1 * rng.standard_normal(256)]
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, *affine[:2], m.Dense_1.weight.t(),
          m.Dense_1.bias, m.Dense_2.weight.t(), m.Dense_2.bias, *affine[2:],
          m.Dense_3.weight.t(), m.Dense_3.bias]
    inputs["norms"] = dict(
        x0=(0.3 * rng.standard_normal((4, 4, 8, 3))).astype(np.float32),
        wb=[np.asarray(w.detach() if isinstance(w, torch.Tensor) else w, np.float32)
            for w in wb],
        dy=rng.standard_normal((4, 4, wb[10].shape[1])).astype(np.float32),
        x=(rng.standard_normal((4, 16, 8)) + 1.0).astype(np.float32),
        scale=(1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(8)).astype(np.float32),
        dx_out=rng.standard_normal((4, 16, 8)).astype(np.float32))
    fcfg = tconfig.Config(**TINY)
    inputs["features"] = dict(cfg=fcfg,
                              state=tfactory.build_pc_model(fcfg, device="cpu").state_dict())
    # the CLIs: ft_cls spawns its own two ranks here; the worker resumes it
    # on its two ranks, and runs the pretrain CLI and its --resume
    from vipformer_tpu_torch.cli import ft_cls, pretrain

    runs = str(d / "runs")
    ft_argv = CLI + ["--batch_size", "64", "--test_batch_size", "100", "--num_ft_points", "128",
                     "--optim", "adamw", "--run_dir", runs, "--exp_name", "ft"]
    pt_argv = CLI + ["--synthetic_size", "8", "--batch_size", "4", "--num_pt_points", "128",
                     "--img_height", "24", "--img_width", "24", "--num_test_points", "128",
                     "--run_dir", runs, "--exp_name", "pt"]
    inputs["clis"] = {
        "pretrain": [pretrain.parse_args(pt_argv + ["--epochs", "1"])[0],
                     pretrain.parse_args(pt_argv + ["--epochs", "2", "--resume", "true"])[0]],
        "ft_cls_resume": ft_cls.parse_args(ft_argv + ["--epochs", "2", "--resume_training",
                                                      "true"])[0]}
    torch.save(inputs, d / "inputs.pt")

    def ranks_side():
        first = ft_cls.main(*ft_cls.parse_args(ft_argv + ["--epochs", "1"]))
        tmesh.spawn(worker.run_checks, W, "cpu", (str(d),))
        return first

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(ranks_side)
        jax_out = {kind: _jax_mesh_step(kind, *args) for kind, args in jax_steps.items()}
        first = ranks_done.result()
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]
    return dict(inputs=inputs, jax=jax_out, ranks=ranks, first=first, runs=d / "runs")


def _check_stats_equal_on_ranks(ranks, kind):
    for name, tensors in ranks[0][kind]["tensors"].items():
        for k, v in tensors.items():
            if "running_" in k:
                assert torch.equal(v, ranks[1][kind]["tensors"][name][k]), (kind, name, k)


@pytest.mark.parametrize("kind", ["pretrain", "ft_cls"])
def test_two_rank_step_matches_jax_mesh_step(dp, kind):
    """Both ranks' metrics, updated parameters and BatchNorm statistics
    equal JAX's step on a two-device mesh over the same global batch (the
    pretrain step with both branches and one NT-Xent group per rank)."""
    metrics, (params, stats) = dp["jax"][kind]
    want = {n: from_jax_variables({"params": params[n], "batch_stats": stats[n]})
            for n in params}
    for got in dp["ranks"]:
        got = got[kind]
        for k in metrics:
            _close(got["metrics"][k], metrics[k], 1e-5, k)
        for n, tensors in want.items():
            assert set(got["tensors"][n]) == set(tensors)
            for k, v in tensors.items():
                _close(got["tensors"][n][k], v, 1e-4 if "running_" in k else 2e-4, f"{n}.{k}")
    _check_stats_equal_on_ranks(dp["ranks"], kind)


@pytest.mark.parametrize("kind", ["partseg", "semseg", "global_negatives"])
def test_two_rank_step_matches_one_process(dp, kind):
    """The partseg and semseg steps and the pretrain step with
    --global_negatives: two ranks against the port's one process at the
    global batch (metrics, gradients, parameters, statistics)."""
    want = worker.run_step(kind, dp["inputs"][kind])
    for got in dp["ranks"]:
        got = got[kind]
        for k, v in want["metrics"].items():
            _close(got["metrics"][k], v, 1e-5, k)
        for n in want["tensors"]:
            for k, v in want["grads"][n].items():
                _close(got["grads"][n][k], v, 2e-4, f"grad {n}.{k}")
            for k, v in want["tensors"][n].items():
                _close(got["tensors"][n][k], v, 1e-4 if "running_" in k else 2e-5, f"{n}.{k}")
    _check_stats_equal_on_ranks(dp["ranks"], kind)


def test_global_negatives_differ_from_per_rank_groups(dp):
    """--global_negatives trains another loss than the per-rank groups."""
    case = dict(dp["inputs"]["global_negatives"])
    case["cfg"] = case["cfg"].replace(global_negatives=False)
    per_rank = worker.run_step("global_negatives", case)["metrics"]["loss_imid"]
    assert abs(per_rank - dp["ranks"][0]["global_negatives"]["metrics"]["loss_imid"]) > 1e-4


@pytest.mark.parametrize("op", ["k9", "k18", "bn"])
def test_norm_seams_two_ranks_against_one(dp, op):
    """K9's twin (Group2Emb's two batch-statistics BatchNorms), K18's twin
    and the plain BatchNorm split at their seams: each rank's outputs and
    input gradients are the one-process run's rows, their statistics the
    global ones on both ranks, and the ranks' parameter gradients sum to
    the one-process gradients."""
    want = worker.run_norms(dp["inputs"]["norms"])[op]
    got = [r["norms"][op] for r in dp["ranks"]]
    n = dp["inputs"]["norms"]["x0" if op == "k9" else "x"].shape[0]
    for r in range(W):
        rows = tsharding.rank_rows(n, r, W)
        for key in ("out", "y"):
            if key in want:
                _close(got[r][key], want[key][rows], 1e-5, key)
        _close(got[r]["dx"], want["dx"][rows], 1e-4, "dx")
    for key in ("stats", "mean", "var", "running"):
        if key in want:
            seq = [g[key] if isinstance(g[key], list) else [g[key]] for g in (*got, want)]
            for a, b, w in zip(*seq):
                assert torch.equal(a, b), key
                _close(a, w, 1e-5, key)
    for i, w in enumerate(want["grads"]):
        _close(got[0]["grads"][i] + got[1]["grads"][i], w, 1e-4, f"grad {i}")


def test_loader_rank_slices_are_the_one_process_batch(dp):
    """Every rank draws the global order and seeds and builds its own slice:
    the slices stacked in rank order are the one-process batches, bit for
    bit, over two epochs."""
    want = worker.loader_batches()
    got = [r["loader"] for r in dp["ranks"]]
    assert len(got[0]) == len(got[1]) == len(want) == 6
    for i, batch in enumerate(want):
        for k, v in batch.items():
            assert got[0][i][k].shape[0] == v.shape[0] // W
            assert np.array_equal(np.concatenate([got[0][i][k], got[1][i][k]]), v), (i, k)


def test_extract_features_split_over_ranks(dp):
    """The padded feature batches split over two ranks and gathered: every
    rank holds the one-process features, in order (the last batch padded)."""
    want_feats, want_labels = worker.features(dp["inputs"]["features"])
    assert want_feats.shape[0] == 10
    for feats, labels in (r["features"] for r in dp["ranks"]):
        assert np.array_equal(labels, want_labels)
        _close(feats, want_feats, 1e-5, "features")


def test_collectives_and_their_gradients(dp):
    """all_reduce_sum's gradient is the summed gradient; all_gather_rows
    stacks in rank order and sends each rank the summed gradient of its
    rows."""
    for r, got in enumerate(c["collectives"] for c in dp["ranks"]):
        assert got["sum"].tolist() == [3.0, 3.0]
        assert got["sum_grad"].tolist() == [2.0, 4.0]
        assert got["rows"].tolist() == [[1.0, 1.0], [2.0, 2.0]]
        assert got["rows_grad"].tolist() == [[2.0 + 4 * r, 4.0 + 4 * r]]


def test_dryrun_multicard_rank(dp):
    """`parallel/dryrun.py`'s rank (what `dryrun_multicard(n)` spawns): one
    dual-branch pretrain step at tiny widths from the placed state, the
    same parameters on both ranks after it."""
    for got in (r["dryrun"] for r in dp["ranks"]):
        assert got["world"] == W and got["backend"] == "gloo" and np.isfinite(got["loss"])
    assert dp["ranks"][0]["dryrun"] == dp["ranks"][1]["dryrun"]


def _metrics(root):
    return [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]


def _log(root):
    return "".join(p.read_text() for p in sorted(root.glob("*.log")))


def test_ft_cls_cli_on_two_ranks_writes_from_the_chief(dp):
    """`cli.ft_cls --num_devices 2` spawns two ranks: the chief's result
    comes back, and the run's files are written once (one metrics line an
    epoch, each log line once, the snapshots)."""
    root = dp["runs"] / "ViPFormerTPU" / "ft"
    assert dp["first"]["best_epoch"] == 0
    log = _log(root)
    assert log.count("ft_cls on cpu x 2:") == 2  # the first run and the resumed one
    assert log.count("final best test acc") == 2
    assert (root / "config.json").exists()
    assert {p.name for p in (root / "models").iterdir()} >= {"model_best.ckpt",
                                                              "model_last.ckpt"}


def test_ft_cls_resume_training_on_two_ranks(dp):
    """--resume_training on two ranks continues the two-rank run from its
    model_last: epoch 1 follows epoch 0, no epoch repeated."""
    root = dp["runs"] / "ViPFormerTPU" / "ft"
    assert [m["step"] for m in _metrics(root)] == [0, 1]
    assert _log(root).count("resumed training from") == 1
    for r in dp["ranks"]:
        assert np.isfinite(r["ft_cls_cli"]["best_acc"])


def test_pretrain_cli_on_two_ranks_and_resume(dp):
    """The pretrain CLI on two ranks (per-rank NT-Xent groups, the probe
    split and fitted on the chief), then --resume on two ranks: metrics
    for epochs 0 and 1, written once; both ranks return the same best."""
    root = dp["runs"] / "ViPFormerTPU" / "pt"
    lines = _metrics(root)
    assert [m["step"] for m in lines] == [0, 1]
    assert all(m["ranks"] == 2 and np.isfinite(m["pretrain_loss"]) for m in lines)
    log = _log(root)
    assert log.count("pretrain on cpu x 2:") == 2 and log.count("resumed from") == 1
    assert {p.name for p in (root / "models").iterdir()} >= {
        "pc_model_best.ckpt", "img_model_best.ckpt", "pc_model_last.ckpt"}
    assert dp["ranks"][0]["pretrain_cli"] == dp["ranks"][1]["pretrain_cli"]


@pytest.mark.parametrize("cli", ["pretrain", "ft_cls", "ft_partseg", "ft_semseg",
                                 "eval_zeroshot", "eval_fewshot"])
def test_model_axis_must_divide_the_ranks(tmp_path, cli):
    """--num_devices 3 --model_axis 2 raises JAX's "not divisible by
    model_axis" (parallel/mesh.py:70-71 there) before a run directory is
    made; --model_axis itself runs (tests/test_torch_tensor_parallel.py)."""
    import importlib

    mod = importlib.import_module(f"vipformer_tpu_torch.cli.{cli}")
    cfg, device = mod.parse_args(["--synthetic_data", "true", "--num_devices", "3",
                                  "--model_axis", "2", "--run_dir", str(tmp_path),
                                  "--device", "cpu"])
    with pytest.raises(ValueError, match="3 devices not divisible by model_axis=2"):
        mod.main(cfg, device)
    assert not any(tmp_path.iterdir())


def test_batches_must_split_over_the_ranks():
    """A batch that does not split evenly over the ranks raises (JAX's
    round_up_batch), in the shard, the Loader and the batch check; 0
    devices on the CPU is one rank."""
    with pytest.raises(ValueError, match="not divisible by data-axis size 2"):
        tsharding.round_up_batch(5, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tsharding.shard_batch({"x": np.zeros((5, 3))}, 0, 2)
    with pytest.raises(ValueError, match="not divisible"):
        Loader(worker.Draws(8), 5, collate_cls, drop_last=True, rank=0, world=2)
    with pytest.raises(ValueError, match="drop_last"):
        Loader(worker.Draws(8), 4, collate_cls, rank=0, world=2)
    got = tsharding.shard_batch({"x": np.arange(8)}, 1, 2)["x"]
    assert got.tolist() == [4, 5, 6, 7]
    assert tmesh.resolve_num_devices(0, "cpu") == 1 and tmesh.resolve_num_devices(3, "cpu") == 3
    assert tmesh.data_axis_size() == 1 and tmesh.rank() == 0 and tmesh.is_chief()
