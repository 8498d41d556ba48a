"""The evaluation slice against the JAX package, on the CPU: the RBF probe,
the grid search, the few-shot episodes, the complexity report, and both
evaluation entry points end to end.

Inputs come from numpy seeds. Exact where both sides compute the same
integers (stratified folds, episode rows, the grid's choice) or the same
numpy value (`scale_gamma`); the RBF probe's predictions agree on at least
99% of test rows (an f32 fit of 500 Adam steps, products summed in other
orders: a prediction may flip only where two classes' scores nearly tie,
the bound chip_smoke.py holds the linear probe to). The parameter count
equals JAX's `param_count`; the FLOPs equal a hand count of the tiny
model's products (the counter counts the matmul family only, where JAX's
XLA cost model also counts elementwise work, so the two packages' FLOPs
are not compared).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.evaluation import fewshot as jfew
from vipformer_tpu.evaluation import svm as jsvm
from vipformer_tpu.models import crossformer as jcf
from vipformer_tpu.models import perceiver_models as jpm
from vipformer_tpu.utils import param_count as jax_param_count
from vipformer_tpu_torch.config import Config, decode_arch_name
from vipformer_tpu_torch.evaluation import fewshot as tfew
from vipformer_tpu_torch.evaluation import svm as tsvm
from vipformer_tpu_torch.evaluation.flops import complexity_report
from vipformer_tpu_torch.models.factory import build_pc_model
from vipformer_tpu_torch.models.perceiver_models import PerceiverFeatsModel

AGREE = 0.99


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The probe fits are loops of small products. In the parallel test
    run several workers each start a thread per core, and the fits then
    run ~100x slower than alone (a 500-step RBF fit: 0.4 s alone, 59 s
    among six such processes on 8 cores, 0.9 s on one thread each), so
    this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(n: int, d: int, k: int, seed: int, n_test: int = 0):
    """k overlapping Gaussian clusters in d dimensions at unequal feature
    scales -> (x, y) of n rows, and the test rows after them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 0.6
    y = rng.integers(0, k, n + n_test)
    x = (centers[y] + rng.standard_normal((n + n_test, d))) * rng.uniform(0.5, 2.0, d)
    x = x.astype(np.float32)
    return (x[:n], y[:n], x[n:], y[n:]) if n_test else (x, y)


@pytest.mark.parametrize("cv,seed", [(3, 0), (5, 4)])
def test_stratified_folds_match_jax(cv, seed):
    labels = np.random.default_rng(seed).integers(0, 7, 101)
    got = tsvm._stratified_folds(labels, cv, seed)
    want = jsvm._stratified_folds(labels, cv, seed)
    assert len(got) == len(want) == cv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_episode_indices_match_jax():
    """Five episodes drawn from one stream on each side: the same support
    and query rows and labels; too few hosting classes raise on both."""
    labels = np.random.default_rng(1).integers(0, 9, 300)
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        for g, w in zip(tfew._episode_indices(rt, labels, 5, 4, 6),
                        jfew._episode_indices(rj, labels, 5, 4, 6)):
            np.testing.assert_array_equal(g, w)
    for fn in (tfew._episode_indices, jfew._episode_indices):
        with pytest.raises(ValueError, match="cannot sample 5-way episodes"):
            fn(np.random.default_rng(0), labels, 5, 30, 20)


def test_scale_gamma_matches_jax():
    x, _ = _features(150, 12, 3, 5)
    assert tsvm.scale_gamma(x) == jsvm.scale_gamma(x)
    assert tsvm.scale_gamma(torch.from_numpy(x)) == jsvm.scale_gamma(x)


def test_fit_rbf_svm_matches_jax():
    """The RBF probe on [240, 16] features of 5 classes at C = 1: the
    test-row predictions agree with JAX's on >= 99% of rows, and the
    accuracy is neither trivial nor perfect."""
    x, y, xt, yt = _features(240, 16, 5, 6, n_test=160)
    want = jsvm.fit_rbf_svm(x, y, c=1.0)
    got = tsvm.fit_rbf_svm(x, y, c=1.0)
    assert got.gamma == want.gamma
    agree = float(np.mean(got.predict(xt) == want.predict(xt)))
    assert agree >= AGREE, agree
    assert 0.3 < got.score(xt, yt) < 1.0


def test_fit_rbf_svm_sklearn_backend_agrees_with_jax():
    """backend="sklearn" hands the RBF fit to sklearn's SVC with the same
    gamma on both sides (imported only then): equal predictions."""
    x, y, xt, _ = _features(120, 8, 3, 10, n_test=40)
    got = tsvm.fit_rbf_svm(torch.from_numpy(x), y, backend="sklearn")
    want = jsvm.fit_rbf_svm(x, y, backend="sklearn")
    assert got.alpha is None and got.gamma == want.gamma
    np.testing.assert_array_equal(got.predict(xt), want.predict(xt))


def test_fit_svm_takes_num_classes():
    """A probe over fewer classes than named (a few-shot episode's labels
    0..k-1 with a class absent) has num_classes score columns."""
    x, y = _features(60, 8, 3, 7)
    svm = tsvm.fit_svm(x, y, c=0.5, num_classes=5)
    assert tuple(svm.w.shape) == (8, 5) and svm.decision(x).shape == (60, 5)


def test_grid_search_picks_jax_best():
    """The {linear, rbf} x C grid with 3 stratified folds on [150, 12]
    features: the same best (kernel, C) as JAX's, and a refit probe."""
    x, y, xt, yt = _features(150, 12, 4, 8, n_test=60)
    cs = (0.01, 1.0)
    _, want, want_val = jsvm.grid_search_svm(x, y, cs=cs)
    model, got, got_val = tsvm.grid_search_svm(x, y, cs=cs)
    assert got == want
    assert abs(got_val - want_val) <= 0.02
    assert model.score(xt, yt) > 0.3


def test_fewshot_eval_matches_jax():
    """Four 3-way 5-shot episodes over [200, 16] features: the same
    per-episode accuracies as JAX's within one query row."""
    x, y = _features(200, 16, 6, 9)
    got = tfew.fewshot_eval(x, y, 3, 5, 8, 4, c=1.0, seed=2)
    want = jfew.fewshot_eval(x, y, 3, 5, 8, 4, c=1.0, seed=2)
    np.testing.assert_allclose(got[2], want[2], atol=100.0 / 24 + 1e-9)
    assert len(got[2]) == 4


# ---------------------------------------------------------- complexity

ARCH = "E1CL1SL-H2D32-L8-MR2"


def _hand_flops(b, n, d, g, s, h, r, sa_layers, c=3) -> int:
    """2 x the multiply-adds of every product of CrossFormerPC's eval
    forward at these sizes (the unfused stem: G*S = 64 rows is not a
    multiple of 128, so the eval stem is Group2Emb's Dense chain)."""
    mm = lambda rows, cin, cout: 2 * rows * cin * cout  # noqa: E731
    adapter = mm(b * n, c, 64) + mm(b * n, 64, d)
    g2e = (mm(b * g * s, c, 64) + mm(b * g * s, 64, 128) + mm(b * g, 128, 256)
           + mm(b * g * s, 128, 256) + mm(b * g * s, 256, d))
    pos = mm(b * g, c, 128) + mm(b * g, 128, d)
    mlp = mm(b * g, d, r * d) + mm(b * g, r * d, d)
    ca = 2 * mm(b * g, d, d) + 2 * mm(b * n, d, d) + 2 * mm(b * h * g, d // h, n) + mlp
    sa = 4 * mm(b * g, d, d) + 2 * mm(b * h * g, d // h, g) + mlp
    head = mm(b, 2 * d, d) + mm(b, d, d)
    return adapter + g2e + pos + ca + sa_layers * sa + head


def test_complexity_report_counts_params_and_products():
    """CrossFormerPC: params equal JAX's param_count of the same model;
    the FLOPs of a [2, 64, 3] forward equal the hand count."""
    cfg = Config(**decode_arch_name(ARCH), group_size=8, compute_dtype="float32")
    model = build_pc_model(cfg, device="cpu")
    report = complexity_report(model, torch.zeros(2, 64, 3))
    jm = jcf.CrossFormerPC(num_latents=8, num_latent_channels=32, group_size=8,
                           num_cross_attention_heads=2, num_self_attention_layers=1,
                           num_self_attention_heads=2, mlp_widen_factor=2, dtype=jnp.float32)
    variables = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((2, 64, 3)))
    assert report["params"] == jax_param_count(variables["params"])
    assert report["flops_per_batch"] == _hand_flops(2, 64, 32, 8, 8, 2, 2, 1)


def test_param_count_counts_a_shared_module_once():
    """A Perceiver feature model with unequal cross-attention widths: the
    shared first blocks once, as in the flax tree."""
    kw = dict(num_latents=8, num_latent_channels=32, num_cross_attention_heads=2,
              num_cross_attention_v_channels=16, num_self_attention_heads=2,
              num_self_attention_layers_per_block=1, atten_drop=0.0, mlp_drop=0.0)
    tm = PerceiverFeatsModel("pointcloud", dtype=torch.float32, device="cpu", **kw)
    jm = jpm.PerceiverFeatsModel(adapter="pointcloud", dtype=jnp.float32, **kw)
    variables = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((2, 16, 3)))
    assert complexity_report(tm, torch.zeros(2, 16, 3))["params"] == jax_param_count(
        variables["params"])


# ---------------------------------------------------------------- CLIs

TINY = ["--synthetic_data", "true", "--arch", "E1CL1SL-H2D32-L16-MR2", "--group_size", "8",
        "--num_test_points", "64", "--test_batch_size", "200", "--compute_dtype", "float32",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A one-epoch pretrain run's directory (its pc_model_best checkpoint)."""
    from vipformer_tpu_torch.cli import pretrain

    root = tmp_path_factory.mktemp("runs")
    cfg, device = pretrain.parse_args(
        TINY + ["--synthetic_size", "4", "--epochs", "1", "--batch_size", "2",
                "--num_pt_points", "64", "--img_height", "24", "--img_width", "24",
                "--run_dir", str(root), "--exp_name", "pt"])
    pretrain.main(cfg, device)
    return root


def _log(root, exp):
    return "".join(p.read_text() for p in (root / "ViPFormerTPU" / exp).glob("*.log"))


def test_eval_zeroshot_cli(pretrained):
    """From the pretrain run's checkpoint: the complexity report, the three
    probes with their log lines, and JAX's return keys."""
    from vipformer_tpu_torch.cli import eval_zeroshot

    cfg, device = eval_zeroshot.parse_args(TINY + ["--run_dir", str(pretrained),
                                                   "--exp_name", "pt"])
    assert device == "cpu"
    out = eval_zeroshot.main(cfg, device)
    assert set(out) == {"linear_acc", "rbf_acc", "grid_acc", "grid_best", "params",
                        "flops_per_batch"}
    assert set(out["grid_best"]) == {"kernel", "C"} and out["params"] > 0
    assert all(0.0 <= out[k] <= 1.0 for k in ("linear_acc", "rbf_acc", "grid_acc"))
    log = _log(pretrained, "pt")
    for line in ("loaded pretrained model from", "total parameters:", "linear SVM acc:",
                 "rbf SVM acc:", "grid-search best"):
        assert line in log, line


def test_eval_fewshot_cli(pretrained, tmp_path):
    """ScanObjectNN 5-way 10-shot with 20 queries (about 40 train clouds a
    class) from the pretrain checkpoint; ModelNet40's 800 clouds (about 20
    a class) cannot host a 30-row episode and raise, as JAX's; with no
    checkpoint the raw init is evaluated with JAX's warning."""
    from vipformer_tpu_torch.cli import eval_fewshot

    args = TINY + ["--ft_dataset", "ScanObjectNN", "--n_runs", "2", "--run_dir", str(pretrained),
                   "--exp_name", "pt"]
    out = eval_fewshot.main(*eval_fewshot.parse_args(args))
    assert len(out["accs"]) == 2 and 0.0 <= out["mean"] <= 100.0
    assert "acc: " in _log(pretrained, "pt") and " over 2 runs" in _log(pretrained, "pt")
    with pytest.raises(ValueError, match="cannot sample 5-way episodes"):
        eval_fewshot.main(*eval_fewshot.parse_args(
            TINY + ["--ft_dataset", "ModelNet40", "--n_runs", "1",
                    "--run_dir", str(pretrained), "--exp_name", "pt"]))
    eval_fewshot.main(*eval_fewshot.parse_args(
        TINY + ["--ft_dataset", "ScanObjectNN", "--n_runs", "1", "--run_dir", str(tmp_path),
                "--exp_name", "raw"]))
    assert "WARNING: no checkpoint at" in _log(tmp_path, "raw")


def test_eval_fewshot_cli_on_a_finetuned_model(tmp_path):
    """`--fewshot_model ft` restores the ft_cls CLI's model_best (a single
    classifier's state dict) strictly and takes its backbone features."""
    from vipformer_tpu_torch.cli import eval_fewshot
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.train.checkpoint import save_checkpoint

    args = TINY + ["--ft_dataset", "ScanObjectNN", "--n_runs", "1", "--fewshot_model", "ft",
                   "--num_obj_classes", "15", "--run_dir", str(tmp_path), "--exp_name", "ft",
                   "--pc_model_file", str(tmp_path / "model_best.ckpt")]
    cfg, device = eval_fewshot.parse_args(args)
    save_checkpoint(str(tmp_path / "model_best.ckpt"), build_ft_cls(cfg, device="cpu", seed=5),
                    {"kind": "ft_cls"})
    out = eval_fewshot.main(cfg, device)
    assert len(out["accs"]) == 1
    assert "loaded pretrained model from" in _log(tmp_path, "ft")
