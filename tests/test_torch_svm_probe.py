"""The port's linear SVM probe and the pretrain CLI's checkpoint gate
against the JAX package's, on the CPU.

`fit_svm` runs the same fit on both sides (one-vs-rest squared hinge, 300
full-batch Adam steps, cosine-decayed learning rate) from features made
with a numpy seed; w and b agree within 1e-4 of max(1, max |jax|) (f32
products summed in other orders over 300 steps) and the predictions are
equal. The pretrain CLI saves `pc_model_best` on a new best probe
accuracy, as JAX cli/pretrain.py:194-202 does (strictly greater: the
first epoch of the best accuracy is kept), with the accuracy in its
metadata.
"""

import json

import numpy as np
import pytest
import torch

from vipformer_tpu.evaluation import svm as jsvm
from vipformer_tpu_torch.evaluation import svm as tsvm

TOL = 1e-4


def _features(n: int, d: int, k: int, seed: int, n_test: int = 0):
    """k Gaussian clusters in d dimensions, overlapping enough that the
    squared hinge is active on many rows; an offset and unequal feature
    scales so that standardising matters. -> (x, y) of n rows, and with
    n_test > 0 (x, y, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 0.5
    y = rng.integers(0, k, n + n_test)
    x = centers[y] + rng.standard_normal((n + n_test, d))
    x = (x * rng.uniform(0.2, 3.0, d) + 2.0).astype(np.float32)
    if not n_test:
        return x, y
    return x[:n], y[:n], x[n:], y[n:]


@pytest.mark.parametrize("standardize", [False, True], ids=["raw", "standardized"])
def test_fit_svm_matches_jax(standardize):
    """w [D, K] and b [K] within 1e-4 of JAX's, the same test-split
    predictions and accuracy; C = 0.1, as a probe gate would run it."""
    x, y, xt, yt = _features(400, 24, 6, 0, n_test=120)
    want = jsvm.fit_svm(x, y, c=0.1, standardize=standardize)
    got = tsvm.fit_svm(x, y, c=0.1, standardize=standardize)
    for name in ("w", "b"):
        ref = np.asarray(getattr(want, name))
        err = np.abs(getattr(got, name).numpy() - ref).max()
        assert err <= TOL * max(1.0, np.abs(ref).max()), (name, err)
    np.testing.assert_array_equal(got.predict(xt), want.predict(xt))
    assert got.score(xt, yt) == want.score(xt, yt)
    assert 0.3 < got.score(xt, yt) < 1.0  # neither trivial nor separable


def test_fit_svm_takes_tensors_on_their_device():
    """A feature tensor is fitted where it lies, and score reads numpy or
    tensors alike; sklearn fits only when asked (backend="sklearn")."""
    x, y = _features(200, 16, 4, 2)
    a = tsvm.fit_svm(x, y, c=0.1)
    b = tsvm.fit_svm(torch.from_numpy(x), y, c=0.1)
    assert a.w.device == b.w.device == torch.device("cpu")
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)
    assert a.score(torch.from_numpy(x), y) == a.score(x, y)
    assert tsvm.cosine_lr(0, 300) == pytest.approx(0.05)
    assert tsvm.cosine_lr(300, 300) == pytest.approx(0.0)
    with pytest.raises(ValueError, match="backend"):
        tsvm.fit_svm(x, y, backend="libsvm")
    sk = tsvm.fit_svm(torch.from_numpy(x), y, c=0.1, standardize=True, backend="sklearn")
    assert sk.w is None and sk.predict(x).shape == (200,) and sk.score(x, y) > 0.5


def test_extract_features_masks_the_padding():
    """Every batch is padded to the batch size and the padding masked out:
    11 samples in batches of 4 give 11 feature rows in dataset order."""
    from vipformer_tpu_torch.cli.common import extract_features

    class Rows:
        def __len__(self):
            return 11

        def get(self, i, rng=None):
            return np.full((5, 3), i, np.float32), i % 3

    calls = []

    def feats_fn(points):
        calls.append(len(points))
        return torch.as_tensor(points).mean(dim=1)  # [B, 3]

    feats, labels = extract_features(feats_fn, Rows(), 4)
    assert calls == [4, 4, 4]
    np.testing.assert_array_equal(feats[:, 0].numpy(), np.arange(11, dtype=np.float32))
    np.testing.assert_array_equal(labels, np.arange(11) % 3)


def test_pretrain_gate_keeps_the_best_probe_epoch(tmp_path, monkeypatch):
    """Over probe accuracies 0.30, 0.55, 0.55, 0.40 the CLI keeps epoch 1
    (JAX's rule: a new best only when strictly greater), saves both
    branches' best checkpoints with {"epoch": 1, "svm_test_acc": 0.55,
    "kind": "pretrain"}, and logs svm_test_acc and svm_best_acc each epoch;
    the probe fitted on the train split's and scored the test split's
    features of the point branch (800 and 200 ModelNet40 clouds)."""
    from vipformer_tpu_torch.cli import pretrain as cli
    from vipformer_tpu_torch.train.checkpoint import load_metadata

    accs = iter([0.30, 0.55, 0.55, 0.40])
    seen = []

    class Probe:
        def score(self, feats, labels):
            seen.append(("score", tuple(feats.shape), len(labels)))
            return next(accs)

    def fake_fit(feats, labels, c):
        seen.append(("fit", tuple(feats.shape), len(labels), c))
        return Probe()

    monkeypatch.setattr(cli, "fit_svm", fake_fit)
    argv = ["--synthetic_data", "true", "--synthetic_size", "4", "--epochs", "4",
            "--batch_size", "2", "--arch", "E1CL1SL-H2D32-L8-MR2", "--group_size", "8",
            "--num_pt_points", "64", "--num_test_points", "64", "--test_batch_size", "500",
            "--img_height", "24", "--img_width", "24", "--compute_dtype", "float32",
            "--svm_coff", "0.1", "--run_dir", str(tmp_path), "--exp_name", "gate",
            "--device", "cpu"]
    cfg, device = cli.parse_args(argv)
    out = cli.main(cfg, device)
    assert out == {"best_acc": 0.55, "best_epoch": 1}
    assert seen[:2] == [("fit", (800, 64), 800, 0.1), ("score", (200, 64), 200)]
    root = tmp_path / cfg.proj_name / "gate"
    lines = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [m["svm_test_acc"] for m in lines] == [0.30, 0.55, 0.55, 0.40]
    assert [m["svm_best_acc"] for m in lines] == [0.30, 0.55, 0.55, 0.55]
    for name in ("pc", "img"):
        meta = load_metadata(str(root / "models" / f"{name}_model_best.ckpt"))
        assert {k: meta[k] for k in ("epoch", "svm_test_acc", "kind")} == {
            "epoch": 1, "svm_test_acc": 0.55, "kind": "pretrain"}
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "new best probe acc 0.5500 at epoch 1" in log and "probe is skipped" not in log
