"""K18 (train-mode BatchNorm reductions) and K17 (row LayerNorm) of the
port against the JAX package's Pallas kernels, on the CPU.

The JAX kernels run in interpret mode (`bn_stats_pallas`,
`bn_grad_reduces_pallas`, `layernorm_apply` take it on a non-TPU backend);
the port's wrappers run their plain twins on CPU tensors. Inputs come
from a numpy seed, in f32 (the point is the algorithm; the card holds the
kernels against the twins in bf16 too).

Tolerances: the column sums within 1e-5 of their channel's sum of
magnitudes (f32 sums in another order); y, mean, var, dx, dscale and
dbias within 1e-5 of max(1, max |jax|). The gates are equal everywhere.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipformer_tpu.nn import layers as jlayers
from vipformer_tpu.ops.pallas import batchnorm as jbn
from vipformer_tpu.ops.pallas import layernorm as jln
from vipformer_tpu_torch.nn.layers import BatchNorm, LayerNorm
from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
from vipformer_tpu_torch.ops.cuda import layernorm as kln

TOL = 1e-5


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def _colsum_close(got, want, mag, name=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= TOL * np.asarray(mag, np.float64)).all(), (name, err.max())


def _data(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("r,c", [(512, 96), (1024, 40)])
def test_bn_reduces_twin_matches_pallas(r, c):
    """sum / sumsq and dscale / dbias of the twin against the interpret-mode
    Pallas kernels, per channel against the channel's sum of magnitudes."""
    x, dy = _data((r, c), 0, 2.0, 0.5), _data((r, c), 1)
    s_j, ss_j = jbn.bn_stats_pallas(jnp.asarray(x), interpret=True)
    s_t, ss_t = kbn.bn_stats(torch.from_numpy(x))
    _colsum_close(s_t, s_j, np.abs(x).sum(0), "sum")
    _colsum_close(ss_t, ss_j, (x * x).sum(0), "sumsq")
    mean = (np.asarray(s_j) / r).astype(np.float32)
    rstd = (1.0 / np.sqrt(np.asarray(ss_j) / r - mean * mean + 1e-5)).astype(np.float32)
    ds_j, db_j = jbn.bn_grad_reduces_pallas(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(mean),
                                            jnp.asarray(rstd), interpret=True)
    ds_t, db_t = kbn.bn_grad_reduces(torch.from_numpy(x), torch.from_numpy(dy),
                                     torch.from_numpy(mean), torch.from_numpy(rstd))
    _colsum_close(ds_t, ds_j, np.abs(dy * (x - mean) * rstd).sum(0), "dscale")
    _colsum_close(db_t, db_j, np.abs(dy).sum(0), "dbias")


def test_bn_train_apply_matches_jax():
    """The autograd core against JAX's custom VJP (kernels in interpret
    mode): y, mean, var, and the gradients of x, scale and bias under
    nonzero cotangents of all three outputs (the mean/var terms of the
    backward included)."""
    shape = (4, 128, 48)
    x, cy = _data(shape, 2, 1.5, -0.3), _data(shape, 3)
    scale, bias = _data((48,), 4, 0.2, 1.0), _data((48,), 5, 0.1)
    cm, cv = _data((48,), 6), _data((48,), 7)

    def jloss(xx, ss, bb):
        y, m, v = jbn.bn_train_apply(xx, ss, bb, 1e-5)
        return jnp.sum(y * cy) + jnp.sum(m * cm) + jnp.sum(v * cv), (y, m, v)

    (_, outs_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    y, m, v = kbn.bn_train_apply(xt, st, bt, 1e-5)
    loss = (y * torch.from_numpy(cy)).sum() + (m * torch.from_numpy(cm)).sum() \
        + (v * torch.from_numpy(cv)).sum()
    grads_t = torch.autograd.grad(loss, (xt, st, bt))
    for name, got, want in zip(("y", "mean", "var", "dx", "dscale", "dbias"),
                               (y, m, v) + grads_t, outs_j + grads_j):
        _close(got, want, name=name)


def test_batchnorm_module_forced_matches_jax(monkeypatch):
    """The port's BatchNorm in train mode with USE_BN_TRAIN forced (K18's
    twin) against JAX's kernel-backed BatchNorm module: the output, the
    running statistics after one update (flax momentum 0.9, biased var),
    and the gradients of x and the parameters."""
    shape = (2, 256, 32)
    x, cy = _data(shape, 8, 1.2, 0.4), _data(shape, 9)
    monkeypatch.setattr(jbn, "USE_BN_TRAIN", True)
    monkeypatch.setattr(kbn, "USE_BN_TRAIN", True)
    jm = jlayers.BatchNorm()
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(_data((32,), 10, 0.2, 1.0)),
              "bias": jnp.asarray(_data((32,), 11, 0.1))}
    stats = {"mean": jnp.asarray(_data((32,), 12, 0.1)),
             "var": jnp.asarray(_data((32,), 13, 0.1, 1.0))}

    def jloss(xx, p):
        y, new = jm.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * cy), (y, new["batch_stats"])

    (_, (y_j, new_j)), (gx_j, gp_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params)
    assert set(variables["params"]) == {"scale", "bias"}
    bn = BatchNorm(32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(params["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(stats["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(stats["var"])))
    bn.train()
    calls = []
    fwd = kbn.bn_stats
    monkeypatch.setattr(kbn, "bn_stats", lambda *a: calls.append(1) or fwd(*a))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    assert calls == [1] and y.dtype == torch.float32
    gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(cy)).sum(), (xt, bn.weight, bn.bias))
    _close(y, y_j, name="y")
    _close(bn.running_mean, new_j["mean"], name="running mean")
    _close(bn.running_var, new_j["var"], name="running var")
    for name, got, want in (("dx", gx, gx_j), ("dscale", gs, gp_j["scale"]),
                            ("dbias", gb, gp_j["bias"])):
        _close(got, want, name=name)


# widths: the earlier 72, the input adapter's 64, the semseg latents' 384
# and the Fourier tokens' 261 (odd: no vector of two columns divides it)
@pytest.mark.parametrize("d", [72, 64, 384, 261])
def test_layernorm_apply_matches_jax(d):
    """K17's twin through the port's autograd function against JAX's
    `layernorm_apply` (forward and backward kernels in interpret mode): y
    and the gradients of x, scale and bias."""
    shape = (2, 256, d)
    x, cy = _data(shape, 14, 1.5, 0.2), _data(shape, 15)
    scale, bias = _data((d,), 16, 0.2, 1.0), _data((d,), 17, 0.1)

    def jloss(xx, ss, bb):
        y = jln.layernorm_apply(xx, ss, bb)
        return jnp.sum(y * cy), y

    (_, y_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    y = kln.layernorm_apply(xt, st, bt)
    grads_t = torch.autograd.grad((y * torch.from_numpy(cy)).sum(), (xt, st, bt))
    for name, got, want in zip(("y", "dx", "dscale", "dbias"), (y,) + grads_t,
                               (y_j,) + grads_j):
        _close(got, want, name=name)


def test_layernorm_module_forced_routes_through_k17(monkeypatch):
    """With USE_LAYERNORM forced the port's LayerNorm runs K17's twin where
    the JAX row blocking is feasible (512 rows) and the plain math where it
    is not (100 rows), with the same values either way; a bf16 input gives
    the module's compute dtype."""
    calls = []
    fwd = kln.ln_fwd
    monkeypatch.setattr(kln, "ln_fwd", lambda *a: calls.append(a[0].shape) or fwd(*a))
    ln = LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(_data((64,), 18, 0.2, 1.0)))
        ln.bias.copy_(torch.from_numpy(_data((64,), 19, 0.1)))
    x = torch.from_numpy(_data((2, 256, 64), 20))
    plain = ln(x)
    monkeypatch.setattr(kln, "USE_LAYERNORM", True)
    _close(ln(x), plain.detach().numpy(), name="512 rows")
    assert calls == [(512, 64)]
    ln(x[:, :50])
    assert len(calls) == 1
    assert LayerNorm(64, dtype=torch.bfloat16)(x.bfloat16()).dtype == torch.bfloat16


def test_gates_match_jax(monkeypatch):
    """`bn_train_enabled` and `layernorm_enabled` equal the JAX gates over
    a grid of row counts, widths and item sizes, with the flag at None,
    True and False."""
    rows = (96, 128, 256, 512, 1000, 4096, 32768, 131072, 995328)
    widths = (13, 64, 256, 261, 384, 1024, 1536, 2048)
    for flag in (None, True, False):
        monkeypatch.setattr(jbn, "USE_BN_TRAIN", flag)
        monkeypatch.setattr(kbn, "USE_BN_TRAIN", flag)
        monkeypatch.setattr(jln, "USE_LAYERNORM", flag)
        monkeypatch.setattr(kln, "USE_LAYERNORM", flag)
        for r, c, item in itertools.product(rows, widths, (2, 4)):
            assert kbn.bn_train_enabled(r, c, item) == jbn.bn_train_enabled(r, c, item), \
                (flag, r, c, item)
            assert kln.layernorm_enabled(r, c, item) == jln.layernorm_enabled(r, c, item), \
                (flag, r, c, item)
    # forced, the semseg step's sites qualify: the decode's four BatchNorms
    # over 32 x 4,096 rows and the latents' LayerNorms over 32 x 128
    monkeypatch.setattr(kbn, "USE_BN_TRAIN", True)
    monkeypatch.setattr(kln, "USE_LAYERNORM", True)
    assert all(kbn.bn_train_enabled(131072, c, 2) for c in (1536, 1024, 512, 256))
    assert kln.layernorm_enabled(4096, 384, 2) and kln.layernorm_enabled(131072, 64, 2)
