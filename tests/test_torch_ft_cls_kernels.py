"""The ft_cls slice's kernel modules (K11, K6), its gates and its loss
against the JAX package, on the CPU.

Each kernel's plain twin (what `vipformer_tpu_torch` runs on a CPU tensor)
is held against the Pallas kernel it replaces, run by the JAX package in
interpret mode, on the same numpy inputs; the layers that route through
the kernels (Dense's backward, the eval SelfAttention) are held against
the JAX layers with the kernel flags forced on both sides. The CUDA
kernels themselves run only on a card (tests/test_torch_port_cuda.py,
chip_smoke.py).

Tolerances, relative to max(1, max |jax|): f32 within 1e-5 (sums in
other orders); bf16 values that both sides round from f32 sums within one
bf16 ulp, 2^-8 (a sum that lands on a rounding boundary may round either
way); the bf16 K6 output within 2e-2 (as chip_smoke.py's KERNEL_TOL: one
bf16 rounding of an intermediate may flip).
"""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.losses.classification import smoothed_cross_entropy as jax_sce
from vipformer_tpu.nn import layers as jl
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu_torch.convert import from_jax_variables, grads_from_jax
from vipformer_tpu_torch.losses.classification import smoothed_cross_entropy
from vipformer_tpu_torch.nn import layers as tl
from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import dense as kdense

TOL = 1e-5
BF16_ULP = 2.0**-8
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, name=""):
    got = np.asarray((got.detach().float() if isinstance(got, torch.Tensor) else got), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.fixture
def flags():
    """Restore the port's and the JAX package's kernel flags after a test."""
    saved = [(m, n, getattr(m, n)) for m, n in ((kdense, "USE_DENSE_GRAD"),
                                                (kattn, "USE_SA_QKV_LN"),
                                                (jdense, "USE_DENSE_GRAD"),
                                                (jattn, "USE_SA_QKV_LN"))]
    yield
    for mod, name, value in saved:
        setattr(mod, name, value)


# ------------------------------------------------------------------ K11


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("r,cin,cout", [(256, 3, 16), (384, 32, 48)])
def test_dense_grads_twin_matches_pallas(rng, r, cin, cout, dt):
    """K11's twin against dense_grads_pallas (interpret): dW and db in f32,
    then both rounded to the compute dtype as the custom VJP does."""
    tdt, jdt = DTYPES[dt]
    x = rng.standard_normal((r, cin)).astype(np.float32)
    dy = rng.standard_normal((r, cout)).astype(np.float32)
    want_w, want_b = jdense.dense_grads_pallas(jnp.asarray(x, jdt), jnp.asarray(dy, jdt),
                                               interpret=True)
    got_w, got_b = kdense.dense_grads(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt))
    assert got_w.dtype == got_b.dtype == torch.float32
    _close(got_w, want_w, TOL, "dW")
    _close(got_b, want_b, TOL, "db")
    rounded = TOL if dt == "float32" else BF16_ULP
    _close(got_w.to(tdt), want_w.astype(jdt), rounded, "dW in the compute dtype")
    _close(got_b.to(tdt), want_b.astype(jdt), rounded, "db in the compute dtype")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_layer_grads_match_jax(rng, flags, dt, use_bias):
    """The port's Dense in train mode against the JAX Dense, USE_DENSE_GRAD
    forced on both: the output, dx and the f32 master weights' gradients
    (K11's twin on the port's side, the Pallas kernel in interpret mode on
    the JAX side)."""
    tdt, jdt = DTYPES[dt]
    x = rng.standard_normal((2, 64, 24)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 40)).astype(np.float32)
    jdense.USE_DENSE_GRAD = kdense.USE_DENSE_GRAD = True
    jm = jl.Dense(40, use_bias=use_bias, dtype=jdt)
    params = jm.init(jax.random.key(0), jnp.asarray(x))

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx).astype(jnp.float32) * cot)

    want_y = jm.apply(params, jnp.asarray(x))
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = tl.Dense(24, 40, use_bias=use_bias, dtype=tdt)
    tm.load_state_dict(from_jax_variables(params), strict=True)
    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    assert type(y.grad_fn).__name__ == "_DenseApplyBackward"
    (y.float() * torch.from_numpy(cot)).sum().backward()
    tol = TOL if dt == "float32" else BF16_ULP
    _close(y, want_y, tol, "y")
    _close(xt.grad, want_gx, tol, "dx")
    want = grads_from_jax(want_gp["params"])
    assert set(want) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        _close(p.grad, want[k], tol, k)


@pytest.mark.parametrize("on", [True, False])
def test_dense_gate_forced_matches_jax(flags, on):
    """Forced, the port's gate and the JAX gate agree on every shape (both
    still need the JAX kernel's feasible row blocking)."""
    jdense.USE_DENSE_GRAD = kdense.USE_DENSE_GRAD = on
    for rows in (2, 64, 128, 256, 42240, 16411, 337920):
        for cin, cout in ((3, 128), (256, 512), (1024, 2048)):
            for itemsize in (2, 4):
                assert (kdense.dense_grad_enabled(rows, cin, cout, itemsize, on_card=False)
                        == jdense.dense_grad_enabled(rows, cin, cout, itemsize)), (rows, cin, cout)


def test_dense_gate_window(flags):
    """Auto: off the card never; on the card the JAX window (16,384-131,072
    rows, widths <= 1024, a feasible row block): every latent Dense of the
    ft_cls step at B=330 (42,240 rows) qualifies, the adapter (337,920
    rows), the head (330) and the B=48 pretrain step's latents (12,288)
    do not."""
    kdense.USE_DENSE_GRAD = None
    sites = ((3, 128), (128, 256), (256, 256), (256, 512), (512, 256))
    assert all(kdense.dense_grad_enabled(42240, ci, co, 2) for ci, co in sites)
    assert not any(kdense.dense_grad_enabled(42240, ci, co, 2, on_card=False) for ci, co in sites)
    assert not kdense.dense_grad_enabled(337920, 64, 256, 2)
    assert not kdense.dense_grad_enabled(330, 256, 256, 2)
    assert not kdense.dense_grad_enabled(12288, 256, 256, 2)
    assert not kdense.dense_grad_enabled(16411, 256, 256, 2)  # no feasible row block
    assert not kdense.dense_grad_enabled(42240, 256, 2048, 2)


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,g,din,h", [(2, 16, 128, 2), (3, 24, 256, 4)])
def test_attention_small_qkv_ln_twin_matches_pallas(rng, b, g, din, h, dt):
    tdt, jdt = DTYPES[dt]
    d = 64 * h
    x = rng.standard_normal((b, g, din)).astype(np.float32)
    lw = (1.0 + 0.2 * rng.standard_normal(din)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(din)).astype(np.float32)
    ws = [(rng.standard_normal((din, d)) * din ** -0.5).astype(np.float32) for _ in range(3)]
    scale = (d // h) ** -0.5
    want = jattn.fused_attention_packed_small_qkv_ln(
        jnp.asarray(x, jdt), jnp.asarray(lw), jnp.asarray(lb),
        *(jnp.asarray(w, jdt) for w in ws), num_heads=h, scale=scale, interpret=True)
    got = kattn.fused_attention_packed_small_qkv_ln(
        torch.from_numpy(x).to(tdt), torch.from_numpy(lw), torch.from_numpy(lb),
        *(torch.from_numpy(w).to(tdt) for w in ws), num_heads=h, scale=scale)
    assert got.dtype == tdt
    _close(got, want, TOL if dt == "float32" else 2e-2)


def test_eval_self_attention_matches_jax_through_k6(rng, flags, monkeypatch):
    """The port's eval SelfAttention with USE_SA_QKV_LN forced against the
    JAX SelfAttention forced likewise (its Pallas K6 in interpret mode):
    the port takes K6's route (its wrapper runs once) and the outputs
    agree."""
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jattn.USE_SA_QKV_LN = kattn.USE_SA_QKV_LN = True
    jm = jl.SelfAttention(num_heads=2)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["params"]["norm"]["scale"] = (1.0 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    v["params"]["norm"]["bias"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x))
    calls = []
    kernel = kattn.fused_attention_packed_small_qkv_ln
    monkeypatch.setattr(kattn, "fused_attention_packed_small_qkv_ln",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    tm = tl.SelfAttention(128, 2)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert calls == [1]
    _close(got, want, TOL)


def test_qkv_ln_gate_matches_jax_forced_and_the_batch_threshold(flags):
    """Forced on, the port's gate and the JAX gate agree on the structural
    conditions; auto, the port engages only on the card, in eval, at
    B >= 128 (the flagship eval at B=330 yes, the B=64 serving batch no)."""
    jattn.USE_SA_QKV_LN = kattn.USE_SA_QKV_LN = True
    for h, qk, vch, g, din in ((4, 256, 256, 128, 256), (4, 256, 128, 128, 256),
                               (3, 256, 256, 128, 256), (4, 256, 256, 600, 256),
                               (4, 256, 256, 128, 96), (4, 256, 256, 128, 2048),
                               (2, 128, 128, 16, 128)):
        for training in (False, True):
            want = jattn.packed_small_qkv_ln_enabled(h, qk, vch, 8, g, din, None, 0.0,
                                                     not training)
            got = kattn.packed_small_qkv_ln_enabled(h, qk, vch, 8, g, din, training, False)
            assert got == want, (h, qk, vch, g, din, training)
    kattn.USE_SA_QKV_LN = None
    assert kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, 128, 256, False, True)
    assert not kattn.packed_small_qkv_ln_enabled(4, 256, 256, 64, 128, 256, False, True)
    assert not kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, 128, 256, True, True)
    assert not kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, 128, 256, False, False)
    # the kernel's shared memory bounds G at 178 (qkv_ln_smem_bytes)
    assert not kattn.packed_small_qkv_ln_enabled(4, 256, 256, 330, 200, 256, False, True)


def test_layernorm_eps_is_one_constant():
    """Every LayerNorm of the port reads one epsilon: the plain layers and
    twins `ops.cuda.LN_EPS`, the kernels `vpt::LN_EPS` in csrc/common.cuh,
    which holds the same value; no kernel source hard-codes its own."""
    assert kcuda.LN_EPS == 1e-5
    with open(os.path.join(kcuda.CSRC, "common.cuh")) as f:
        m = re.search(r"constexpr float LN_EPS = ([0-9.e+-]+)f;", f.read())
    assert m and float(m.group(1)) == kcuda.LN_EPS
    for src in ("attention.cu", "flash_train.cu"):
        with open(os.path.join(kcuda.CSRC, src)) as f:
            text = f.read()
        assert "vpt::LN_EPS" in text and "LN_EPS = " not in text, src


# ----------------------------------------------------------------- loss


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
@pytest.mark.parametrize("shape", [(6, 40), (2, 5, 7)])
def test_smoothed_cross_entropy_matches_jax(rng, shape, smoothing):
    logits = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1])
    want = jax_sce(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    _close(got, want, TOL)
    got_bf16 = smoothed_cross_entropy(torch.from_numpy(logits).bfloat16(),
                                      torch.from_numpy(labels), smoothing)
    assert got_bf16.dtype == torch.float32
