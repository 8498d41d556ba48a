"""K14 (head-split eval attention), its gate and the modules that reach it
(attention sites whose v width differs from the q/k width) against the
JAX package, on the CPU.

K14's wrapper takes its plain twin on CPU tensors; the twin is held
against the Pallas kernel it replaces (`fused_attention`, run by the JAX
package in interpret mode) at v widths unequal and equal to the q/k width,
in f32 within 2e-5 and in bf16 within 2e-2 of max(1, max |jax|)
(chip_smoke.py's KERNEL_TOL). The gate copy gives the JAX gate's truth
table. A Perceiver point feature model with `num_cross_attention_v_channels`
and an encoder with unequal self-attention widths run with the weights
bridged from the flax tree (convert.from_jax_variables, which carries the
k/v/o projections at their unequal widths) against the JAX modules at f32
within 1e-4, with both packages' USE_FUSED_ATTENTION forced (the twin of
K14 against the Pallas kernel) and at auto (plain attention on both
sides). The JAX package's head-split branch calls its kernel without
interpret mode (ops/attention.py:63-66), which its CPU backend refuses,
so with the flag forced the test runs that call in interpret mode, as the
JAX package's own kernel tests run its kernels. The CUDA kernel itself
runs only on a card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import functools
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.models import perceiver_models as jpm
from vipformer_tpu.nn import perceiver as jperc
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.models import perceiver_models as tpm
from vipformer_tpu_torch.nn import perceiver as tperc
from vipformer_tpu_torch.ops.cuda import attention as kattn

KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, name=""):
    got = np.asarray(got.detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.fixture(params=["forced", "auto"])
def route(request, monkeypatch):
    """Both packages' attention flag forced on (K14's twin and the Pallas
    kernel in interpret mode) or at auto (plain attention on the CPU)."""
    forced = request.param == "forced"
    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION", True if forced else None)
    monkeypatch.setattr(jattn, "USE_FUSED_ATTENTION", True if forced else None)
    if forced:
        monkeypatch.setattr(jattn, "fused_attention",
                            functools.partial(jattn.fused_attention, interpret=True))
    return request.param


# (B, H, G, M, dh, dv): v narrower than q/k, equal, wider; a single query
CASES = [(2, 3, 5, 7, 16, 8), (2, 2, 8, 40, 16, 16), (1, 2, 1, 33, 32, 64),
         (2, 4, 16, 64, 64, 32)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,h,g,m,dh,dv", CASES)
def test_head_split_twin_matches_pallas(rng, b, h, g, m, dh, dv, dt):
    tdt, jdt = DTYPES[dt]
    q = rng.standard_normal((b, h, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, m, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, m, dv)).astype(np.float32)
    scale = dh ** -0.5
    want = jattn.fused_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), scale=scale,
                                 interpret=True)
    got = kattn.fused_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), scale=scale)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, g, dv)
    _close(got, want, KERNEL_TOL[dt], "K14")


def test_gate_matches_jax_truth_table():
    """fused_attention_enabled(rate, training) against JAX's
    fused_attention_enabled(None, rate, deterministic) over every
    combination, with the flag forced on, off and at auto (the port's
    attention sites take no padding mask, JAX's gate refuses one)."""
    saved = kattn.USE_FUSED_ATTENTION, jattn.USE_FUSED_ATTENTION
    try:
        for flag, rate, training in itertools.product((None, True, False), (0.0, 0.1),
                                                      (False, True)):
            kattn.USE_FUSED_ATTENTION = jattn.USE_FUSED_ATTENTION = flag
            want = jattn.fused_attention_enabled(None, rate, not training)
            assert kattn.fused_attention_enabled(rate, training) == want, (flag, rate, training)
            assert not jattn.fused_attention_enabled(jnp.zeros((2, 4), bool), rate, not training)
    finally:
        kattn.USE_FUSED_ATTENTION, jattn.USE_FUSED_ATTENTION = saved


def _jax_init(module, x):
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _spy_k14(monkeypatch):
    calls = []
    fn = kattn.fused_attention
    monkeypatch.setattr(kattn, "fused_attention",
                        lambda *a, **kw: calls.append(tuple(a[2].shape)) or fn(*a, **kw))
    return calls


TINY = dict(num_latents=16, num_latent_channels=32, num_cross_attention_heads=2,
            cross_attention_widening_factor=2, num_self_attention_heads=2,
            num_self_attention_layers_per_block=1, self_attention_widening_factor=2,
            atten_drop=0.0, mlp_drop=0.0)


def test_feats_model_with_cross_attention_v_channels(rng, route, monkeypatch):
    """PerceiverFeatsModel on points [2, 64, 3] with the cross-attention's
    v width 16 (q/k 32, 2 heads: dh 16, dv 8): the bridged k/v/o
    projections keep their shapes, both outputs agree with JAX, and
    forced, the one cross-attention runs K14 (its twin here) while the
    self-attention layers (equal widths) keep the packed kernels."""
    x = rng.standard_normal((2, 64, 3)).astype(np.float32)
    kw = dict(TINY, num_cross_attention_v_channels=16)
    jm = jpm.PerceiverFeatsModel(adapter="pointcloud", dtype=jnp.float32, **kw)
    variables = _jax_init(jm, x)
    tm = tpm.PerceiverFeatsModel("pointcloud", dtype=torch.float32, device="cpu", **kw)
    state = from_jax_variables(variables)
    att = "encoder.cross_attn_n.CrossAttention_0.attention"
    assert tuple(state[f"{att}.k_proj.weight"].shape) == (32, 32)
    assert tuple(state[f"{att}.v_proj.weight"].shape) == (16, 32)
    assert tuple(state[f"{att}.o_proj.weight"].shape) == (32, 16)
    tm.load_state_dict(state, strict=True)
    calls = _spy_k14(monkeypatch)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for name, g, w in zip(("proj", "backbone"), got, want):
        _close(g, w, MODEL_TOL, name)
    assert calls == ([(2, 2, 64, 8)] if route == "forced" else [])


def test_encoder_with_self_attention_widths(rng, route, monkeypatch):
    """PerceiverEncoder whose self-attention has q/k width 16 and v width 48
    (2 heads: dh 8, dv 24) and whose cross-attention has v width 64: the
    eval latents agree with JAX's, and forced, every attention runs K14."""
    din = 24
    x = rng.standard_normal((2, 40, din)).astype(np.float32)
    kw = dict(num_latents=8, num_latent_channels=32, num_cross_attention_heads=2,
              num_cross_attention_v_channels=64, cross_attention_widening_factor=2,
              num_self_attention_heads=2, num_self_attention_qk_channels=16,
              num_self_attention_v_channels=48, num_self_attention_layers_per_block=2,
              self_attention_widening_factor=2, atten_drop=0.0, mlp_drop=0.0)
    jm = jperc.PerceiverEncoder(dtype=jnp.float32, **kw)
    variables = _jax_init(jm, x)
    tm = tperc.PerceiverEncoder(num_input_channels=din, dtype=torch.float32, **kw).eval()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    att = "self_attn_n.SelfAttentionLayer_0.SelfAttention_0.attention"
    assert tuple(tm.state_dict()[f"{att}.q_proj.weight"].shape) == (16, 32)
    assert tuple(tm.state_dict()[f"{att}.v_proj.weight"].shape) == (48, 32)
    calls = _spy_k14(monkeypatch)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    _close(got, want, MODEL_TOL, "latents")
    assert calls == ([(2, 2, 40, 32)] + [(2, 2, 8, 24)] * 2 if route == "forced" else [])


def test_decoder_takes_the_widths():
    """PerceiverDecoder carries JAX's width fields to its attentions."""
    dec = tperc.PerceiverDecoder(32, 32, num_cross_attention_heads=2,
                                 num_cross_attention_v_channels=16, num_self_attention_heads=2,
                                 num_self_attention_qk_channels=16,
                                 num_self_attention_v_channels=64)
    assert dec.cross_attn.CrossAttention_0.attention.v_channels == 16
    sa = dec.self_attn.SelfAttentionLayer_0.SelfAttention_0.attention
    assert (sa.qk_channels, sa.v_channels) == (16, 64)
    out = dec(torch.zeros(3, 1, 32), torch.zeros(3, 8, 32))
    assert tuple(out.shape) == (3, 1, 32)


def test_forced_train_mode_runs_the_twin_with_gradients(rng, monkeypatch):
    """At dropout 0 the JAX gate holds in train mode too; on CPU tensors the
    twin runs there and passes gradients back (the CUDA kernel has no
    backward and refuses inputs that need one)."""
    from vipformer_tpu_torch.nn.layers import MultiHeadAttention

    monkeypatch.setattr(kattn, "USE_FUSED_ATTENTION", True)
    calls = _spy_k14(monkeypatch)
    mha = MultiHeadAttention(16, 2, torch.float32, v_channels=8).train()
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    mha(x, x).sum().backward()
    assert calls == [(2, 2, 5, 4)]
    assert all(p.grad is not None for p in mha.parameters())
