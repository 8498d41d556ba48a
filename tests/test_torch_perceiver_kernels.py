"""The Perceiver slice's kernel modules (K13, K15), its adapters, encoder,
models and attention gates against the JAX package, on the CPU.

K13's and K15's wrappers take their plain twins on CPU tensors; they are
held against the Pallas kernels they replace (`fused_attention_packed`,
`fused_attention_packed_kv`), run by the JAX package in interpret mode on
the same numpy inputs, including several kv chunks (an explicit
`kv_chunk` on the JAX side), an M that no 32-token chunk divides, and a
single query row. The modules are held against the flax modules with
weights carried over by `convert.from_jax_variables` and the attention
kernels forced on both sides (`USE_FUSED_ATTENTION`). The CUDA kernels
themselves run only on a card (tests/test_torch_port_cuda.py,
chip_smoke.py).

Tolerances, relative to max(1, max |jax|): kernels in f32 within 1e-5
(sums in other orders), in bf16 within 2e-2 (chip_smoke.py's KERNEL_TOL:
one bf16 rounding of an intermediate may flip); the image adapter exactly;
modules and models in f32 within 1e-4 (tests/test_torch_port_model.py's
whole-model bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.models import perceiver_models as jpm
from vipformer_tpu.nn import adapters as jad
from vipformer_tpu.nn import perceiver as jperc
from vipformer_tpu.ops.pallas import attention as jattn
from vipformer_tpu.ops.pallas import dense as jdense
from vipformer_tpu.ops.pallas import flash_train as jflash
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.models import perceiver_models as tpm
from vipformer_tpu_torch.nn import adapters as tad
from vipformer_tpu_torch.nn import perceiver as tperc
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import dense as kdense
from vipformer_tpu_torch.ops.cuda import flash_train as kflash

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, name=""):
    got = np.asarray((got.detach().float() if isinstance(got, torch.Tensor) else got), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.fixture
def fused():
    """Force the attention kernels (their twins here, interpret mode on
    the JAX side) on both sides, and restore the flags after the test."""
    saved = kattn.USE_FUSED_ATTENTION, jattn.USE_FUSED_ATTENTION
    kattn.USE_FUSED_ATTENTION = jattn.USE_FUSED_ATTENTION = True
    yield
    kattn.USE_FUSED_ATTENTION, jattn.USE_FUSED_ATTENTION = saved


# -------------------------------------------------------------- K13, K15


# (B, G, M, JAX kv_chunk): several chunks, an M no 32-token chunk divides
# (one chunk on the JAX side), and a single query row
CASES = [(2, 8, 576, 64), (2, 5, 1000, None), (3, 1, 576, 192)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,g,m,chunk", CASES)
def test_packed_attention_matches_pallas(rng, b, g, m, chunk, dt):
    """K13's wrapper on CPU tensors against fused_attention_packed."""
    tdt, jdt = DTYPES[dt]
    h, d = 2, 128
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for n in (g, m, m))
    scale = (d // h) ** -0.5
    want = jattn.fused_attention_packed(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), num_heads=h,
        scale=scale, kv_chunk=chunk, interpret=True)
    got = kattn.fused_attention_packed(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                                       num_heads=h, scale=scale)
    assert got.dtype == tdt
    _close(got, want, KERNEL_TOL[dt], "K13")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,g,m,chunk", CASES)
@pytest.mark.parametrize("din", [128, 96])
def test_packed_kv_attention_matches_pallas(rng, b, g, m, chunk, din, dt):
    """K15's wrapper on CPU tensors against fused_attention_packed_kv: the
    k/v projections rounded to the compute dtype, then K13's attention."""
    tdt, jdt = DTYPES[dt]
    h, d = 2, 128
    q = rng.standard_normal((b, g, d)).astype(np.float32)
    x = rng.standard_normal((b, m, din)).astype(np.float32)
    wk, wv = (rng.standard_normal((din, d)).astype(np.float32) * din ** -0.5 for _ in "kv")
    scale = (d // h) ** -0.5
    want = jattn.fused_attention_packed_kv(
        *(jnp.asarray(t, jdt) for t in (q, x, wk, wv)), num_heads=h, scale=scale,
        kv_chunk=chunk, interpret=True)
    got = kattn.fused_attention_packed_kv(*(torch.from_numpy(t).to(tdt) for t in (q, x, wk, wv)),
                                          num_heads=h, scale=scale)
    _close(got, want, KERNEL_TOL[dt], "K15")


def test_twins_chunking_is_numerics_only(rng):
    """The twins stream over chunks as the Pallas kernels do; the chunk
    size moves only the f32 rounding of the running rescale."""
    b, g, m, h, d = 2, 4, 1728, 2, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
               for n in (g, m, m))
    whole = kattn.attention_packed_plain(q, k, v, h, 0.125, kv_chunk=m)
    for chunk in (64, 200, 1000):
        _close(kattn.attention_packed_plain(q, k, v, h, 0.125, kv_chunk=chunk), whole.numpy(),
               KERNEL_TOL["float32"], str(chunk))


# ------------------------------------------------------------- adapters


@pytest.mark.parametrize("hw,bands", [((24, 24), 4), ((8, 12), 3)])
def test_image_input_adapter_matches_jax(rng, hw, bands):
    """Pixels + Fourier encoding, exactly (the encoding is numpy on both
    sides, cast to the images' dtype before the concat)."""
    shape = (*hw, 3)
    imgs = rng.standard_normal((2, *shape)).astype(np.float32)
    jm = jad.ImageInputAdapter(shape, bands)
    want = jm.apply({}, jnp.asarray(imgs))
    tm = tad.ImageInputAdapter(shape, bands)
    got = tm(torch.from_numpy(imgs))
    assert tm.num_input_channels == jm.num_input_channels == 3 + 2 * (2 * bands + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_bf16 = tm(torch.from_numpy(imgs).to(torch.bfloat16))
    want_bf16 = jm.apply({}, jnp.asarray(imgs, jnp.bfloat16))
    np.testing.assert_array_equal(got_bf16.float().numpy(),
                                  np.asarray(want_bf16.astype(jnp.float32)))
    with pytest.raises(ValueError, match="input image shape"):
        tm(torch.zeros((1, hw[0] + 1, hw[1], 3)))


def test_fourier_encoding_is_made_once_per_device_and_dtype(rng):
    """The adapter reuses one encoding tensor per (grid, bands, device,
    dtype), and one made under inference mode serves a forward that
    records autograd afterwards."""
    tad._fourier_encoding_on.cache_clear()
    tm = tad.ImageInputAdapter((6, 5, 3), 3)
    imgs = torch.from_numpy(rng.standard_normal((2, 6, 5, 3)).astype(np.float32))
    with torch.inference_mode():
        want = tm(imgs)
    x = imgs.clone().requires_grad_(True)
    got = tm(x)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    np.testing.assert_array_equal(x.grad.numpy(), np.ones_like(imgs.numpy()))
    tm(imgs.to(torch.bfloat16))
    info = tad._fourier_encoding_on.cache_info()
    assert (info.misses, info.hits) == (2, 1)


def test_classification_output_adapter_init_and_squeeze():
    """output_query N(0, 0.02) clamped to +-2; logits [B, 1, C] squeezed."""
    tm = tad.ClassificationOutputAdapter(5, 1, 16)
    assert tuple(tm.output_query.shape) == (1, 16)
    big = tad.latent_init((4096,), torch.Generator().manual_seed(0))
    assert 0.018 < float(big.std()) < 0.022 and float(big.abs().max()) <= 2.0
    assert tuple(tm(torch.zeros(3, 1, 16)).shape) == (3, 5)
    assert tuple(tm(torch.zeros(3, 2, 16)).shape) == (3, 2, 5)


# -------------------------------------------------------------- encoder


def _jax_init(module, *inputs):
    variables = module.init(jax.random.key(0), *(jnp.asarray(x) for x in inputs))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.mark.parametrize("share_ca,share_sa", [(False, True), (True, False), (False, False)])
def test_perceiver_encoder_sharing_matches_jax(rng, fused, share_ca, share_sa):
    """Two cross-attention layers and two SA blocks, the first of each
    shared or not: the same parameters exist on both sides (a shared
    module once, under its `_n` name) and the eval latents agree."""
    d, din, h = 32, 21, 2
    x = rng.standard_normal((2, 40, din)).astype(np.float32)
    kw = dict(num_latents=8, num_latent_channels=d, num_cross_attention_heads=h,
              num_cross_attention_qk_channels=d, num_cross_attention_layers=2,
              first_cross_attention_layer_shared=share_ca, cross_attention_widening_factor=2,
              num_self_attention_heads=h, num_self_attention_layers_per_block=1,
              num_self_attention_blocks=2, first_self_attention_block_shared=share_sa,
              self_attention_widening_factor=2, atten_drop=0.0, mlp_drop=0.0)
    jm = jperc.PerceiverEncoder(dtype=jnp.float32, **kw)
    variables = _jax_init(jm, x)
    want = jm.apply(variables, jnp.asarray(x))
    tm = tperc.PerceiverEncoder(num_input_channels=din, dtype=torch.float32, **kw).eval()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tops = {k.split(".")[0] for k in tm.state_dict()}
    assert ("cross_attn_1" in tops) == (not share_ca)
    assert ("self_attn_1" in tops) == (not share_sa)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    _close(got, want, MODEL_TOL, "latents")


# --------------------------------------------------------------- models

TINY = dict(num_latents=16, num_latent_channels=32, num_cross_attention_heads=2,
            num_cross_attention_qk_channels=32, cross_attention_widening_factor=2,
            num_self_attention_heads=2, num_self_attention_layers_per_block=2,
            self_attention_widening_factor=2, atten_drop=0.0, mlp_drop=0.0)


def _bridged(jm, tm, x):
    variables = _jax_init(jm, x)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


@pytest.mark.parametrize("adapter", ["pointcloud", "image"])
def test_feats_model_matches_jax(rng, fused, adapter):
    """PerceiverFeatsModel on points [2, 64, 3] and on 24x24 images with 4
    bands (576 tokens of 21 channels): both eval outputs."""
    extra = dict(image_shape=(24, 24, 3), num_frequency_bands=4) if adapter == "image" else {}
    shape = (2, 24, 24, 3) if adapter == "image" else (2, 64, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jpm.PerceiverFeatsModel(adapter=adapter, dtype=jnp.float32, **TINY, **extra)
    variables = _bridged(jm, tm := tpm.PerceiverFeatsModel(adapter, dtype=torch.float32,
                                                           device="cpu", **TINY, **extra), x)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for name, g, w in zip(("proj", "backbone"), got, want):
        _close(g, w, MODEL_TOL, name)


@pytest.mark.parametrize("decoder", ["query", "pooled"])
def test_classifier_matches_jax(rng, fused, decoder):
    """PerceiverClassifier with the output-query decoder (the adapter's
    keys at the classifier's top level, as in the flax tree) and with the
    pooled head: logits and pooled features in eval."""
    x = rng.standard_normal((3, 64, 3)).astype(np.float32)
    kw = {k: v for k, v in TINY.items() if k != "num_cross_attention_qk_channels"}
    jm = jpm.PerceiverClassifier(adapter="pointcloud", num_classes=5, decoder=decoder,
                                 dtype=jnp.float32, **kw)
    tm = tpm.PerceiverClassifier("pointcloud", num_classes=5, decoder=decoder,
                                 dtype=torch.float32, device="cpu",
                                 num_cross_attention_qk_channels=32, **kw)
    variables = _bridged(jm, tm, x)
    if decoder == "query":
        assert "output_adapter" in variables["params"]
    want = jm.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for name, g, w in zip(("logits", "feats"), got, want):
        _close(g, w, MODEL_TOL, name)


# ---------------------------------------------------------------- gates


def _route_jax(site, h=4):
    """The kernel the JAX layers pick for one site of the routing table."""
    kind, train, b, g, m, din = site
    d = 256
    if kind == "dense":
        return jdense.dense_grad_enabled(b, g, m, 2)
    if kind == "ca":
        if train and jflash.flash_train_kv_enabled(h, d, d, g, m, din, None, False):
            return "K7"
        if not train and jattn.packed_attention_kv_enabled(h, d, d, m, din, None, 0.1, True):
            return "K4"
        # else LN, then the MultiHeadAttention over the normalised tokens
    if kind == "sa":
        if not train and jattn.packed_small_qkv_ln_enabled(h, d, d, b, g, din, None, 0.1, True):
            return "K6"
    if not train and jattn.packed_attention_kv_enabled(h, d, d, m, din, None, 0.1, True):
        return "K15"
    if train and jflash.flash_train_enabled(h, d, d, g, m, None, False):
        return "K8"
    if jattn.packed_attention_enabled(h, d, d, m, None, 0.1, not train):
        return "K13"
    if jattn.packed_small_attention_enabled(h, d, d, g, m, None, 0.1, not train):
        return "K5"
    return "plain"


def _route_port(site, h=4):
    """The kernel the port's layers pick for the same site on the card."""
    kind, train, b, g, m, din = site
    d = 256
    if kind == "dense":
        return kdense.dense_grad_enabled(b, g, m, 2, True)
    if kind == "ca":
        if kflash.flash_train_kv_enabled(h, d, d, din, train, True):
            return "K7"
        if kattn.packed_attention_kv_enabled(h, d, d, m, din, 0.1, train, True):
            return "K4"
    if kind == "sa" and kattn.packed_small_qkv_ln_enabled(h, d, d, b, g, din, train, True):
        return "K6"
    if kattn.packed_attention_kv_enabled(h, d, d, m, din, 0.1, train, True):
        return "K15"
    if kflash.flash_train_enabled(h, d, d, train, True):
        return "K8"
    if kattn.packed_attention_enabled(h, d, d, m, 0.1, train, True):
        return "K13"
    if kattn.packed_small_attention_enabled(h, d, d, g, m, 0.1, train, True):
        return "K5"
    return "plain"


# (site kind, train mode, batch, G, M, Din) -> the route of the PR's
# routing table (D = 256, 4 heads, atten_drop 0.1). Dense sites are
# (rows, Cin, Cout) with the route K11's gate gives.
ROUTES = [
    (("ca", True, 96, 128, 2048, 256), "K7"),        # point CA, pretrain
    (("ca", False, 330, 128, 1024, 256), "K4"),      # point CA, ft_cls eval
    (("ca", True, 48, 128, 20736, 261), "K8"),       # Fourier image CA, train
    (("ca", False, 48, 128, 20736, 261), "K13"),     # Fourier image CA, eval
    (("sa", True, 96, 128, 128, 256), "K8"),         # encoder SA, train
    (("sa", False, 330, 128, 128, 256), "K6"),       # encoder SA, eval B >= 128
    (("sa", False, 48, 128, 128, 256), "K5"),        # encoder SA, eval B < 128
    (("sa", False, 64, 512, 512, 256), "K15"),       # SA at 512 latents
    (("sa", False, 330, 512, 512, 256), "K15"),      # (K6's tiles do not fit)
    (("ca", True, 330, 1, 128, 256), "K7"),          # decoder CA, train
    (("ca", False, 330, 1, 128, 256), "K5"),         # decoder CA, eval
    (("sa", True, 330, 1, 1, 256), "K8"),            # decoder SA, train
    (("sa", False, 330, 1, 1, 256), "K6"),           # decoder SA, eval B >= 128
    (("sa", False, 8, 1, 1, 256), "K5"),             # decoder SA, eval B < 128
    (("dense", True, 42240, 256, 256, 0), True),     # ft_cls latent Denses
    (("dense", True, 42240, 256, 512, 0), True),
    (("dense", True, 337920, 64, 256, 0), False),    # ft_cls input adapter
    (("dense", True, 196608, 64, 256, 0), False),    # pretrain point adapter
    (("dense", True, 12288, 256, 256, 0), False),    # pretrain latents (96 clouds)
]


@pytest.mark.parametrize("site,route", ROUTES, ids=[str(s) for s, _ in ROUTES])
def test_gates_route_as_jax(monkeypatch, site, route):
    """JAX's gates on a TPU backend (its auto policy) and the port's on the
    card give the routing table's kernel at every site."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert _route_jax(site) == route
    assert _route_port(site) == route


def test_gates_stay_off_the_cpu_in_auto():
    """Auto means the card: on CPU tensors every attention gate is off
    (the plain attention runs), unless the flag forces the twins."""
    assert kattn.USE_FUSED_ATTENTION is None
    assert not kattn.packed_attention_enabled(4, 256, 256, 20736, 0.1, False, False)
    assert not kattn.packed_attention_kv_enabled(4, 256, 256, 512, 256, 0.1, False, False)
    assert not kattn.packed_small_attention_enabled(4, 256, 256, 128, 128, 0.1, False, False)
    assert not kflash.flash_train_enabled(4, 256, 256, True, False)
    assert not kflash.flash_train_kv_enabled(4, 256, 256, 256, True, False)


@pytest.mark.parametrize("heads", [2, 8])
@pytest.mark.parametrize("site,route", ROUTES, ids=[str(s) for s, _ in ROUTES])
def test_gates_ignore_the_head_width(monkeypatch, site, route, heads):
    """At head widths the kernels are not built for (128, 32) the port's
    gates still route as JAX's: on the card the kernel then raises rather
    than the layer falling back to the plain attention."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert _route_port(site, heads) == _route_jax(site, heads) == route


@pytest.mark.parametrize("kernel,check", [
    ("attn_packed", lambda: kattn.require_head_width("attn_packed", 256, 2)),
    ("attn_train", lambda: kflash._check_heads(256, 8)),
])
def test_kernels_refuse_other_head_widths(kernel, check):
    with pytest.raises(NotImplementedError, match="dh=64"):
        check()
    kattn.require_head_width(kernel, 256, 4)
    kflash._check_heads(256, 4)
