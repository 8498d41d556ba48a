"""The PyTorch port's layers, weight bridge and serving slice against the
JAX package, on the CPU at small sizes.

Weights come from a flax init (plus random BatchNorm statistics) and reach
the port through `convert.from_jax_variables` with `strict=True`; inputs
come from numpy. Tolerance for the f32 comparisons: 1e-5 relative per
layer, 1e-4 relative for the whole model (summation orders differ).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.models import crossformer as jcf
from vipformer_tpu.nn import layers as jl
from vipformer_tpu.nn import perceiver as jp
from vipformer_tpu.nn import pointnet as jpn
from vipformer_tpu.ops import geometry as jgeo
from vipformer_tpu.ops.pallas import stem as jstem
from vipformer_tpu_torch.config import Config, decode_arch_name
from vipformer_tpu_torch.convert import from_jax_variables
from vipformer_tpu_torch.inference import classifier_predictor
from vipformer_tpu_torch.models import crossformer as tcf
from vipformer_tpu_torch.models import perceiver_models as tpm
from vipformer_tpu_torch.models.factory import (
    build_ft_cls,
    build_ft_partseg,
    build_img_model,
    build_pc_model,
)
from vipformer_tpu_torch.nn import layers as tl
from vipformer_tpu_torch.nn import perceiver as tp
from vipformer_tpu_torch.nn import pointnet as tpn

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_latents=16, num_latent_channels=32, group_size=8,
             num_cross_attention_heads=4, num_self_attention_layers=2,
             num_self_attention_heads=4, mlp_widen_factor=2)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _variables(rng, module, *inputs):
    """flax init + random BatchNorm statistics, as numpy trees."""
    v = module.init({"params": jax.random.key(0)}, *inputs)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), v["batch_stats"])
    return v


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


# name -> (flax module, port module, input shapes)
LAYERS = {
    "dense": (lambda: jl.Dense(24), lambda: tl.Dense(16, 24), [(2, 5, 16)]),
    "layernorm": (lambda: jl.LayerNorm(), lambda: tl.LayerNorm(16), [(2, 5, 16)]),
    "batchnorm": (lambda: jl.batch_norm(True), lambda: tl.BatchNorm(16), [(2, 5, 16)]),
    "mlp": (lambda: jl.MLP(2), lambda: tl.MLP(16, 2), [(2, 5, 16)]),
    "cross_attention_layer": (
        lambda: jl.CrossAttentionLayer(num_heads=4, widening_factor=2),
        lambda: tl.CrossAttentionLayer(32, 4, 2), [(2, 8, 32), (2, 40, 32)]),
    "self_attention_layer": (
        lambda: jl.SelfAttentionLayer(num_heads=4, widening_factor=2),
        lambda: tl.SelfAttentionLayer(32, 4, 2), [(2, 8, 32)]),
    "input_adapter": (lambda: jpn.PointCloudInputAdapter(32),
                      lambda: tpn.PointCloudInputAdapter(3, 32), [(2, 20, 3)]),
    "position_emb": (lambda: jpn.PositionEmb(32), lambda: tpn.PositionEmb(3, 32),
                     [(2, 8, 3)]),
    "group2emb": (lambda: jpn.Group2Emb(32), lambda: tpn.Group2Emb(3, 32), [(2, 4, 8, 3)]),
    "latent_head": (lambda: jp.LatentFeatsHead(32), lambda: tp.LatentFeatsHead(32),
                    [(4, 64)]),
    "finetune_head": (lambda: jcf.FinetuneHead(32, 5), lambda: tcf.FinetuneHead(32, 5),
                      [(4, 64)]),
    # two cross-attention layers: cross_attn_1 first, cross_attn_n after it
    "encoder_two_ca": (
        lambda: jcf.MPEncoder(num_latent_channels=32, num_cross_attention_layers=2,
                              num_cross_attention_heads=4, num_self_attention_layers=2,
                              num_self_attention_heads=4, modal_prior=True),
        lambda: tcf.MPEncoder(32, 2, 4, 2, 4), [(2, 8, 32), (2, 8, 32), (2, 40, 32)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax(rng, name):
    make_jax, make_torch, shapes = LAYERS[name]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jm = make_jax()
    v = _variables(rng, jm, *map(jnp.asarray, xs))
    want = jm.apply(v, *map(jnp.asarray, xs))
    tm = _load(make_torch(), v)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, xs))
    _close(got.numpy(), want, LAYER_RTOL)


def test_dense_adds_bias_after_the_cast(rng):
    """bf16: the product is rounded to bf16 before the bias is added (not
    F.linear's single rounding), as in the JAX Dense."""
    x = rng.standard_normal((64, 32)).astype(np.float32)
    jm = jl.Dense(16, dtype=jnp.bfloat16)
    v = _variables(rng, jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    tm = _load(tl.Dense(32, 16, dtype=torch.bfloat16), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gelu_and_dpr_schedule_match_jax(rng):
    x = rng.standard_normal(1000).astype(np.float32) * 4
    _close(tl.gelu_exact(torch.from_numpy(x)).numpy(), jl.gelu_exact(jnp.asarray(x)), 1e-6)
    for n in (1, 2, 8):
        assert tl.dpr_schedule(0.3, n) == jl.dpr_schedule(0.3, n)


@pytest.fixture(scope="module")
def slice_models():
    """JAX CrossFormerPC / CrossFormerPCFT at small widths, their variables,
    and the port's models loaded from them."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    out = {}
    for name, jcls, tcls, extra in (
        ("pc", jcf.CrossFormerPC, tcf.CrossFormerPC, {}),
        ("ft", jcf.CrossFormerPCFT, tcf.CrossFormerPCFT, {"num_obj_classes": 5}),
    ):
        jm = jcls(**SMALL, **extra, dtype=jnp.float32)
        v = _variables(rng, jm, jnp.zeros((1, 128, 3)), True)
        tm = _load(tcls(**SMALL, **extra, dtype=torch.float32, device="cpu"), v)
        out[name] = (jm, v, tm)
    return pts, out


@pytest.mark.parametrize("kernels", ["xla", "interpret"])
@pytest.mark.parametrize("model", ["pc", "ft"])
def test_slice_matches_jax(slice_models, monkeypatch, request, model, kernels):
    """The whole model at f32 against two JAX paths: its default CPU path
    with the kernel's kNN keys (geometry.KNN_METHOD="pallas"), and the same
    with K1-K3 in interpret mode. The JAX attention stays on its XLA path:
    forcing USE_FUSED_ATTENTION on the CPU routes the SA sites through
    other kernels than K5, so K4/K5 parity rests on test_torch_port_ops."""
    pts, models = slice_models
    jm, v, tm = models[model]
    monkeypatch.setattr(jgeo, "KNN_METHOD", "pallas")
    if kernels == "interpret":
        monkeypatch.setattr(jgeo, "USE_PALLAS_FPS", True)
        monkeypatch.setattr(jstem, "USE_FUSED_STEM", True)
        # the jitted FPS reads its flag while tracing: drop the traces made
        # under the default, and the ones made here once it is restored
        for fn in (jgeo.farthest_point_sample, jgeo.farthest_point_sample_with_centers):
            fn.clear_cache()
            request.addfinalizer(fn.clear_cache)
    want = jm.apply(v, jnp.asarray(pts), True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(pts))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w, MODEL_RTOL)


def test_bridge_is_strict(slice_models):
    _, models = slice_models
    jm, v, tm = models["ft"]
    state = from_jax_variables(v)
    assert "stem.group2emb.Dense_0.weight" in state
    assert "encoder.sa_0.SelfAttention_0.attention.q_proj.weight" in state
    assert "stem.group2emb.BatchNorm_1.running_var" in state
    assert set(state) == set(tm.state_dict())
    kernel = v["params"]["stem"]["group2emb"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["stem.group2emb.Dense_0.weight"].numpy(), kernel.T)
    state.pop("finetune_head.Dense_2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        tm.load_state_dict(state, strict=True)


def test_predictor_strips_padding(slice_models):
    pts, models = slice_models
    tm = models["ft"][2]
    predictor = classifier_predictor(tm, max_batch=8)
    assert predictor.buckets == [1, 2, 4, 8]
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((3, 128, 3)).astype(np.float32)
    out = predictor(batch)
    assert out["logits"].shape == (3, 5) and out["backbone_feats"].shape == (3, 64)
    with torch.inference_mode():
        logits, feats = tm(torch.from_numpy(batch))
    _close(out["logits"], logits.numpy(), LAYER_RTOL)
    _close(out["backbone_feats"], feats.numpy(), LAYER_RTOL)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        predictor(np.zeros((9, 128, 3), np.float32))


def test_factory_builds_from_config():
    cfg = Config(**decode_arch_name("E1CL2SL-H4D32-L16-MR2"), group_size=8,
                 num_obj_classes=5, compute_dtype="float32")
    ft, pc = build_ft_cls(cfg, device="cpu"), build_pc_model(cfg, device="cpu")
    assert isinstance(ft, tcf.CrossFormerPCFT) and isinstance(pc, tcf.CrossFormerPC)
    assert len(ft.encoder.sa_layers) == 2 and ft.stem.dtype == torch.float32
    # same seed, same weights
    a, b = build_ft_cls(cfg, device="cpu").state_dict(), ft.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the generic Perceiver family: all three non-mp builders, seeded as the
    # mp ones; part segmentation stays mp-only, as in the JAX package
    pm = cfg.replace(mp=False, num_sa_layers_per_block=1, img_height=8, img_width=8)
    for build, kind in ((build_pc_model, tpm.PerceiverFeatsModel),
                        (build_img_model, tpm.PerceiverFeatsModel),
                        (build_ft_cls, tpm.PerceiverClassifier)):
        a, b = build(pm, device="cpu"), build(pm, device="cpu")
        assert isinstance(a, kind), build
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), build
    with pytest.raises(NotImplementedError, match="mp family"):
        build_ft_partseg(pm, device="cpu")


def test_chip_smoke_builds_the_configured_flagship(capsys):
    """chip_smoke.py builds its models through the port's factory from the
    flagship's arch name, decoded by the port's Config as the JAX package
    decodes it; without a card the script fails before printing a result."""
    import chip_smoke
    from vipformer_tpu.config import Config as JaxConfig
    from vipformer_tpu.config import decode_arch_name as jax_decode

    cfg = chip_smoke.config()
    jcfg = JaxConfig(**jax_decode(chip_smoke.ARCH))
    for key in jax_decode(chip_smoke.ARCH):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    assert (cfg.num_latent_channels, cfg.num_sa_layers, cfg.num_pc_latents) == (256, 8, 128)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_port_imports_no_jax():
    """Importing every module of `vipformer_tpu_torch` and chip_smoke.py,
    plus a CPU forward, leaves jax, flax, optax and vipformer_tpu out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import vipformer_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(vipformer_tpu_torch.__path__, 'vipformer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from vipformer_tpu_torch.config import Config, decode_arch_name\n"
        "from vipformer_tpu_torch.models.factory import build_ft_cls\n"
        "from vipformer_tpu_torch.inference import classifier_predictor\n"
        "import numpy as np\n"
        "cfg = Config(**decode_arch_name('E1CL1SL-H4D32-L16-MR2'), group_size=8,\n"
        "             num_obj_classes=3, compute_dtype='float32')\n"
        "out = classifier_predictor(build_ft_cls(cfg, device='cpu'), max_batch=2)(\n"
        "    np.zeros((1, 128, 3), np.float32))\n"
        "assert np.isfinite(out['logits']).all()\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'vipformer_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "VIPFORMER_PLATFORM"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
