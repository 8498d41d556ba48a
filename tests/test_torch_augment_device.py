"""The port's on-device augmentations (`vipformer_tpu_torch/data/
augment_device.py`) against the JAX package's, on the CPU.

JAX's threefry streams cannot be reproduced by a torch.Generator, so each
op is held at JAX's own draws: the test re-derives them from the JAX key
with the same `jax.random` calls and splits the JAX op makes, and hands
them to the port's pure function of its draws. Bound: 1e-6 of
max(1, max |jax|) (f32 sums and trigonometry in other orders). The
chain's own draws (from a torch.Generator) are held by their statistics.
Finally the `device_augs` train step is held against the plain step fed
the views it made.

The image chain's resize: jax.image.resize's "linear" and the port's
F.interpolate(bilinear, antialias=True) are both a triangle filter
widened by the scale where it shrinks, its weights renormalised at the
borders. Over five seeds the whole chain's output stayed within 2.7e-7 of
max(1, max |jax|) without a resize, 4.5e-7 growing 12 x 10 to 16 x 14,
4.3e-7 shrinking 20 x 18 to 9 x 7, 1.5e-6 growing 137 x 137 to 144 x 144
and 6.3e-7 shrinking it to 64 x 64; the bound with a resize is 2e-6.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.data import augment_device as jaug
from vipformer_tpu_torch import config as tconfig
from vipformer_tpu_torch.data import augment_device as taug
from vipformer_tpu_torch.models import factory as tfactory
from vipformer_tpu_torch.train import trainer as ttrainer

TOL = 1e-6
RESIZE_TOL = 2e-6


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)
    return err


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _cloud(seed, b=3, n=64, c=3):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    return pts * rng.uniform(0.5, 3.0, (b, 1, 1)).astype(np.float32)


def _jax_view_draws(key, b, n):
    """The draws `pretrain_view(pts, key)` makes, as the port's dict."""
    ks = jax.random.split(key, 5)
    k_ratio, k_mask = jax.random.split(ks[4])
    return {
        "scale": _t(jax.random.uniform(ks[0], (b, 1, 1), minval=0.5, maxval=2.0)),
        "angle": _t(jax.random.uniform(ks[1], (b, 1), minval=0.0, maxval=2.0 * jnp.pi)),
        "translate": _t(jax.random.uniform(ks[2], (b, 1, 3), minval=-0.5, maxval=0.5)),
        "jitter": _t(jax.random.normal(ks[3], (b, n, 3))),
        "ratio": _t(jax.random.uniform(k_ratio, (b, 1)) * 0.875),
        "u": _t(jax.random.uniform(k_mask, (b, n))),
    }


@pytest.mark.parametrize("c", [3, 6])
def test_point_ops_match_jax_at_its_draws(c):
    """normalize, scale, rotate (normals too at C = 6), translate, jitter,
    input dropout and the finetune scale-and-translate, each at JAX's
    draws."""
    pts = _cloud(c, c=c)
    b, n = pts.shape[:2]
    key = jax.random.PRNGKey(c)
    x = torch.from_numpy(pts)
    _close(taug.normalize_unit_sphere(x), jaug.normalize_unit_sphere(pts), name="normalize")
    s = jax.random.uniform(key, (b, 1, 1), minval=0.5, maxval=2.0)
    _close(taug.scale(x, _t(s)), jaug.random_scale(pts, key, 0.5, 2.0), name="scale")
    a = jax.random.uniform(key, (b, 1), minval=0.0, maxval=2.0 * jnp.pi)
    _close(taug.rotate_y(x, _t(a)), jaug.random_rotate_y(pts, key), name="rotate")
    t = jax.random.uniform(key, (b, 1, 3), minval=-0.5, maxval=0.5)
    _close(taug.translate(x, _t(t)), jaug.random_translate(pts, key, 0.5), name="translate")
    z = jax.random.normal(key, (b, n, 3))
    _close(taug.jitter(x, _t(z)), jaug.random_jitter(pts, key), name="jitter")
    k_ratio, k_mask = jax.random.split(key)
    ratio = jax.random.uniform(k_ratio, (b, 1)) * 0.875
    u = jax.random.uniform(k_mask, (b, n))
    got = taug.input_dropout(x, _t(ratio), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jaug.random_input_dropout(pts, key)))
    k_s, k_t = jax.random.split(key)
    s3 = jax.random.uniform(k_s, (b, 1, 3), minval=2.0 / 3.0, maxval=1.5)
    t3 = jax.random.uniform(k_t, (b, 1, 3), minval=-0.2, maxval=0.2)
    _close(taug.scale_and_translate(x, _t(s3), _t(t3)),
           jaug.scale_and_translate_device(pts, key), name="scale_and_translate")


def test_pretrain_views_match_jax_at_its_draws():
    """One view and the two views of the whole chain, at JAX's draws."""
    pts = _cloud(11, b=4, n=128)
    b, n = pts.shape[:2]
    key = jax.random.PRNGKey(5)
    x = torch.from_numpy(pts)
    _close(taug.pretrain_view(x, _jax_view_draws(key, b, n)), jaug.pretrain_view(pts, key))
    k1, k2 = jax.random.split(key)
    w1, w2 = jaug.pretrain_two_views(pts, key)
    _close(taug.pretrain_view(x, _jax_view_draws(k1, b, n)), w1, name="view 1")
    _close(taug.pretrain_view(x, _jax_view_draws(k2, b, n)), w2, name="view 2")


def _order_index(orders):
    table = [tuple(o) for o in taug.JITTER_ORDERS]
    return [table.index(tuple(int(v) for v in o)) for o in orders]


def test_jitter_affine_matches_jax_and_the_sequential_ops_in_all_six_orders():
    """The batched composition equals JAX's vmapped `_jitter_affine` for
    each of the six orders, and applying it equals running brightness,
    contrast (about the running mean luma) and saturation one after the
    other on the image."""
    rng = np.random.default_rng(0)
    b = len(taug.JITTER_ORDERS)
    factors = rng.uniform(0.6, 1.4, (b, 3)).astype(np.float32)
    img = rng.uniform(0, 255, (b, 5, 7, 3)).astype(np.float32)
    mean_rgb = img.mean(axis=(1, 2))
    orders = np.asarray(taug.JITTER_ORDERS, np.int32)
    m, d = taug.jitter_affine(_t(factors), _t(mean_rgb), _t(orders))
    mj, dj = jax.vmap(jaug._jitter_affine)(factors, mean_rgb, orders)
    _close(m, mj, name="M")
    _close(d, dj, name="d")
    assert _order_index(orders) == list(range(b))
    luma = np.asarray(taug.LUMA, np.float64)
    for i in range(b):
        x = img[i].astype(np.float64)
        for op in orders[i]:
            f = factors[i, op]
            if op == 0:
                x = f * x
            elif op == 1:
                x = f * x + (1 - f) * (x @ luma).mean()
            else:
                x = f * x + (1 - f) * (x @ luma)[..., None]
        want = img[i] @ m[i].numpy().T.astype(np.float64) + d[i].numpy()
        _close(want, x, 1e-5, name=f"order {orders[i]}")


@pytest.mark.parametrize("size", [None, (16, 14), (9, 7)])
def test_image_chain_matches_jax_at_its_draws(size):
    """The chain on uint8 images, without a resize, growing 12 x 10 to
    16 x 14 and shrinking 20 x 18 to 9 x 7 (JAX antialiases there), at
    JAX's draws: factors, order and flip."""
    hw = {None: (12, 10), (16, 14): (12, 10), (9, 7): (20, 18)}[size]
    b = 6
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (b, *hw, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(9)
    h, w = size or (None, None)
    want = np.asarray(jaug.image_pretrain_chain(jnp.asarray(imgs), key, h, w))
    k_f, k_o, k_flip = jax.random.split(key, 3)
    d = {"factors": _t(jax.random.uniform(k_f, (b, 3), minval=0.6, maxval=1.4)),
         "order": _t(np.asarray(jaug._JITTER_ORDERS)[
             np.asarray(jax.random.randint(k_o, (b,), 0, 6))]),
         "flip": _t(jax.random.bernoulli(k_flip, 0.5, (b,)))}
    got = taug.image_pretrain_chain(torch.from_numpy(imgs), d, h, w)
    assert got.dtype == torch.float32
    _close(got, want, TOL if size is None else RESIZE_TOL, name=str(size))


def test_generator_draws_statistics():
    """The chain's draws from a torch.Generator: every factor in its
    range, the two views drawn independently, flips near one half, all six
    orders, dropout ratios below 0.875 and the dropped points the cloud's
    first; each `random_*` op is its draw followed by its pure function."""
    g = torch.Generator().manual_seed(0)
    b, n = 2000, 64
    d1, d2 = taug.draw_pretrain_view(b, n, g), taug.draw_pretrain_view(b, n, g)
    for d in (d1, d2):
        assert 0.5 <= d["scale"].min() and d["scale"].max() < 2.0
        assert 0.0 <= d["angle"].min() and d["angle"].max() < 2 * np.pi
        assert d["translate"].abs().max() <= 0.5
        assert 0.0 <= d["ratio"].min() and d["ratio"].max() <= 0.875
        assert abs(float(d["ratio"].mean()) - 0.4375) < 0.03
        assert abs(float(d["jitter"].std()) - 1.0) < 0.01
    for k in ("scale", "angle", "ratio"):
        r = np.corrcoef(d1[k].reshape(-1).numpy(), d2[k].reshape(-1).numpy())[0, 1]
        assert abs(r) < 0.1, (k, r)
    im = taug.draw_image_chain(b, g)
    assert 0.6 <= im["factors"].min() and im["factors"].max() < 1.4
    assert abs(float(im["flip"].float().mean()) - 0.5) < 0.04
    assert sorted(set(_order_index(im["order"].tolist()))) == list(range(6))
    pts = torch.from_numpy(_cloud(1, b=8, n=512))
    b8, n8 = pts.shape[:2]
    for rand, draw, pure in (
            (taug.random_scale, lambda: taug.draw_scale(b8, g), taug.scale),
            (taug.random_rotate_y, lambda: taug.draw_rotate_y(b8, g), taug.rotate_y),
            (taug.random_translate, lambda: taug.draw_translate(b8, g), taug.translate),
            (taug.random_jitter, lambda: taug.draw_jitter(b8, n8, g), taug.jitter),
            (taug.random_input_dropout, lambda: taug.draw_input_dropout(b8, n8, g),
             taug.input_dropout),
            (taug.scale_and_translate_device, lambda: taug.draw_scale_and_translate(b8, g),
             taug.scale_and_translate)):
        state = g.get_state()
        got = rand(pts, g)
        g.set_state(state)
        d = draw()
        assert torch.equal(got, pure(pts, *d) if isinstance(d, tuple) else pure(pts, d)), rand
    v1, v2 = taug.pretrain_two_views(pts, g)
    assert not torch.equal(v1, v2)
    for v in (v1, v2):
        same = (v == v[:, :1]).all(-1)[:, 1:].float().mean(1)
        assert float(same.max()) <= 0.875 + 0.05
        assert torch.isfinite(v).all()


TINY = dict(tconfig.decode_arch_name("E1CL2SL-H4D32-L16-MR2"), group_size=8, num_pt_points=128,
            img_height=24, img_width=24, patch_size=12, compute_dtype="float32",
            atten_drop=0.1, mlp_drop=0.1, max_dpr=0.0, optim="adamw", lr=1e-3)


def test_device_augs_step_equals_the_plain_step_on_its_views(monkeypatch):
    """The `device_augs` step makes both views and the image chain from the
    step's generator before the model draws from it: recorded, its views
    and images and the generator's state after them, fed to the plain step
    from the same weights, give the same loss, gradients and update, bit
    for bit. Without a generator it raises."""
    cfg = tconfig.Config(**TINY, device_augs=True)
    rng = np.random.default_rng(0)
    batch = {"pc_raw": rng.standard_normal((4, 128, 3)).astype(np.float32),
             "imgs": rng.integers(0, 256, (4, 24, 24, 3)).astype(np.uint8)}
    models = {"pc": tfactory.build_pc_model(cfg, device="cpu", seed=1),
              "img": tfactory.build_img_model(cfg, device="cpu", seed=2)}
    plain_models = copy.deepcopy(models)
    seen = {}

    def two_views(pts, generator):
        seen["views"] = taug.pretrain_two_views(pts, generator)
        return seen["views"]

    def image_chain(imgs, generator):
        seen["imgs"] = taug.random_image_chain(imgs, generator)
        seen["state"] = generator.get_state()
        return seen["imgs"]

    monkeypatch.setattr(ttrainer, "pretrain_two_views", two_views)
    monkeypatch.setattr(ttrainer, "random_image_chain", image_chain)
    state = ttrainer.create_state(cfg, models)
    step = ttrainer.make_pretrain_step(cfg, models["pc"], models["img"])
    with pytest.raises(ValueError, match="generator"):
        step(state, batch, 1e-3)
    _, got = step(state, batch, 1e-3, torch.Generator().manual_seed(7))

    pcfg = tconfig.Config(**TINY)
    pstate = ttrainer.create_state(pcfg, plain_models)
    gen = torch.Generator()
    gen.set_state(seen["state"])
    plain = {"pc_t1": seen["views"][0], "pc_t2": seen["views"][1], "imgs": seen["imgs"]}
    _, want = ttrainer.make_pretrain_step(pcfg, plain_models["pc"], plain_models["img"])(
        pstate, plain, 1e-3, gen)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(state.parameters(), pstate.parameters()):
        assert torch.equal(a.grad, b.grad)
        assert torch.equal(a, b)
