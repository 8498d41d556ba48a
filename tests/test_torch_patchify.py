"""K16 (fused FPS + kNN) against the JAX package, on the CPU.

The wrapper `ops.cuda.patchify.fps_knn` takes its plain twin on CPU
tensors; the twin is held against the Pallas kernel it replaces
(`fps_knn_pallas`, run by the JAX package in interpret mode) and against
the port's own K1 + K2 twins on the same numpy inputs, at several cloud,
group and neighbourhood sizes, with index 0 and random FPS starts. Both
are index computations over the same f32 difference-of-squares keys, so
every comparison is exact (`assert_array_equal`). The route through K16
(`USE_FPS_KNN`) gives the same patches and the same fused-stem features as
the default K1 + K2 route. The CUDA kernel itself runs only on a card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _knn_clouds import hard_cloud
from vipformer_tpu.ops.pallas.patchify import fps_knn_pallas
from vipformer_tpu_torch.models.crossformer import CrossFormerPC
from vipformer_tpu_torch.ops import geometry as tgeo
from vipformer_tpu_torch.ops.cuda import fps as kfps
from vipformer_tpu_torch.ops.cuda import knn as kknn
from vipformer_tpu_torch.ops.cuda import patchify as kpatch

# (B, N, G, K, random start, cloud): a power-of-two cloud, a ragged one,
# G = N and K = N; then clouds that stress the kNN selection (normal ones
# keep their ids): "tied", every fifth point a copy of the one before it and
# the first cloud on a half-unit lattice; "lane", uniform with the points
# of one lane of K2's warps (index = 31 mod 32) moved 8 units away
CASES = [pytest.param(2, 64, 8, 4, False, None, id="2-64-8-4-False"),
         pytest.param(3, 100, 16, 8, True, None, id="3-100-16-8-True"),
         pytest.param(2, 257, 32, 16, True, None, id="2-257-32-16-True"),
         pytest.param(1, 128, 128, 32, False, None, id="1-128-128-32-False"),
         pytest.param(2, 40, 8, 40, True, None, id="2-40-8-40-True"),
         pytest.param(2, 100, 16, 8, True, "tied", id="tied-2-100-16-8-True"),
         pytest.param(1, 64, 64, 33, False, "tied", id="tied-1-64-64-33-False"),
         pytest.param(2, 256, 32, 32, True, "lane", id="lane-2-256-32-32-True"),
         pytest.param(1, 96, 24, 4, False, "lane", id="lane-1-96-24-4-False")]


@pytest.fixture
def forced():
    saved = kpatch.USE_FPS_KNN
    kpatch.USE_FPS_KNN = True
    yield
    kpatch.USE_FPS_KNN = saved


def _cloud(rng, b, n, c=3, kind=None):
    if kind is None:
        return rng.standard_normal((b, n, c)).astype(np.float32)
    return hard_cloud(rng.uniform(-1, 1, (b, n, c)).astype(np.float32), kind)


@pytest.mark.parametrize("b,n,g,k,random_start,cloud", CASES)
def test_fps_knn_twin_matches_pallas(rng, b, n, g, k, random_start, cloud):
    """centers_idx [B, G] and neighbor_idx [B, G, K] equal to the Pallas
    kernel's in interpret mode, and to K1's twin followed by K2's."""
    xyz = _cloud(rng, b, n, kind=cloud)
    start = rng.integers(0, n, b).astype(np.int32) if random_start else None
    want_c, want_n = fps_knn_pallas(jnp.asarray(xyz), g, k,
                                    None if start is None else jnp.asarray(start),
                                    interpret=True)
    t_start = None if start is None else torch.from_numpy(start)
    got_c, got_n = kpatch.fps_knn(torch.from_numpy(xyz), g, k, t_start)
    assert got_c.dtype == got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    idx, centers = kfps.fps(torch.from_numpy(xyz), g, t_start)
    np.testing.assert_array_equal(got_c.numpy(), idx.numpy())
    np.testing.assert_array_equal(got_n.numpy(), kknn.knn(k, torch.from_numpy(xyz),
                                                          centers).numpy())


def test_fps_knn_reads_the_xyz_of_wider_points(rng):
    """Points with extra channels (semseg's xyz + rgb): only the first three
    are read, as K1 and K2 read them."""
    pts = _cloud(rng, 2, 90, 6)
    got = kpatch.fps_knn(torch.from_numpy(pts), 12, 6)
    want = kpatch.fps_knn(torch.from_numpy(np.ascontiguousarray(pts[..., :3])), 12, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flag_is_off_by_default():
    """Auto (None) keeps K1 + K2, as the JAX package wires its kernel
    nowhere; only True forces K16."""
    saved = kpatch.USE_FPS_KNN
    try:
        for flag, on in ((None, False), (False, False), (True, True)):
            kpatch.USE_FPS_KNN = flag
            assert kpatch.fps_knn_enabled() is on
    finally:
        kpatch.USE_FPS_KNN = saved


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("seeded", [False, True])
def test_route_gives_the_same_patches(rng, channels, seeded):
    """divide_patches (the train stem's FPS, kNN and centered gather) with
    K16 forced equals the default route: the same centers (every channel),
    neighbourhoods and FPS starts from the same generator draws."""
    pts = torch.from_numpy(_cloud(rng, 3, 96, channels))

    def run():
        gen = torch.Generator().manual_seed(5) if seeded else None
        return tgeo.divide_patches(pts, 16, 8, gen)

    saved = kpatch.USE_FPS_KNN
    try:
        kpatch.USE_FPS_KNN = None
        want = run()
        kpatch.USE_FPS_KNN = True
        got = run()
    finally:
        kpatch.USE_FPS_KNN = saved
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_stem_route_gives_the_same_features(rng, monkeypatch):
    """The eval forward of a small CrossFormerPC (the fused stem K3's twin
    at 128 rows) gives the same features bit for bit with K16 forced; the
    forced route calls the fused wrapper once and K1 / K2 never."""
    model = CrossFormerPC(num_latents=16, num_latent_channels=32, group_size=8,
                          num_cross_attention_heads=2, num_self_attention_layers=1,
                          num_self_attention_heads=2, mlp_widen_factor=2,
                          dtype=torch.float32, device="cpu", seed=3)
    pts = torch.from_numpy(_cloud(rng, 2, 128))
    with torch.inference_mode():
        want = model(pts)
    calls = []
    for mod, name in ((kpatch, "fps_knn"), (kfps, "fps"), (kknn, "knn")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: calls.append(_n)
                            or _f(*a, **kw))
    monkeypatch.setattr(kpatch, "USE_FPS_KNN", True)
    with torch.inference_mode():
        got = model(pts)
    assert calls == ["fps_knn"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
