"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here needs the card: it carries the `cuda` marker and skips
inside the test when `torch.cuda.is_available()` is false. The file
imports no JAX (the card's machine has none), so run it there with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

`chip_smoke.py` runs the same comparisons at the flagship shapes; these
cover other shapes the wrappers accept: another width and head count,
more points, a token count that is not a multiple of the kernels' chunk,
and smaller groups.

Tolerances: FPS and kNN indices exactly equal (both sides use the same
f32 difference-of-squares keys); K3-K5 within 2e-5 (f32) and 2e-2 (bf16)
of max(1, max |twin|), as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from vipformer_tpu_torch.models.crossformer import CrossFormerPCFT, init_weights
from vipformer_tpu_torch.nn.pointnet import Group2Emb
from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import fps as kfps
from vipformer_tpu_torch.ops.cuda import knn as kknn
from vipformer_tpu_torch.ops.cuda import stem as kstem

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (batch, points, groups, group size, width, heads)
SHAPES = [(3, 2048, 64, 32, 384, 6), (2, 1000, 128, 16, 256, 4), (1, 512, 32, 32, 128, 2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev, dt=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dt)


def _assert_close(got, want, dt):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dt] * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_twins(dev, shape, dt):
    b, n, g, s, d, h = shape
    rng = np.random.default_rng(0)
    xyz = _t(rng, (b, n, 3), dev)
    start = torch.zeros(b, dtype=torch.int32, device=dev)
    idx, centers = kfps.fps(xyz, g)
    want_idx, want_c = kfps.fps_plain(xyz, g, start)
    assert torch.equal(idx, want_idx) and torch.equal(centers, want_c)
    nn_idx = kknn.knn(s, xyz, centers)
    assert torch.equal(nn_idx, kknn.knn_plain(s, xyz, centers))

    g2e = init_weights(Group2Emb(3, d), 0).to(dev)
    ops = kstem.stem_operands(g2e, xyz, centers, nn_idx, dt)
    _assert_close(kstem.stem_kernel(*ops), kstem.stem_plain(*ops), dt)

    scale = (d // h) ** -0.5
    args = (_t(rng, (b, g, d), dev, dt), _t(rng, (b, n, d), dev, dt),
            _t(rng, (d,), dev, scale=0.2) + 1.0, _t(rng, (d,), dev, scale=0.1),
            _t(rng, (d, d), dev, dt, d ** -0.5), _t(rng, (d, d), dev, dt, d ** -0.5))
    _assert_close(kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=scale),
                  kattn.attention_kv_ln_plain(*args, h, scale), dt)
    qkv = [_t(rng, (b, g, d), dev, dt) for _ in range(3)]
    _assert_close(kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale),
                  kattn.attention_small_plain(*qkv, h, scale), dt)


@pytest.mark.cuda
def test_model_on_card_matches_cpu(dev):
    """A small classifier on the card (f32) against the same weights on the
    CPU: equal logits within 1e-4, every kernel launched."""
    kw = dict(num_latents=32, num_latent_channels=128, group_size=16,
              num_cross_attention_heads=2, num_self_attention_layers=2,
              num_self_attention_heads=2, mlp_widen_factor=2, num_obj_classes=7,
              dtype=torch.float32)
    cpu = CrossFormerPCFT(**kw)
    card = CrossFormerPCFT(**kw, device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    pts = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 512, 3)).astype(
        np.float32))
    kcuda.reset_launch_counts()
    with torch.inference_mode():
        want, _ = cpu(pts)
        got, _ = card(pts.to(dev))
    assert all(n > 0 for n in kcuda.launch_counts().values()), kcuda.launch_counts()
    _assert_close(got.cpu(), want, torch.float32)
