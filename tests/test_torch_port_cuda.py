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
f32 difference-of-squares keys); K3-K6 within 2e-5 (f32) and 2e-2 (bf16)
of max(1, max |twin|), as in chip_smoke.py; K13 of the twin's own max.
"""

import numpy as np
import pytest
import torch

from _knn_clouds import KNN_CLOUDS, KNN_SHAPES, hard_cloud
from vipformer_tpu_torch.models.crossformer import CrossFormerPCFT, init_weights
from vipformer_tpu_torch.nn.pointnet import Group2Emb
from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import attention as kattn
from vipformer_tpu_torch.ops.cuda import fps as kfps
from vipformer_tpu_torch.ops.cuda import knn as kknn
from vipformer_tpu_torch.ops.cuda import stem as kstem

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVING_KERNELS = ("fps", "knn", "stem", "attn_kv_ln", "attn_small")

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


def _assert_close(got, want, dt, floor=1.0):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dt] * max(floor, want.float().abs().max().item()), err


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


# ---------------------------------------------------------------- K2
# K2 equal to its twin in its order (torch.equal) and to a second launch at
# (N, k) from k = N to the threshold select's largest k (128) and past it
# (the exact scan: 129, 200), on uniform, tied and lane-adversarial clouds
# (the queries the FPS centers, as on the main path).


def _knn_cloud(gen, kind, b, n, dev):
    """A [B, N, 3] f32 cloud of `kind` (tests/_knn_clouds.py) on `dev`."""
    return hard_cloud(torch.rand((b, n, 3), generator=gen, device=dev) * 2 - 1, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KNN_CLOUDS)
@pytest.mark.parametrize("n,k", [*KNN_SHAPES, (1024, 129), (4096, 200)])
def test_knn_kernel_matches_twin_on_hard_clouds(dev, n, k, kind):
    """Equal to knn_plain in order and to a second launch; on the
    lane-adversarial clouds past 512 points, where the threshold is the
    largest kept key (k = 32, 128), queries take the exact scan."""
    gen = torch.Generator(device=dev).manual_seed(n + k)
    b, g = 3, min(128, n)
    xyz = _knn_cloud(gen, kind, b, n, dev)
    start = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
    centers = kfps.fps(xyz, g, start)[1]
    over = torch.zeros(1, dtype=torch.int32, device=dev)
    got = kknn.knn(k, xyz, centers, overflow=over)
    assert torch.equal(got, kknn.knn_plain(k, xyz, centers))
    assert torch.equal(got, kknn.knn(k, xyz, centers))
    if kind == "lane" and n > 512 and k in (32, 128):
        assert over.item() > 0


@pytest.mark.cuda
def test_model_on_card_matches_cpu(dev):
    """A small classifier on the card (f32) against the same weights on the
    CPU: equal logits within 1e-4, every serving kernel (K1-K5) launched."""
    kw = dict(num_latents=32, num_latent_channels=128, group_size=16,
              num_cross_attention_heads=2, num_self_attention_layers=2,
              num_self_attention_heads=2, mlp_widen_factor=2, num_obj_classes=7,
              dtype=torch.float32)
    cpu = CrossFormerPCFT(**kw, device="cpu")
    card = CrossFormerPCFT(**kw, device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    pts = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 512, 3)).astype(
        np.float32))
    kcuda.reset_launch_counts()
    with torch.inference_mode():
        want, _ = cpu(pts)
        got, _ = card(pts.to(dev))
    counts = kcuda.launch_counts()
    assert all(counts[k] > 0 for k in SERVING_KERNELS), counts
    _assert_close(got.cpu(), want, torch.float32)


# ---------------------------------------------------------------- K7-K10
# Kernel against twin on the card, forward and backward given the same
# saved tensors, at ragged and odd shapes: token counts that are not a
# multiple of the 64-row tiles, B=1, a single query, odd group sizes.
# Tolerances as above for outputs; gradients (longer sums) within 1e-4
# (f32) and 5e-2 (bf16) of max(1, max |twin|).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _assert_grad_close(got, want, dt):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GRAD_TOL[dt] * max(1.0, want.float().abs().max().item()), err


# K9's exactly-zero gradients (of b0, b1, b2) are column sums of R bf16
# rows (dh1p, dh2, dh3p) that cancel, so each side's value is the sum of
# the rows' rounding errors; two implementations whose f32 steps differ in
# order round a share of the rows the other way (at 16,384 rows the f32 and
# the f64 twin differ by up to 0.14, above GRAD_TOL's 5e-2; `chip_smoke.py
# --k9-numerics`). Held instead to the rounding noise of such a sum: one
# bf16 rounding (2^-8) of each row, adding as a random walk, 2^-8 times
# the column's root sum of squares of its rows.
ZERO_GRADS = (1, 5, 7)
BF16_ROUNDING = 2.0 ** -8


def _assert_zero_grad_close(got, want, rss):
    scale = BF16_ROUNDING * rss.double().clamp_min(1e-30)
    err = ((got.double() - want.double()).abs() / scale).max().item()
    assert err <= 1.0, err


def _assert_k9_near_ties_and_zeros(kg, args, work, grads):
    """The bf16 K9's one rule at a near-tie and at zero, as chip_smoke.py
    `check_k9_ties_and_zeros` holds it: every (group, column) whose tie set
    h2 == gmax differs between the kernel (its backward's workspace) and
    the twin is counted and printed, and each must be a true near-tie (the
    two competing h2 values within one bf16 ulp); the exactly-zero
    gradients of b0, b1 and b2 within their rounding noise of the f64
    twin's."""
    x0, wb, _, _, stats, _, s = args
    n, ulps = kg.tie_flips(*kg.kernel_h2_pool(work, s), *kg.h2_pool(x0, wb, stats, s), s)
    print(f"K9 bf16: {n} (group, column) tie sets differ from the twin's; the competing h2 at "
          f"most {ulps:.3f} bf16 ulp apart")
    assert ulps <= 1.0, (n, ulps)
    _, ref, rss = kg.g2e_bwd_plain(*args, acc=torch.float64, rss=True)
    for i, r in zip(ZERO_GRADS, rss):
        _assert_zero_grad_close(grads[i], ref[i], r)


def _g2e_bwd_reference(kg, *args):
    """K9's backward twin as the bf16 kernels are held to it: between the
    bf16 rounding points in f64. The gradients of b0, b1 and b2 are exactly
    0, so each is a sum of R bf16 roundings that cancel, and which of them
    round up depends on the last bits of f32 sums (the BatchNorm
    backward's means): at a few thousand rows the f32 twin's own error in
    them can exceed GRAD_TOL, the f64 twin's stays far below it. The f32
    kernels are held to the f32 twin."""
    x0 = args[0]
    acc = torch.float64 if x0.dtype == torch.bfloat16 else torch.float32
    return kg.g2e_bwd_plain(*args, acc=acc)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,h", [(1, 144, 144, 4), (2, 100, 70, 2), (1, 1, 5, 1),
                                     (3, 128, 128, 4), (2, 65, 1000, 6), (2, 129, 63, 2),
                                     (2, 1, 130, 2), (1, 70, 130, 1)])
def test_flash_train_kernel_matches_twin(dev, b, g, m, h, dt, rate):
    """K8 forward and backward; the bf16 routes (tensor cores) also at the
    pretrain latents' 128, at one query (the Perceiver decoder's), at
    query counts off their 64-row blocks (65, 70, 129) and key counts off
    their 64-key tiles (63, 130, 1000)."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(1)
    d = 64 * h
    q, k, v, do = (_t(rng, (b, n, d), dev, dt) for n in (g, m, m, g))
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    scale = 64 ** -0.5
    out_k, lse_k = kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate)
    out_p, lse_p = kf.attention_fwd_plain(q, k, v, seed, h, scale, rate)
    _assert_close(out_k, out_p, dt)
    _assert_close(lse_k, lse_p, torch.float32)
    delta = kf.attention_delta(do, out_p, h)
    for got, want in zip(kf.attention_bwd_kernel(q, k, v, do, lse_p, delta, seed, h, scale, rate),
                         kf.attention_bwd_plain(q, k, v, do, lse_p, delta, seed, h, scale, rate)):
        _assert_grad_close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,din,h", [(1, 144, 144, 256, 4), (2, 50, 300, 96, 2),
                                         (3, 1, 130, 128, 2)])
def test_flash_train_kv_kernel_matches_twin(dev, b, g, m, din, h, dt):
    """K7 forward and backward (the bf16 backward's attention on K8's
    tensor-core backward, with f32 dk / dv), also at one query over a key
    count off the 64-key tiles."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(2)
    d = 64 * h
    args = (_t(rng, (b, g, d), dev, dt), _t(rng, (b, m, din), dev, dt),
            _t(rng, (din,), dev, scale=0.2) + 1.0, _t(rng, (din,), dev, scale=0.1),
            _t(rng, (din, d), dev, dt, din ** -0.5), _t(rng, (din, d), dev, dt, din ** -0.5))
    do = _t(rng, (b, g, d), dev, dt)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    out_k, _ = kf.attention_kv_fwd_kernel(*args, seed, h, 0.125, 0.1)
    out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, 0.125, 0.1)
    _assert_close(out_k, out_p, dt)
    delta = kf.attention_delta(do, out_p, h)
    for got, want in zip(kf.attention_kv_bwd_kernel(*args, do, lse_p, delta, seed, h, 0.125, 0.1),
                         kf.attention_kv_bwd_plain(*args, do, lse_p, delta, seed, h, 0.125, 0.1)):
        _assert_grad_close(got, want, dt)


# K7's forward (q [B, G, H*64] over x [B, M, Din]) at the driven paths'
# shapes: pretrain's point branch, ft_cls, partseg (Din 384), and Din 512
# with a token count off the 64-token tiles
K7_FWD_SHAPES = [(96, 128, 2048, 256, 4), (330, 128, 1024, 256, 4), (96, 128, 1024, 384, 6),
                 (8, 128, 1000, 512, 8)]


def _k7_args(rng, dev, b, g, m, din, h, dt=torch.bfloat16):
    d = 64 * h
    return (_t(rng, (b, g, d), dev, dt), _t(rng, (b, m, din), dev, dt),
            _t(rng, (din,), dev, scale=0.2) + 1.0, _t(rng, (din,), dev, scale=0.1),
            _t(rng, (din, d), dev, dt, din ** -0.5), _t(rng, (din, d), dev, dt, din ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,g,m,din,h", K7_FWD_SHAPES)
def test_flash_train_kv_bf16_forward_matches_twin(dev, b, g, m, din, h, rate):
    """K7's bf16 forward (the LayerNorm pass, then the tile kernel with the
    dropout and the log-sum-exp) against the twin at its planned split:
    out and lse within the bf16 bound (its LayerNorm sums the f32
    statistics in another order than the twin's, so an element of xn, and
    so of k, can round one bf16 ulp apart, which moves a logit, and lse,
    by up to scale x |q| x that ulp; K8's f32 bound on lse holds where q
    and k are given). Unsplit it is
    bitwise equal to K7's projection (`kv_project_kernel`) followed by
    K8's bf16 forward on those k and v; split 2 and 3 ways (the merge pass
    writing lse) its lse within 1e-5 of the unsplit one, out within the
    bf16 bound. Its lse fed to the backward gives gradients within the
    bf16 GRAD_TOL of the twin's."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(7)
    args = _k7_args(rng, dev, b, g, m, din, h)
    seed = torch.tensor([2024], dtype=torch.int32, device=dev)
    scale = 64 ** -0.5
    out_k, lse_k = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)
    out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, rate)
    _assert_close(out_k, out_p, torch.bfloat16)
    _assert_close(lse_k, lse_p, torch.bfloat16)
    k, v = kf.kv_project_kernel(*args[1:])
    out_8, lse_8 = kf.attention_fwd_kernel(args[0], k, v, seed, h, scale, rate)
    out_1, lse_1 = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate, nsplit=1)
    assert torch.equal(out_1, out_8) and torch.equal(lse_1, lse_8)
    for nsplit in (2, 3):
        out_s, lse_s = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate, nsplit=nsplit)
        _assert_close(out_s, out_p, torch.bfloat16)
        assert ((lse_s - lse_1).abs() <= 1e-5 * lse_1.abs().clamp_min(1.0)).all()
    do = _t(rng, (b, g, 64 * h), dev, torch.bfloat16)
    delta = kf.attention_delta(do, out_k, h)
    for got, want in zip(kf.attention_kv_bwd_kernel(*args, do, lse_k, delta, seed, h, scale, rate),
                         kf.attention_kv_bwd_plain(*args, do, lse_p, delta, seed, h, scale, rate)):
        _assert_grad_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 2])
@pytest.mark.parametrize("window", [0, 1])
def test_flash_train_kv_bf16_forward_drops_the_twins_elements(dev, window, nsplit):
    """K7's bf16 forward drops what `keep_mask_plain` drops. The tokens of
    one 64-token window of 128 are one-hot rows x_p = e_(p - 64 w) over
    Din = 128, the others zero, so their normalised rows are a e_j - c
    (zero rows stay zero) and, with wv[j, 64 h + j] = 1 and wv[64 + j,
    64 h + j] = -1 (columns summing to 0), token p's v in every head is
    a e_(p - 64 w): output column c of a row is its dropped p of key 64 w +
    c times a / l, zero exactly where the mask drops it; unsplit and split
    in two (each split's p summed apart)."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(8)
    b, g, m, din, h, rate = 2, 128, 128, 128, 3, 0.1
    d = 64 * h
    q = _t(rng, (b, g, d), dev, torch.bfloat16)
    x = torch.zeros((b, m, din), device=dev)
    x[:, 64 * window:64 * window + 64, :64] = torch.eye(64, device=dev)
    wv = torch.zeros((din, h, 64), device=dev)
    wv[:64] = torch.eye(64, device=dev)[:, None, :]
    wv[64:] = -torch.eye(64, device=dev)[:, None, :]
    wk = _t(rng, (din, d), dev, torch.bfloat16, din ** -0.5)
    seed = torch.tensor([31], dtype=torch.int32, device=dev)
    ones, zeros = torch.ones((din,), device=dev), torch.zeros((din,), device=dev)
    out, _ = kf.attention_kv_fwd_kernel(q, x.to(torch.bfloat16), ones, zeros, wk,
                                        wv.view(din, d).to(torch.bfloat16), seed, h, 0.125, rate,
                                        nsplit=nsplit)
    kept = out.view(b, g, h, 64).transpose(1, 2).reshape(b * h, g, 64) != 0
    keep = kf.keep_mask_plain(seed, b * h, g, m, rate)
    assert torch.equal(kept, keep[..., 64 * window:64 * window + 64])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1])
def test_flash_train_bf16_forward_drops_the_twins_elements(dev, window):
    """With v the identity on one 64-key window of 128 keys (zero rows
    elsewhere), the bf16 K8 forward's output column c is the row's dropped
    p of key 64 w + c: zero exactly where the twin's mask drops it."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(3)
    b, n, h, rate = 2, 128, 3, 0.1
    q, k = (_t(rng, (b, n, 64 * h), dev, torch.bfloat16) for _ in range(2))
    v = torch.zeros((b, n, h, 64), device=dev)
    v[:, 64 * window:64 * window + 64] = torch.eye(64, device=dev)[:, None, :]
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    out, _ = kf.attention_fwd_kernel(q, k, v.view(b, n, 64 * h).to(torch.bfloat16), seed, h,
                                     0.125, rate)
    kept = out.view(b, n, h, 64).transpose(1, 2).reshape(b * h, n, 64) != 0
    keep = kf.keep_mask_plain(seed, b * h, n, n, rate)
    assert torch.equal(kept, keep[..., 64 * window:64 * window + 64])


@pytest.mark.cuda
def test_dropout_mask_kernel_matches_twin(dev):
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    seed = torch.tensor([123456], dtype=torch.int32, device=dev)
    assert torch.equal(kf.dropout_mask_kernel(seed, 6, 70, 130, 0.1),
                       kf.keep_mask_plain(seed, 6, 70, 130, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,s,d", [(1, 8, 32, 256), (2, 5, 7, 64)])
def test_g2e_train_kernel_matches_twin(dev, b, g, s, d, dt):
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rng = np.random.default_rng(3)
    wb = [init_weights(Group2Emb(3, d), 0).to(dev)]
    m = wb[0]
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, _t(rng, (64,), dev, scale=0.2) + 1.0,
          _t(rng, (64,), dev, scale=0.1), m.Dense_1.weight.t(), m.Dense_1.bias,
          m.Dense_2.weight.t(), m.Dense_2.bias, _t(rng, (256,), dev, scale=0.2) + 1.0,
          _t(rng, (256,), dev, scale=0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float() for w in wb]
    x0 = _t(rng, (b * g * s, 3), dev, dt)
    got = kg.g2e_fwd_kernel(x0, wb, s)
    want = kg.g2e_fwd_plain(x0, wb, s)
    _assert_close(got[0], want[0], dt)  # out
    _assert_close(got[1], want[1], dt)  # h3p
    _assert_close(got[3], want[3], torch.float32)  # statistics
    dy = _t(rng, (b * g, d), dev, dt)
    _, h3p, amax, stats = want
    args = (x0, wb, h3p, amax, stats, dy, s)
    work = kg.bwd_workspace(b * g * s, s, 3, d, dt, dev, kcuda.sm_count(0))
    dx_k, gr_k = kg.g2e_bwd_kernel(*args, work=work)
    dx_p, gr_p = _g2e_bwd_reference(kg, *args)
    _assert_grad_close(dx_k, dx_p, dt)
    for got_g, want_g in zip(gr_k, gr_p):
        _assert_grad_close(got_g, want_g, dt)
    if dt == torch.bfloat16:
        _assert_k9_near_ties_and_zeros(kg, args, work, gr_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,gnum,s,n,c", [(1, 4, 8, 50, 3), (3, 16, 32, 700, 6)])
def test_gather_centered_kernel_matches_twin(dev, b, gnum, s, n, c, dt):
    from vipformer_tpu_torch.ops.cuda import gather as kg

    rng = np.random.default_rng(4)
    pts, centers = _t(rng, (b, n, c), dev, dt), _t(rng, (b, gnum, 3), dev)
    idx = torch.from_numpy(rng.integers(0, n, (b, gnum * s)).astype(np.int32)).to(dev)
    assert torch.equal(kg.gather_centered_kernel(pts, centers, idx, s),
                       kg.gather_centered_plain(pts, centers, idx, s))
    grad = _t(rng, (b, gnum * s, c), dev, dt)
    got = kg.scatter_centered_kernel(grad, idx, n, gnum, s)
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    for one, want in zip(got, kg.scatter_centered_plain(grad, idx, n, gnum, s)):
        _assert_grad_close(one, want, dt)  # d_points in dt; d_centers rounded to dt
    again = kg.scatter_centered_kernel(grad, idx, n, gnum, s)  # no float atomics
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# K10's forward at the driven paths' (B, N, C, groups, S): pretrain's 96
# clouds of 2,048 points, ft_cls's 330 of 1,024, partseg's 96 of 1,024,
# semseg's 32 of 4,096 xyz+rgb; then group sizes other than 32 and a row
# count that is not a multiple of 32 (its runs' ragged 16-byte ends)
K10_SHAPES = [(96, 2048, 3, 128, 32), (330, 1024, 3, 128, 32), (96, 1024, 3, 128, 32),
              (32, 4096, 6, 128, 32), (3, 500, 3, 37, 24), (2, 300, 6, 5, 13), (1, 64, 128, 3, 7),
              (2, 999, 5, 3, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,gnum,s", K10_SHAPES)
def test_gather_centered_kernel_bitwise_at_driven_shapes(dev, b, n, c, gnum, s, dt):
    """K10's forward (one warp a run of groups, 16-byte stores) bitwise
    equal to its twin, on points from kNN-like random indices."""
    from vipformer_tpu_torch.ops.cuda import gather as kg

    rng = np.random.default_rng(10)
    pts, centers = _t(rng, (b, n, c), dev, dt), _t(rng, (b, gnum, 3), dev)
    idx = torch.from_numpy(rng.integers(0, n, (b, gnum * s)).astype(np.int32)).to(dev)
    assert torch.equal(kg.gather_centered_kernel(pts, centers, idx, s),
                       kg.gather_centered_plain(pts, centers, idx, s))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [3, 6])
def test_g2e_train_kernel_at_segmentation_width(dev, cin):
    """K9 at D = 384 (partseg, semseg; Cin = 6 is semseg's xyz+rgb), bf16:
    against its twin, and two backward runs give the same bits. Its db3
    column partials span D columns, more than the 256 of the BatchNorm
    sums; a buffer sized for 256 wrote past its end and corrupted other
    tensors at random."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rng = np.random.default_rng(4)
    b, g, s, d, dt = 8, 64, 32, 384, torch.bfloat16
    m = init_weights(Group2Emb(cin, d), 0).to(dev)
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, _t(rng, (64,), dev, scale=0.2) + 1.0,
          _t(rng, (64,), dev, scale=0.1), m.Dense_1.weight.t(), m.Dense_1.bias,
          m.Dense_2.weight.t(), m.Dense_2.bias, _t(rng, (256,), dev, scale=0.2) + 1.0,
          _t(rng, (256,), dev, scale=0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float() for w in wb]
    x0 = _t(rng, (b * g * s, cin), dev, dt)
    got, want = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_plain(x0, wb, s)
    _assert_close(got[0], want[0], dt)
    _, h3p, amax, stats = want
    dy = _t(rng, (b * g, d), dev, dt)
    args = (x0, wb, h3p, amax, stats, dy, s)
    work = kg.bwd_workspace(b * g * s, s, cin, d, dt, dev, kcuda.sm_count(0))
    dx_k, gr_k = kg.g2e_bwd_kernel(*args, work=work)
    dx_k2, gr_k2 = kg.g2e_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(dx_k, dx_k2) and all(map(torch.equal, gr_k, gr_k2))
    dx_p, gr_p = _g2e_bwd_reference(kg, *args)
    _assert_grad_close(dx_k, dx_p, dt)
    for got_g, want_g in zip(gr_k, gr_p):
        _assert_grad_close(got_g, want_g, dt)
    _assert_k9_near_ties_and_zeros(kg, args, work, gr_k)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 512])
def test_g2e_bf16_takes_any_width(dev, d):
    """The bf16 K9 at output widths it takes padded with zero columns to a
    multiple of 64 (96), and past 384 columns in P1's chunks (512):
    against its twin, forward and backward (`_g2e_bwd_reference`), and two
    backward runs give the same bits. The exactly-zero gradients of b0, b1
    and b2 are held to their rounding noise (`_assert_zero_grad_close`),
    and every tie flip to a true near-tie."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rng = np.random.default_rng(5)
    b, g, s, dt = 8, 64, 32, torch.bfloat16
    m = init_weights(Group2Emb(3, d), 0).to(dev)
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, _t(rng, (64,), dev, scale=0.2) + 1.0,
          _t(rng, (64,), dev, scale=0.1), m.Dense_1.weight.t(), m.Dense_1.bias,
          m.Dense_2.weight.t(), m.Dense_2.bias, _t(rng, (256,), dev, scale=0.2) + 1.0,
          _t(rng, (256,), dev, scale=0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float() for w in wb]
    x0 = _t(rng, (b * g * s, 3), dev, dt)
    got, want = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_plain(x0, wb, s)
    assert got[0].shape == (b * g, d) and got[2].shape == (b * g, d)
    _assert_close(got[0], want[0], dt)
    _assert_close(got[1], want[1], dt)
    _, h3p, amax, stats = want
    dy = _t(rng, (b * g, d), dev, dt)
    args = (x0, wb, h3p, amax, stats, dy, s)
    work = kg.bwd_workspace(b * g * s, s, 3, d, dt, dev, kcuda.sm_count(0))
    dx_k, gr_k = kg.g2e_bwd_kernel(*args, work=work)
    dx_k2, gr_k2 = kg.g2e_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(dx_k, dx_k2) and all(map(torch.equal, gr_k, gr_k2))
    assert gr_k[10].shape == (256, d) and gr_k[11].shape == (d,)
    dx_p, gr_p, rss = kg.g2e_bwd_plain(*args, acc=torch.float64, rss=True)
    _assert_grad_close(dx_k, dx_p, dt)
    for i, (got_g, want_g) in enumerate(zip(gr_k, gr_p)):
        if i in ZERO_GRADS:
            _assert_zero_grad_close(got_g, want_g, rss[ZERO_GRADS.index(i)])
        else:
            _assert_grad_close(got_g, want_g, dt)
    _assert_k9_near_ties_and_zeros(kg, args, work, gr_k)


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,s,ties", [(96, 128, 24, False), (24, 128, 128, False),
                                        (96, 128, 32, True)])
def test_g2e_bf16_tiles_hold_whole_groups(dev, b, g, s, ties):
    """The bf16 K9 (tensor-core passes over 128-row tiles of whole groups:
    5 groups of 24 in 120 rows, one of 128) and, at S = 32, on x0 on a
    grid of 5 values a channel, whose groups repeat rows (exact ties in h2
    and h4): against its twin (the backward's in f64 between the bf16
    rounding points, `_g2e_bwd_reference`), each pass launched twice and
    bitwise equal; no f32 array of R rows and no h4, dh4, dy3 or dxc in
    its workspace. The exactly-zero gradients of b0, b1 and b2 are held,
    as chip_smoke.py holds them, within `zero_grad_bound` (each side sums R
    bf16-rounded terms that cancel: a bound set by their magnitudes) and to
    their rounding noise, and every tie flip to a true near-tie
    (`_assert_k9_near_ties_and_zeros`)."""
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rng = np.random.default_rng(6)
    d, r = 256, b * g * s
    m = init_weights(Group2Emb(3, d), 0).to(dev)
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, _t(rng, (64,), dev, scale=0.2) + 1.0,
          _t(rng, (64,), dev, scale=0.1), m.Dense_1.weight.t(), m.Dense_1.bias,
          m.Dense_2.weight.t(), m.Dense_2.bias, _t(rng, (256,), dev, scale=0.2) + 1.0,
          _t(rng, (256,), dev, scale=0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float() for w in wb]
    x0 = _t(rng, (r, 3), dev)
    if ties:
        x0 = (x0 * 2).round().clamp(-2, 2) / 2
    x0 = x0.to(torch.bfloat16)
    got, again = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_kernel(x0, wb, s)
    assert all(map(torch.equal, got, again))
    want = kg.g2e_fwd_plain(x0, wb, s)
    _assert_close(got[0], want[0], torch.bfloat16)
    _assert_close(got[1], want[1], torch.bfloat16)
    # batch statistics: f32 sums of R rows in other orders (chip_smoke.py STATS_TOL)
    assert (got[3] - want[3]).abs().max().item() <= 1e-4 * max(1.0, want[3].abs().max().item())
    _, h3p, amax, stats = want
    dy = _t(rng, (r // s, d), dev, torch.bfloat16)
    args = (x0, wb, h3p, amax, stats, dy, s)
    work = kg.bwd_workspace(r, s, 3, d, torch.bfloat16, dev, kcuda.sm_count(0))
    (dx_k, gr_k), (dx_k2, gr_k2) = kg.g2e_bwd_kernel(*args, work=work), kg.g2e_bwd_kernel(*args)
    assert torch.equal(dx_k, dx_k2) and all(map(torch.equal, gr_k, gr_k2))
    dx_p, gr_p = _g2e_bwd_reference(kg, *args)
    _assert_grad_close(dx_k, dx_p, torch.bfloat16)
    _, _, rss = kg.g2e_bwd_plain(*args, rss=True)
    for i, (got_g, want_g) in enumerate(zip(gr_k, gr_p)):
        if i in ZERO_GRADS:
            # chip_smoke.py zero_grad_bound: 5 (2^-8 + 2^-24 sqrt(R)) times
            # the column's root sum of squares of its rows
            bnd = rss[ZERO_GRADS.index(i)].double() * 5.0 * (2.0 ** -8 + 2.0 ** -24 * r ** 0.5)
            assert ((got_g.double() - want_g.double()).abs() <= bnd).all(), i
        else:
            _assert_grad_close(got_g, want_g, torch.bfloat16)
    _assert_k9_near_ties_and_zeros(kg, args, work, gr_k)
    work = kg.bwd_workspace(r, s, 3, d, torch.bfloat16, "meta", kcuda.sm_count(0))
    assert not {"h4", "dh4", "dy3", "dxc"} & set(work)
    assert all(t.dtype == torch.bfloat16 or t.shape[0] != r for t in work.values())


@pytest.mark.cuda
def test_pretrain_step_on_card_matches_cpu(dev):
    """A small f32 pretrain step (dropout 0, FPS from index 0; 300 points,
    a token count off the 64-row tiles) on the card against the same step
    on the CPU, held as chip_smoke.py holds the flagship's: the IMID step's
    loss within 1e-4 and every gradient leaf within 1e-3 of max(1, max|cpu|);
    the image branch's backbone features within 1e-4 and its gradients
    below the head, under one fixed cotangent, within 1e-3; Group2Emb's
    leaves, behind its final max pool (near-ties may route a group's
    gradient to another row), within 2e-2. K1, K2, K7-K9 forward and
    backward and K10's forward launched on the card."""
    from vipformer_tpu_torch.config import Config, decode_arch_name
    from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = Config(**decode_arch_name("E1CL2SL-H2D128-L32-MR2"), group_size=16,
                 num_pt_points=300, img_height=36, img_width=36, patch_size=12,
                 compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0, max_dpr=0.0,
                 modality="imc-only")
    rng = np.random.default_rng(5)
    b = 3
    batch = {"pc_t1": rng.standard_normal((b, 300, 3)).astype(np.float32),
             "pc_t2": rng.standard_normal((b, 300, 3)).astype(np.float32)}
    imgs = torch.from_numpy(rng.standard_normal((b, 36, 36, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((b, 256)).astype(np.float32))
    got = {}
    for d in ("cpu", dev):
        kcuda.reset_launch_counts()
        pc, img = build_pc_model(cfg, device=d), build_img_model(cfg, device=d)
        _, metrics = make_pretrain_step(cfg, pc)(create_state(cfg, {"pc": pc}), batch, 1e-3)
        img.train()
        _, feats = img(imgs.to(d))
        (feats * cot.to(d)).sum().backward()
        got[str(d)] = (float(metrics["loss"]), feats.detach().cpu(),
                       {f"{n}.{k}": p.grad.detach().cpu()
                        for n, m in (("pc", pc), ("img", img))
                        for k, p in m.named_parameters() if p.grad is not None})
    counts = kcuda.launch_counts()
    assert all(counts[k] > 0 for k in ("fps", "knn", "attn_train_kv_fwd", "attn_train_kv_bwd",
                                       "attn_train_fwd", "attn_train_bwd", "g2e_train_fwd",
                                       "g2e_train_bwd", "gather_centered_fwd")), counts
    (loss_c, feats_c, grads_c), (loss_g, feats_g, grads_g) = got["cpu"], got["cuda"]
    assert abs(loss_g - loss_c) <= 1e-4 * max(1.0, abs(loss_c))
    assert (feats_g - feats_c).abs().max().item() <= 1e-4 * max(1.0, feats_c.abs().max().item())
    assert set(grads_g) == set(grads_c)
    for k, want in grads_c.items():
        err = (grads_g[k] - want).abs().max().item()
        tol = 2e-2 if k.startswith("pc.stem.group2emb.") else 1e-3
        assert err <= tol * max(1.0, want.abs().max().item()), (k, err)


# ---------------------------------------------------------------- K11, K6
# K11 at row counts off its 16- and 32-row steps, at Cin = 3 (PositionEmb's
# first Dense), Cout = 50 (partseg's head), 1024 -> 512 and R = 100 (f32
# on the CUDA cores, bf16 on the tensor cores), gradient tolerances as above; K6 at a batch that is not a
# multiple of anything the kernel tiles and at G = 144 (more rows than one
# attention batch of 128, and a projection tile only partly filled).


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,cin,cout", [(16411, 3, 128), (1, 3, 5), (777, 130, 70),
                                        (42240, 3, 128), (3000, 256, 50), (2048, 1024, 512),
                                        (100, 64, 64), (16411, 256, 256)])
def test_dense_grads_kernel_matches_twin(dev, r, cin, cout, dt):
    from vipformer_tpu_torch.ops.cuda import dense as kdense

    rng = np.random.default_rng(6)
    x, dy = _t(rng, (r, cin), dev, dt), _t(rng, (r, cout), dev, dt)
    for got, want in zip(kdense.dense_grads(x, dy), kdense.dense_grads_plain(x, dy)):
        assert got.dtype == torch.float32
        _assert_grad_close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,din,h", [(130, 128, 256, 4), (3, 144, 256, 4), (2, 37, 128, 2),
                                       (5, 1, 256, 4), (3, 129, 384, 6), (2, 178, 1024, 4),
                                       (4, 128, 1024, 1), (3, 64, 384, 6)])
def test_attention_small_qkv_ln_kernel_matches_twin(dev, b, g, din, h, dt):
    """K6 at the gate's ends (one row; 178 rows at Din = 1024), about the
    bf16 kernel's 128-row score mode (128, 129), at partseg's D = 384 with 6
    heads and at one head."""
    rng = np.random.default_rng(7)
    d = 64 * h
    args = (_t(rng, (b, g, din), dev, dt), _t(rng, (din,), dev, scale=0.2) + 1.0,
            _t(rng, (din,), dev, scale=0.1), _t(rng, (din, d), dev, dt, din ** -0.5),
            _t(rng, (din, d), dev, dt, din ** -0.5), _t(rng, (din, d), dev, dt, din ** -0.5))
    scale = 64 ** -0.5
    with torch.inference_mode():
        _assert_close(kattn.fused_attention_packed_small_qkv_ln(*args, num_heads=h, scale=scale),
                      kattn.attention_small_qkv_ln_plain(*args, h, scale), dt)


@pytest.mark.cuda
def test_cls_step_on_card_matches_cpu(dev):
    """A small f32 ft_cls step (dropout 0, FPS from index 0, K11 and K6
    forced; 8 clouds of 32 latents, so the latent Denses' 256 rows have the
    feasible row block that forcing K11 still needs) on the card against
    the same step on the CPU: the eval logits through K6 within 1e-4, the
    loss within 1e-4 and every gradient leaf within 1e-3 of max(1,
    max|cpu|) (the head's BatchNorm over 8 rows); Group2Emb's leaves,
    behind its max pool, within 2e-2. K11 and K6 launched on the card."""
    from vipformer_tpu_torch.config import Config, decode_arch_name
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.train.trainer import create_state, make_cls_step

    cfg = Config(**decode_arch_name("E1CL2SL-H2D128-L32-MR2"), group_size=16,
                 num_ft_points=300, num_obj_classes=7, compute_dtype="float32",
                 atten_drop=0.0, mlp_drop=0.0, max_dpr=0.0)
    rng = np.random.default_rng(8)
    batch = {"points": rng.standard_normal((8, 300, 3)).astype(np.float32),
             "labels": rng.integers(0, 7, 8)}
    saved = kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN
    kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = True, True
    got = {}
    try:
        for d in ("cpu", dev):
            kcuda.reset_launch_counts()
            model = build_ft_cls(cfg, device=d)
            with torch.inference_mode():
                logits, _ = model(torch.from_numpy(batch["points"]).to(d))
            _, metrics = make_cls_step(cfg, model)(create_state(cfg, {"pc": model}), batch, 1e-3)
            got[str(d)] = (logits.cpu(), float(metrics["loss"]),
                           {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    finally:
        kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = saved
    counts = kcuda.launch_counts()
    assert counts["dense_grads"] > 0 and counts["attn_small_qkv_ln"] == 2, counts
    (logits_c, loss_c, grads_c), (logits_g, loss_g, grads_g) = got["cpu"], got["cuda"]
    _assert_grad_close(logits_g, logits_c, torch.float32)
    assert abs(loss_g - loss_c) <= 1e-4 * max(1.0, abs(loss_c))
    assert set(grads_g) == set(grads_c)
    for k, want in grads_c.items():
        err = (grads_g[k] - want).abs().max().item()
        tol = 2e-2 if k.startswith("stem.group2emb.") else 1e-3
        assert err <= tol * max(1.0, want.abs().max().item()), (k, err)


# -------------------------------------------------------------- K12, partseg
# K12 at the compat stem's shape, at a K off 128-row tiles with C=128, at
# short last runs (B K off the run length; C = 128 and 16), and at one
# row; the gather equal to the twin, the scatter (d_points in the
# table's dtype, the same bits on two launches) within the dtype's
# gradient bound of the twin's f32 sums; a small partseg step on the card
# against the CPU with patch_compat on, so K12 runs on the card's path.


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,k", [(2, 1024, 3, 4096), (3, 300, 128, 1000), (1, 5, 7, 1),
                                     (3, 300, 128, 77), (5, 700, 16, 300)])
def test_gather_rows_kernel_matches_twin(dev, b, n, c, k, dt):
    from vipformer_tpu_torch.ops.cuda import gather as kg

    rng = np.random.default_rng(9)
    pts = _t(rng, (b, n, c), dev, dt)
    idx = torch.from_numpy(rng.integers(0, n, (b, k)).astype(np.int32)).to(dev)
    assert torch.equal(kg.gather_rows_kernel(pts, idx), kg.gather_rows_plain(pts, idx))
    grad = _t(rng, (b, k, c), dev, dt)
    got = kg.scatter_rows_kernel(grad, idx, n)
    assert got.dtype == dt and torch.equal(got, kg.scatter_rows_kernel(grad, idx, n))
    _assert_grad_close(got, kg.scatter_rows_plain(grad, idx, n), dt)
    kcuda.reset_launch_counts()
    leaf = pts.clone().requires_grad_()
    kg.gather_rows(leaf, idx).backward(grad)
    counts = kcuda.launch_counts()
    assert counts["gather_rows_fwd"] == counts["gather_rows_bwd"] == 1, counts
    assert leaf.grad.dtype == dt
    _assert_grad_close(leaf.grad, kg.scatter_rows_plain(grad, idx, n).to(dt), dt)


@pytest.mark.cuda
def test_partseg_step_on_card_matches_cpu(dev):
    """A small f32 partseg step with patch_compat on (dropout, DropPath and
    the head's dropout 0, FPS from index 0, K11 forced; 8 clouds of 300
    points, 32 groups of 16) on the card against the same step on the CPU:
    the eval logits within 1e-4, the loss within 1e-4 and every gradient
    leaf within 1e-3 of max(1, max|cpu|); Group2Emb's leaves within 2e-2.
    K12 launched on the card (the compat stem's gather, 512 rows)."""
    from vipformer_tpu_torch.config import Config, decode_arch_name
    from vipformer_tpu_torch.models.factory import build_ft_partseg
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step

    cfg = Config(**decode_arch_name("E1CL2SL-H2D128-L32-MR2"), group_size=16,
                 num_ft_points=300, layer_idx=(1, 2), compute_dtype="float32", atten_drop=0.0,
                 mlp_drop=0.0, max_dpr=0.0, patch_compat=True, grad_clip_norm=10.0)
    rng = np.random.default_rng(10)
    batch = {"points": rng.standard_normal((8, 300, 3)).astype(np.float32),
             "obj_labels": rng.integers(0, 16, 8), "seg": rng.integers(0, 50, (8, 300))}
    saved = kdense.USE_DENSE_GRAD
    kdense.USE_DENSE_GRAD = True
    got = {}
    try:
        for d in ("cpu", dev):
            kcuda.reset_launch_counts()
            model = build_ft_partseg(cfg, device=d)
            model.seg_head.drop = 0.0
            logits, _ = make_partseg_eval(model)(batch["points"], batch["obj_labels"])
            grads = {}
            for k, p in model.named_parameters():
                p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().cpu()))
            _, metrics = make_partseg_step(cfg, model)(create_state(cfg, {"pc": model}), batch,
                                                       1e-3)
            got[str(d)] = (logits.cpu(), float(metrics["loss"]), grads)
    finally:
        kdense.USE_DENSE_GRAD = saved
    assert kcuda.launch_counts()["gather_rows_fwd"] == 2  # the eval and the step
    (logits_c, loss_c, grads_c), (logits_g, loss_g, grads_g) = got["cpu"], got["cuda"]
    _assert_grad_close(logits_g, logits_c, torch.float32)
    assert abs(loss_g - loss_c) <= 1e-4 * max(1.0, abs(loss_c))
    assert set(grads_g) == set(grads_c)
    for k, want in grads_c.items():
        err = (grads_g[k] - want).abs().max().item()
        tol = 2e-2 if k.startswith("stem.group2emb.") else 1e-3
        assert err <= tol * max(1.0, want.abs().max().item()), (k, err)


# ------------------------------------------------------------- K13, K15


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,h", [(2, 128, 2592, 4), (3, 1, 1000, 2), (1, 130, 33, 6),
                                     (2, 129, 63, 4), (2, 129, 65, 2), (2, 128, 20736, 4)])
def test_packed_attention_kernels_match_twins(dev, b, g, m, h, dt):
    """K13 and K15 at token counts off the 32-token chunks and at the edges
    of K13's 64-token bf16 tiles (63, 65), one query, query counts over
    one 128-row tile, the Fourier image's M = 20,736, and Din off a
    multiple of 128."""
    rng = np.random.default_rng(11)
    d = 64 * h
    scale = 64 ** -0.5
    q, k, v = _t(rng, (b, g, d), dev, dt), _t(rng, (b, m, d), dev, dt), _t(rng, (b, m, d), dev, dt)
    with torch.inference_mode():
        # K13 relative to the twin's own max (outputs ~0.01 at large M)
        _assert_close(kattn.fused_attention_packed(q, k, v, num_heads=h, scale=scale),
                      kattn.attention_packed_plain(q, k, v, h, scale), dt, floor=0.0)
        for din in (d, 96):
            args = (q, _t(rng, (b, m, din), dev, dt), _t(rng, (din, d), dev, dt, din ** -0.5),
                    _t(rng, (din, d), dev, dt, din ** -0.5))
            _assert_close(kattn.fused_attention_packed_kv(*args, num_heads=h, scale=scale),
                          kattn.attention_packed_kv_plain(*args, h, scale), dt)


@pytest.mark.cuda
def test_perceiver_feats_on_card_match_cpu(dev):
    """Small f32 Perceiver feature models on the card against the same
    weights on the CPU: the Fourier image branch (576 tokens: K13) and a
    point branch at 512 latents (K4, then K15 in its self-attention),
    features within 2e-5."""
    from vipformer_tpu_torch.models.perceiver_models import PerceiverFeatsModel

    kw = dict(num_latent_channels=128, num_cross_attention_heads=2,
              num_cross_attention_qk_channels=128, num_self_attention_heads=2,
              num_self_attention_layers_per_block=2, cross_attention_widening_factor=2,
              self_attention_widening_factor=2, dtype=torch.float32)
    rng = np.random.default_rng(12)
    cases = (("image", dict(num_latents=64, image_shape=(24, 24, 3), num_frequency_bands=4),
              rng.standard_normal((3, 24, 24, 3)), "attn_packed"),
             ("pointcloud", dict(num_latents=512), rng.standard_normal((3, 600, 3)),
              "attn_packed_kv"))
    for adapter, extra, x, kernel in cases:
        cpu = PerceiverFeatsModel(adapter, **kw, **extra, device="cpu")
        card = PerceiverFeatsModel(adapter, **kw, **extra, device=dev)
        card.load_state_dict(cpu.state_dict(), strict=True)
        x = torch.from_numpy(x.astype(np.float32))
        kcuda.reset_launch_counts()
        with torch.inference_mode():
            want = cpu(x)[1]
            got = card(x.to(dev))[1]
        assert kcuda.launch_counts()[kernel] > 0, (adapter, kcuda.launch_counts())
        _assert_close(got.cpu(), want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_attention_at_another_head_width_raises_on_the_card(dev, train):
    """A site the JAX gates give a kernel runs one on the card, or fails:
    at dh = 32 (D=128, 4 heads), which no kernel is built for, the layer
    raises instead of running the plain attention (eval over 1,024 tokens:
    K15's gate; train: K8's)."""
    from vipformer_tpu_torch.nn.layers import MultiHeadAttention

    rng = np.random.default_rng(13)
    mha = MultiHeadAttention(128, 4).to(dev).train(train)
    x_q, x_kv = _t(rng, (2, 64, 128), dev), _t(rng, (2, 1024, 128), dev)
    with pytest.raises(NotImplementedError, match="dh=64"):
        mha(x_q, x_kv)


# ------------------------------------------------------------- K17, K18


def _colsum_ok(got, want, mag):
    """A column sum within 1e-5 of its channel's sum of magnitudes."""
    assert ((got - want).abs() <= 1e-5 * mag).all(), ((got - want).abs() / mag).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(131072, 256), (1000, 77), (7, 3), (513, 1536)])
def test_batchnorm_reduces_match_twins(dev, r, c, dt):
    """K18's statistics and gradient reduces at an even and an odd width
    (the column pairs' scalar path), a ragged row count and one split,
    against their twins; the statistics bitwise equal between two runs."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn

    rng = np.random.default_rng(11)
    x, dy = _t(rng, (r, c), dev, dt, 2.0) + 0.5, _t(rng, (r, c), dev, dt)
    s, ss = kbn.bn_stats(x)
    s2, ss2 = kbn.bn_stats(x)
    assert torch.equal(s, s2) and torch.equal(ss, ss2)
    ps, pss = kbn.bn_stats_plain(x)
    xf = x.float()
    _colsum_ok(s, ps, xf.abs().sum(0))
    _colsum_ok(ss, pss, (xf * xf).sum(0))
    mean = ps / r
    rstd = torch.rsqrt(torch.clamp_min(pss / r - mean * mean, 0.0) + 1e-5)
    ds, db = kbn.bn_grad_reduces(x, dy, mean, rstd)
    pds, pdb = kbn.bn_grad_reduces_plain(x, dy, mean, rstd)
    _colsum_ok(ds, pds, (dy.float() * (xf - mean) * rstd).abs().sum(0))
    _colsum_ok(db, pdb, dy.float().abs().sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d", [(4096, 384), (1000, 261), (3, 33), (256, 2048), (5000, 64),
                                 (300, 1024), (517, 1638), (131072, 64), (995328, 261),
                                 (4097, 384), (4097, 383)])
def test_layernorm_kernels_match_twins(dev, r, d, dt):
    """K17's forward (y, mu, rsig, the same bits on a second run) and
    backward (dx; dscale and dbias as column sums, the same bits on a
    second run) at the three driven shapes (the semseg latents' [4,096,
    384], the input adapter's [131,072, 64], the Fourier tokens' [995,328,
    261]), the odd width at fewer rows, a few rows, widths that share a row
    between 2 and 4 warps in the backward (1024, the JAX gate's widest bf16
    1638, 2048), rows off the forward's block of rows (4,097), and a width
    of one column a vector (383) beside one of eight (384)."""
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    rng = np.random.default_rng(12)
    x, dy = _t(rng, (r, d), dev, dt, 2.0) + 0.5, _t(rng, (r, d), dev, dt)
    s, b = _t(rng, (d,), dev, scale=0.2) + 1.0, _t(rng, (d,), dev, scale=0.1)
    y, mu, rsig = kln.ln_fwd(x, s, b)
    py, pmu, prsig = kln.ln_fwd_plain(x, s, b)
    assert y.dtype == dt
    assert all(torch.equal(a, b) for a, b in zip((y, mu, rsig), kln.ln_fwd(x, s, b)))
    for got, want, tol in ((y, py, TOL[dt]), (mu, pmu, 2e-5), (rsig, prsig, 2e-5)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), err
    dx, ds, db = kln.ln_bwd(x, dy, pmu, prsig, s)
    pdx, pds, pdb = kln.ln_bwd_plain(x, dy, pmu, prsig, s)
    err = (dx.float() - pdx.float()).abs().max().item()
    assert err <= TOL[dt] * pdx.float().abs().max().item(), err
    xhat = (x.float() - pmu[:, None]) * prsig[:, None]
    _colsum_ok(ds, pds, (dy.float() * xhat).abs().sum(0))
    _colsum_ok(db, pdb, dy.float().abs().sum(0))
    assert all(torch.equal(a, b) for a, b in zip((dx, ds, db), kln.ln_bwd(x, dy, pmu, prsig, s)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_layernorm_forward_takes_unaligned_rows(dev, dt):
    """K17's forward on x that starts one element past a vector boundary
    (a view into a larger buffer): the wrapper narrows the vectors
    (`fwd_plan`); mu and rsig within 2e-5 of the aligned run's, y within
    the dtype's tolerance (the lanes' partial sums group the columns
    otherwise)."""
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    rng = np.random.default_rng(14)
    r, d = 1000, 384
    x = _t(rng, (r, d), dev, dt, 2.0) + 0.5
    s, b = _t(rng, (d,), dev, scale=0.2) + 1.0, _t(rng, (d,), dev, scale=0.1)
    step = 2 // x.element_size() or 1
    buf = torch.empty(r * d + step, dtype=dt, device=dev)
    xo = buf[step:].view(r, d)
    xo.copy_(x)
    item = x.element_size()
    assert kln.fwd_plan(d, item, xo.data_ptr())[1] < kln.fwd_plan(d, item, x.data_ptr())[1]
    got, want = kln.ln_fwd(xo, s, b), kln.ln_fwd(x, s, b)
    for g, w, tol in zip(got, want, (TOL[dt], 2e-5, 2e-5)):
        assert (g.float() - w.float()).abs().max().item() <= tol * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_layernorm_backward_takes_unaligned_rows(dev, dt):
    """K17's backward on x and dy that start one element past a vector
    boundary (views into a larger buffer): the wrapper narrows the vectors
    (`vec_for`); the column sums equal the aligned run's bits (each column
    sums the same rows in the same order), dx agrees within the tolerance
    (its row sums add the lanes' columns in another grouping)."""
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    rng = np.random.default_rng(13)
    r, d = 1000, 384
    x, dy = _t(rng, (r, d), dev, dt), _t(rng, (r, d), dev, dt)
    s = _t(rng, (d,), dev, scale=0.2) + 1.0
    _, mu, rsig = kln.ln_fwd_plain(x, s, torch.zeros_like(s))
    step = 2 // x.element_size() or 1  # one element past the start: 2 or 4 bytes
    bx, bdy = (torch.empty(r * d + step, dtype=dt, device=dev) for _ in range(2))
    xo, dyo = bx[step:].view(r, d), bdy[step:].view(r, d)
    xo.copy_(x)
    dyo.copy_(dy)
    assert kln.vec_for(d, x.element_size(), xo.data_ptr()) < kln.vec_for(d, x.element_size(),
                                                                          x.data_ptr())
    (dx, ds, db), (want_dx, want_ds, want_db) = (kln.ln_bwd(xo, dyo, mu, rsig, s),
                                                 kln.ln_bwd(x, dy, mu, rsig, s))
    assert torch.equal(ds, want_ds) and torch.equal(db, want_db)
    _assert_close(dx, want_dx, dt, floor=0.0)


@pytest.mark.cuda
def test_semseg_step_forced_on_card_matches_cpu(dev):
    """A small f32 semseg step with K17 and K18 forced (dropout, DropPath
    and the head's dropout 0, FPS from index 0; 8 blocks of 512 xyz+rgb
    points, 32 groups of 16, D=128) on the card against the same step on
    the CPU (their twins): the eval logits within 1e-4, the loss within
    1e-4, every gradient leaf within 1e-3 of max(1, max|cpu|) (Group2Emb's
    2e-2) and the running statistics within 1e-4; K18 ran at the decode's 4
    BatchNorms and K17 at every LayerNorm, forward and backward."""
    from vipformer_tpu_torch.config import Config, decode_arch_name
    from vipformer_tpu_torch.models.factory import build_ft_semseg
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln
    from vipformer_tpu_torch.train.trainer import create_state, make_semseg_step

    cfg = Config(**decode_arch_name("E1CL2SL-H2D128-L32-MR2"), group_size=16, point_channels=6,
                 num_obj_classes=13, layer_idx=(1, 2), compute_dtype="float32", atten_drop=0.0,
                 mlp_drop=0.0, max_dpr=0.0)
    rng = np.random.default_rng(13)
    batch = {"points": rng.uniform(0, 1, (8, 512, 6)).astype(np.float32),
             "seg": rng.integers(0, 13, (8, 512))}
    saved = kbn.USE_BN_TRAIN, kln.USE_LAYERNORM
    kbn.USE_BN_TRAIN = kln.USE_LAYERNORM = True
    got = {}
    try:
        init = build_ft_semseg(cfg, device="cpu").state_dict()
        for d in ("cpu", dev):
            model = build_ft_semseg(cfg, device=d)
            model.load_state_dict(init)
            model.seg_head.drop = 0.0
            with torch.inference_mode():
                logits = model(torch.from_numpy(batch["points"]).to(d)).cpu()
            grads = {}
            for k, p in model.named_parameters():
                p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().cpu()))
            kcuda.reset_launch_counts()
            _, metrics = make_semseg_step(cfg, model)(create_state(cfg, {"pc": model}), batch,
                                                      1e-3)
            stats = {k: v.cpu() for k, v in model.state_dict().items() if "running_" in k}
            got[str(d)] = (logits, float(metrics["loss"]), grads, stats)
    finally:
        kbn.USE_BN_TRAIN, kln.USE_LAYERNORM = saved
    counts = kcuda.launch_counts()
    assert counts["batchnorm_fwd"] == counts["batchnorm_bwd"] == 4
    # the adapter's, the CA's q_norm and MLP LayerNorm (its kv_norm inside
    # K7), two in each SA layer, the shared norm at the two taps
    assert counts["layernorm_fwd"] == counts["layernorm_bwd"] == 1 + 2 + 2 * 2 + 2
    (logits_c, loss_c, grads_c, stats_c), (logits_g, loss_g, grads_g, stats_g) = \
        got["cpu"], got["cuda"]
    _assert_grad_close(logits_g, logits_c, torch.float32)
    assert abs(loss_g - loss_c) <= 1e-4 * max(1.0, abs(loss_c))
    assert set(grads_g) == set(grads_c)
    for k, want in grads_c.items():
        err = (grads_g[k] - want).abs().max().item()
        tol = 2e-2 if k.startswith("stem.group2emb.") else 1e-3
        assert err <= tol * max(1.0, want.abs().max().item()), (k, err)
    for k, want in stats_c.items():
        assert (stats_g[k] - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


# ---------------------------------------------------------------- K16, K14
# K16 (fused FPS + kNN) equal to its twin, to K1 + K2 and to a second
# launch at ragged cloud sizes, G = N and random starts, and on K2's
# shapes and clouds (3 and 70 clouds a launch); K14 (head-split attention) within TOL of
# its twin at ragged G and M, every built width pair, and its refusals
# (other widths, inputs that need a gradient).


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,g,k,cloud", [
    pytest.param(3, 1000, 128, 32, None, id="3-1000-128-32"),
    pytest.param(2, 4096, 128, 32, None, id="2-4096-128-32"),
    pytest.param(2, 300, 300, 7, None, id="2-300-300-7"),
    pytest.param(1, 33, 16, 33, None, id="1-33-16-33"),
    *[pytest.param(3, n, min(128, n), k, kind, id=f"{kind}-3-{n}-{min(128, n)}-{k}")
      for n, k in KNN_SHAPES for kind in KNN_CLOUDS],
    pytest.param(2, 1024, 1024, 32, "tied", id="tied-2-1024-1024-32"),
    pytest.param(2, 1000, 1000, 33, "lane", id="lane-2-1000-1000-33"),
    pytest.param(1, 64, 64, 4, "lane", id="lane-1-64-64-4"),
    pytest.param(70, 1024, 128, 32, "tied", id="tied-70-1024-128-32"),
    pytest.param(70, 2048, 128, 32, "lane", id="lane-70-2048-128-32"),
])
def test_fps_knn_kernel_matches_twin_and_k1_k2(dev, b, n, g, k, cloud):
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch

    rng = np.random.default_rng(2)
    if cloud is None:
        xyz = _t(rng, (b, n, 3), dev)
        start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(n + g + k)
        xyz = _knn_cloud(gen, cloud, b, n, dev)
        start = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
    cidx, nidx = kpatch.fps_knn(xyz, g, k, start)
    want_c, want_n = kpatch.fps_knn_plain(xyz, g, k, start)
    assert torch.equal(cidx, want_c) and torch.equal(nidx, want_n)
    again = kpatch.fps_knn(xyz, g, k, start)
    assert torch.equal(cidx, again[0]) and torch.equal(nidx, again[1])
    idx, centers = kfps.fps(xyz, g, start)
    assert torch.equal(cidx, idx) and torch.equal(nidx, kknn.knn(k, xyz, centers))
    with pytest.raises(ValueError, match="fps_knn kernel"):
        kpatch.fps_knn(_t(rng, (1, 5000, 3), dev), 16, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,dv", [(64, 64), (64, 32), (32, 64), (32, 32)])
@pytest.mark.parametrize("b,h,g,m", [(2, 4, 128, 2048), (3, 2, 100, 77), (1, 3, 1, 5),
                                     (2, 1, 513, 130), (2, 2, 129, 63), (1, 2, 129, 65)])
def test_head_split_kernel_matches_twin(dev, b, h, g, m, dh, dv, dt):
    rng = np.random.default_rng(3)
    q, k = _t(rng, (b, h, g, dh), dev, dt), _t(rng, (b, h, m, dh), dev, dt)
    v = _t(rng, (b, h, m, dv), dev, dt)
    with torch.inference_mode():
        got = kattn.fused_attention(q, k, v, scale=dh ** -0.5)
    _assert_close(got, kattn.fused_attention_plain(q, k, v, dh ** -0.5), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["attn_packed", "attn_head_split", "attn_small_qkv_ln",
                                    "attn_train_fwd", "attn_train_bwd"])
def test_tensor_core_kernels_repeat_bitwise(dev, kernel):
    """The bf16 tensor-core routes of K13, K14, K6 and K8's forward and
    backward give the same bits on a second launch (no atomics, a fixed
    order of products); K13 with its kv split forced to 1 (no merge pass)
    agrees with the planned split."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(5)
    dt = torch.bfloat16
    with torch.inference_mode():
        if kernel == "attn_small_qkv_ln":
            args = (_t(rng, (130, 128, 256), dev, dt), _t(rng, (256,), dev),
                    _t(rng, (256,), dev), *(_t(rng, (256, 256), dev, dt, 0.0625)
                                            for _ in range(3)))
            run = lambda: kattn.fused_attention_packed_small_qkv_ln(  # noqa: E731
                *args, num_heads=4, scale=0.125)
            assert torch.equal(run(), run())
            return
        if kernel == "attn_train_fwd":
            q, k, v = (_t(rng, (96, 128, 256), dev, dt) for _ in range(3))
            seed = torch.tensor([7], dtype=torch.int32, device=dev)
            (o1, l1), (o2, l2) = (kf.attention_fwd_kernel(q, k, v, seed, 4, 0.125, 0.1)
                                  for _ in range(2))
            assert torch.equal(o1, o2) and torch.equal(l1, l2)
            return
        if kernel == "attn_train_bwd":  # at one query over 130 keys, with dropout
            q, do = _t(rng, (2, 1, 128), dev, dt), _t(rng, (2, 1, 128), dev, dt)
            k, v = _t(rng, (2, 130, 128), dev, dt), _t(rng, (2, 130, 128), dev, dt)
            seed = torch.tensor([7], dtype=torch.int32, device=dev)
            out, lse = kf.attention_fwd_plain(q, k, v, seed, 2, 0.125, 0.1)
            args = (q, k, v, do, lse, kf.attention_delta(do, out, 2), seed, 2, 0.125, 0.1)
            first, again = kf.attention_bwd_kernel(*args), kf.attention_bwd_kernel(*args)
            assert all(torch.equal(a, b) for a, b in zip(first, again))
            return
        if kernel == "attn_head_split":
            q, k = _t(rng, (2, 4, 129, 64), dev, dt), _t(rng, (2, 4, 1000, 64), dev, dt)
            v = _t(rng, (2, 4, 1000, 32), dev, dt)
            run = lambda: kattn.fused_attention(q, k, v, scale=0.125)  # noqa: E731
            assert torch.equal(run(), run())
            return
        h, m = 4, 20736
        q, k, v = _t(rng, (2, 128, 256), dev, dt), _t(rng, (2, m, 256), dev, dt), \
            _t(rng, (2, m, 256), dev, dt)
        got = kattn.fused_attention_packed(q, k, v, num_heads=h, scale=0.125)
        assert torch.equal(got, kattn.fused_attention_packed(q, k, v, num_heads=h, scale=0.125))
        assert kattn.packed_splits(dt, 2, 128, m, h, kattn._sms(dev)) > 1
        one = kattn.fused_attention_packed_split(q, k, v, num_heads=h, scale=0.125, nsplit=1)
    _assert_close(one, got, dt, floor=0.0)


# K5 at one query (the Perceiver decoder), G off the 16-row warp tiles and
# the 64-row blocks, M off the 64-key tiles (the scores in registers up to
# 128 keys, in two passes above: M = 170 is about the most the gate admits
# at G = 150), partseg's D = 384 at 6 heads, and the largest M the gate
# admits at G = 16; bf16 runs the tensor-core kernel, f32 the CUDA cores
SMALL_CASES = [(3, 1, 128, 4), (2, 129, 63, 4), (2, 129, 65, 4), (2, 40, 127, 2),
               (2, 40, 129, 2), (3, 128, 128, 6), (2, 16, 390, 4), (2, 150, 100, 4),
               (2, 150, 170, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,m,h", SMALL_CASES)
def test_small_attention_kernel_matches_twin(dev, b, g, m, h, dt):
    rng = np.random.default_rng(11)
    q = _t(rng, (b, g, 64 * h), dev, dt)
    k, v = _t(rng, (b, m, 64 * h), dev, dt), _t(rng, (b, m, 64 * h), dev, dt)
    assert kattn.packed_small_attention_enabled(h, 64 * h, 64 * h, g, m, 0.0, False, True)
    with torch.inference_mode():
        _assert_close(kattn.fused_attention_packed_small(q, k, v, num_heads=h, scale=0.125),
                      kattn.attention_small_plain(q, k, v, h, 0.125), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["attn_small", "dense_grads", "dense_grads_cin3"])
def test_tensor_core_k5_k11_repeat_bitwise(dev, case):
    """The bf16 tensor-core K5 and K11 give the same bits on a second
    launch: a fixed order of products, split partials summed in split
    order, no atomics."""
    from vipformer_tpu_torch.ops.cuda import dense as kdense

    rng = np.random.default_rng(13)
    dt = torch.bfloat16
    if case == "attn_small":
        q, k, v = (_t(rng, (64, 128, 256), dev, dt) for _ in range(3))
        with torch.inference_mode():
            run = lambda: kattn.fused_attention_packed_small(  # noqa: E731
                q, k, v, num_heads=4, scale=0.125)
            assert torch.equal(run(), run())
        return
    cin = 3 if case == "dense_grads_cin3" else 256
    x, dy = _t(rng, (42240, cin), dev, dt), _t(rng, (42240, 128), dev, dt)
    (w1, b1), (w2, b2) = kdense.dense_grads(x, dy), kdense.dense_grads(x, dy)
    assert torch.equal(w1, w2) and torch.equal(b1, b2)


@pytest.mark.cuda
def test_tensor_core_k5_k11_refuse_misaligned(dev):
    """K5, K11, K6 and K8's forward in bf16 (16-byte cp.async) refuse an
    operand whose storage starts off a 16-byte boundary."""
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    rng = np.random.default_rng(14)
    dt = torch.bfloat16
    flat = _t(rng, (64 * 256 + 8,), dev, dt)
    x = flat[1:1 + 64 * 256].view(64, 256)  # storage off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte boundary"):
        kdense.dense_grads(x, _t(rng, (64, 128), dev, dt))
    with pytest.raises(ValueError, match="16-byte boundary"):
        kattn.fused_attention_packed_small(x.view(1, 64, 256), x.view(1, 64, 256),
                                           x.view(1, 64, 256), num_heads=4, scale=0.125)
    w = _t(rng, (256, 256), dev, dt)
    w_off = _t(rng, (256 * 256 + 8,), dev, dt)[1:1 + 256 * 256].view(256, 256)
    ln = _t(rng, (256,), dev)
    ln_off = _t(rng, (260,), dev)[1:257]  # f32, 4 bytes off
    x1 = _t(rng, (1, 64, 256), dev, dt)
    for args in ((x.view(1, 64, 256), ln, ln, w, w, w), (x1, ln, ln_off, w, w, w),
                 (x1, ln, ln, w, w_off, w)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            kattn.fused_attention_packed_small_qkv_ln(*args, num_heads=4, scale=0.125)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kf.attention_fwd_kernel(x.view(1, 64, 256), x1, x1, seed, 4, 0.125, 0.1)


@pytest.mark.cuda
def test_head_split_kernel_refuses(dev):
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng, (1, 2, 8, w), dev) for w in (48, 48, 64))
    with pytest.raises(NotImplementedError, match="built for dh, dv"):
        kattn.fused_attention(q, k, v, scale=0.1)
    q, k, v = (_t(rng, (1, 2, 8, 64), dev).requires_grad_() for _ in range(3))
    with pytest.raises(NotImplementedError, match="no backward"):
        kattn.fused_attention(q, k, v, scale=0.1)
    # a bf16 view 2 bytes into its storage: the tensor-core route refuses it
    q = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16, device=dev)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kattn.fused_attention(q, q, q, scale=0.1)


# ---------------------------------------------------------------- K3, K4
# K3 in bf16 (tensor cores) at group sizes the gate admits and tiles of
# whole groups (16 of 8, 5 of 24 in 120 rows, 4 of 32, 16 of 4 in 64),
# partseg's and semseg's D = 384 (semseg's xyz+rgb C = 6 at N = 4,096),
# a width padded to a multiple of 64, and group counts no tile count
# divides: (B, N, G, S, D, C)
STEM_TC_CASES = [(2, 1024, 128, 32, 256, 3), (3, 1000, 40, 24, 256, 3),
                 (2, 700, 128, 16, 256, 3), (1, 300, 24, 8, 384, 3),
                 (2, 4096, 128, 32, 384, 6), (2, 512, 100, 32, 96, 3), (3, 64, 16, 4, 128, 3)]


def _stem_ops(dev, b, n, g, s, d, c, dt, seed=21):
    rng = np.random.default_rng(seed)
    pts = _t(rng, (b, n, c), dev)
    idx, centers = kfps.fps(pts[..., :3].contiguous(), g)
    nn_idx = kknn.knn(s, pts[..., :3].contiguous(), centers)
    g2e = init_weights(Group2Emb(c, d), 0).to(dev).eval()
    with torch.no_grad():  # nontrivial eval BatchNorm statistics
        for bn in (g2e.BatchNorm_0, g2e.BatchNorm_1):
            ch = bn.running_mean.shape[0]
            bn.running_mean.copy_(_t(rng, (ch,), dev, scale=0.1))
            bn.running_var.copy_(_t(rng, (ch,), dev).abs() + 0.5)
            bn.weight.copy_(_t(rng, (ch,), dev, scale=0.2) + 1.0)
            bn.bias.copy_(_t(rng, (ch,), dev, scale=0.1))
    return kstem.stem_operands(g2e, pts, centers, nn_idx, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,g,s,d,c", STEM_TC_CASES)
def test_stem_tc_kernel_matches_twin(dev, b, n, g, s, d, c):
    """The bf16 K3 (two tensor-core passes) against stem_plain within
    2e-2 of max(1, max |twin|), two launches bitwise equal; the f32 kernel
    (CUDA cores) within 2e-5 at the same shape."""
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            ops = _stem_ops(dev, b, n, g, s, d, c, dt)
            got = kstem.stem_kernel(*ops)
            assert got.shape == (b, g, d)
            if dt == torch.bfloat16:
                assert torch.equal(got, kstem.stem_kernel(*ops))
            _assert_close(got, kstem.stem_plain(*ops), dt)


# K4 in bf16 (tensor cores): the serving shape, token counts off the
# 64-token tiles (63, 65, 777), semseg's 4,096 tokens at Din = 384 and 6
# heads, more than 128 queries (k and v projected once, then K13; the
# Perceiver's 512 latents, and Din past and within the tile kernel's
# 256), one query, Din = 1,024 (the gate's largest) and Din = 96 (a
# multiple of 8 only): (B, G, M, Din, H)
KV_LN_TC_CASES = [(2, 128, 1024, 256, 4), (3, 130, 65, 384, 6), (2, 128, 4096, 384, 6),
                  (1, 1, 63, 128, 2), (2, 200, 777, 1024, 4), (3, 50, 300, 96, 2),
                  (2, 512, 2048, 256, 4), (1, 300, 63, 96, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,m,din,h", KV_LN_TC_CASES)
def test_attention_kv_ln_tc_kernel_matches_twin(dev, b, g, m, din, h, monkeypatch):
    """The bf16 K4 (the LayerNorm pass, then one tensor-core block per
    (head, cloud, kv split), or past 128 queries the projection pass and
    K13) against attention_kv_ln_plain within 2e-2, two launches bitwise
    equal; with its kv splits forced to 1 (no merge pass) within 2e-2 of
    the planned split; the f32 kernel within 2e-5."""
    rng = np.random.default_rng(23)
    d = 64 * h
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            args = (_t(rng, (b, g, d), dev, dt), _t(rng, (b, m, din), dev, dt),
                    _t(rng, (din,), dev, scale=0.2) + 1.0, _t(rng, (din,), dev, scale=0.1),
                    *(_t(rng, (din, d), dev, dt, din ** -0.5) for _ in range(2)))
            got = kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=0.125)
            if dt == torch.bfloat16:
                assert torch.equal(got, kattn.fused_attention_packed_kv_ln(
                    *args, num_heads=h, scale=0.125))
                with monkeypatch.context() as mp:
                    mp.setattr(kattn, "kv_ln_plan", lambda *_: (1, 1))
                    _assert_close(kattn.fused_attention_packed_kv_ln(
                        *args, num_heads=h, scale=0.125), got, dt)
            _assert_close(got, kattn.attention_kv_ln_plain(*args, h, 0.125), dt)


@pytest.mark.cuda
def test_tensor_core_k3_k4_refuse_misaligned(dev):
    """The bf16 K3 and K4 (16-byte loads and cp.async) refuse an operand
    whose storage starts off a 16-byte boundary, before any launch."""
    rng = np.random.default_rng(24)
    dt = torch.bfloat16
    ops = list(_stem_ops(dev, 1, 256, 16, 8, 256, 3, dt))
    t1 = ops[0]
    ops[0] = _t(rng, (t1.numel() + 8,), dev, dt)[1:1 + t1.numel()].view(t1.shape)
    kcuda.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        kstem.stem_kernel(*ops)
    q, x = _t(rng, (1, 8, 256), dev, dt), _t(rng, (1, 64, 256), dev, dt)
    x_off = _t(rng, (64 * 256 + 8,), dev, dt)[1:1 + 64 * 256].view(1, 64, 256)
    ln, w = _t(rng, (256,), dev), _t(rng, (256, 256), dev, dt, 0.0625)
    for args in ((q, x_off, ln, ln, w, w), (q, x, _t(rng, (260,), dev)[1:257], ln, w, w)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            kattn.fused_attention_packed_kv_ln(*args, num_heads=4, scale=0.125)
    assert kcuda.launch_counts()["stem"] == 0 and kcuda.launch_counts()["attn_kv_ln"] == 0


# ------------------------------------------------------------- K15, K1
# K15's bf16 shapes (B, G, M, Din, H): the cluster kernel at the Perceiver's
# 512 latents, a ragged 300, 512 queries at Din = 384, G above M; K4's
# passes on the raw tokens over 2,048 and 700 tokens (projection, then
# K13's kernel; at Din = 384 the stream kernel's projection), at one query
# (the double-buffered attention pass) and at G <= 128 (one pass)
PACKED_KV_TC_CASES = [(64, 512, 512, 256, 4), (3, 300, 300, 256, 4), (8, 512, 512, 384, 6),
                      (2, 130, 33, 256, 4), (8, 512, 2048, 256, 4), (8, 512, 700, 384, 6),
                      (4, 1, 700, 384, 6), (3, 100, 512, 96, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,m,din,h", PACKED_KV_TC_CASES)
def test_packed_kv_tc_kernel_matches_twin(dev, b, g, m, din, h, monkeypatch):
    """The bf16 K15 (the cluster kernel, or K4's passes on the tokens as
    they are, as `packed_kv_plan` picks) against attention_packed_kv_plain
    within 2e-2 of the twin's own scale, two launches bitwise equal; where
    the plan is the cluster kernel, also on K4's passes (forced), within
    2e-2 of the planned kernel; the f32 kernel within 2e-5."""
    rng = np.random.default_rng(25)
    d = 64 * h
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            args = (_t(rng, (b, g, d), dev, dt), _t(rng, (b, m, din), dev, dt),
                    *(_t(rng, (din, d), dev, dt, din ** -0.5) for _ in range(2)))
            got = kattn.fused_attention_packed_kv(*args, num_heads=h, scale=0.125)
            _assert_close(got, kattn.attention_packed_kv_plain(*args, h, 0.125), dt, floor=0.0)
            if dt == torch.bfloat16:
                assert torch.equal(got, kattn.fused_attention_packed_kv(
                    *args, num_heads=h, scale=0.125))
                if kattn.packed_kv_plan(dt, b, g, m, h, din, kattn._sms(dev))[0]:
                    with monkeypatch.context() as mp:
                        mp.setattr(kattn, "packed_kv_plan", lambda dt, b, g, m, h, din, sms: (
                            0, *kattn.kv_ln_plan(dt, b, g, m, h, din, sms)))
                        _assert_close(kattn.fused_attention_packed_kv(
                            *args, num_heads=h, scale=0.125), got, dt, floor=0.0)


@pytest.mark.cuda
def test_packed_kv_tc_kernel_refuses_misaligned(dev):
    """The bf16 K15 (16-byte cp.async) refuses an operand whose storage
    starts off a 16-byte boundary, before any launch."""
    rng = np.random.default_rng(26)
    dt = torch.bfloat16
    q, w = _t(rng, (1, 300, 256), dev, dt), _t(rng, (256, 256), dev, dt, 0.0625)
    x_off = _t(rng, (300 * 256 + 8,), dev, dt)[1:1 + 300 * 256].view(1, 300, 256)
    kcuda.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte boundary"):
        kattn.fused_attention_packed_kv(q, x_off, w, w, num_heads=4, scale=0.125)
    assert kcuda.launch_counts()["attn_packed_kv"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 1000, 1024, 2048, 4096, 8192])
def test_fps_kernel_matches_twin_at_every_width(dev, n):
    """K1 against fps_plain from random starts, on clouds with exact ties
    (every fifth point a copy of the one before it; a cloud on a half-unit
    grid), one warp a cloud at N = 200: indices and centers equal; and,
    where K16 takes the cloud (N <= 4,096), K16 still equal to its twin
    and to K1 followed by K2."""
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch

    gen = torch.Generator(device=dev).manual_seed(n)
    b, g, k = 3, 128, 32
    xyz = torch.randn((b, n, 3), generator=gen, device=dev)
    xyz[:, 1::5] = xyz[:, 0::5][:, :xyz[:, 1::5].shape[1]]
    xyz[0] = torch.round(xyz[0] * 2) / 2
    start = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
    want_i, want_c = kfps.fps_plain(xyz, g, start)
    idx, centers = kfps.fps(xyz, g, start)
    assert torch.equal(idx, want_i) and torch.equal(centers, want_c)
    if n <= 4096:
        cidx, nidx = kpatch.fps_knn(xyz, g, k, start)
        want_ci, want_ni = kpatch.fps_knn_plain(xyz, g, k, start)
        assert torch.equal(cidx, want_ci) and torch.equal(nidx, want_ni)
        assert torch.equal(cidx, idx) and torch.equal(nidx, kknn.knn(k, xyz, centers))


@pytest.mark.cuda
def test_launch_takes_the_current_stream_of_the_operands_card(dev):
    """A wrapper launches on the current stream of its operands' card
    (`cuda.launch`): under a side stream its kernel is ordered on that
    stream (the result read after the side stream's synchronize equals the
    twin's), and the current device is left as it was."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn

    rng = np.random.default_rng(21)
    x = _t(rng, (4096, 256), dev)
    want = kbn.bn_stats_plain(x)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = kbn.bn_stats(x)
    side.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    assert torch.cuda.current_device() == (dev.index or 0)


@pytest.mark.cuda
def test_launch_on_another_card_than_the_current_one(dev):
    """With the current device set to card 0, a launch on card 1's tensors
    runs there, on card 1's stream, and equals the twin (it would otherwise
    take card 0's stream with card 1's pointers); card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import fps as kfps

    rng = np.random.default_rng(22)
    other = torch.device("cuda", 1)
    x = _t(rng, (4096, 256), other)
    xyz = _t(rng, (4, 1024, 3), other)
    with torch.cuda.device(0):
        stats = kbn.bn_stats(x)
        idx, centers = kfps.fps(xyz, 128)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    for a, b in zip(stats, kbn.bn_stats_plain(x)):
        assert a.device == other
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    idx_p, centers_p = kfps.fps_plain(xyz, 128, torch.zeros(4, dtype=torch.int32, device=other))
    assert torch.equal(idx, idx_p) and torch.equal(centers, centers_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_g2e_seams_at_one_rank_give_the_fused_bits(dev, dt, monkeypatch):
    """K9's data-parallel path (three launches a call, split at the
    BatchNorm seams, csrc/g2e_train.cu `seam`) run with one rank's sums (the
    all-reduce the identity, the global row count this call's): forward and
    backward bitwise equal to the fused one-launch path."""
    import torch.distributed as dist

    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    rng = np.random.default_rng(23)
    b, g, s, d = 8, 64, 32, 256
    m = init_weights(Group2Emb(3, d), 0).to(dev)
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, _t(rng, (64,), dev, scale=0.2) + 1.0,
          _t(rng, (64,), dev, scale=0.1), m.Dense_1.weight.t(), m.Dense_1.bias,
          m.Dense_2.weight.t(), m.Dense_2.bias, _t(rng, (256,), dev, scale=0.2) + 1.0,
          _t(rng, (256,), dev, scale=0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float().contiguous() for w in wb]
    x0 = _t(rng, (b * g * s, 3), dev, dt)
    dy = _t(rng, (b * g, d), dev, dt)
    fused = kg.g2e_fwd_kernel(x0, wb, s)
    fused_bwd = kg.g2e_bwd_kernel(x0, wb, *fused[1:], dy, s)
    monkeypatch.setattr(kg, "data_axis_size", lambda: 2)
    monkeypatch.setattr(kg, "_global_rows", lambda r: float(r))
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: None)
    split = kg.g2e_fwd_kernel(x0, wb, s)
    split_bwd = kg.g2e_bwd_kernel(x0, wb, *split[1:], dy, s)
    for name, a, c in zip(("out", "h3p", "amax", "stats"), fused, split):
        assert torch.equal(a, c), name
    assert torch.equal(fused_bwd[0], split_bwd[0]), "dx0"
    for i, (a, c) in enumerate(zip(fused_bwd[1], split_bwd[1])):
        assert torch.equal(a, c), i
