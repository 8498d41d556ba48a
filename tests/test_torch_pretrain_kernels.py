"""The pretrain slice's kernel modules (K7-K10) against the JAX package.

Each kernel's plain PyTorch twin (what `vipformer_tpu_torch` runs on a CPU
tensor) is held against the Pallas kernel it replaces, run by the JAX
package itself in interpret mode (as tests/test_flash_train.py and
tests/test_g2e_train.py run them), on the same numpy inputs, in f32 at
dropout 0: the forward and every gradient. The CUDA kernels themselves run
only on a card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|) per output, unless
a test states otherwise (the sums run in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vipformer_tpu.ops.pallas.flash_train import (
    flash_attention_train as jax_flash,
    flash_attention_train_kv as jax_flash_kv,
)
from vipformer_tpu.ops.pallas.g2e_train import g2e_train_apply as jax_g2e
from vipformer_tpu.ops.pallas.gather import gather_rows_centered_pallas
from vipformer_tpu_torch.ops import cuda as kcuda
from vipformer_tpu_torch.ops.cuda import flash_train as kflash
from vipformer_tpu_torch.ops.cuda import g2e_train as kg2e
from vipformer_tpu_torch.ops.cuda import gather as kgather

TOL = 1e-5
SEED0 = torch.zeros(1, dtype=torch.int32)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def _torch_grads(fn, arrays, cot):
    """Output and gradients of sum(fn(*xs) * cot) through torch autograd."""
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    (out * torch.from_numpy(cot)).sum().backward()
    return out, [x.grad for x in xs]


def _jax_grads(fn, arrays, cot):
    xs = [jnp.asarray(a) for a in arrays]
    out = fn(*xs)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=tuple(range(len(xs))))(*xs)
    return out, grads


# the last two at the kernels' dh = 64: one query (the Perceiver decoder's
# single query), and G, M off the 64-row tiles
@pytest.mark.parametrize("b,g,m,h,d", [(2, 16, 64, 4, 32), (1, 12, 40, 2, 16),
                                       (2, 1, 130, 2, 128), (1, 70, 130, 1, 64)])
def test_flash_train_twin_matches_pallas(rng, b, g, m, h, d):
    """K8 at dropout 0: output and dq, dk, dv."""
    q, k, v = _f32(rng, b, g, d), _f32(rng, b, m, d), _f32(rng, b, m, d)
    cot = _f32(rng, b, g, d)
    scale = (d // h) ** -0.5
    want, want_g = _jax_grads(
        lambda q, k, v: jax_flash(q, k, v, jnp.zeros(1, jnp.int32), h, scale, 0.0, None, True),
        (q, k, v), cot)
    got, got_g = _torch_grads(
        lambda q, k, v: kflash.flash_attention_train(q, k, v, SEED0, h, scale, 0.0),
        (q, k, v), cot)
    _close(got, want, name="out")
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        _close(a, w, name=name)


@pytest.mark.parametrize("m,din", [(64, 128), (48, 64)])
def test_flash_train_kv_twin_matches_pallas(rng, m, din):
    """K7 at dropout 0: output and the gradients of q, x, the LN scale and
    bias, wk and wv."""
    b, g, h, d = 2, 8, 4, 32
    args = (_f32(rng, b, g, d), _f32(rng, b, m, din), _f32(rng, din, scale=0.2) + 1.0,
            _f32(rng, din, scale=0.1), _f32(rng, din, d, scale=0.1),
            _f32(rng, din, d, scale=0.1))
    cot = _f32(rng, b, g, d)
    scale = (d // h) ** -0.5
    want, want_g = _jax_grads(
        lambda *a: jax_flash_kv(*a, jnp.zeros(1, jnp.int32), h, scale, 0.0, None, True),
        args, cot)
    got, got_g = _torch_grads(
        lambda *a: kflash.flash_attention_train_kv(*a, SEED0, h, scale, 0.0), args, cot)
    _close(got, want, name="out")
    for name, a, w in zip(("dq", "dx", "dln_w", "dln_b", "dwk", "dwv"), got_g, want_g):
        _close(a, w, name=name)


def _g2e_params(rng, cin, d):
    shapes = [(cin, 64), (64,), (64,), (64,), (64, 128), (128,), (256, 256), (256,), (256,),
              (256,), (256, d), (d,)]
    out = []
    for i, s in enumerate(shapes):
        if i in (2, 8):  # BN scales around 1
            out.append(_f32(rng, *s, scale=0.2) + 1.0)
        else:
            out.append(_f32(rng, *s, scale=0.3 if len(s) == 2 else 0.1))
    return out


def test_g2e_train_twin_matches_pallas(rng):
    """K9: output, the four batch statistics, dx0 and all 12 weight grads."""
    b, g, s, cin, d = 4, 8, 16, 3, 64
    x0 = _f32(rng, b, g, s, cin)
    wb = _g2e_params(rng, cin, d)
    cot = _f32(rng, b, g, d)
    jwb = tuple(map(jnp.asarray, wb))
    want, want_stats = jax_g2e(jnp.asarray(x0), jwb, s, True)
    jg = jax.grad(lambda x, w: jnp.sum(jax_g2e(x, w, s, True)[0] * cot), argnums=(0, 1))(
        jnp.asarray(x0), jwb)
    tx = torch.from_numpy(x0).requires_grad_()
    twb = [torch.from_numpy(w).requires_grad_() for w in wb]
    got, got_stats = kg2e.g2e_train_apply(tx, twb, s)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, want, name="out")
    for i, (a, w) in enumerate(zip(got_stats, want_stats)):
        _close(a, w, name=f"stat{i}")
    _close(tx.grad, jg[0], name="dx0")
    for i, (a, w) in enumerate(zip(twb, jg[1])):
        if i in (1, 5, 7):
            # b0, b1 and b2 only shift what a batch-statistics BatchNorm
            # subtracts again (b1 through h2 and its group max alike): their
            # gradient is zero up to the rounding of a sum of 512
            # cancelling terms, on both sides
            assert a.grad.abs().max() < 1e-3 and np.abs(np.asarray(w)).max() < 1e-3, i
        else:
            _close(a.grad, w, name=f"grad{i}")


def test_g2e_final_pool_routes_to_first_argmax():
    """Exact ties in the final max pool: the whole gradient goes to the
    first row of the maximum (the Pallas kernel's stored int32 argmax)."""
    rng = np.random.default_rng(3)
    b, g, s, cin, d = 1, 2, 4, 3, 8
    wb = [torch.from_numpy(w) for w in _g2e_params(rng, cin, d)]
    wb[10] = torch.zeros_like(wb[10])  # every row of h4 equals the bias
    x0 = torch.from_numpy(_f32(rng, b, g, s, cin))
    out, h3p, amax, stats = kg2e.g2e_fwd_plain(x0.reshape(-1, cin), wb, s)
    assert (amax == 0).all()
    dy = torch.ones((b * g, d))
    _, grads = kg2e.g2e_bwd_plain(x0.reshape(-1, cin), wb, h3p, amax, stats, dy, s)
    assert torch.allclose(grads[11], torch.full((d,), float(b * g)))


@pytest.mark.parametrize("c", [3, 6])
def test_gather_centered_twin_matches_pallas(rng, c):
    """K10: output, d_points (scatter-add over repeated picks) and
    d_centers; extra channels ride along uncentered."""
    b, n, gnum, s = 2, 64, 16, 8
    pts, centers = _f32(rng, b, n, c), _f32(rng, b, gnum, 3)
    idx = rng.integers(0, n, (b, gnum * s)).astype(np.int32)
    cot = _f32(rng, b, gnum * s, c)
    want, want_g = _jax_grads(
        lambda p, cz: gather_rows_centered_pallas(p, cz, jnp.asarray(idx), s, 8, True),
        (pts, centers), cot)
    got, got_g = _torch_grads(
        lambda p, cz: kgather.gather_rows_centered(p, cz, torch.from_numpy(idx), s),
        (pts, centers), cot)
    _close(got, want, 0.0, "out")
    _close(got_g[0], want_g[0], name="d_points")
    _close(got_g[1], want_g[1], name="d_centers")


def test_dropout_mask_is_deterministic_with_the_right_rate():
    """The twin's keep mask: a pure function of the seed, different for
    another seed, keep share 1 - rate; the threshold matches the rate."""
    seed = torch.tensor([1234], dtype=torch.int32)
    a = kflash.keep_mask_plain(seed, 8, 128, 256, 0.1)
    assert torch.equal(a, kflash.keep_mask_plain(seed, 8, 128, 256, 0.1))
    other = kflash.keep_mask_plain(torch.tensor([1235], dtype=torch.int32), 8, 128, 256, 0.1)
    assert (a != other).float().mean() > 0.1
    # 262,144 draws: the keep share is within 5 binomial sigmas of 0.9
    share = a.float().mean().item()
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / a.numel()) ** 0.5, share
    # no visible structure along any axis: per-row and per-column shares
    assert a.float().mean(-1).min() > 0.8 and a.float().mean((0, 1)).min() > 0.8
    assert kflash.dropout_threshold(0.0) == 0
    assert kflash.dropout_threshold(0.5) == 2**31


def test_dropout_twin_matches_masked_reference(rng):
    """At rate 0.3 the twin's forward and gradients equal autograd through
    the plain masked attention built from the same mask: the backward
    regenerates the forward's mask."""
    b, g, m, h, d, rate = 2, 8, 24, 2, 16, 0.3
    q, k, v = _f32(rng, b, g, d), _f32(rng, b, m, d), _f32(rng, b, m, d)
    cot = _f32(rng, b, g, d)
    seed = torch.tensor([99], dtype=torch.int32)
    scale = (d // h) ** -0.5
    keep = kflash.keep_mask_plain(seed, b * h, g, m, rate).view(b, h, g, m)

    def ref(q, k, v):
        def split(t):
            return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

        p = torch.softmax(split(q) @ split(k).transpose(-1, -2) * scale, dim=-1)
        o = torch.where(keep, p / (1 - rate), 0.0) @ split(v)
        return o.transpose(1, 2).reshape(b, g, d)

    want, want_g = _torch_grads(ref, (q, k, v), cot)
    got, got_g = _torch_grads(
        lambda q, k, v: kflash.flash_attention_train(q, k, v, seed, h, scale, rate), (q, k, v),
        cot)
    _close(got, want.detach().numpy(), name="out")
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        _close(a, w.numpy(), name=name)
    again = kflash.flash_attention_train(*map(torch.from_numpy, (q, k, v)), seed, h, scale, rate)
    assert torch.equal(again, got.detach())


def test_cpu_tensors_never_reach_the_training_kernels(rng):
    """A CPU tensor runs the twins: no launch is counted and the CUDA
    library is never built."""
    kcuda.reset_launch_counts()
    q = torch.from_numpy(_f32(rng, 1, 4, 8)).requires_grad_()
    kflash.flash_attention_train(q, q, q, SEED0, 2, 0.5, 0.0).sum().backward()
    x = torch.from_numpy(_f32(rng, 1, 2, 4, 3))
    kg2e.g2e_train_apply(x, [torch.from_numpy(w) for w in _g2e_params(rng, 3, 8)], 4)
    kgather.gather_rows_centered(torch.from_numpy(_f32(rng, 1, 8, 3)),
                                 torch.from_numpy(_f32(rng, 1, 2, 3)),
                                 torch.zeros((1, 4), dtype=torch.int32), 2)
    assert kcuda.launch_counts() == dict.fromkeys(kcuda.launch_counts(), 0)
    assert kcuda._lib is None


def test_training_wrappers_validate_operands():
    for base in ("g2e_fwd", "g2e_bwd", "gather_centered", "scatter_centered"):
        for dt in (torch.float32, torch.bfloat16):
            assert kcuda.entry_point(base, dt) in kcuda.SIGNATURES
    for dt in (torch.float32, torch.bfloat16):  # K7, K8: bf16 on the tensor cores, both ways
        for base in ("attn_train_kv_fwd", "attn_train_kv_bwd", "attn_train_fwd",
                     "attn_train_bwd"):
            assert kcuda.tc_route(base, dt) in kcuda.SIGNATURES
    with pytest.raises(NotImplementedError, match="dh=64"):
        kflash._check_heads(96, 2)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        kflash._dropout_args(1.0)
    with pytest.raises(ValueError, match="Generator"):
        kflash.draw_seed(None, 0.1, "cpu")
    assert kflash.draw_seed(None, 0.0, "cpu").tolist() == [0]
