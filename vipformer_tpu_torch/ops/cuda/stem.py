"""K3: fused eval patch stem (counterpart of ops/pallas/stem.py).

`group2emb_fused_apply` folds the eval BatchNorms into the Dense weights
and builds the extended first-layer table `t1ext` in plain PyTorch (as
stem.py:170-203 does in plain JAX), then runs the gather + mini-PointNet
chain: `csrc/stem.cu` on a CUDA tensor, the plain twin `stem_plain` on a
CPU tensor.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.ops import cuda

LAUNCHES = cuda.LaunchCounter()
BN_EPS = 1e-5
MAX_GROUP_SIZE = 32  # row accumulators per thread in the kernel


def _dense(x, w, b, dt):
    """nn.layers.Dense numerics on [in, out] weights: f32-accumulated
    product, cast to the compute dtype, then the bias added in it."""
    return (x.float() @ w.float()).to(dt) + b


def stem_plain(t1ext, idx, w2, b2, w3, b3, w4, b4, n: int, g: int, s: int):
    """t1ext [B, N+G, C1], idx int32 [B, G*S] -> [B, G, D] (compute dtype
    of t1ext)."""
    bsz = t1ext.shape[0]
    dt = t1ext.dtype
    row_g = n + torch.arange(g * s, device=t1ext.device) // s  # center rows
    nb = torch.gather(t1ext, 1, idx.long()[..., None].expand(-1, -1, t1ext.shape[2]))
    x = torch.relu((nb.float() - t1ext[:, row_g].float()).to(dt))
    x = _dense(x, w2, b2, dt)  # [B, G*S, 128]
    c2 = x.shape[-1]
    gmax = x.view(bsz, g, s, c2).amax(dim=2, keepdim=True)
    x = torch.cat([gmax.expand(bsz, g, s, c2).reshape(bsz, g * s, c2), x], dim=-1)
    x = torch.relu(_dense(x, w3, b3, dt))
    x = _dense(x, w4, b4, dt)
    return x.view(bsz, g, s, x.shape[-1]).amax(dim=2)


def _fold_bn(bn):
    """Eval BatchNorm -> per-channel (scale, shift)."""
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


def stem_operands(g2e, pts, centers, idx, dtype) -> tuple:
    """The BN folds and the extended table, in plain PyTorch: the operands
    of `stem_plain` / `stem_kernel` for Group2Emb module `g2e` (eval) on
    pts [B, N, C>=3], centers [B, G, >=3] and kNN idx [B, G, S]."""
    b, g, s = idx.shape
    s0, t0 = _fold_bn(g2e.BatchNorm_0)
    s1, t1_ = _fold_bn(g2e.BatchNorm_1)
    # fold BN0 into Dense_0 and BN1 into Dense_2 (weights as [in, out])
    w1 = (g2e.Dense_0.weight.t() * s0[None, :]).float()
    b1 = (g2e.Dense_0.bias * s0 + t0).float()
    w3 = (g2e.Dense_2.weight.t() * s1[None, :]).to(dtype).contiguous()
    b3 = (g2e.Dense_2.bias * s1 + t1_).to(dtype).contiguous()

    # xyz is centered; extra channels (e.g. rgb) stay uncentered
    pf = pts.float()
    cz = torch.cat([
        centers[..., :3].float(),
        torch.zeros((b, g, pf.shape[-1] - 3), dtype=torch.float32, device=pf.device),
    ], dim=-1)
    n = pf.shape[1]
    # (p - c) @ W1 + b1 = (p @ W1) - (c @ W1 - b1): rows [0, N) of t1ext hold
    # the point projections, rows [N, N+G) the per-group center terms
    t1 = torch.einsum("bnc,cf->bnf", pf, w1)
    c1 = torch.einsum("bgc,cf->bgf", cz, w1) - b1
    t1ext = torch.cat([t1, c1], dim=1).to(dtype).contiguous()
    flat_idx = idx.reshape(b, g * s).to(torch.int32).contiguous()
    w2 = g2e.Dense_1.weight.t().to(dtype).contiguous()
    b2 = g2e.Dense_1.bias.to(dtype).contiguous()
    w4 = g2e.Dense_3.weight.t().to(dtype).contiguous()
    b4 = g2e.Dense_3.bias.to(dtype).contiguous()
    return t1ext, flat_idx, w2, b2, w3, b3, w4, b4, n, g, s


def group2emb_fused_apply(g2e, pts, centers, idx, dtype) -> torch.Tensor:
    """Group2Emb (eval) on (pts, centers, kNN idx) without materialising
    the [B, G, S, C] neighbour tensor -> [B, G, D] in `dtype`."""
    ops = stem_operands(g2e, pts, centers, idx, dtype)
    if not ops[0].is_cuda:
        return stem_plain(*ops)
    return stem_kernel(*ops)


def stem_kernel(t1ext, idx, w2, b2, w3, b3, w4, b4, n: int, g: int, s: int):
    """Launch csrc/stem.cu; operands as `stem_plain` takes them."""
    bsz, _, c1 = t1ext.shape
    dt = t1ext.dtype
    d = w4.shape[1]
    if not 1 <= s <= MAX_GROUP_SIZE:
        raise ValueError(f"stem kernel takes group sizes 1..{MAX_GROUP_SIZE}, got {s}")
    if w2.shape[1] != 128 or w3.shape != (256, 256):
        raise ValueError("stem kernel expects Group2Emb's 128/256 hidden widths")
    fn = cuda.entry_point("stem", dt)
    cuda.require(t1ext, "t1ext", dt, (bsz, n + g, c1))
    cuda.require(idx, "idx", torch.int32, (bsz, g * s))
    for name, t, shape in (("w2", w2, (c1, 128)), ("b2", b2, (128,)), ("w3", w3, (256, 256)),
                           ("b3", b3, (256,)), ("w4", w4, (256, d)), ("b4", b4, (d,))):
        cuda.require(t, name, dt, shape)
    out = torch.empty((bsz, g, d), dtype=dt, device=t1ext.device)
    LAUNCHES.n += 1
    cuda.check(getattr(cuda.lib(), fn)(
        t1ext.data_ptr(), idx.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(), out.data_ptr(),
        bsz, n, g, s, c1, d, cuda.stream_ptr(),
    ), fn)
    return out


def fused_stem_supported(num_groups: int, group_size: int, n: int,
                         deterministic: bool, patch_compat: bool) -> bool:
    """The JAX package's structural gate (stem.py:224-240): eval mode, the
    documented-intent centering, and its row tiling."""
    if not deterministic or patch_compat:
        return False
    rows = num_groups * group_size
    if rows % 128:
        return False
    gc = max(1, min(num_groups, 1024 // group_size))
    while num_groups % gc:
        gc -= 1
    if gc * group_size % 128:
        return False
    return n <= 4096
