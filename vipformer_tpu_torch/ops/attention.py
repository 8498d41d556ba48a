"""Scaled dot-product attention, the plain path (counterpart of
vipformer_tpu/ops/attention.py: what the XLA path computes).

Logits and softmax in f32 whatever the compute dtype; the attention matrix
drops back to the compute dtype before an f32-accumulated PV product.
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, *, scale: float, dropout_rate: float = 0.0,
                          generator: torch.Generator | None = None,
                          heads: tuple[int, int] | None = None):
    """q [B, H, N, Ck], k [B, H, M, Ck], v [B, H, M, Cv] -> [B, H, N, Cv]
    in v's dtype. `dropout_rate` > 0 drops elements of the normalised
    attention matrix (train mode, JAX ops/attention.py:74-80), kept ones
    divided by 1 - rate, with the keep draws taken from `generator`.
    `heads` (first, total): the H heads here are heads [first, first + H)
    of `total`, and the keep draws are those of all `total` heads, this
    slice kept (a model rank's heads under tensor parallelism).
    Padding masks come with the slices that use them."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a torch.Generator")
        keep = 1.0 - dropout_rate
        b, h, n, m = attn.shape
        first, total = heads if heads is not None else (0, h)
        u = torch.rand((b, total, n, m), generator=generator,
                       device=generator.device)[:, first:first + h]
        attn = torch.where(u.to(attn.device) < keep, attn / keep, torch.zeros_like(attn))
    attn = attn.to(v.dtype)
    return (attn.float() @ v.float()).to(v.dtype)
