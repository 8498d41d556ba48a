"""Scaled dot-product attention, the plain path (counterpart of
vipformer_tpu/ops/attention.py: what the XLA path computes).

Logits and softmax in f32 whatever the compute dtype; the attention matrix
drops back to the compute dtype before an f32-accumulated PV product.
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, *, scale: float):
    """q [B, H, N, Ck], k [B, H, M, Ck], v [B, H, M, Cv] -> [B, H, N, Cv]
    in v's dtype. Eval only: padding masks and attention dropout come with
    the slices that use them."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return (attn.float() @ v.float()).to(v.dtype)
