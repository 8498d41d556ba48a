"""NT-Xent contrastive loss (counterpart of vipformer_tpu/losses/contrastive.py).

SimCLR's full-batch form over the 2B concatenated views, temperature 0.1
(the reference's lightly NTXentLoss): cosine-similarity logits in f32, the
diagonal masked, positives at offset B.
"""

from __future__ import annotations

import torch


def nt_xent_loss(z0: torch.Tensor, z1: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Mean NT-Xent over the 2B anchors of the paired views z0, z1 [B, D]."""
    z0, z1 = z0.float(), z1.float()
    b = z0.shape[0]
    z = torch.cat([z0, z1], dim=0)
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-12)
    logits = (z @ z.t()) / temperature
    n = 2 * b
    diag = torch.eye(n, dtype=torch.bool, device=z.device)
    logits = logits.masked_fill(diag, torch.finfo(torch.float32).min)
    labels = (torch.arange(n, device=z.device) + b) % n
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def nt_xent_grouped(z0: torch.Tensor, z1: torch.Tensor, num_groups: int,
                    temperature: float = 0.1) -> torch.Tensor:
    """NT-Xent with negatives restricted to `num_groups` contiguous batch
    groups (the reference's per-rank negatives); 1 = global negatives."""
    if num_groups <= 1:
        return nt_xent_loss(z0, z1, temperature)
    b = z0.shape[0]
    if b % num_groups:
        raise ValueError(f"batch {b} does not split into {num_groups} groups")
    g = b // num_groups
    losses = [nt_xent_loss(z0[i * g:(i + 1) * g], z1[i * g:(i + 1) * g], temperature)
              for i in range(num_groups)]
    return torch.stack(losses).mean()
