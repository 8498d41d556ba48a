"""NT-Xent contrastive loss (counterpart of vipformer_tpu/losses/contrastive.py).

SimCLR's full-batch form over the 2B concatenated views, temperature 0.1
(the reference's lightly NTXentLoss): cosine-similarity logits in f32, the
diagonal masked, positives at offset B.
"""

from __future__ import annotations

import torch

from vipformer_tpu_torch.parallel.mesh import all_gather_rows, data_axis_size


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


def nt_xent_data_parallel(z0: torch.Tensor, z1: torch.Tensor, num_groups: int,
                          temperature: float = 0.1) -> torch.Tensor:
    """NT-Xent of a global batch split contiguously over the data axis
    (the data group's D ranks; the model ranks of one data index compute
    the same loss), each rank holding its rows of z0, z1: `num_groups`
    groups over the global batch, as JAX's `nt_xent_grouped`
    (losses/contrastive.py:51-76). With
    one group (`--global_negatives`) every rank gathers the ranks'
    projections (`all_gather_rows`, whose gradient sums the ranks') and
    computes the one global loss; otherwise the groups fall within the
    ranks (num_groups a multiple of D) and each rank computes its own,
    with nothing exchanged. Returns this rank's loss: the step's mean over
    the ranks is the global one."""
    world = data_axis_size()
    if world == 1:
        return nt_xent_grouped(z0, z1, num_groups, temperature)
    if num_groups <= 1:
        return nt_xent_loss(all_gather_rows(z0), all_gather_rows(z1), temperature)
    if num_groups % world:
        raise ValueError(f"{num_groups} NT-Xent groups do not split over {world} ranks")
    return nt_xent_grouped(z0, z1, num_groups // world, temperature)
