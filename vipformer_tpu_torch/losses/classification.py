"""Classification loss (counterpart of vipformer_tpu/losses/classification.py:
`smoothed_cross_entropy`; the part-segmentation loss comes with its slice)."""

from __future__ import annotations

import torch


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over the leading dims with torch's
    `label_smoothing` semantics (eps/n mass on every class, the target
    included), in f32; logits [..., C], labels [...] int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None]).squeeze(-1)
    if smoothing == 0.0:
        return nll.mean()
    return ((1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)).mean()
