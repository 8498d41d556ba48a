"""Classification and segmentation losses (counterpart of
vipformer_tpu/losses/classification.py): `smoothed_cross_entropy` (torch's
label_smoothing semantics, what the finetune steps use) and the
reference's hand-rolled `partseg_smoothed_loss`."""

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


def partseg_smoothed_loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: bool = True,
                          eps: float = 0.2) -> torch.Tensor:
    """The reference's partseg loss (JAX losses/classification.py:35-47):
    targets one_hot * (1 - eps) + eps / (n - 1) on the other classes, over
    every row of logits [..., n], in f32."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1).long()
    if not smoothing:
        return smoothed_cross_entropy(logits, labels, 0.0)
    n = logits.shape[-1]
    one_hot = torch.nn.functional.one_hot(labels, n).float()
    target = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (n - 1)
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
