"""Segmentation metrics (the port's own copy of
vipformer_tpu/evaluation/iou.py:32-120), in numpy. Part segmentation, over
the refined predictions:

* per-shape part IoU with the empty-union -> IoU = 1 rule (reference
  ft_partseg.py:297-322);
* instance-mean part IoU (over all shapes) and category-mean IoU (over the
  category means);
* mean part accuracy as the reference computes it: per part id the
  predicted count over the true count (ft_partseg.py:290-295, 324);
* point-level accuracy.

Semantic segmentation (`semseg_miou`): overall point accuracy and the IoU
averaged over the classes that occur in the predictions or the labels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vipformer_tpu_torch.data.synthetic import INDEX_START, SEG_NUM

CATEGORIES = (
    "Airplane", "Bag", "Cap", "Car", "Chair", "Earphone", "Guitar", "Knife",
    "Lamp", "Laptop", "Motorbike", "Mug", "Pistol", "Rocket", "Skateboard",
    "Table",
)


def shape_ious(pred: np.ndarray, seg: np.ndarray, obj_label: np.ndarray) -> np.ndarray:
    """Per-shape mean part IoU over the parts of its category. pred, seg:
    [B, N] part ids; obj_label: [B]."""
    out = np.zeros(len(pred), dtype=np.float64)
    for i in range(len(pred)):
        c = int(obj_label[i])
        ious = []
        for part in range(INDEX_START[c], INDEX_START[c] + SEG_NUM[c]):
            p, g = pred[i] == part, seg[i] == part
            union = np.logical_or(p, g).sum()
            ious.append(1.0 if union == 0 else np.logical_and(p, g).sum() / union)
        out[i] = np.mean(ious)
    return out


@dataclass
class PartSegMetrics:
    """Streaming accumulator over evaluation batches; `valid` masks the
    padding of a padded last batch."""

    num_parts: int = 50
    part_pred_count: np.ndarray = None
    part_true_count: np.ndarray = None
    correct_points: int = 0
    total_points: int = 0
    cat_ious: dict = field(default_factory=lambda: {c: [] for c in CATEGORIES})

    def __post_init__(self):
        self.part_pred_count = np.zeros(self.num_parts, dtype=np.int64)
        self.part_true_count = np.zeros(self.num_parts, dtype=np.int64)

    def update(self, pred: np.ndarray, seg: np.ndarray, obj_label: np.ndarray,
               valid: np.ndarray | None = None) -> None:
        if valid is not None:
            pred, seg, obj_label = pred[valid], seg[valid], obj_label[valid]
        if len(pred) == 0:
            return
        self.correct_points += int((pred == seg).sum())
        self.total_points += pred.size
        self.part_pred_count += np.bincount(pred.reshape(-1), minlength=self.num_parts)
        self.part_true_count += np.bincount(seg.reshape(-1), minlength=self.num_parts)
        for iou, c in zip(shape_ious(pred, seg, obj_label), obj_label):
            self.cat_ious[CATEGORIES[int(c)]].append(iou)

    def results(self) -> dict:
        all_ious = [v for vs in self.cat_ious.values() for v in vs]
        cat_means = [np.mean(vs) for vs in self.cat_ious.values() if vs]
        part_acc = self.part_pred_count / np.maximum(self.part_true_count, 1)
        seen = self.part_true_count > 0
        return {
            "mean_part_iou": float(np.mean(all_ious)) if all_ious else 0.0,
            "mean_category_iou": float(np.mean(cat_means)) if cat_means else 0.0,
            "mean_part_acc": float(np.mean(part_acc[seen])) if seen.any() else 0.0,
            "point_level_acc": self.correct_points / max(self.total_points, 1),
        }


def semseg_miou(pred: np.ndarray, seg: np.ndarray, num_classes: int = 13) -> dict:
    """Point accuracy and class-mean IoU over all points (JAX iou.py:107-
    120): a class whose union is empty is left out of the mean."""
    pred, seg = pred.reshape(-1), seg.reshape(-1)
    ious = []
    for c in range(num_classes):
        p, g = pred == c, seg == c
        union = np.logical_or(p, g).sum()
        if union > 0:
            ious.append(np.logical_and(p, g).sum() / union)
    return {"point_level_acc": float(np.mean(pred == seg)), "miou": float(np.mean(ious))}
