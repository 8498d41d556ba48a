"""Datasets, synthetic only (counterpart of vipformer_tpu/data/datasets.py;
the readers of the real ShapeNet clouds and renderings and of the HDF5
classification sets come with a later slice).

* `ShapeNetRender` (pretraining): two independently augmented views of one
  cloud and one augmented image of it (reference data.py:92-118).
* `ModelNet40SVM`, `ScanObjectNNSVM` (classification finetune): the JAX
  package's synthetic stand-ins of the same sizes and seeds
  (datasets.py:37-97), 2048-point clouds cut to `num_points`.
"""

from __future__ import annotations

import numpy as np

from vipformer_tpu_torch.data import augment, synthetic


class ShapeNetRender:
    """`synthetic_size` class-structured clouds of `num_points` points (16
    classes, data seed 7, as the JAX package's stand-in), each with its
    splat image."""

    def __init__(self, img_height: int = 144, img_width: int = 144, num_points: int = 2048,
                 synthetic_size: int = 512):
        self.img_height, self.img_width = img_height, img_width
        self.num_points = num_points
        self.synthetic = True
        self._data, self._labels = synthetic.synthetic_classification(
            synthetic_size, num_points, 16, seed=7)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, i: int, rng: np.random.Generator):
        raw = self._data[i][:self.num_points]
        img = synthetic.splat_image(raw)
        im = augment.image_transform(img, rng, self.img_height, self.img_width)
        t1 = augment.pretrain_transform(raw, rng)
        t2 = augment.pretrain_transform(raw, rng)
        return t1, t2, im


class _SyntheticClassification:
    """A classification split: (points [num_points, 3] f32, label) per
    sample, no augmentation (the JAX readers' `get`)."""

    num_classes: int
    sizes: dict  # partition -> (samples, data seed)

    def __init__(self, partition: str = "train", num_points: int = 1024):
        n, seed = self.sizes[partition]
        self.data, self.label = synthetic.synthetic_classification(n, 2048, self.num_classes,
                                                                   seed=seed)
        self.num_points = num_points

    def __len__(self) -> int:
        return len(self.data)

    def get(self, i: int, rng=None):
        return self.data[i][:self.num_points].astype(np.float32), int(self.label[i])


class ModelNet40SVM(_SyntheticClassification):
    """ModelNet40's synthetic stand-in: 800 train / 200 test clouds of 40
    classes (data seeds 0 and 1)."""

    num_classes = 40
    sizes = {"train": (800, 0), "test": (200, 1)}


class ScanObjectNNSVM(_SyntheticClassification):
    """ScanObjectNN's synthetic stand-in: 600 train / 150 test clouds of 15
    classes (data seeds 2 and 3)."""

    num_classes = 15
    sizes = {"train": (600, 2), "test": (150, 3)}
