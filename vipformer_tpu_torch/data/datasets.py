"""The pretraining dataset, synthetic only (counterpart of
`ShapeNetRender` in vipformer_tpu/data/datasets.py; reading the real
ShapeNet clouds and renderings comes with a later slice).

Each sample: two independently augmented views of one cloud and one
augmented image of it (reference data.py:92-118).
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
