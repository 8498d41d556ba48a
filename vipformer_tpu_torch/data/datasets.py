"""Datasets, synthetic only (counterpart of vipformer_tpu/data/datasets.py;
the readers of the real ShapeNet clouds and renderings and of the HDF5
classification and segmentation sets come with a later slice).

* `ShapeNetRender` (pretraining): two independently augmented views of one
  cloud and one augmented image of it (reference data.py:92-118).
* `ModelNet40SVM`, `ScanObjectNNSVM` (classification finetune): the JAX
  package's synthetic stand-ins of the same sizes and seeds
  (datasets.py:37-97), 2048-point clouds cut to `num_points`.
* `ShapeNetPart` (part segmentation): the JAX package's synthetic stand-in
  (datasets.py:177-240), 400 trainval / 120 test clouds, data seeds 4 / 5.
* `S3DIS` (semantic segmentation): the JAX package's synthetic stand-in
  (datasets.py:243-285), 200 train / 60 test blocks of 4,096 points x 9
  channels, data seeds 6 / 8.
"""

from __future__ import annotations

import os

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


class ShapeNetPart:
    """ShapeNetPart's synthetic stand-in: (points [num_points, 3] f32, object
    label, part ids [num_points]) per sample. `class_choice` keeps one
    category; the trainval split shuffles each sample's point order with
    the sample's generator (reference shapenet_part.py:100-104)."""

    CAT2ID = {
        "airplane": 0, "bag": 1, "cap": 2, "car": 3, "chair": 4, "earphone": 5, "guitar": 6,
        "knife": 7, "lamp": 8, "laptop": 9, "motor": 10, "mug": 11, "pistol": 12,
        "rocket": 13, "skateboard": 14, "table": 15,
    }
    sizes = {"trainval": (400, 4), "test": (120, 5)}

    def __init__(self, partition: str = "trainval", num_points: int = 1024,
                 class_choice: str | None = None):
        n, seed = self.sizes["trainval" if partition == "trainval" else "test"]
        self.data, self.label, self.seg = synthetic.synthetic_partseg(n, 2048, seed=seed)
        self.partition = partition
        self.num_points = num_points
        self.class_choice = class_choice.lower() if class_choice else None
        if self.class_choice is not None:
            cid = self.CAT2ID[self.class_choice]
            sel = (self.label == cid).reshape(-1)
            self.data, self.label, self.seg = self.data[sel], self.label[sel], self.seg[sel]
            self.seg_num_all = synthetic.SEG_NUM[cid]
            self.seg_start_index = synthetic.INDEX_START[cid]
        else:
            self.seg_num_all = 50
            self.seg_start_index = 0

    def __len__(self) -> int:
        return len(self.data)

    def get(self, i: int, rng: np.random.Generator | None = None):
        pts = self.data[i][:self.num_points]
        seg = self.seg[i][:self.num_points]
        if self.partition == "trainval" and rng is not None:
            order = rng.permutation(len(pts))
            pts, seg = pts[order], seg[order]
        return pts.astype(np.float32), int(self.label[i].reshape(-1)[0]), seg.astype(np.int64)


class S3DIS:
    """S3DIS's synthetic stand-in: (points [4096, 9] f32, labels [4096]
    int64) per block, 13 classes. The reader of the real HDF5 blocks with
    the Area-`test_area` holdout (JAX datasets.py:249-272) is not ported:
    where the listing exists under `data_dir`, the constructor raises."""

    num_classes = 13
    sizes = {"train": (200, 6), "test": (60, 8)}

    def __init__(self, data_dir: str = "data", split: str = "train", test_area: int = 5):
        listing = os.path.join(data_dir, "indoor3d_sem_seg_hdf5_data", "all_files.txt")
        if os.path.exists(listing):
            raise NotImplementedError(
                f"{listing} exists, but the S3DIS HDF5 reader is not ported yet (ROADMAP "
                "Queue 1, item 18): only the synthetic stand-in runs")
        n, seed = self.sizes["train" if split == "train" else "test"]
        self.data, self.label = synthetic.synthetic_semseg(n, 4096, seed=seed)

    def __len__(self) -> int:
        return len(self.data)

    def get(self, i: int, rng=None):
        return self.data[i].astype(np.float32), self.label[i].astype(np.int64)
