"""Dataset readers with a data root and synthetic stand-ins (counterpart of
vipformer_tpu/data/datasets.py; reference `datasets/data.py`,
`datasets/shapenet_part.py`, `datasets/s3dis.py`, whose roots are
hard-coded to a private mount).

Each reader takes `data_dir` and reads the real files under it where they
are; where they are not, it builds the JAX package's synthetic stand-in of
the same shapes, sizes and seeds (`data/synthetic.py`) when `synthetic_ok`,
and raises FileNotFoundError otherwise. `h5py` (the HDF5 sets) and PIL
(the ShapeNet renderings, the host image chain) are imported only where a
reader needs them.

* `ShapeNetRender` (pretraining): <data_dir>/ShapeNet/<cls>/<id>.ply and
  <data_dir>/ShapeNetRendering/<cls>/<id>/rendering/*.png; two augmented
  views of the cloud and one augmented view of a random rendering, or, with
  `raw_views`, the raw cloud and the uint8 image for `--device_augs`.
* `ModelNet40SVM`, `ScanObjectNNSVM` (classification): the HDF5 splits
  (`modelnet40_ply_hdf5_2048/ply_data_<split>*.h5`,
  `ScanObjectNN/main_split/<split>.h5`), clouds cut to `num_points`.
* `ShapeNetPart` (part segmentation): `shapenet_part_seg_hdf5_data/*.h5`,
  with `class_choice` and the trainval split's point shuffle.
* `S3DIS` (semantic segmentation): `indoor3d_sem_seg_hdf5_data` blocks of
  4,096 points x 9 channels, Area `test_area` held out by
  `room_filelist.txt`.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from vipformer_tpu_torch.data import augment, synthetic
from vipformer_tpu_torch.data.ply import load_ply


def _load_h5_concat(paths, keys) -> tuple[np.ndarray, ...]:
    """The arrays under `keys` of every HDF5 file in `paths` (sorted),
    concatenated along the first axis."""
    import h5py

    out = {k: [] for k in keys}
    for p in sorted(paths):
        with h5py.File(p, "r") as f:
            for k in keys:
                out[k].append(np.asarray(f[k][:]))
    return tuple(np.concatenate(out[k], axis=0) for k in keys)


class ShapeNetRender:
    """Pretraining samples (reference data.py:92-118): the real clouds and
    renderings where `<data_dir>/ShapeNet` holds any, else `synthetic_size`
    class-structured clouds of `num_points` points (16 classes, data seed
    7), each with its splat image. A cloud shorter than `num_points` is
    padded with points the sample's generator picks. `get` returns (view 1,
    view 2, image) augmented on the host, or with `raw_views` (raw cloud
    f32 [num_points, 3], image uint8 [img_height, img_width, 3]) resized as
    PIL's BILINEAR does (`augment.resize_bilinear_u8`, no PIL needed), for
    the step's own augmentation (`data/augment_device.py`)."""

    def __init__(self, data_dir: str, img_height: int = 144, img_width: int = 144,
                 num_points: int = 2048, synthetic_ok: bool = True, synthetic_size: int = 512,
                 raw_views: bool = False):
        self.img_height, self.img_width = img_height, img_width
        self.num_points = num_points
        self.raw_views = raw_views
        self.paths = sorted(glob.glob(os.path.join(data_dir, "ShapeNet", "*", "*")))
        self.synthetic = not self.paths
        if self.synthetic:
            if not synthetic_ok:
                raise FileNotFoundError(f"ShapeNet not found under {data_dir}")
            self._data, self._labels = synthetic.synthetic_classification(
                synthetic_size, num_points, 16, seed=7)

    def __len__(self) -> int:
        return len(self._data) if self.synthetic else len(self.paths)

    @staticmethod
    def _render_paths(pcd_path: str) -> list[str]:
        parts = pcd_path.split(os.sep)
        parts[-3] = "ShapeNetRendering"
        parts[-1] = os.path.splitext(parts[-1])[0]
        return glob.glob(os.path.join(os.sep.join(parts + ["rendering"]), "*.png"))

    def get(self, i: int, rng: np.random.Generator):
        if self.synthetic:
            raw = self._data[i]
            img = synthetic.splat_image(raw)
        else:
            raw = load_ply(self.paths[i])
            renders = self._render_paths(self.paths[i])
            if renders:
                from PIL import Image

                img = np.asarray(Image.open(renders[rng.integers(len(renders))]).convert("RGB"))
            else:
                img = synthetic.splat_image(raw)
        if len(raw) >= self.num_points:
            raw = raw[:self.num_points]
        else:
            pad = rng.integers(0, len(raw), self.num_points - len(raw))
            raw = np.concatenate([raw, raw[pad]], axis=0)
        if self.raw_views:
            u8 = augment.resize_bilinear_u8(np.asarray(img, dtype=np.uint8), self.img_height,
                                            self.img_width)
            return raw.astype(np.float32), u8
        im = augment.image_transform(img, rng, self.img_height, self.img_width)
        t1 = augment.pretrain_transform(raw, rng)
        t2 = augment.pretrain_transform(raw, rng)
        return t1, t2, im


class _Classification:
    """A classification split: (points [num_points, 3] f32, label) per
    sample, no augmentation. `sizes` maps the split to the stand-in's
    (samples, data seed)."""

    num_classes: int
    sizes: dict

    def __init__(self, data_dir: str, partition: str = "train", num_points: int = 1024,
                 synthetic_ok: bool = True):
        paths = self._paths(data_dir, partition)
        if paths:
            self.data, self.label = _load_h5_concat(paths, ["data", "label"])
            self.label = self.label.reshape(-1).astype(np.int64)
        elif synthetic_ok:
            n, seed = self.sizes[partition]
            self.data, self.label = synthetic.synthetic_classification(n, 2048, self.num_classes,
                                                                       seed=seed)
        else:
            raise FileNotFoundError(f"{type(self).__name__[:-3]} not found under {data_dir}")
        self.num_points = num_points

    @staticmethod
    def _paths(data_dir: str, partition: str) -> list[str]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.data)

    def get(self, i: int, rng=None):
        return self.data[i][:self.num_points].astype(np.float32), int(self.label[i])


class ModelNet40SVM(_Classification):
    """ModelNet40's HDF5 split (reference data.py:120-132); stand-in: 800
    train / 200 test clouds of 40 classes (data seeds 0 and 1)."""

    num_classes = 40
    sizes = {"train": (800, 0), "test": (200, 1)}

    @staticmethod
    def _paths(data_dir: str, partition: str) -> list[str]:
        return glob.glob(os.path.join(data_dir, "modelnet40_ply_hdf5_2048",
                                      f"ply_data_{partition}*.h5"))


class ScanObjectNNSVM(_Classification):
    """ScanObjectNN's main_split (reference data.py:134-146); stand-in: 600
    train / 150 test clouds of 15 classes (data seeds 2 and 3)."""

    num_classes = 15
    sizes = {"train": (600, 2), "test": (150, 3)}

    @staticmethod
    def _paths(data_dir: str, partition: str) -> list[str]:
        path = os.path.join(data_dir, "ScanObjectNN", "main_split", f"{partition}.h5")
        return [path] if os.path.exists(path) else []


class ShapeNetPart:
    """ShapeNetPart's HDF5 part-segmentation split (reference
    shapenet_part.py:71-108): (points [num_points, 3] f32, object label,
    part ids [num_points]) per sample; stand-in: 400 trainval / 120 test
    clouds (data seeds 4 / 5). `class_choice` keeps one category; the
    trainval split shuffles each sample's point order with the sample's
    generator (shapenet_part.py:100-104)."""

    CAT2ID = {
        "airplane": 0, "bag": 1, "cap": 2, "car": 3, "chair": 4, "earphone": 5, "guitar": 6,
        "knife": 7, "lamp": 8, "laptop": 9, "motor": 10, "mug": 11, "pistol": 12,
        "rocket": 13, "skateboard": 14, "table": 15,
    }
    sizes = {"trainval": (400, 4), "test": (120, 5)}

    def __init__(self, data_dir: str, partition: str = "train", num_points: int = 1024,
                 class_choice: str | None = None, synthetic_ok: bool = True):
        root = os.path.join(data_dir, "shapenet_part_seg_hdf5_data")
        if partition == "trainval":
            paths = (glob.glob(os.path.join(root, "*train*.h5"))
                     + glob.glob(os.path.join(root, "*val*.h5")))
        else:
            paths = glob.glob(os.path.join(root, f"*{partition}*.h5"))
        if paths:
            self.data, self.label, self.seg = _load_h5_concat(paths, ["data", "label", "pid"])
            self.label = self.label.astype(np.int64)
        elif synthetic_ok:
            n, seed = self.sizes["trainval" if partition == "trainval" else "test"]
            self.data, self.label, self.seg = synthetic.synthetic_partseg(n, 2048, seed=seed)
        else:
            raise FileNotFoundError(f"ShapeNetPart not found under {data_dir}")
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
        return (pts.astype(np.float32), int(np.asarray(self.label[i]).reshape(-1)[0]),
                seg.astype(np.int64))


class S3DIS:
    """S3DIS's chopped-scene blocks with Area `test_area` held out
    (reference s3dis.py:5-56): (points [4096, 9] f32, labels [4096] int64)
    per block, 13 classes. Where `all_files.txt` exists the blocks come
    from the HDF5 files it lists, the rooms of `room_filelist.txt` naming
    each block's area (a listed file that is missing raises); else the
    stand-in: 200 train / 60 test blocks (data seeds 6 / 8)."""

    num_classes = 13
    sizes = {"train": (200, 6), "test": (60, 8)}

    def __init__(self, data_dir: str = "data", split: str = "train", test_area: int = 5,
                 synthetic_ok: bool = True):
        root = os.path.join(data_dir, "indoor3d_sem_seg_hdf5_data")
        listing = os.path.join(root, "all_files.txt")
        if os.path.exists(listing):
            import h5py

            with open(listing) as f:
                files = [line.strip() for line in f]
            with open(os.path.join(root, "room_filelist.txt")) as f:
                rooms = [line.strip() for line in f]
            data, label = [], []
            for fn in files:
                with h5py.File(os.path.join(root, os.path.basename(fn)), "r") as h5:
                    data.append(h5["data"][:])
                    label.append(h5["label"][:])
            data, label = np.concatenate(data, 0), np.concatenate(label, 0)
            area = f"Area_{test_area}"
            idx = [i for i, r in enumerate(rooms) if (area in r) == (split != "train")]
            self.data = data[idx]
            self.label = label[idx].astype(np.int64)
        elif synthetic_ok:
            n, seed = self.sizes["train" if split == "train" else "test"]
            self.data, self.label = synthetic.synthetic_semseg(n, 4096, seed=seed)
        else:
            raise FileNotFoundError(f"S3DIS not found under {data_dir}")

    def __len__(self) -> int:
        return len(self.data)

    def get(self, i: int, rng=None):
        return self.data[i].astype(np.float32), self.label[i].astype(np.int64)
