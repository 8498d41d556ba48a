"""The port's data layer against the JAX package's, on the CPU: the PLY
reader and writer, the PIL-free uint8 resize, every dataset reader on
tiny real files (PLY, PNG, HDF5 written into tmp_path) and on its
synthetic stand-in, the prefetcher against the plain loader, and the
CLIs on tiny real files and with `--device_augs true`.

Readers are held exactly: the same arrays and labels as JAX's readers
from the same files and the same per-sample generator. The uint8 resize
(`augment.resize_bilinear_u8`) is held bit for bit against PIL's
`Image.resize(..., BILINEAR)`: no pixel may differ by even one level.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from vipformer_tpu.data import datasets as jds
from vipformer_tpu.data import pipeline as jpipe
from vipformer_tpu.data import ply as jply
from vipformer_tpu_torch.data import augment as taugment
from vipformer_tpu_torch.data import datasets as tds
from vipformer_tpu_torch.data import pipeline as tpipe
from vipformer_tpu_torch.data import ply as tply

h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")


def _assert_same(a, b):
    assert type(a) is type(b) or np.isscalar(a), (type(a), type(b))
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _write_ply(path, xyz, fmt):
    """A vertex element with normals and a colour beside xyz, then a face
    element with a list property."""
    n = len(xyz)
    rng = np.random.default_rng(n)
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    red = rng.integers(0, 256, n).astype(np.uint8)
    head = (f"ply\nformat {fmt} 1.0\ncomment tiny\nelement vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\nproperty uchar red\n"
            "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if fmt == "ascii":
            for p, q, r in zip(xyz, normals, red):
                f.write((" ".join(f"{v:.9g}" for v in (*p, *q)) + f" {r}\n").encode())
            f.write(b"3 0 1 2\n")
        else:
            e = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(k, e + "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
                          + [("red", "u1")])
            rec = np.empty(n, dt)
            for i, k in enumerate(("x", "y", "z")):
                rec[k] = xyz[:, i]
                rec["n" + k] = normals[:, i]
            rec["red"] = red
            f.write(rec.tobytes())
            f.write(np.array([3], "u1").tobytes() + np.array([0, 1, 2], e + "i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_load_and_save_ply_match_jax(tmp_path, fmt):
    xyz = np.random.default_rng(0).standard_normal((37, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    _write_ply(path, xyz, fmt)
    got = tply.load_ply(path)
    _assert_same(got, jply.load_ply(path))
    np.testing.assert_array_equal(got, xyz)
    tply.save_ply(str(tmp_path / "t.ply"), xyz)
    jply.save_ply(str(tmp_path / "j.ply"), xyz)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    with pytest.raises(ValueError, match="not a PLY"):
        (tmp_path / "bad.ply").write_bytes(b"nope\n")
        tply.load_ply(str(tmp_path / "bad.ply"))


@pytest.mark.parametrize("shape", [(137, 137, 144, 144), (137, 137, 64, 64), (20, 30, 7, 45),
                                   (5, 9, 5, 20), (256, 300, 137, 137), (33, 17, 33, 17),
                                   (3, 3, 100, 1), (100, 64, 1, 1)])
def test_uint8_resize_is_pils_bit_for_bit(shape):
    """Bound: exact (0 levels) on every pixel, growing, shrinking, one side
    only and unchanged, on noise with a saturated band."""
    h, w, oh, ow = shape
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[: h // 3] = 255
    img[-1] = 0
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    got = taugment.resize_bilinear_u8(img, oh, ow)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    """ShapeNet/<cls>/<id>.ply (some shorter than 64 points) and
    ShapeNetRendering/<cls>/<id>/rendering/*.png (one cloud without)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(1)
    for c, cls in enumerate(("02691156", "03001627")):
        (root / "ShapeNet" / cls).mkdir(parents=True)
        for j, n in enumerate((80, 40, 64)):
            name = f"m{j}"
            _write_ply(str(root / "ShapeNet" / cls / f"{name}.ply"),
                       rng.standard_normal((n, 3)).astype(np.float32), "binary_little_endian")
            if (c, j) == (1, 2):
                continue
            rdir = root / "ShapeNetRendering" / cls / name / "rendering"
            rdir.mkdir(parents=True)
            for k in range(3):
                hw = (17 + k, 13 + 2 * k)
                Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)).save(
                    str(rdir / f"{k:02d}.png"))
    return str(root)


@pytest.mark.parametrize("raw_views", [False, True])
@pytest.mark.parametrize("real", [True, False])
def test_shapenet_render_matches_jax(shapenet_root, tmp_path, raw_views, real):
    """The real PLY + PNG layout (a random rendering, short clouds padded
    from the generator, a cloud without renderings splatted) and the
    synthetic stand-in, host-augmented views or raw views, from the same
    per-sample seeds."""
    root = shapenet_root if real else str(tmp_path)
    kw = dict(img_height=16, img_width=16, num_points=64, synthetic_size=6,
              raw_views=raw_views)
    got, want = tds.ShapeNetRender(root, **kw), jds.ShapeNetRender(root, **kw)
    assert len(got) == len(want) == 6 and got.synthetic == want.synthetic == (not real)
    for i in range(len(got)):
        _assert_same(got.get(i, np.random.default_rng(i)), want.get(i, np.random.default_rng(i)))
    collate = (tpipe.collate_pretrain_raw, jpipe.collate_pretrain_raw) if raw_views else (
        tpipe.collate_pretrain, jpipe.collate_pretrain)
    bt = next(iter(tpipe.Loader(got, 4, collate[0], shuffle=True, seed=3)))
    bj = next(iter(jpipe.Loader(want, 4, collate[1], shuffle=True, seed=3)))
    assert bt.keys() == bj.keys()
    for k in bj:
        _assert_same(bt[k], bj[k])
    if raw_views:
        assert bt["imgs"].dtype == np.uint8 and bt["imgs"].shape == (4, 16, 16, 3)


def _h5(path, **arrays):
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(2)
    mn = root / "modelnet40_ply_hdf5_2048"
    mn.mkdir()
    for name, n in (("ply_data_train1.h5", 5), ("ply_data_train0.h5", 7),
                    ("ply_data_test0.h5", 4)):
        _h5(str(mn / name), data=rng.standard_normal((n, 48, 3)).astype(np.float32),
            label=rng.integers(0, 40, (n, 1)).astype(np.uint8))
    so = root / "ScanObjectNN" / "main_split"
    so.mkdir(parents=True)
    for split, n in (("train", 6), ("test", 3)):
        _h5(str(so / f"{split}.h5"), data=rng.standard_normal((n, 48, 3)).astype(np.float32),
            label=rng.integers(0, 15, n).astype(np.int64))
    sp = root / "shapenet_part_seg_hdf5_data"
    sp.mkdir()
    for name, n in (("ply_data_train0.h5", 6), ("ply_data_val0.h5", 3), ("ply_data_test0.h5", 4)):
        _h5(str(sp / name), data=rng.standard_normal((n, 40, 3)).astype(np.float32),
            label=rng.choice([4, 15], (n, 1)).astype(np.uint8),
            pid=rng.integers(0, 50, (n, 40)).astype(np.uint8))
    s3 = root / "indoor3d_sem_seg_hdf5_data"
    s3.mkdir()
    rooms = []
    for k, (n, areas) in enumerate(((4, (1, 5, 2, 5)), (3, (5, 3, 6)))):
        _h5(str(s3 / f"ply_data_all_{k}.h5"),
            data=rng.standard_normal((n, 32, 9)).astype(np.float32),
            label=rng.integers(0, 13, (n, 32)).astype(np.uint8))
        rooms += [f"Area_{a}_office_{i}" for i, a in enumerate(areas)]
    (s3 / "all_files.txt").write_text(
        "".join(f"indoor3d_sem_seg_hdf5_data/ply_data_all_{k}.h5\n" for k in range(2)))
    (s3 / "room_filelist.txt").write_text("".join(r + "\n" for r in rooms))
    return str(root)


def _same_reader(got, want, n_expected, rng_seed=None):
    assert len(got) == len(want) == n_expected
    for i in range(len(want)):
        r = (lambda: np.random.default_rng(rng_seed + i)) if rng_seed is not None else (
            lambda: None)
        _assert_same(got.get(i, r()), want.get(i, r()))


@pytest.mark.parametrize("name,splits", [("ModelNet40SVM", {"train": 12, "test": 4}),
                                         ("ScanObjectNNSVM", {"train": 6, "test": 3})])
def test_classification_hdf5_readers_match_jax(h5_root, name, splits):
    for split, n in splits.items():
        got, want = getattr(tds, name)(h5_root, split, 32), getattr(jds, name)(h5_root, split, 32)
        _same_reader(got, want, n)
        _assert_same(got.label, want.label)
        assert got.get(0)[0].shape == (32, 3)


@pytest.mark.parametrize("class_choice", [None, "table"])
def test_shapenetpart_hdf5_reader_matches_jax(h5_root, class_choice):
    """trainval = the train and val files, the point shuffle from the
    sample's generator; class_choice keeps one category and its part
    range."""
    for split in ("trainval", "test"):
        got = tds.ShapeNetPart(h5_root, split, 24, class_choice)
        want = jds.ShapeNetPart(h5_root, split, 24, class_choice)
        assert (got.seg_num_all, got.seg_start_index) == (want.seg_num_all, want.seg_start_index)
        _same_reader(got, want, len(want), rng_seed=10)
        if class_choice is None:
            assert len(got) == (9 if split == "trainval" else 4)


@pytest.mark.parametrize("test_area", [5, 1])
def test_s3dis_hdf5_reader_holds_out_its_area(h5_root, test_area):
    for split in ("train", "test"):
        got = tds.S3DIS(h5_root, split, test_area)
        want = jds.S3DIS(h5_root, split, test_area)
        n_test = {5: 3, 1: 1}[test_area]
        _same_reader(got, want, n_test if split == "test" else 7 - n_test)


@pytest.mark.parametrize("name", ["ShapeNetRender", "ModelNet40SVM", "ScanObjectNNSVM",
                                  "ShapeNetPart", "S3DIS"])
def test_readers_fall_back_or_raise_without_files(tmp_path, name):
    """Without files: the synthetic stand-in (JAX's sizes and seeds), or
    FileNotFoundError with synthetic_ok=False, as JAX's readers."""
    args = {"ShapeNetRender": (), "S3DIS": ("test",)}.get(name, ("test", 64))
    kw = {"synthetic_size": 5} if name == "ShapeNetRender" else {}
    got, want = getattr(tds, name)(str(tmp_path), *args, **kw), getattr(jds, name)(
        str(tmp_path), *args, **kw)
    assert len(got) == len(want)
    for i in (0, len(want) - 1):
        _assert_same(got.get(i, np.random.default_rng(i)), want.get(i, np.random.default_rng(i)))
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError):
            getattr(mod, name)(str(tmp_path), *args, synthetic_ok=False, **kw)


class _Counting:
    """A dataset whose get raises at index `fail` (if any)."""

    def __init__(self, n, fail=None):
        self.n, self.fail = n, fail

    def __len__(self):
        return self.n

    def get(self, i, rng):
        if i == self.fail:
            raise KeyError(f"sample {i}")
        return rng.standard_normal(3).astype(np.float32), np.full(2, i, np.uint8)


def _collate(samples):
    return {"x": np.stack([s[0] for s in samples]), "i": np.stack([s[1] for s in samples])}


def test_prefetch_matches_the_plain_loader_and_reraises():
    """The same batches in the same order (CPU tensors sharing nothing but
    their values with the loader's arrays), a clean end, a loader's
    exception raised in the consumer with the batches before it
    delivered, and an early exit that stops the producer thread; the
    same batches with 16 loader threads under a short switch interval."""
    loader = tpipe.Loader(_Counting(23), 4, _collate, shuffle=True, seed=5, drop_last=True)
    loader.set_epoch(2)
    plain = list(loader)
    got = list(tpipe.prefetch_to_device(iter(loader), "cpu"))
    assert len(got) == len(plain) == 5
    for b, p in zip(got, plain):
        assert b.keys() == p.keys()
        for k in p:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(b[k].numpy(), p[k])
    # under a short switch interval, 16 loader threads: still every batch, in order
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        busy = tpipe.Loader(_Counting(23), 4, _collate, shuffle=True, seed=5, drop_last=True,
                            num_workers=16)
        busy.set_epoch(2)
        again = list(tpipe.prefetch_to_device(iter(busy), "cpu", depth=1))
    finally:
        sys.setswitchinterval(interval)
    assert [b["i"].tolist() for b in again] == [p["i"].tolist() for p in plain]
    order = [int(i) for b in tpipe.Loader(_Counting(23), 4, _collate, shuffle=False)
             for i in b["i"][:, 0]]
    fail = tpipe.Loader(_Counting(23, fail=order[9]), 4, _collate, shuffle=False)
    seen = []
    with pytest.raises(KeyError, match=f"sample {order[9]}"):
        for b in tpipe.prefetch_to_device(iter(fail), "cpu"):
            seen.append(b)
    assert len(seen) == 2  # the batches before the failing one
    before = threading.active_count()
    it = tpipe.prefetch_to_device(iter(tpipe.Loader(_Counting(400), 2, _collate)), "cpu", 2)
    next(it)
    it.close()
    assert threading.active_count() <= before


def test_pretrain_cli_device_augs_epoch_on_the_cpu(tmp_path):
    """One tiny epoch of the pretrain CLI with `--device_augs true`: raw
    clouds and uint8 images through the prefetcher, both chains inside
    the step."""
    from vipformer_tpu_torch.cli import pretrain as cli

    argv = ["--synthetic_data", "true", "--synthetic_size", "8", "--epochs", "1",
            "--batch_size", "4", "--arch", "E1CL1SL-H2D32-L16-MR2", "--group_size", "8",
            "--num_pt_points", "64", "--img_height", "24", "--img_width", "24",
            "--patch_size", "12", "--num_test_points", "64", "--compute_dtype", "float32",
            "--device_augs", "true", "--data_dir", str(tmp_path / "none"),
            "--run_dir", str(tmp_path), "--exp_name", "da", "--device", "cpu"]
    cfg, device = cli.parse_args(argv)
    assert cfg.device_augs
    batch = next(iter(cli.train_loader(cfg)))
    assert set(batch) == {"pc_raw", "imgs"} and batch["imgs"].dtype == np.uint8
    cli.main(cfg, device)
    root = tmp_path / cfg.proj_name / "da"
    (line,) = (root / "metrics.jsonl").read_text().splitlines()
    assert np.isfinite(json.loads(line)["pretrain_loss"])
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "device augmentation" in log


def test_ft_cls_cli_reads_real_files(h5_root, tmp_path):
    """`--synthetic_data false` with the ModelNet40 HDF5 splits under
    `--data_dir`: ft_cls trains on the 12 train clouds and tests the 4."""
    from vipformer_tpu_torch.cli import ft_cls

    argv = ["--synthetic_data", "false", "--data_dir", h5_root, "--epochs", "1",
            "--batch_size", "4", "--test_batch_size", "4", "--arch", "E1CL1SL-H2D32-L16-MR2",
            "--group_size", "8", "--num_ft_points", "32", "--compute_dtype", "float32",
            "--num_obj_classes", "40", "--run_dir", str(tmp_path), "--exp_name", "real",
            "--device", "cpu"]
    cfg, device = ft_cls.parse_args(argv)
    assert not cfg.synthetic_data
    ft_cls.main(cfg, device)
    root = tmp_path / cfg.proj_name / "real"
    (line,) = (root / "metrics.jsonl").read_text().splitlines()
    assert np.isfinite(json.loads(line)["train_loss"])
    log = "".join(p.read_text() for p in root.glob("*.log"))
    assert "ModelNet40 12 train / 4 test clouds of 32 points" in log
