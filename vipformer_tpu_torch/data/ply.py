"""Minimal PLY reader and writer (the port's own copy of
vipformer_tpu/data/ply.py): `load_ply(path)` -> float32 [N, 3] vertex
coordinates, all the pretraining pipeline reads of a ShapeNet cloud
(reference `datasets/data.py:107-109`), from ascii, binary little-endian
and binary big-endian files. The vertex element's other scalar properties
are read and dropped; list properties of later elements (faces) are never
reached."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


@dataclass
class _Element:
    name: str
    count: int
    props: list = field(default_factory=list)  # (name, dtype) or ("list", count_t, item_t, name)


def _parse_header(f) -> tuple[str | None, list[_Element]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.strip().split()
        if not tokens or tokens[0] in (b"comment", b"obj_info"):
            continue
        if tokens[0] == b"format":
            fmt = tokens[1].decode()
        elif tokens[0] == b"element":
            elements.append(_Element(tokens[1].decode(), int(tokens[2])))
        elif tokens[0] == b"property":
            if tokens[1] == b"list":
                elements[-1].props.append(("list", _TYPES[tokens[2].decode()],
                                           _TYPES[tokens[3].decode()], tokens[4].decode()))
            else:
                elements[-1].props.append((tokens[-1].decode(), _TYPES[tokens[1].decode()]))
        elif tokens[0] == b"end_header":
            return fmt, elements


def load_ply(path: str) -> np.ndarray:
    """The vertex xyz of a PLY file -> float32 [N, 3]."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        vertex = next(e for e in elements if e.name == "vertex")
        if any(p[0] == "list" for p in vertex.props):
            raise ValueError("list properties on vertex element unsupported")
        names = [p[0] for p in vertex.props]
        if fmt == "ascii":
            rows = [[float(v) for v in f.readline().split()[:len(names)]]
                    for _ in range(vertex.count)]
            arr = np.asarray(rows, dtype=np.float64)
            data = {n: arr[:, i] for i, n in enumerate(names)}
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(n, endian + t) for n, t in vertex.props])
            rec = np.frombuffer(f.read(dt.itemsize * vertex.count), dtype=dt, count=vertex.count)
            data = {n: rec[n] for n in names}
    return np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)


def save_ply(path: str, xyz: np.ndarray) -> None:
    """Write a float32 [N, 3] cloud as a binary little-endian PLY."""
    xyz = np.asarray(xyz, dtype="<f4")
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(xyz)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\nend_header\n")
        f.write(xyz.tobytes())
