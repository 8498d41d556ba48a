"""Build and load the package's CUDA kernels (counterpart of ops/pallas).

All `csrc/*.cu` sources compile with `nvcc` into ONE shared library with a
plain C interface, loaded with ctypes. The build runs at the first launch
of any kernel, never at import, into `_build/` inside this package (listed
in .gitignore), keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one loads the cached library.

Every C entry point takes raw device pointers plus the launch stream and
returns `cudaGetLastError()` after its launch; `check()` raises when that
is not cudaSuccess (a refused launch never runs, and a later synchronize
would not report it).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: argument types in order (pointers and
# the stream as void*, sizes as int, scalars as float); all return int.
SIGNATURES = {
    "fps_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "knn_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "stem_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stem_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "attn_kv_ln_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "attn_kv_ln_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "attn_small_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "attn_small_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def build() -> str:
    """Compile the kernels (if the hashed library is not there) and return
    the library's path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libvipformer_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        cu = [p for p in sources() if p.endswith(".cu")]
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def entry_point(base: str, dt: torch.dtype) -> str:
    """Name of the C entry point of kernel `base` for compute dtype `dt`."""
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}.get(dt)
    if suffix is None:
        raise TypeError(f"{base} kernel takes float32 or bfloat16, got {dt}")
    return f"{base}_{suffix}"


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a kernel operand: on CUDA, the expected dtype, contiguous,
    and (where given) the expected shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset, by kernel."""
    from vipformer_tpu_torch.ops.cuda import attention, fps, knn, stem

    return {
        "fps": fps.LAUNCHES.n,
        "knn": knn.LAUNCHES.n,
        "stem": stem.LAUNCHES.n,
        "attn_kv_ln": attention.KV_LN_LAUNCHES.n,
        "attn_small": attention.SMALL_LAUNCHES.n,
    }


def reset_launch_counts() -> None:
    from vipformer_tpu_torch.ops.cuda import attention, fps, knn, stem

    for c in (fps.LAUNCHES, knn.LAUNCHES, stem.LAUNCHES,
              attention.KV_LN_LAUNCHES, attention.SMALL_LAUNCHES):
        c.n = 0


class LaunchCounter:
    """A plain integer count of a wrapper's kernel launches."""

    def __init__(self):
        self.n = 0
