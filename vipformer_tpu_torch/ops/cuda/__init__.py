"""Build and load the package's CUDA kernels (counterpart of ops/pallas).

All `csrc/*.cu` sources compile with `nvcc` into ONE shared library with a
plain C interface, loaded with ctypes: one `nvcc -c` per source, all
started together, then one link. The build runs at the first launch of
any kernel, never at import, into `_build/` inside this package (listed
in .gitignore), keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one loads the cached library.

Every C entry point takes raw device pointers plus the launch stream and
returns `cudaGetLastError()` after its launch; `check()` raises when that
is not cudaSuccess (a refused launch never runs, and a later synchronize
would not report it).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
    "-Xcompiler", "-fPIC",
]

# LayerNorm epsilon of every LayerNorm in the port: the plain layers and
# twins use this one, the kernels vpt::LN_EPS in csrc/common.cuh (a test
# holds the two equal); the JAX package hard-codes 1e-5 in each place.
LN_EPS = 1e-5
# the one-pass backwards' arrival counters (a group count + 1 of them)
ARRIVE_COUNTERS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signature of every entry point: argument types in order (pointers and
# the stream as void*, sizes as int, scalars as float); all return int.
SIGNATURES = {
    "fps_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    # K2 (points, queries, out, b, n, s, k, overflow counter or null, stream)
    "knn_f32": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # K16 (xyz, start, centers_idx, neighbor_idx, b, n, g, k, overflow, stream)
    "fps_knn_f32": [_P] * 4 + [_I] * 4 + [_P, _P],
    # K3 (t1ext, idx, w2, b2, w3, b3, w4, b4, out, b, n, g, s, c1, d, stream):
    # f32 on the CUDA cores; bf16 on the tensor cores, with the x2 scratch
    # after out and the two passes' grids after d
    "stem_f32": [_P] * 9 + [_I] * 6 + [_P],
    "stem_tc_bf16": [_P] * 10 + [_I] * 8 + [_P],
    # K4 (q, x, ln_w, ln_b, wk, wv, out, part_acc, part_ml, b, g, m, din, h,
    # nsplit, scale, stream): as K3, bf16 with the normalised tokens' (xn)
    # and k|v scratch after part_ml and the projection's split after nsplit
    "attn_kv_ln_f32": [_P] * 9 + [_I] * 6 + [_F, _P],
    "attn_kv_ln_tc_bf16": [_P] * 11 + [_I] * 7 + [_F, _P],
    # K5 (q, k, v, out, b, g, m, h, scale, stream): f32 on the CUDA cores,
    # bf16 on the tensor cores
    "attn_small_f32": [_P] * 4 + [_I] * 4 + [_F, _P],
    "attn_small_tc_bf16": [_P] * 4 + [_I] * 4 + [_F, _P],
    # K7 / K8: (..., scale, keep probability, dropout threshold, dropout on, stream)
    # (f32 on the CUDA cores, K8's bf16 forward and backward on the tensor cores)
    "attn_train_fwd_f32": [_P] * 6 + [_I] * 4 + [_F, _F, _U, _I, _P],
    "attn_train_fwd_tc_bf16": [_P] * 6 + [_I] * 4 + [_F, _F, _U, _I, _P],
    "attn_train_bwd_f32": [_P] * 10 + [_I] * 4 + [_F, _F, _U, _I, _P],
    "attn_train_bwd_tc_bf16": [_P] * 10 + [_I] * 4 + [_F, _F, _U, _I, _P],
    # K7: f32 on the CUDA cores; bf16 on the tensor cores (one more scratch
    # pointer each way, xn; the forward's split states part_acc, part_ml
    # and its kv split nsplit after the heads), and its projection alone
    # (x, ln_w, ln_b, wk, wv, k, v, xn, stats, rows, din, h, stream)
    "attn_train_kv_fwd_f32": [_P] * 12 + [_I] * 5 + [_F, _F, _U, _I, _P],
    "attn_train_kv_fwd_tc_bf16": [_P] * 15 + [_I] * 6 + [_F, _F, _U, _I, _P],
    "attn_train_kv_bwd_f32": [_P] * 23 + [_I] * 7 + [_F, _F, _U, _I, _P],
    "attn_train_kv_bwd_tc_bf16": [_P] * 24 + [_I] * 7 + [_F, _F, _U, _I, _P],
    "kv_project_tc_bf16": [_P] * 9 + [_I] * 3 + [_P],
    "dropout_mask_u8": [_P, _I, _I, _I, _U, _P, _P],
    # K9: f32 on the CUDA cores; bf16 on the tensor cores, with no h4 or
    # dh4 scratch and the persistent grids and weight-gradient splits
    "g2e_fwd_f32": [_P] * 21 + [_I] * 5 + [_P],
    "g2e_fwd_tc_bf16": [_P] * 18 + [_I] * 7 + [_P],
    "g2e_bwd_f32": [_P] * 38 + [_I] * 6 + [_P],
    "g2e_bwd_tc_bf16": [_P] * 34 + [_I] * 10 + [_P],
    # K10 (points, centers, idx, out, b, n, c, g, k, s, run, stream); its
    # VJP (grad, idx, dpoints, dcenters, b, n, c, g, k, s, np, lanes, vec,
    # stage, stream)
    "gather_centered_f32": [_P] * 4 + [_I] * 7 + [_P],
    "gather_centered_bf16": [_P] * 4 + [_I] * 7 + [_P],
    "scatter_centered_f32": [_P] * 4 + [_I] * 10 + [_P],
    "scatter_centered_bf16": [_P] * 4 + [_I] * 10 + [_P],
    # K12 (points, idx, out, b, n, c, k, run, stream); (grad, idx, dpoints,
    # b, n, c, k, np, lanes, vec, stage, stream)
    "gather_rows_f32": [_P] * 3 + [_I] * 5 + [_P],
    "gather_rows_bf16": [_P] * 3 + [_I] * 5 + [_P],
    "scatter_rows_f32": [_P] * 3 + [_I] * 8 + [_P],
    "scatter_rows_bf16": [_P] * 3 + [_I] * 8 + [_P],
    # K11 (x, dy, dw, db, wpart, bpart, r, cin, cout, splits, stream): as K5
    "dense_grads_f32": [_P] * 6 + [_I] * 4 + [_P],
    "dense_grads_tc_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # K13 (q, k, v, out, part_acc, part_ml, b, g, m, h, nsplit, scale, stream):
    # f32 on the CUDA cores, bf16 on the tensor cores
    "attn_packed_f32": [_P] * 6 + [_I] * 5 + [_F, _P],
    "attn_packed_tc_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
    # K15 (q, x, wk, wv, out, part_acc, part_ml, b, g, m, din, h, nsplit, scale,
    # stream): f32 on the CUDA cores; bf16 on the tensor cores, with the
    # k|v scratch after part_ml, the cluster kernel's blocks a cluster (0:
    # K4's passes) before nsplit and the projection's split after it
    "attn_packed_kv_f32": [_P] * 7 + [_I] * 6 + [_F, _P],
    "attn_packed_kv_tc_bf16": [_P] * 8 + [_I] * 8 + [_F, _P],
    # K14 (q, k, v, out, bh, g, m, dh, dv, scale, stream): as K13
    "mha_f32": [_P] * 4 + [_I] * 5 + [_F, _P],
    "mha_tc_bf16": [_P] * 4 + [_I] * 5 + [_F, _P],
    # K6 (x, ln_w, ln_b, wq, wk, wv, out, b, g, din, h, scale, stream): as K5
    "attn_small_qkv_ln_f32": [_P] * 7 + [_I] * 4 + [_F, _P],
    "attn_small_qkv_ln_tc_bf16": [_P] * 7 + [_I] * 4 + [_F, _P],
    # K18 (x, sum, sumsq, part, r, c, splits, stream); (x, dy, mean, rstd,
    # dscale, dbias, part, arrive, r, c, per, group, vec, stream)
    "bn_stats_f32": [_P] * 4 + [_I] * 3 + [_P],
    "bn_stats_bf16": [_P] * 4 + [_I] * 3 + [_P],
    "bn_grad_reduces_f32": [_P] * 8 + [_I] * 5 + [_P],
    "bn_grad_reduces_bf16": [_P] * 8 + [_I] * 5 + [_P],
    # K17 (x, s, b, y, mu, rsig, r, d, lanes, vec, nv, rows_block, staged,
    # sms, stream); (x, dy, mu, rsig, s, dx, dscale, dbias, part, arrive, r,
    # d, per, group, vec, wpr, stream)
    "ln_fwd_f32": [_P] * 6 + [_I] * 8 + [_P],
    "ln_fwd_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "ln_bwd_f32": [_P] * 10 + [_I] * 6 + [_P],
    "ln_bwd_bf16": [_P] * 10 + [_I] * 6 + [_P],
}

_lib = None
_lock = threading.Lock()
_arrive: dict = {}  # (kernel, device) -> the one-pass kernels' int32 arrival counters


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
    the library's path: one `nvcc -c` per source, started together, then
    one link."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libvipformer_kernels_{tag}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    stem = os.path.join(BUILD_DIR, f"{tag}.{os.getpid()}")
    objs, procs = [], []
    for src in (p for p in sources() if p.endswith(".cu")):
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{stem}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        os.remove(obj)
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


def tc_route(base: str, dt: torch.dtype) -> str:
    """The C entry point of a kernel with a tensor-core route (K3 `stem`,
    K4 `attn_kv_ln`, K5 `attn_small`, K6 `attn_small_qkv_ln`, K7's forward
    `attn_train_kv_fwd` and backward `attn_train_kv_bwd`, K8's forward
    `attn_train_fwd` and backward `attn_train_bwd`, K9's forward `g2e_fwd`
    and backward `g2e_bwd`, K11 `dense_grads`, K13 `attn_packed`, K14
    `mha`, K15 `attn_packed_kv`) for
    dtype `dt`: bf16 on the tensor cores, f32 on the CUDA cores (a
    tensor-core f32 product is TF32, about 3 decimal digits: it would break
    the f32 bounds against the twins). Not a fallback: each dtype has one
    kernel, and any other dtype raises."""
    if dt == torch.bfloat16:
        return f"{base}_tc_bf16"
    if dt == torch.float32:
        return f"{base}_f32"
    raise TypeError(f"{base} kernel takes float32 or bfloat16, got {dt}")


def require_aligned(fn: str, **ptrs: int) -> None:
    """The tensor-core kernels load rows with 16-byte cp.async, so each
    operand they copy so must start on a 16-byte boundary: `ptrs` maps
    each one's name to its data pointer (every tensor the port makes is
    aligned; a view into the middle of a row may not be)."""
    if fn.endswith("_tc_bf16"):
        for name, ptr in ptrs.items():
            if ptr % 16:
                raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device `index` (asked once: the query costs microseconds
    of host time at every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def arrive_counters(kernel: str, dev) -> int:
    """The data pointer of `kernel`'s int32 arrival counters on `dev`
    (K17's and K18's one-pass backwards: train_common.cuh
    last_block_sums): zeroed once, and reset to 0 by the kernel's last
    block, so that its launches on one stream share them."""
    t = _arrive.get((kernel, dev))
    if t is None:
        t = _arrive[(kernel, dev)] = torch.zeros((ARRIVE_COUNTERS,), dtype=torch.int32,
                                                 device=dev)
    return t.data_ptr()


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


def _counters() -> dict[str, "LaunchCounter"]:
    from vipformer_tpu_torch.ops.cuda import (attention, batchnorm, dense, flash_train, fps,
                                              g2e_train, gather, knn, layernorm, patchify, stem)

    return {
        "fps": fps.LAUNCHES,
        "knn": knn.LAUNCHES,
        "fps_knn": patchify.LAUNCHES,
        "stem": stem.LAUNCHES,
        "attn_kv_ln": attention.KV_LN_LAUNCHES,
        "attn_small": attention.SMALL_LAUNCHES,
        "attn_small_qkv_ln": attention.SMALL_QKV_LN_LAUNCHES,
        "attn_packed": attention.PACKED_LAUNCHES,
        "attn_packed_kv": attention.PACKED_KV_LAUNCHES,
        "attn_head_split": attention.HEAD_SPLIT_LAUNCHES,
        "attn_train_kv_fwd": flash_train.KV_FWD_LAUNCHES,
        "attn_train_kv_bwd": flash_train.KV_BWD_LAUNCHES,
        "attn_train_fwd": flash_train.FWD_LAUNCHES,
        "attn_train_bwd": flash_train.BWD_LAUNCHES,
        "g2e_train_fwd": g2e_train.FWD_LAUNCHES,
        "g2e_train_bwd": g2e_train.BWD_LAUNCHES,
        "gather_centered_fwd": gather.FWD_LAUNCHES,
        "gather_centered_bwd": gather.BWD_LAUNCHES,
        "gather_rows_fwd": gather.ROWS_FWD_LAUNCHES,
        "gather_rows_bwd": gather.ROWS_BWD_LAUNCHES,
        "dense_grads": dense.LAUNCHES,
        "batchnorm_fwd": batchnorm.STATS_LAUNCHES,
        "batchnorm_bwd": batchnorm.GRAD_LAUNCHES,
        "layernorm_fwd": layernorm.FWD_LAUNCHES,
        "layernorm_bwd": layernorm.BWD_LAUNCHES,
    }


@contextlib.contextmanager
def plain_reference_mode():
    """Force every kernel flag to its plain route for the duration, and
    restore the flags after (counterpart of the JAX package's
    `ops.pallas.xla_reference_mode`, ops/pallas/__init__.py:53-97): the
    attention gates (K4-K6, K8, K13-K15), K11, K12, K16, K17 and K18 off.
    Used to count a forward's products (evaluation/flops.py), which a
    counter cannot see inside a kernel. The eval stem K3 and FPS, kNN and
    the centered gather (K1, K2, K10) have no flag: on a CPU or meta
    tensor their wrappers take the plain twins."""
    from vipformer_tpu_torch.ops.cuda import (attention, batchnorm, dense, gather, layernorm,
                                              patchify)

    flags = ((attention, "USE_FUSED_ATTENTION"), (attention, "USE_SA_QKV_LN"),
             (dense, "USE_DENSE_GRAD"), (gather, "USE_ROW_GATHER"),
             (patchify, "USE_FPS_KNN"), (layernorm, "USE_LAYERNORM"),
             (batchnorm, "USE_BN_TRAIN"))
    saved = [getattr(mod, name) for mod, name in flags]
    try:
        for mod, name in flags:
            setattr(mod, name, False)
        yield
    finally:
        for (mod, name), value in zip(flags, saved):
            setattr(mod, name, value)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset, by kernel."""
    return {name: c.n for name, c in _counters().items()}


def reset_launch_counts() -> None:
    for c in _counters().values():
        c.n = 0


class LaunchCounter:
    """A plain integer count of a wrapper's kernel launches."""

    def __init__(self):
        self.n = 0
