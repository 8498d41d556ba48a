#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`vipformer_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the hand-written kernels (csrc/*.cu -> one .so, nvcc, sm_90a);
  2. turn TF32 off for matmuls and cuDNN;
  3. hold each kernel K1-K5 against its plain PyTorch twin on the card at
     the flagship shapes (B = 32 and 64; K1/K2 on f32 points, K3-K5 in f32
     and bf16), and time both with CUDA events;
  4. build the flagship classifier CrossFormerPCFT (E1CL8SL-H4D256-L128-MR2,
     random weights from a seed) in bf16 on the card and serve ragged
     requests through `classifier_predictor(max_batch=64)`;
  5. check that every kernel launched during that run, that the outputs
     are finite, and that the card agrees with the plain path on the CPU
     (f32: identical FPS/kNN indices and close logits; bf16: logits within
     a bf16 bound);
  6. time the bf16 forward at B = 32 and 64.

Prints the card's name and power limit, one JSON line of per-kernel
results, and last the line {"ok": true, "device": {...}}. Imports nothing
of JAX and nothing of the JAX package (vipformer_tpu).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ARCH = "E1CL8SL-H4D256-L128-MR2"
# ARCH as vipformer_tpu.config decodes it (with the Config defaults
# group_size=32 and 40 classes), written out so that this script loads
# nothing of the JAX package; a CPU test holds the two equal.
FLAGSHIP = dict(
    num_latents=128, num_latent_channels=256, group_size=32, patch_compat=False,
    num_cross_attention_layers=1, num_cross_attention_heads=4,
    num_self_attention_layers=8, num_self_attention_heads=4, mlp_widen_factor=2,
    num_obj_classes=40,
)
NUM_POINTS = 1024
NUM_CLASSES = FLAGSHIP["num_obj_classes"]
SEED = 0
BATCHES = (32, 64)
REQUESTS = (1, 5, 32, 64)
# Kernel vs plain twin, as max|kernel - plain| / max(1, max|plain|):
# f32 differs only by summation order (K = 64..1024 terms);
# bf16 may flip an intermediate rounding by one bf16 ulp (2^-8).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Card vs CPU plain path on the flagship logits, as max abs error over
# max(1, max|ref|): f32 as above through 8 layers; bf16 against the f32
# CPU reference carries bf16 rounding of every activation (2^-8 each,
# compounded over the 8 layers and the head).
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}

KERNELS = {
    "fps": ("vipformer_tpu_torch/csrc/fps.cu",
            "vipformer_tpu/ops/pallas/fps.py:100 fps_pallas"),
    "knn": ("vipformer_tpu_torch/csrc/knn.cu",
            "vipformer_tpu/ops/pallas/knn.py:70 knn_pallas"),
    "stem": ("vipformer_tpu_torch/csrc/stem.cu",
             "vipformer_tpu/ops/pallas/stem.py:96 _stem_call"),
    "attn_kv_ln": ("vipformer_tpu_torch/csrc/attention.cu",
                   "vipformer_tpu/ops/pallas/attention.py:450 fused_attention_packed_kv_ln"),
    "attn_small": ("vipformer_tpu_torch/csrc/attention.cu",
                   "vipformer_tpu/ops/pallas/attention.py:639 fused_attention_packed_small"),
}


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |ref|)) in f32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def check_kernels(results: dict) -> None:
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    d, h, g, s = 256, 4, 128, 32
    scale = (d // h) ** -0.5

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    g2e = init_weights(Group2Emb(3, d), SEED).to(dev)
    with torch.no_grad():  # nontrivial eval BatchNorm statistics
        for bn in (g2e.BatchNorm_0, g2e.BatchNorm_1):
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(t((c,), scale_=0.1))
            bn.running_var.copy_(t((c,)).abs() + 0.5)
            bn.weight.copy_(t((c,), scale_=0.2) + 1.0)
            bn.bias.copy_(t((c,), scale_=0.1))

    def record(name, b, dt, err, rel, tol, ms, plain_ms):
        print(f"kernel {name:10s} B={b:3d} {dt:8s} max_abs_err={err:.3e} "
              f"rel={rel:.3e} (bound {tol:.0e}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        expect(rel <= tol, f"{name} {dt} B={b}: error {rel:.3e} above {tol:.0e}")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if b == max(BATCHES) and (dt == "bfloat16" or name in ("fps", "knn")):
            # the timing kept is the main path's: B=64, bf16 where it applies
            r["ms"], r["plain_ms"] = ms, plain_ms

    def check_kv_ln(b, dt_name, dt):
        q, x = t((b, g, d), dt), t((b, NUM_POINTS, d), dt)
        lw, lb = t((d,), scale_=0.2) + 1.0, t((d,), scale_=0.1)
        wk, wv = t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5)
        args = (q, x, lw, lb, wk, wv)
        out_k = kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=scale)
        out_p = kattn.attention_kv_ln_plain(*args, h, scale)
        record("attn_kv_ln", b, dt_name, *rel_err(out_k, out_p), KERNEL_TOL[dt_name],
               cuda_ms(lambda: kattn.fused_attention_packed_kv_ln(
                   *args, num_heads=h, scale=scale)),
               cuda_ms(lambda: kattn.attention_kv_ln_plain(*args, h, scale)))

    with torch.inference_mode():
        # K4 splits the kv chunks over blocks by batch size: cover one split
        # (B=128) and one chunk per block (B=1) besides the flagship batches
        for b in (1, 128):
            check_kv_ln(b, "float32", torch.float32)
        for b in BATCHES:
            xyz = t((b, NUM_POINTS, 3))
            start = torch.zeros((b,), dtype=torch.int32, device=dev)
            # K1
            idx_k, cen_k = kfps.fps(xyz, g)
            idx_p, cen_p = kfps.fps_plain(xyz, g, start)
            expect(torch.equal(idx_k, idx_p), f"fps B={b}: indices differ")
            expect(torch.equal(cen_k, cen_p), f"fps B={b}: centers differ")
            record("fps", b, "float32", 0.0, 0.0, 0.0,
                   cuda_ms(lambda: kfps.fps(xyz, g)),
                   cuda_ms(lambda: kfps.fps_plain(xyz, g, start), iters=3, warmup=1))
            # K2 (queries: the FPS centers, as on the main path)
            nn_k = kknn.knn(s, xyz, cen_k)
            nn_p = kknn.knn_plain(s, xyz, cen_k)
            expect(torch.equal(nn_k.sort(-1).values, nn_p.sort(-1).values),
                   f"knn B={b}: index sets differ")
            record("knn", b, "float32", 0.0, 0.0, 0.0,
                   cuda_ms(lambda: kknn.knn(s, xyz, cen_k)),
                   cuda_ms(lambda: kknn.knn_plain(s, xyz, cen_k)))
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                # K3
                ops = kstem.stem_operands(g2e, xyz, cen_k, nn_k, dt)
                out_k, out_p = kstem.stem_kernel(*ops), kstem.stem_plain(*ops)
                record("stem", b, dt_name, *rel_err(out_k, out_p), KERNEL_TOL[dt_name],
                       cuda_ms(lambda: kstem.stem_kernel(*ops)),
                       cuda_ms(lambda: kstem.stem_plain(*ops)))
                check_kv_ln(b, dt_name, dt)  # K4
                # K5
                qkv = (t((b, g, d), dt), t((b, g, d), dt), t((b, g, d), dt))
                out_k = kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale)
                out_p = kattn.attention_small_plain(*qkv, h, scale)
                record("attn_small", b, dt_name, *rel_err(out_k, out_p), KERNEL_TOL[dt_name],
                       cuda_ms(lambda: kattn.fused_attention_packed_small(
                           *qkv, num_heads=h, scale=scale)),
                       cuda_ms(lambda: kattn.attention_small_plain(*qkv, h, scale)))


def build_model(dtype: str, device):
    from vipformer_tpu_torch.models.crossformer import CrossFormerPCFT

    return CrossFormerPCFT(**FLAGSHIP, dtype=getattr(torch, dtype), device=device, seed=SEED)


def drive_main_path(counts_out: dict) -> None:
    from vipformer_tpu_torch.inference import classifier_predictor
    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.ops import geometry

    rng = np.random.default_rng(SEED + 1)
    model = build_model("bfloat16", "cuda")
    predictor = classifier_predictor(model, max_batch=64)
    requests = [rng.standard_normal((n, NUM_POINTS, 3)).astype(np.float32) for n in REQUESTS]

    kcuda.reset_launch_counts()
    outs = [predictor(r) for r in requests]
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    counts_out.update(counts)
    print("main path launches:", json.dumps(counts))
    for name, n in counts.items():
        expect(n > 0, f"kernel {name} was not launched on the main path")
    for req, out in zip(requests, outs):
        expect(out["logits"].shape == (len(req), NUM_CLASSES), "logits shape")
        expect(out["backbone_feats"].shape == (len(req), 2 * 256), "backbone shape")
        expect(bool(np.isfinite(out["logits"]).all()), "non-finite logits")
        expect(bool(np.isfinite(out["backbone_feats"]).all()), "non-finite backbone feats")
    print(f"served requests of {list(REQUESTS)} clouds: outputs finite, padding stripped")

    # the card against the plain path on the CPU, same weights, 8 clouds
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    pts = rng.standard_normal((8, NUM_POINTS, 3)).astype(np.float32)
    cpu = build_model("float32", "cpu")
    cpu.load_state_dict(state, strict=True)
    with torch.inference_mode():
        ref_logits, _ = cpu(torch.from_numpy(pts))
        pc, pg = torch.from_numpy(pts), torch.from_numpy(pts).cuda()
        i_c, c_c = geometry.farthest_point_sample_with_centers(pc, 128)
        i_g, c_g = geometry.farthest_point_sample_with_centers(pg, 128)
        expect(torch.equal(i_c, i_g.cpu()), "card FPS indices differ from the CPU path")
        nn_c = geometry.knn(32, pc, c_c)
        nn_g = geometry.knn(32, pg, c_g)
        expect(torch.equal(nn_c, nn_g.cpu()), "card kNN indices differ from the CPU path")
        print("card vs CPU: FPS and kNN indices identical (8 clouds)")
        for dt in ("float32", "bfloat16"):
            card = build_model(dt, "cuda")
            card.load_state_dict(state, strict=True)
            logits, _ = card(pg)
            err, rel = rel_err(logits.cpu(), ref_logits)
            print(f"card {dt} vs CPU f32 plain path: logits max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (bound {MODEL_TOL[dt]:.0e})")
            expect(rel <= MODEL_TOL[dt], f"card {dt} logits off the CPU path: {rel:.3e}")


def time_forward() -> None:
    model = build_model("bfloat16", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        for b in BATCHES:
            x = torch.randn((b, NUM_POINTS, 3), device="cuda", generator=gen)
            ms = cuda_ms(lambda: model(x), iters=10)
            print(f"forward bf16 B={b}: {ms:.3f} ms ({ms / b:.4f} ms/cloud, "
                  f"{1000.0 * b / ms:.0f} clouds/s)")


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "vipformer_tpu_torch")):
        print("chip_smoke: the vipformer_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vipformer_tpu_torch.ops import cuda as kcuda

    try:
        t0 = time.perf_counter()
        kcuda.lib()
        print(f"built kernels in {time.perf_counter() - t0:.1f} s: {kcuda.build()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        results: dict = {}
        check_kernels(results)
        counts: dict = {}
        drive_main_path(counts)
        time_forward()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "flax", "optax", "vipformer_tpu")]
    if bad:
        print(f"chip_smoke FAILED: imported {bad}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
