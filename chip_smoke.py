#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`vipformer_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches an error and
goes on):
  1. build the hand-written kernels (csrc/*.cu -> one .so: one nvcc per
     source, all started together, sm_90a);
  2. turn TF32 off for matmuls and cuDNN;
  3. hold each serving kernel K1-K5 against its plain PyTorch twin on the
     card at the flagship serving shapes (B = 32 and 64; K1/K2 on f32
     points, K3-K5 in f32 and bf16), and time both with CUDA events;
  4. serving path: build the flagship classifier (ARCH, decoded by the
     port's Config, through the port's factory; random weights from a
     seed) in bf16 on the card, serve ragged requests through
     `classifier_predictor`, check that K1-K5 launched, the outputs are
     finite and the card agrees with the plain path on the CPU;
  5. hold each training kernel K7-K10, forward and backward, against its
     twin at the flagship pretrain shapes (f32 and bf16; K7/K8 at dropout
     0 and 0.1 with the same seed, the dropout masks compared exactly),
     and time both, with K8's forward beside PyTorch's SDPA;
  6. pretrain path: three steps of `make_pretrain_step` at B=48 in bf16 on
     synthetic ShapeNetRender batches; the loss and parameters stay
     finite, the parameters move, and K1, K2, the forward and backward of
     K7-K9 and the forward of K10 launched (the points need no gradient,
     so K10's backward runs only in phase 5);
  7. the card's f32 path against the plain path on the CPU (full width,
     B=2, dropout 0, FPS from index 0): each branch's backbone features
     and every gradient leaf below its head under a fixed cotangent, and
     the IMID step's loss and every gradient leaf;
  8. the bf16 step time at B=48 (CUDA events over 5 steps after warm-up)
     and where it goes (kernel sums from torch.profiler).

Prints the card's name and power limit, one JSON line of per-kernel
results (time, twin's time, bound, launches on the main path), and last
the line {"ok": true, "device": {...}}. Imports nothing of JAX and nothing
of the JAX package (vipformer_tpu).
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
SEED = 0
NUM_POINTS = 1024  # serving clouds (the finetune / test point count)
BATCHES = (32, 64)  # serving batches
REQUESTS = (1, 5, 32, 64)
PRETRAIN_BATCH = 48  # clouds per view: 96 point clouds per step
STEPS = 3  # pretrain steps on the main path
TIMED_STEPS = 5
# Kernel vs plain twin, as max|kernel - plain| / max(1, max|plain|):
# f32 differs only by summation order (K = 64..1024 terms);
# bf16 may flip an intermediate rounding by one bf16 ulp (2^-8).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Gradients are longer sums (up to 393,216 rows for K9's weight grads,
# split into partials on the card, one torch reduction in the twin);
# bf16 gradients also flip one bf16 rounding of an intermediate.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# K9's BatchNorm statistics: f32 sums of 393,216 rows in other orders,
# through the fast variance E[x^2] - E[x]^2.
STATS_TOL = 1e-4
# K9's gradients of b0, b1 and b2 are exactly 0 (a batch-statistics
# BatchNorm subtracts any shift of its input again): each side is the f32
# rounding of a sum of R cancelling terms, which grows like sqrt(R), so
# they are held within GRAD_TOL["float32"] * sqrt(R), absolute.
ZERO_GRADS = (1, 5, 7)
# Card vs CPU plain path on the flagship logits, as max abs error over
# max(1, max|ref|): f32 as above through 8 layers; bf16 against the f32
# CPU reference carries bf16 rounding of every activation (2^-8 each,
# compounded over the 8 layers and the head).
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# Card f32 vs the CPU plain path at full width (B=2): backbone features,
# the IMID loss and every gradient below the heads within 1e-4 of
# max(1, max|cpu|) (sums in other orders through 8 layers per branch).
# The IMID step's gradients pass through the point head's train-mode
# BatchNorm over 4 rows, whose small batch variances amplify those
# differences: within 1e-2. Group2Emb's leaves sit behind its final max
# pool: where two of a group's 32 rows are within f32 rounding of each
# other, the card and the CPU may pick different rows and send that
# group's gradient to different places: within 2e-2 (which also covers
# its exactly-zero bias gradients, see ZERO_GRADS).
STEP_TOL, STEP_HEAD_TOL, STEP_G2E_TOL = 1e-4, 1e-2, 2e-2
# H100 SXM peaks (NVIDIA's data sheet, 700 W): device memory rate, and the
# rate for each operand type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# name -> (source, the TPU kernel it replaces, path whose run counts it)
KERNELS = {
    "fps": ("vipformer_tpu_torch/csrc/fps.cu",
            "vipformer_tpu/ops/pallas/fps.py:100 fps_pallas", "serve"),
    "knn": ("vipformer_tpu_torch/csrc/knn.cu",
            "vipformer_tpu/ops/pallas/knn.py:70 knn_pallas", "serve"),
    "stem": ("vipformer_tpu_torch/csrc/stem.cu",
             "vipformer_tpu/ops/pallas/stem.py:96 _stem_call", "serve"),
    "attn_kv_ln": ("vipformer_tpu_torch/csrc/attention.cu",
                   "vipformer_tpu/ops/pallas/attention.py:450 fused_attention_packed_kv_ln",
                   "serve"),
    "attn_small": ("vipformer_tpu_torch/csrc/attention.cu",
                   "vipformer_tpu/ops/pallas/attention.py:639 fused_attention_packed_small",
                   "serve"),
    "attn_train_kv": ("vipformer_tpu_torch/csrc/flash_train.cu",
                      "vipformer_tpu/ops/pallas/flash_train.py:916 flash_attention_train_kv "
                      "(fwd :701, bwd :747)", "pretrain"),
    "attn_train": ("vipformer_tpu_torch/csrc/flash_train.cu",
                   "vipformer_tpu/ops/pallas/flash_train.py:418 flash_attention_train "
                   "(fwd :238, bwd :276)", "pretrain"),
    "g2e_train": ("vipformer_tpu_torch/csrc/g2e_train.cu",
                  "vipformer_tpu/ops/pallas/g2e_train.py:722 g2e_train_apply", "pretrain"),
    "gather_centered": ("vipformer_tpu_torch/csrc/gather.cu",
                        "vipformer_tpu/ops/pallas/gather.py:358 gather_rows_centered_pallas "
                        "(VJP :390)", "pretrain"),
}
SERVING_KERNELS = ("fps", "knn", "stem", "attn_kv_ln", "attn_small")
# the launch counters of the pretrain path (K10's backward never runs there)
PRETRAIN_COUNTERS = ("fps", "knn", "attn_train_kv_fwd", "attn_train_kv_bwd", "attn_train_fwd",
                     "attn_train_bwd", "g2e_train_fwd", "g2e_train_bwd", "gather_centered_fwd")


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def config(**over):
    """The flagship pretrain configuration (scripts/pretrain/
    pt-E1CL8SL-H4D256-L128-MR2.sh, batch cut to 48), as the port's Config."""
    from vipformer_tpu_torch.config import Config, decode_arch_name

    kw = dict(decode_arch_name(ARCH), modality="both", num_pt_points=2048,
              group_size=32, img_height=144, img_width=144,
              patch_size=12, optim="adamw", lr=1e-3, max_dpr=0.0, atten_drop=0.1,
              mlp_drop=0.5, compute_dtype="bfloat16", batch_size=PRETRAIN_BATCH,
              synthetic_data=True, seed=SEED)
    kw.update(over)
    return Config(**kw)


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


def bound(nbytes: float, ops: float, dt: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Recorder:
    """Errors, times and bounds per kernel (and per direction for the
    training kernels) for the JSON line."""

    def __init__(self):
        self.r: dict = {}

    def check(self, name, what, err, rel, tol):
        print(f"  {name:18s} {what:34s} max_abs_err={err:.3e} rel={rel:.3e} (bound {tol:.0e})")
        expect(rel <= tol, f"{name} {what}: error {rel:.3e} above {tol:.0e}")
        e = self.r.setdefault(name, {"max_abs_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], err)

    def timing(self, name, ms, plain_ms, bnd, library_ms=None, shape=""):
        e = self.r.setdefault(name, {"max_abs_err": 0.0})
        e.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, shape=shape, **bnd)
        lib = f" library_ms={library_ms:.4f}" if library_ms is not None else ""
        print(f"  {name:18s} {shape:34s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}){lib}")


def sdpa_ms(q, k, v, h, scale, rate) -> float:
    """One PyTorch call computing the same attention: SDPA on the
    head-split views (with its own dropout draw at `rate`)."""
    import torch.nn.functional as F

    def split(t):
        return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate,
                                                          scale=scale))


def check_serving_kernels(rec: Recorder) -> None:
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

    g2e = init_weights(Group2Emb(3, d), SEED).to(dev).eval()
    with torch.no_grad():  # nontrivial eval BatchNorm statistics
        for bn in (g2e.BatchNorm_0, g2e.BatchNorm_1):
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(t((c,), scale_=0.1))
            bn.running_var.copy_(t((c,)).abs() + 0.5)
            bn.weight.copy_(t((c,), scale_=0.2) + 1.0)
            bn.bias.copy_(t((c,), scale_=0.1))

    def timed(b, dt_name, name):
        # the timing kept is the main path's: B=64, bf16 where it applies
        return b == max(BATCHES) and (dt_name == "bfloat16" or name in ("fps", "knn"))

    def check_kv_ln(b, dt_name, dt):
        q, x = t((b, g, d), dt), t((b, NUM_POINTS, d), dt)
        lw, lb = t((d,), scale_=0.2) + 1.0, t((d,), scale_=0.1)
        wk, wv = t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5)
        args = (q, x, lw, lb, wk, wv)
        out_k = kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=scale)
        out_p = kattn.attention_kv_ln_plain(*args, h, scale)
        rec.check("attn_kv_ln", f"B={b} {dt_name}", *rel_err(out_k, out_p), KERNEL_TOL[dt_name])
        if timed(b, dt_name, "attn_kv_ln"):
            ops = 2 * b * NUM_POINTS * d * 2 * d + 4 * b * g * NUM_POINTS * d
            rec.timing("attn_kv_ln",
                       cuda_ms(lambda: kattn.fused_attention_packed_kv_ln(
                           *args, num_heads=h, scale=scale)),
                       cuda_ms(lambda: kattn.attention_kv_ln_plain(*args, h, scale)),
                       bound(nbytes(*args, out_k), ops, dt_name),
                       shape=f"q[{b},{g},{d}] x[{b},{NUM_POINTS},{d}] {dt_name}")

    print("serving kernels K1-K5 against their twins:")
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
            rec.check("fps", f"B={b} float32 (indices equal)", 0.0, 0.0, 0.0)
            if timed(b, "float32", "fps"):
                rec.timing("fps", cuda_ms(lambda: kfps.fps(xyz, g)),
                           cuda_ms(lambda: kfps.fps_plain(xyz, g, start), iters=3, warmup=1),
                           bound(nbytes(xyz, idx_k, cen_k), 9 * b * g * NUM_POINTS, "float32"),
                           shape=f"xyz[{b},{NUM_POINTS},3] -> {g}")
            # K2 (queries: the FPS centers, as on the main path)
            nn_k = kknn.knn(s, xyz, cen_k)
            nn_p = kknn.knn_plain(s, xyz, cen_k)
            expect(torch.equal(nn_k.sort(-1).values, nn_p.sort(-1).values),
                   f"knn B={b}: index sets differ")
            rec.check("knn", f"B={b} float32 (index sets equal)", 0.0, 0.0, 0.0)
            if timed(b, "float32", "knn"):
                rec.timing("knn", cuda_ms(lambda: kknn.knn(s, xyz, cen_k)),
                           cuda_ms(lambda: kknn.knn_plain(s, xyz, cen_k)),
                           bound(nbytes(xyz, cen_k, nn_k), 8 * b * g * NUM_POINTS, "float32"),
                           shape=f"[{b},{NUM_POINTS}] x {g} queries, k={s}")
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                # K3
                ops = kstem.stem_operands(g2e, xyz, cen_k, nn_k, dt)
                out_k, out_p = kstem.stem_kernel(*ops), kstem.stem_plain(*ops)
                rec.check("stem", f"B={b} {dt_name}", *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                if timed(b, dt_name, "stem"):
                    rows = b * g * s
                    flops = (2 * rows * (3 * 64 + 64 * 128 + 128 * 256 + 256 * d)
                             + 2 * b * g * 128 * 256)
                    tensors = [o for o in ops if isinstance(o, torch.Tensor)]
                    rec.timing("stem", cuda_ms(lambda: kstem.stem_kernel(*ops)),
                               cuda_ms(lambda: kstem.stem_plain(*ops)),
                               bound(nbytes(*tensors, out_k), flops, dt_name),
                               shape=f"B={b} G={g} S={s} D={d} {dt_name}")
                check_kv_ln(b, dt_name, dt)  # K4
                # K5
                qkv = (t((b, g, d), dt), t((b, g, d), dt), t((b, g, d), dt))
                out_k = kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale)
                out_p = kattn.attention_small_plain(*qkv, h, scale)
                rec.check("attn_small", f"B={b} {dt_name}", *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                if timed(b, dt_name, "attn_small"):
                    rec.timing("attn_small",
                               cuda_ms(lambda: kattn.fused_attention_packed_small(
                                   *qkv, num_heads=h, scale=scale)),
                               cuda_ms(lambda: kattn.attention_small_plain(*qkv, h, scale)),
                               bound(nbytes(*qkv, out_k), 4 * b * g * g * d, dt_name),
                               sdpa_ms(*qkv, h, scale, 0.0),
                               shape=f"[{b},{g},{d}] H={h} {dt_name}")


def serving_model(dt: str, device):
    from vipformer_tpu_torch.models.factory import build_ft_cls

    return build_ft_cls(config(compute_dtype=dt), device=device)


def drive_serving_path(counts_out: dict) -> None:
    from vipformer_tpu_torch.inference import classifier_predictor
    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.ops import geometry

    cfg = config()
    rng = np.random.default_rng(SEED + 1)
    model = serving_model("bfloat16", "cuda")
    predictor = classifier_predictor(model, max_batch=64)
    requests = [rng.standard_normal((n, NUM_POINTS, 3)).astype(np.float32) for n in REQUESTS]

    kcuda.reset_launch_counts()
    outs = [predictor(r) for r in requests]
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    counts_out.update(counts)
    print("serving path launches:", json.dumps(counts))
    for name in SERVING_KERNELS:
        expect(counts[name] > 0, f"kernel {name} was not launched on the serving path")
    for req, out in zip(requests, outs):
        expect(out["logits"].shape == (len(req), cfg.num_obj_classes), "logits shape")
        expect(out["backbone_feats"].shape == (len(req), 2 * cfg.num_latent_channels),
               "backbone shape")
        expect(bool(np.isfinite(out["logits"]).all()), "non-finite logits")
        expect(bool(np.isfinite(out["backbone_feats"]).all()), "non-finite backbone feats")
    print(f"served requests of {list(REQUESTS)} clouds: outputs finite, padding stripped")

    # the card against the plain path on the CPU, same weights, 8 clouds
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    pts = rng.standard_normal((8, NUM_POINTS, 3)).astype(np.float32)
    cpu = serving_model("float32", "cpu")
    cpu.load_state_dict(state, strict=True)
    with torch.inference_mode():
        ref_logits, _ = cpu(torch.from_numpy(pts))
        pc, pg = torch.from_numpy(pts), torch.from_numpy(pts).cuda()
        i_c, c_c = geometry.farthest_point_sample_with_centers(pc, cfg.num_pc_latents)
        i_g, c_g = geometry.farthest_point_sample_with_centers(pg, cfg.num_pc_latents)
        expect(torch.equal(i_c, i_g.cpu()), "card FPS indices differ from the CPU path")
        nn_c = geometry.knn(cfg.group_size, pc, c_c)
        nn_g = geometry.knn(cfg.group_size, pg, c_g)
        expect(torch.equal(nn_c, nn_g.cpu()), "card kNN indices differ from the CPU path")
        print("card vs CPU: FPS and kNN indices identical (8 clouds)")
        for dt in ("float32", "bfloat16"):
            card = serving_model(dt, "cuda")
            card.load_state_dict(state, strict=True)
            logits, _ = card(pg)
            err, rel = rel_err(logits.cpu(), ref_logits)
            print(f"card {dt} vs CPU f32 plain path: logits max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (bound {MODEL_TOL[dt]:.0e})")
            expect(rel <= MODEL_TOL[dt], f"card {dt} logits off the CPU path: {rel:.3e}")


def time_forward() -> None:
    model = serving_model("bfloat16", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        for b in BATCHES:
            x = torch.randn((b, NUM_POINTS, 3), device="cuda", generator=gen)
            ms = cuda_ms(lambda: model(x), iters=10)
            print(f"forward bf16 B={b}: {ms:.3f} ms ({ms / b:.4f} ms/cloud, "
                  f"{1000.0 * b / ms:.0f} clouds/s)")


# ----------------------------------------------------------- K7-K10


def check_training_kernels(rec: Recorder) -> None:
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops.cuda import flash_train as kf
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg
    from vipformer_tpu_torch.ops.cuda import gather as kgather
    from vipformer_tpu_torch.ops.cuda import knn as kknn

    cfg = config()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    d, h = cfg.num_latent_channels, cfg.num_sa_heads
    g, s, npts = cfg.num_pc_latents, cfg.group_size, cfg.num_pt_points
    nb = 2 * PRETRAIN_BATCH  # point clouds per step: both views
    ntok = (cfg.img_height // cfg.patch_size) * (cfg.img_width // cfg.patch_size)
    scale = (d // h) ** -0.5
    rate = cfg.atten_drop

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    seed = torch.tensor([20240613], dtype=torch.int32, device=dev)
    print("training kernels K7-K10 against their twins (flagship pretrain shapes):")

    # K8 at the point branch's and the image branch's self-attention
    for b, n, branch in ((nb, g, "point"), (PRETRAIN_BATCH, ntok, "image")):
        keep = kf.dropout_mask_kernel(seed, b * h, n, n, rate)
        expect(torch.equal(keep, kf.keep_mask_plain(seed, b * h, n, n, rate)),
               f"K8 {branch}: dropout masks differ")
        share = keep.float().mean().item()
        print(f"  dropout mask [{b * h},{n},{n}] at rate {rate}: equal, keep rate {share:.5f}")
        expect(abs(share - (1 - rate)) < 1e-3, f"K8 {branch}: keep rate {share}")
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, do = (t((b, n, d), dt) for _ in range(4))
            for p in (0.0, rate):
                out_k, lse_k = kf.attention_fwd_kernel(q, k, v, seed, h, scale, p)
                out_p, lse_p = kf.attention_fwd_plain(q, k, v, seed, h, scale, p)
                what = f"{branch} {dt_name} p={p}"
                rec.check("attn_train_fwd", what, *rel_err(out_k, out_p), KERNEL_TOL[dt_name])
                rec.check("attn_train_fwd", what + " lse", *rel_err(lse_k, lse_p),
                          KERNEL_TOL["float32"])
                delta = kf.attention_delta(do, out_p, h)
                bwd_args = (q, k, v, do, lse_p, delta, seed, h, scale, p)
                for gname, gk, gp in zip(("dq", "dk", "dv"), kf.attention_bwd_kernel(*bwd_args),
                                         kf.attention_bwd_plain(*bwd_args)):
                    rec.check("attn_train_bwd", f"{what} {gname}", *rel_err(gk, gp),
                              GRAD_TOL[dt_name])
            if branch == "point" and dt_name == "bfloat16":
                shape = f"[{b},{n},{d}] H={h} p={rate} bf16"
                ops = 4 * b * n * n * d
                rec.timing("attn_train_fwd",
                           cuda_ms(lambda: kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate)),
                           cuda_ms(lambda: kf.attention_fwd_plain(q, k, v, seed, h, scale, rate)),
                           bound(nbytes(q, k, v, out_k, lse_k), ops, dt_name),
                           sdpa_ms(q, k, v, h, scale, rate), shape)
                grads = kf.attention_bwd_kernel(*bwd_args)
                rec.timing("attn_train_bwd",
                           cuda_ms(lambda: kf.attention_bwd_kernel(*bwd_args)),
                           cuda_ms(lambda: kf.attention_bwd_plain(*bwd_args)),
                           bound(nbytes(q, k, v, do, lse_p, delta, *grads), 2.5 * ops, dt_name),
                           shape=shape)

    # K7 at the point branch's cross-attention (128 latents over 2048
    # points) and the image branch's (144 patches over themselves)
    for b, m, branch in ((nb, npts, "point"), (PRETRAIN_BATCH, ntok, "image")):
        gq = g if branch == "point" else ntok
        keep = kf.dropout_mask_kernel(seed, b * h, gq, m, rate)
        expect(torch.equal(keep, kf.keep_mask_plain(seed, b * h, gq, m, rate)),
               f"K7 {branch}: dropout masks differ")
        print(f"  dropout mask [{b * h},{gq},{m}] at rate {rate}: equal, "
              f"keep rate {keep.float().mean().item():.5f}")
        del keep
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            args = (t((b, gq, d), dt), t((b, m, d), dt), t((d,), scale_=0.2) + 1.0,
                    t((d,), scale_=0.1), t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5))
            do = t((b, gq, d), dt)
            for p in (0.0, rate):
                out_k, lse_k = kf.attention_kv_fwd_kernel(*args, seed, h, scale, p)
                out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, p)
                what = f"{branch} {dt_name} p={p}"
                rec.check("attn_train_kv_fwd", what, *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                delta = kf.attention_delta(do, out_p, h)
                bwd_args = (*args, do, lse_p, delta, seed, h, scale, p)
                names = ("dq", "dx", "dln_w", "dln_b", "dwk", "dwv")
                for gname, gk, gp in zip(names, kf.attention_kv_bwd_kernel(*bwd_args),
                                         kf.attention_kv_bwd_plain(*bwd_args)):
                    rec.check("attn_train_kv_bwd", f"{what} {gname}", *rel_err(gk, gp),
                              GRAD_TOL[dt_name])
            if branch == "point" and dt_name == "bfloat16":
                shape = f"q[{b},{gq},{d}] x[{b},{m},{d}] H={h} p={rate} bf16"
                attn = 4 * b * gq * m * d
                proj = 2 * b * m * d * 2 * d
                rec.timing("attn_train_kv_fwd",
                           cuda_ms(lambda: kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)),
                           cuda_ms(lambda: kf.attention_kv_fwd_plain(*args, seed, h, scale, rate),
                                   iters=5),
                           bound(nbytes(*args, out_k, lse_k), proj + attn, dt_name), shape=shape)
                grads = kf.attention_kv_bwd_kernel(*bwd_args)
                # the backward recomputes k and v (the forward keeps only
                # the logsumexp), then dx through the projections and the
                # weight gradients: three projection-sized products
                rec.timing("attn_train_kv_bwd",
                           cuda_ms(lambda: kf.attention_kv_bwd_kernel(*bwd_args), iters=10),
                           cuda_ms(lambda: kf.attention_kv_bwd_plain(*bwd_args), iters=3),
                           bound(nbytes(*args, do, lse_p, delta, *grads), 3 * proj + 2.5 * attn,
                                 dt_name), shape=shape)
            del args, do, out_k, out_p

    # K10 on real patches: FPS centers and kNN neighbourhoods of random clouds
    xyz = t((nb, npts, 3))
    _, centers = kfps.fps(xyz, g)
    idx = kknn.knn(s, xyz, centers).reshape(nb, -1)
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        pts = xyz.to(dt)
        out_k = kgather.gather_centered_kernel(pts, centers, idx, s)
        out_p = kgather.gather_centered_plain(pts, centers, idx, s)
        expect(torch.equal(out_k, out_p), f"K10 {dt_name}: gather differs")
        rec.check("gather_centered_fwd", f"{dt_name} (equal)", 0.0, 0.0, 0.0)
        grad = t(tuple(out_k.shape), dt)
        for gname, gk, gp in zip(("d_points", "d_centers"),
                                 kgather.scatter_centered_kernel(grad, idx, npts, g, s),
                                 kgather.scatter_centered_plain(grad, idx, npts, g, s)):
            rec.check("gather_centered_bwd", f"{dt_name} {gname}", *rel_err(gk, gp),
                      GRAD_TOL["float32"])
        if dt_name == "bfloat16":
            shape = f"points[{nb},{npts},3] idx[{nb},{g * s}] bf16"
            rec.timing("gather_centered_fwd",
                       cuda_ms(lambda: kgather.gather_centered_kernel(pts, centers, idx, s)),
                       cuda_ms(lambda: kgather.gather_centered_plain(pts, centers, idx, s)),
                       bound(nbytes(pts, centers, idx, out_k), 3 * idx.numel(), dt_name),
                       shape=shape)
            dp, dc = kgather.scatter_centered_kernel(grad, idx, npts, g, s)
            rec.timing("gather_centered_bwd",
                       cuda_ms(lambda: kgather.scatter_centered_kernel(grad, idx, npts, g, s)),
                       cuda_ms(lambda: kgather.scatter_centered_plain(grad, idx, npts, g, s)),
                       bound(nbytes(grad, idx, dp, dc), grad.numel(), dt_name), shape=shape)

    # K9 on those patches: 96 clouds x 128 groups x 32 neighbours
    m = init_weights(Group2Emb(3, d), SEED)
    bn_affine = [t((64,), scale_=0.2) + 1.0, t((64,), scale_=0.1),
                 t((256,), scale_=0.2) + 1.0, t((256,), scale_=0.1)]
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, bn_affine[0], bn_affine[1],
          m.Dense_1.weight.t(), m.Dense_1.bias, m.Dense_2.weight.t(), m.Dense_2.bias,
          bn_affine[2], bn_affine[3], m.Dense_3.weight.t(), m.Dense_3.bias]
    wb = [w.detach().float().contiguous().to(dev) for w in wb]
    rows = nb * g * s
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x0 = kgather.gather_centered_kernel(xyz.to(dt), centers, idx, s).reshape(rows, 3)
        got = kg.g2e_fwd_kernel(x0, wb, s)
        want = kg.g2e_fwd_plain(x0, wb, s)
        rec.check("g2e_train_fwd", f"{dt_name} out", *rel_err(got[0], want[0]),
                  KERNEL_TOL[dt_name])
        rec.check("g2e_train_fwd", f"{dt_name} h3p", *rel_err(got[1], want[1]),
                  KERNEL_TOL[dt_name])
        rec.check("g2e_train_fwd", f"{dt_name} batch statistics", *rel_err(got[3], want[3]),
                  STATS_TOL)
        dy = t((rows // s, d), dt)
        _, h3p, amax, stats = want
        bwd_args = (x0, wb, h3p, amax, stats, dy, s)
        dx_k, gr_k = kg.g2e_bwd_kernel(*bwd_args)
        dx_p, gr_p = kg.g2e_bwd_plain(*bwd_args)
        rec.check("g2e_train_bwd", f"{dt_name} dx0", *rel_err(dx_k, dx_p), GRAD_TOL[dt_name])
        for i, (a, w) in enumerate(zip(gr_k, gr_p)):
            tol = GRAD_TOL["float32"] * rows ** 0.5 if i in ZERO_GRADS else GRAD_TOL[dt_name]
            rec.check("g2e_train_bwd", f"{dt_name} grad {i}", *rel_err(a, w), tol)
        if dt_name == "bfloat16":
            macs = rows * (3 * 64 + 64 * 128 + 256 * 256 + 256 * d)
            shape = f"x0[{nb},{g},{s},3] ({rows} rows) bf16"
            rec.timing("g2e_train_fwd", cuda_ms(lambda: kg.g2e_fwd_kernel(x0, wb, s), iters=5),
                       cuda_ms(lambda: kg.g2e_fwd_plain(x0, wb, s), iters=3),
                       bound(nbytes(x0, *wb, *got), 2 * macs, dt_name), shape=shape)
            rec.timing("g2e_train_bwd",
                       cuda_ms(lambda: kg.g2e_bwd_kernel(*bwd_args), iters=5),
                       cuda_ms(lambda: kg.g2e_bwd_plain(*bwd_args), iters=3),
                       bound(nbytes(x0, *wb, h3p, amax, stats, dy, dx_k, *gr_k), 4 * macs,
                             dt_name), shape=shape)


# ---------------------------------------------------------- pretrain


def pretrain_batches(cfg, n: int, batch: int):
    """`n` batches from the synthetic ShapeNetRender set (numpy, host)."""
    from vipformer_tpu_torch.data.datasets import ShapeNetRender
    from vipformer_tpu_torch.data.pipeline import Loader, collate_pretrain

    ds = ShapeNetRender(cfg.img_height, cfg.img_width, cfg.num_pt_points,
                        synthetic_size=n * batch)
    return list(Loader(ds, batch, collate_pretrain, shuffle=True, seed=cfg.seed,
                       drop_last=True, num_workers=8))


def pretrain_models(cfg, device):
    from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model

    return {"pc": build_pc_model(cfg, device=device), "img": build_img_model(cfg, device=device)}


def drive_pretrain_path(counts_out: dict, batches) -> None:
    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = config()
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    before = [p.detach().clone() for p in state.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    kcuda.reset_launch_counts()
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, batches[i % len(batches)], cfg.lr, gen)
        losses.append(metrics)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    counts_out.update(counts)
    print("pretrain path launches over", STEPS, "steps:", json.dumps(counts))
    for name in PRETRAIN_COUNTERS:
        expect(counts[name] > 0, f"{name} was not launched on the pretrain path")
    for i, m in enumerate(losses):
        vals = {k: float(v) for k, v in m.items()}
        print(f"  step {i}: " + " ".join(f"{k}={v:.5f}" for k, v in vals.items()))
        expect(all(np.isfinite(v) for v in vals.values()), f"step {i}: non-finite loss")
    after = list(state.parameters())
    expect(all(bool(torch.isfinite(p).all()) for p in after), "non-finite parameters")
    moved = sum(not torch.equal(a, b) for a, b in zip(after, before))
    print(f"  {moved} of {len(after)} parameter tensors moved; all finite")
    expect(moved == len(after), "some parameters did not change")


def compare_step_with_cpu(batch) -> None:
    """The card's f32 step against the plain step on the CPU: same weights
    and batch (B=2), dropout 0, FPS from index 0 (no generator).

    Each branch is held below its head: its backbone features and the
    gradient of every leaf under one fixed cotangent on them. The point
    branch also runs the IMID step (modality imc-only, both views, 4
    clouds): its loss and every gradient leaf. The CMID loss is left out:
    at random init some pooled channels of two images differ by ~1e-5 of
    their size, and the head's batch-statistics BatchNorm turns the card's
    and the CPU's 1e-6 differences there into O(1) ones, so a comparison
    through it says nothing about the kernels."""
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = config(compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0, modality="imc-only")
    rng = np.random.default_rng(SEED + 3)
    pts = np.concatenate([batch["pc_t1"], batch["pc_t2"]])
    inputs = {"pc": torch.from_numpy(pts), "img": torch.from_numpy(batch["imgs"])}
    cots = {k: torch.from_numpy(rng.standard_normal(
        (len(x), 2 * cfg.num_latent_channels)).astype(np.float32)) for k, x in inputs.items()}

    def grads_of(models):
        return {f"{name}.{k}": p.grad.detach().cpu() for name, m in models.items()
                for k, p in m.named_parameters() if p.grad is not None}

    got: dict = {}
    for dev in ("cpu", "cuda"):
        models = pretrain_models(cfg, dev)
        feats = {}
        for name, m in models.items():
            m.train()
            _, f = m(inputs[name].to(dev))
            (f * cots[name].to(dev)).sum().backward()
            feats[name] = f.detach().cpu()
        below_head = grads_of(models)
        models = pretrain_models(cfg, dev)
        state = create_state(cfg, {"pc": models["pc"]})
        _, metrics = make_pretrain_step(cfg, models["pc"])(state, batch, cfg.lr)
        got[dev] = dict(feats=feats, below_head=below_head, loss=float(metrics["loss"]),
                        step=grads_of({"pc": models["pc"]}))
    cpu, card = got["cpu"], got["cuda"]
    print(f"card f32 vs CPU plain path (B={len(batch['pc_t1'])}, full width):")
    for name in ("pc", "img"):
        err, rel = rel_err(card["feats"][name], cpu["feats"][name])
        print(f"  {name} backbone features: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(bound {STEP_TOL:.0e})")
        expect(rel <= STEP_TOL, f"{name} backbone features off the CPU path")
    err = abs(card["loss"] - cpu["loss"])
    print(f"  IMID step loss: card {card['loss']:.6f} cpu {cpu['loss']:.6f} (abs err {err:.3e}, "
          f"bound {STEP_TOL:.0e} relative)")
    expect(err <= STEP_TOL * max(1.0, abs(cpu["loss"])), "step loss off the CPU step")
    for what, tol in (("below_head", STEP_TOL), ("step", STEP_HEAD_TOL)):
        expect(set(card[what]) == set(cpu[what]), f"{what}: gradient leaves differ")
        bounds = {k: STEP_G2E_TOL if k.startswith("pc.stem.group2emb.") else tol
                  for k in cpu[what]}
        errs = sorted((rel_err(card[what][k], w)[1] / bounds[k], k)
                      for k, w in cpu[what].items())
        print(f"  {what}: {len(errs)} gradient leaves, bound {tol:.0e} (Group2Emb "
              f"{STEP_G2E_TOL:.0e}); worst error / bound "
              + ", ".join(f"{e:.3f} ({k})" for e, k in errs[:-4:-1]))
        expect(errs[-1][0] <= 1.0, f"{what} gradient {errs[-1][1]} off the CPU step")


def time_pretrain_step(batches) -> None:
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = config()
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    run(2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(TIMED_STEPS)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    ms = start.elapsed_time(end) / TIMED_STEPS
    clouds = 2 * PRETRAIN_BATCH
    print(f"pretrain step bf16 B={PRETRAIN_BATCH} ({clouds} clouds + {PRETRAIN_BATCH} images): "
          f"{ms:.3f} ms/step (CUDA events; host clock {wall:.3f} ms), "
          f"{1000.0 * clouds / ms:.1f} clouds/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(2)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    per_step = {e.key: e.self_device_time_total / 1e3 / 2 for e in kernels}
    busy = sum(per_step.values())
    ours = sum(v for k, v in per_step.items() if "vpt" in k)
    gemm = sum(v for k, v in per_step.items()
               if "vpt" not in k and any(w in k.lower() for w in ("gemm", "nvjet", "cutlass")))
    print(f"where a step goes (torch.profiler over 2 steps, device time per step): kernels "
          f"{busy:.3f} ms of the {ms:.3f} ms step ({100.0 * busy / ms:.1f}% busy): "
          f"hand-written {ours:.3f} ms, library GEMMs {gemm:.3f} ms, other PyTorch kernels "
          f"{busy - ours - gemm:.3f} ms; launches per step "
          f"{sum(e.count for e in kernels) / 2:.0f}; top kernels:")
    counts = {e.key: e.count / 2 for e in kernels}
    for k, v in sorted(per_step.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:9.3f} ms/step {counts[k]:6.0f}/step  {k[:110]}")


def kernel_line(rec: Recorder, serve_counts: dict, pretrain_counts: dict) -> list:
    out = []
    for name, (src, rep, path) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep, "path": path}
        if path == "serve":
            entry.update(launches=serve_counts[name], **rec.r[name])
        else:
            fwd, bwd = rec.r[f"{name}_fwd"], rec.r[f"{name}_bwd"]
            entry.update(launches=pretrain_counts[f"{name}_fwd"], **fwd)
            entry["launches_per_step"] = pretrain_counts[f"{name}_fwd"] / STEPS
            entry["backward"] = dict(launches=pretrain_counts[f"{name}_bwd"], **bwd)
        out.append(entry)
    return out


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
        rec = Recorder()
        check_serving_kernels(rec)
        serve_counts: dict = {}
        drive_serving_path(serve_counts)
        time_forward()
        check_training_kernels(rec)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        batches = pretrain_batches(config(), 2, PRETRAIN_BATCH)
        print(f"made {len(batches)} synthetic batches of {PRETRAIN_BATCH} in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        pretrain_counts: dict = {}
        drive_pretrain_path(pretrain_counts, batches)
        small = {k: v[:2] for k, v in batches[0].items()}
        compare_step_with_cpu(small)
        time_pretrain_step(batches)
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
    print(json.dumps({"kernels": kernel_line(rec, serve_counts, pretrain_counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
