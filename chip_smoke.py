#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`vipformer_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches an error and
goes on):
  1. build the hand-written kernels (csrc/*.cu -> one .so: one nvcc per
     source, all started together, sm_90a), and read from torch.profiler
     that K18's backward is one launch of one kernel in both dtypes, and
     that the bf16 K15 at [64, 512] x [64, 512, 256] is one launch of its
     cluster kernel (no attn_flash_kernel), and that K10's and K12's VJPs
     are one launch of scatter_sorted_kernel a call at every case their
     phases (5 and 13) run;
  2. turn TF32 off for matmuls and cuDNN;
  3. hold each serving kernel K1-K5 against its plain PyTorch twin on the
     card at the flagship serving shapes (B = 32 and 64; K1/K2 on f32
     points, K3-K5 in f32 and bf16), and time both with CUDA events; the
     bf16 K3, K4 and K5 (tensor cores) launched again, bitwise equal, and
     timed on device time (calls queued behind a spin kernel: a wrapper
     may cost the host more than the card) beside their PyTorch routes
     (K3: index_select, three cuBLAS products, amax and cat; K4:
     F.layer_norm, one cuBLAS product and SDPA; K5: SDPA); then the bf16
     K3 and K4 at the eval paths' batches (B = 330 and 160; K4 also at
     the Perceiver's 128 and 512 latents over 2,048 points) against their
     twins, twice bitwise equal, timed beside their routes; K1 also at
     200 (one warp), 1,000, 2,048, 4,096 (semseg's B = 32) and 8,192
     points from random starts on clouds with exact ties, equal to its
     twin, and timed (device time) at [32, 4,096]; K2 equal to its twin in
     its order (torch.equal), launched twice bitwise equal, at (N, k) from
     (33, 33) to (4,096, 128), k = 1, 4, 32 and 33 among them, on uniform,
     tied (duplicated points, a half-unit lattice) and lane-adversarial
     clouds (one lane's points moved away, which drives its exact-scan
     path: the count of queries that took it printed, and at least one
     must), and timed on device time (events beside) at [64, 1,024],
     [48, 2,048] and [32, 4,096] x 128 queries, k = 32;
  4. serving path: build the flagship classifier (ARCH, decoded by the
     port's Config, through the port's factory; random weights from a
     seed) in bf16 on the card, serve ragged requests through
     `classifier_predictor`, check that K1-K5 launched, the outputs are
     finite and the card agrees with the plain path on the CPU; time the
     bf16 forward at B = 32 and 64;
  5. hold each training kernel K7-K10, forward and backward, against its
     twin at the flagship pretrain shapes (f32 and bf16; K7/K8 at dropout
     0 and 0.1 with the same seed, the dropout masks compared exactly),
     and time both; K8's bf16 forward and backward (tensor cores)
     launched again, bitwise equal, the forward's dropped elements read
     through its output (v the identity on a 64-key window) equal to the
     twin's mask bit for bit, and K8 timed on device time beside SDPA's
     forward and forward + backward, the event times beside, its backward
     also at the ft_cls step's [330, 128, 256]; K7's bf16 forward and
     backward (the forward's LayerNorm pass and K4's tile kernel with the
     dropout and the log-sum-exp, k|v on chip; the backward's LN-folded
     k|v projection, attention, dx and dWk|dWv on the tensor cores)
     launched twice, bitwise equal, the projection alone against
     `kv_project_plain`, the forward bitwise equal to that projection
     followed by K8's bf16 forward (split 2 and 3 ways: lse within 1e-5,
     out within the bf16 bound), allocating no k or v, its dropped
     elements read through its output (unsplit and split) equal to the
     twin's mask, and both timed
     (events, device time beside) at the pretrain point shape and, with
     the backward held against its twin, at the ft_cls step's [330, 128]
     x [330, 1,024], with the profiler's time of each of its kernels and
     no SIMT `gemm_kernel` among them (its forward's kernels are read from
     torch.profiler at the start of the run: the LayerNorm pass and one
     tile kernel, and past 128 query rows the projection and K8's
     forward); K10 timed on device time (events beside) at the pretrain,
     ft_cls and (phase 25) semseg points; K10's VJP (one launch of
     csrc/gather.cu scatter_sorted_kernel) at the pretrain, ft_cls and
     semseg points (FPS centers, kNN neighbourhoods; again with 64 rows of
     each cloud on one point) in bf16, and in f32 at the pretrain shape:
     d_points and d_centers within GRAD_TOL of the twin, two launches
     bitwise equal, each shape timed on device time beside its events,
     the twin, the bound and index_add_; K9's bf16
     forward and backward (the
     tensor-core passes of csrc/g2e_train.cu tc) launched twice, bitwise
     equal, the profiler's kernels of each call (their launches, every
     pass present, no SIMT `gemm_kernel`), what each call allocates (no
     h4, dh4, dy3 or dxc; no f32 array of R rows), held against the twin
     also at group sizes 24 and 128, on a tie-heavy input and at output
     widths 96 and 512 (padded to a multiple of 64; P1 in chunks), every
     (group, column) whose tie set h2 == gmax differs from the twin's
     counted and held to a true near-tie (the competing h2 within one
     bf16 ulp) and the exactly-zero bias gradients to their rounding
     noise (2^-8 sqrt(sum of their rows' squares) a column), timed
     (events, device time beside) with the twin, the bound and the same
     function as PyTorch calls (`g2e_library`), also at the ft_cls step's
     x0 [330, 128, 32, 3];
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
     and where it goes (kernel sums from torch.profiler);
 8a. the `--device_augs` chain (data/augment_device.py: both point views
     and the image chain, 144 x 144 images and 137 x 137 resized) on the
     card against the CPU at B=48, 2,048 points, from the same draws
     (within 1e-5 of max(1, max|cpu|), 1e-4 with the resize; dropout
     masks and flips equal),
     and its time on the card;
 8b. three `make_pretrain_step` steps with `device_augs` at B=48, bf16,
     on batches of `ShapeNetRender(raw_views=True)` from the pretrain
     CLI's loader through `prefetch_to_device` (pinned buffers, a side
     stream), PIL and h5py unimportable meanwhile: launch counts equal to
     phase 6's, losses finite, every parameter moved;
 8c. the pretrain CLI's loop (`run_epoch`) over a 6-batch epoch at B=48,
     host augmentation and `--device_augs`: clouds/s, the loader's host ms
     a batch alone, the step's events, the device time, the busy share
     and the memcpy HtoD ms a step (profiler), and the same steps with the
     loader in series (no prefetcher), beside the card's name and power
     limit;
  9. hold the finetune kernels against their twins: K11 (Dense weight
     gradients) at the ft_cls step's 42,240 rows and each of its five
     (Cin, Cout), and at an odd row count, in f32 and bf16 (the bf16
     tensor-core route launched twice, bitwise equal, at 256->256 and
     Cin = 3), timed on device time beside cuBLAS plus a column sum, and
     its sum over one step; K6 (self-attention with the pre-LN and q/k/v
     folded in) at [330, 128, 256] and [64, 128, 256], at one row and at
     G = 178, Din = 1024, in f32 and bf16 (bf16 on the tensor cores,
     launched twice, bitwise equal), timed on device time beside the
     route it replaces (LayerNorm, three cuBLAS projections, K5), the
     event times beside;
 10. ft_cls path: three `make_cls_step` steps at the script's B=330 in
     bf16 on synthetic ModelNet40 (scripts/finetune/ft-E1CL8SL-H4D256-
     L128-MR2.sh, dropout as it sets it): the loss and parameters stay
     finite, every parameter moves, K1, K2, K7-K9 forward and backward,
     K10 forward and K11 (54 launches per step) launched; then one
     `make_cls_eval` at B=330 (the test split padded): K1-K4 launched, K6
     8 times per forward, K5 not at all;
 11. the card's f32 ft_cls path against the plain path on the CPU (full
     width, dropout 0, FPS from index 0, K11 and K6 forced on both sides):
     at B=2 the eval logits, the train-mode backbone features and every
     gradient leaf below the head under a fixed cotangent; at B=8 (the
     head's BatchNorms over 2 rows are ill-conditioned) the step's loss and
     every gradient leaf;
 12. the bf16 ft_cls step time at B=330 and where it goes; torch.profiler's
     kernels of the bf16 ft_cls eval forward at B=330 and of the serving
     forward at B=32 and 64: the tensor-core K3 and K4, and neither
     CUDA-core kernel (`stem_kernel`, `attn_flash_kernel`); the eval
     forward at B=64 and B=330 through the auto gate, with K6 forced and
     with the route it replaces forced (events, and the kernels' device
     time from torch.profiler);
 13. hold K12 (the row gather of `index_points` and its scatter-add
     backward) against its twin at the compat stem's [96, 1024, 3] x 4096
     neighbour gather, at an odd K and at C=128 (8 rows of each cloud on
     one point), in f32 and bf16 (the gather equal; the scatter, one
     launch of K10's VJP kernel without the centers, within GRAD_TOL, two
     launches bitwise equal), timed beside torch.gather and index_add_
     (device time, events beside);
 14. hold the earlier kernels against their twins once at part
     segmentation's widths (D=384, 6 heads): K3, K4, K5, K7 and K8 forward
     and backward, K9 at D=384, and K11 at its five partseg sites (98,304
     rows), in f32 and bf16 (bf16 timed on device time);
 15. partseg path (scripts/finetune/ft-partseg.sh: H6D384, 12 SA layers
     tapped at 2/6/10, B=96) on synthetic ShapeNetPart in bf16: three
     `make_partseg_step` steps with patch_compat off (K1, K2, K7-K9
     forward and backward, K10 forward, K11 exactly PARTSEG_DENSE_SITES
     per step, K12 never; losses and parameters finite, every parameter
     moved), one step with patch_compat on (K12 once, K10 never); then
     `make_partseg_eval` at B=96 with patch_compat off (K3 and K4 once, K5
     12 times) and on (K12 once, K3 never);
 16. the card's f32 partseg path against the plain path on the CPU (full
     width, dropout and DropPath 0, FPS from index 0, K11 forced on both
     sides), both patch_compat settings: the eval logits at B=2 and the
     step's loss and every gradient leaf at B=8;
 17. the bf16 partseg step time at B=96 and where it goes, and the eval
     forward at B=96 with patch_compat off and on;
 18. the Perceiver family (--mp false, the flagship scripts' widths):
     hold K13 (streamed packed attention) at the Fourier cross-attention's
     [48, 128, 256] x [48, 20736, 256], at M = 1000 and at one query, and
     K15 (k/v projections folded in) at [64, 512] x [64, 512, 256] (its
     bf16 cluster kernel), [3, 300] x [3, 300, 256], [8, 512] x [8, 512,
     384] and, on K4's bf16 passes, [8, 512] x [8, 2,048, 256] and [4, 1] x
     [4, 700, 384], against their twins in f32 and bf16, timed (K13 beside
     SDPA; the bf16 K15 twice bitwise equal, on device time beside one
     cuBLAS product onto [wk|wv] and SDPA, at the main shape also on
     K4's passes, its profiler kernels (the cluster kernel,
     no attn_flash_kernel) and no k or v allocated); K13's
     bf16 tensor-core route twice, bitwise equal, and at the image shape
     with its kv split forced to 1 against the planned split; K8
     forward and backward at M = 20,736 with dropout (the bf16 backward
     launched twice, bitwise equal), and K5-K8 at the decoder's single
     query;
 19. Perceiver pretrain path: three `make_pretrain_step` steps of both
     branches at B=48 in bf16 (144x144 images as 20,736 Fourier tokens of
     261 channels): finite, every parameter moved, exactly K7 once and K8
     13 times (the image cross-attention among them) per step, forward and
     backward, and no other kernel;
 20. Perceiver ft_cls path: three `make_cls_step` steps at B=330 (K7 2, K8
     8 and K11 40 times per step, nothing else), then one `make_cls_eval`
     at B=330 (K4 once, K6 8 times, K5 once);
 21. the Perceiver feature forwards through `make_feats_fn`: the image
     branch at B=48 (K13 once, K5 6 times) and the point branch at 512
     latents, B=64 (K4 once, K15 6 times);
 22. the card's f32 Perceiver paths against the plain path on the CPU:
     both branches' features (128 and 512 latents) and the ft_cls eval
     logits (B=2), each branch's gradients below its head (B=2), the
     pretrain and ft_cls steps' losses and gradients (B=8);
 23. the bf16 Perceiver pretrain and ft_cls step times, the ft_cls eval
     and both feature forwards, each with its profiler breakdown;
 24. hold K18 (train-mode BatchNorm statistics and gradient reduces) at
     semseg's four decode shapes [131,072, 1536 / 1024 / 512 / 256] and
     partseg's [98,304, 1536], and K17 (LayerNorm forward and backward) at
     [4,096, 384], [131,072, 64] and the Fourier tokens' [995,328, 261],
     and K17's forward at LN_EDGE_SHAPES (row counts off a block's rows,
     vector-1 widths beside vector-8 ones), against their twins (column
     sums against their channel's sum of magnitudes, K18's statistics and
     gradient reduces and K17's forward and backward bitwise equal between
     two runs), K18 timed at every one of those
     shapes and K17 at each, on device time beside var_mean,
     native_batch_norm_backward and F.layer_norm forward and backward, the
     event times beside;
 25. hold the earlier kernels at semantic segmentation's shapes (B=32,
     4,096 xyz+rgb points, D=384): K1, K2, K10 at C=6, K9 at Cin=6, K7
     over 4,096 tokens, K8, K11 at its five semseg sites, and the eval's
     K3 at N=4,096, K4 at M=4,096 and K5;
 26. semseg path (scripts/finetune/ft-semseg.sh: H6D384, 12 SA layers
     tapped at 2/6/10, B=32) on synthetic S3DIS in bf16: three
     `make_semseg_step` steps with the default flags and three with K17
     and K18 forced, every launch count exact; one `make_semseg_eval`;
 27. one f32 step with K17 and K18 forced against one with the default
     flags from the same state (B=8), and the card's f32 semseg path
     against the CPU's (eval logits at B=2, a step at B=8);
 28. the bf16 semseg step time with the default flags and forced (in
     turns), the eval forward, and (phase 17) the partseg step with K18
     forced against its default;
 29. the SVM probe (`fit_svm`, `score`) on the card against the CPU at
     the synthetic ModelNet40 probe's sizes and at [9,840, 512];
 30. hold K16 (fused FPS + kNN) against its twin and against K1 followed
     by K2, bitwise, at the eval CLIs' [160, 1024] (G = 128, K = 32) and
     semseg's [32, 4,096] xyz+rgb points, from index 0 and random starts,
     and at K2's (N, K) and clouds (G = 128 and, up to 1,024 points, G =
     N; the count of centers that took the exact scan printed), each
     launched twice bitwise equal; timed on device time (events beside) at
     [64, 1,024], [48, 2,048], [32, 4,096] and [160, 1,024], beside K1 +
     K2 at each; and K14 (head-split eval attention) against
     its twin at dh = 64, dv = 32 and 64, M = 128 and 2,048, f32 (CUDA
     cores) and bf16 (tensor cores, two launches bitwise equal), timed
     beside SDPA;
 31. the evaluation entry points in process at the flagship (B=160, 1024
     points, bf16, random weights from the seed): `cli.eval_zeroshot` on
     the synthetic ModelNet40 (complexity, linear, RBF and grid-search
     probes), `cli.eval_fewshot` on ScanObjectNN at 5-way 10-shot with 20
     queries and 10 runs, and again with USE_FPS_KNN forced (K16 once per
     feature batch, K1 / K2 never, the features equal bit for bit), each
     launch count exact;
 32. the eval forward's time at B=160 with K1 + K2 and with K16 (in
     turns, with the profiler's breakdown), and the zeroshot features at
     f32, card against CPU (within STEP_TOL, the probes' predictions
     agreeing on >= PROBE_AGREE of the test rows);
 33. under a forced USE_FUSED_ATTENTION, the Perceiver point feature
     forward with num_cross_attention_v_channels = 128 (K14 once) and a
     PerceiverEncoder with num_self_attention_v_channels = 128 (K14 at its
     6 self-attention layers), exact launch counts, each forward timed
     with its profiler breakdown;
 34. crash-resume on the card: the ft_cls CLI at tiny widths (bf16,
     `--save_freq 1`) for two epochs, then `--resume_training` to four:
     metrics.jsonl reads epochs 0-3, the best never falls, and the rolling
     snapshot restored into a fresh state puts every optimizer moment on
     the card, bitwise equal to the saved one;
 35. data parallelism (`check_data_parallel`): the f32 and bf16 pretrain
     and ft_cls steps and a partseg step with K18 forced on two ranks
     against one process, K9's and K18's launches a rank one process's;
 36. tensor parallelism (`check_tensor_parallel`, `--model_axis 2`): the
     f32 pretrain and ft_cls steps on two model ranks (2 of the 4 heads
     each; both on card 0 over gloo with one card) against one process,
     the shards gathered; the bf16 ft_cls eval forward (K4, K6 on each
     rank's heads) against one process's logits; 5 bf16 steps of each:
     the replicated parameters bitwise equal on the ranks, each rank's
     launches (K4, K6, K7, K8, K11 among them) one process's; ms a step
     at T = 1 and 2; the f32 ft_cls step on 2 data x 2 model ranks
     against one process.

Prints the script's total seconds, the card's name and power limit, one
JSON line of per-kernel results (time, twin's time, bound, launches on the
main path and on every path that ran the kernel), and last the line
{"ok": true, "device": {...}}. Imports nothing of JAX and nothing
of the JAX package (vipformer_tpu).

Each kernel's registers, spilled bytes and shared memory, from nvcc's
`-Xptxas -v` with the build's flags (each source's report kept in DIR),
and for K1, K2 and K16 each kernel's SASS instruction count, LDS.128
loads and REDUX reductions (`cuobjdump -sass`):

    python3 chip_smoke.py --ptxas DIR

To compare this checkout with another commit on one card (unpack the other
with `git archive` into a directory that .gitignore lists):

    python3 chip_smoke.py --ab OTHER_TREE [PAIRS]

times both in turns, PAIRS pairs (10 by default), each sample in its own
process: the host time of a K5, K6, K8 forward and K11 wrapper call (with
the card idle and busy; K6's and K8's device time beside), K8's backward
at B = 96 and 330, K17's and K18's backward (device time), K17's forward
at LN_SHAPES and K12's forward at the compat stem's gather (device
time), K7's forward
and backward at the pretrain point shape (events and device time) and at
the ft_cls step's (the backward's events, the forward's device time), K10
at the pretrain, ft_cls and semseg points (device time), K3 and K4 at
the serving shape B = 64 (device time; events beside; K4 also at the
ft_cls eval's B = 330), K1 and K2
there, K16 at [64, 1,024], [160, 1,024] and [32, 4,096] and K15 at [64,
512] x [64, 512, 256] (device time), the serving forward at
B = 32 and 64, the Perceiver point features at 512 latents (B = 64,
events), the ft_cls step and eval forward at B = 330,
with their kernels' device time, the pretrain step (with its kernels'), the partseg step, the
semseg step with K17 and K18 forced (with its kernels' device time), and
one eval_zeroshot run (host clock).

The bf16 K9's backward against its twin run in f32 and in f64 between the
bf16 rounding points, at the card tests' shapes and data (three seeds
each), and dx0 over ten cotangents at group sizes 24, 32 and 128:

    python3 chip_smoke.py --k9-numerics

prints, for dx0 and each gradient, kernel vs the f32 twin, the f32 twin vs
the f64 twin and kernel vs the f64 twin (max abs error over max(1, max
|reference|)) beside the bound; it reads, and fails only if a kernel does
not build or launch.
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
FT_BATCH = 330  # ft_cls --batch_size and --test_batch_size
FT_STEPS = 3  # ft_cls steps on the main path
# K11's sites in one ft_cls step at B=330 (42,240 latent rows): (Cin, Cout)
# -> launches per step. PositionEmb 3->128 and 128->256; the CA layer's
# q_proj and o_proj and the 8 SA layers' q/k/v/o_proj (256->256); the MLPs
# of those 9 layers (256->512, 512->256). The adapter (337,920 rows) and
# the head (330 rows) lie outside the window, Group2Emb runs in K9.
DENSE_SITES = {(3, 128): 1, (128, 256): 1, (256, 256): 2 + 4 * 8, (256, 512): 9, (512, 256): 9}
DENSE_ODD_ROWS = 16411
TIMED_STEPS = 5
PARTSEG_BATCH = 96  # ft-partseg.sh --batch_size and --test_batch_size
PARTSEG_STEPS = 3  # partseg steps on the main path (patch_compat off)
# K11's sites in one partseg step at B=96 (98,304 point rows): (Cin, Cout)
# -> launches per step, as the JAX gate (dense.py:127-186) gives them: the
# input adapter's 3->64 and 64->384, SegHead's 1024->512 (its per-point
# segment; the 96-row global segment stays plain), 512->256 and 256->50.
# The latent Denses (12,288 rows), LabelConv (96 rows) and FeaturePropagation
# (Cout 1536 and Cin 1536 over the width limit) lie outside; Group2Emb runs
# in K9. tests/test_torch_partseg_kernels.py holds this list against the
# JAX gate.
PARTSEG_DENSE_SITES = {(3, 64): 1, (64, 384): 1, (1024, 512): 1, (512, 256): 1, (256, 50): 1}
# The Perceiver family (--mp false): the point branch at 512 latents (the
# K15 path) runs its feature forward at this batch; K11's launches per
# Perceiver ft_cls step at B=330 (42,240 latent rows): the encoder
# cross-attention's q_proj, o_proj and MLP (4) and the 6 SA layers'
# q/k/v/o_proj and MLP (36); the adapter's 337,920 rows and the decoder's
# 330 lie outside the window.
PERCEIVER_FEATS_BATCH = 64
PERCEIVER_WIDE_LATENTS = 512
PERCEIVER_DENSE_PER_STEP = 40
# K12 beside the compat stem's gather: K off 128-row tiles and off a
# warp's run (a short last run), and C=128 (runs of 8 rows in f32)
GATHER_CASES = ((8, 1024, 128, 1000), (3, 300, 5, 77), (5, 700, 16, 300))
# semantic segmentation (scripts/finetune/ft-semseg.sh): B=32 clouds of
# 4,096 xyz+rgb points, so the decode runs over 131,072 point rows
SEMSEG_BATCH = 32
SEMSEG_POINTS = 4096
SEMSEG_STEPS = 3
SEMSEG_ROWS = SEMSEG_BATCH * SEMSEG_POINTS
# K18 at the semseg decode's four BatchNorms (FeaturePropagation 1536,
# 1024; SegHead 512, 256) and at partseg's widest (96 x 1024 rows)
BN_SHAPES = ((SEMSEG_ROWS, 1536), (SEMSEG_ROWS, 1024), (SEMSEG_ROWS, 512), (SEMSEG_ROWS, 256),
             (PARTSEG_BATCH * NUM_POINTS, 1536))
# K17 at the semseg latents' LayerNorms (32 x 128 rows of 384), the input
# adapter's (131,072 point rows of 64) and the Perceiver's Fourier-token
# LayerNorm (48 x 20,736 rows of 261 channels)
LN_SHAPES = ((SEMSEG_BATCH * 128, 384, ("float32", "bfloat16")),
             (SEMSEG_ROWS, 64, ("float32", "bfloat16")),
             (48 * 144 * 144, 261, ("bfloat16",)))
LN_TIMED = (SEMSEG_BATCH * 128, 384)  # the JSON line's K17 times: the latents' LayerNorms
# K17's forward off the driven shapes: row counts that are not a multiple
# of a block's rows (16 at D = 384 bf16, 32 at 64), an odd width (one
# column a vector) beside 384 (eight), the JAX gate's widest bf16 and the
# kernel's widest
LN_EDGE_SHAPES = ((4097, 384), (4097, 383), (131075, 64), (1000, 1638), (7, 2048))
# K11's sites in one semseg step at B=32 (131,072 point rows): the input
# adapter's 6->64 and 64->384, SegHead's 1024->512 (its per-point segment),
# 512->256 and 256->13; the latent Denses (4,096 rows), FeaturePropagation
# (Cout 1536, Cin 1536) and the 32-row global segment lie outside its
# window, Group2Emb runs in K9
SEMSEG_DENSE_SITES = {(6, 64): 1, (64, 384): 1, (1024, 512): 1, (512, 256): 1, (256, 13): 1}
# exact launches per semseg step with the default flags: K1, K2, K10 once
# (the points need no gradient), K9 forward and backward, K7 (the CA: its
# kv LayerNorm folded in) forward and backward, K8 forward in the 12 SA
# layers and backward in the 10 that reach a tap (layers 11 and 12 do not),
# K11 at its five sites
SEMSEG_STEP_COUNTS = {"fps": 1, "knn": 1, "gather_centered_fwd": 1, "g2e_train_fwd": 1,
                      "g2e_train_bwd": 1, "attn_train_kv_fwd": 1, "attn_train_kv_bwd": 1,
                      "attn_train_fwd": 12, "attn_train_bwd": 10,
                      "dense_grads": sum(SEMSEG_DENSE_SITES.values())}
# and with K17 and K18 forced, besides: K18 at the decode's four
# BatchNorms; K17 forward at the adapter's LayerNorm, the CA's q_norm and
# MLP LayerNorm, two in each of the 12 SA layers and the shared norm at the
# 3 taps (30), backward at those that reach the loss (26: not the 4 of
# layers 11 and 12)
SEMSEG_FORCED_COUNTS = {"batchnorm_fwd": 4, "batchnorm_bwd": 4, "layernorm_fwd": 30,
                        "layernorm_bwd": 26}
# one eval forward at B=32: K1, K2 and K3 (the fused stem; the centers'
# rgb gathered beside it), K4 over the 4,096 point tokens, K5 in the 12 SA
# layers (K6's gate wants B >= 128)
SEMSEG_EVAL_COUNTS = {"fps": 1, "knn": 1, "stem": 1, "attn_kv_ln": 1, "attn_small": 12}
# the evaluation CLIs' feature batch (config.py's --test_batch_size) and the
# Perceiver's unequal v width of phase 33 (dv = 32 at 4 heads; q/k 256)
EVAL_BATCH = 160
HEAD_SPLIT_V = 128
# the probe's card and CPU fits follow one f32 objective in other summation
# orders: a prediction may flip only where two classes' scores nearly tie
PROBE_AGREE = 0.99
# a column sum of R rows against its channel's sum of magnitudes: f32
# accumulation in another order (both read the same values, bf16 or f32)
COLSUM_TOL = 1e-5
# Kernel vs plain twin, as max|kernel - plain| / max(1, max|plain|):
# f32 differs only by summation order (K = 64..1024 terms);
# bf16 may flip an intermediate rounding by one bf16 ulp (2^-8).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The Perceiver shapes hold kernel against twin relative to the twin's own
# max|ref| (rel_err floor 0), at the same tolerances: at M = 20,736 K13's
# and K8's outputs are ~0.01 and K8's dk/dv ~1e-3, where max(1, .) would
# make the bounds absolute and let a kernel off by 30% pass.
OWN_SCALE = 0.0
# Gradients are longer sums (up to 393,216 rows for K9's weight grads,
# split into partials on the card, one torch reduction in the twin);
# bf16 gradients also flip one bf16 rounding of an intermediate.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# K9's BatchNorm statistics: f32 sums of 393,216 rows in other orders,
# through the fast variance E[x^2] - E[x]^2.
STATS_TOL = 1e-4
# K9's gradients of b0, b1 and b2 are exactly 0 (a batch-statistics
# BatchNorm subtracts any shift of its input again): each side sums R rows
# d_i that cancel, so what it returns is rounding noise, and its size is
# set by the rows' magnitudes, not by their count. Per side: each row is
# rounded to the compute dtype, an error of at most u |d_i| (u = 2^-8 in
# bf16, 2^-24 in f32), independent across rows, so their sum is a random
# walk of size u sqrt(sum d_i^2) = u rss; the f32 sum of the R rows adds at
# most about u32 sqrt(R) rss (its partial sums are themselves a random
# walk of size up to sqrt(R) rss / sqrt(R) a row). Hoeffding's inequality
# puts a column past ZERO_LAMBDA times that scale with probability below
# 2 exp(-ZERO_LAMBDA^2 / 2), 7.5e-6 at 5: `zero_grad_bound`. The older rule,
# 1e-4 sqrt(R) absolute, ignored the magnitudes; at the card tests' draws
# it failed in up to 22 of 30 bf16 readings while the kernel stood as close
# to the f64 twin as the f32 twin did (`--k9-numerics`).
ZERO_GRADS = (1, 5, 7)
ZERO_LAMBDA = 5.0
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
# The partseg step (B=8) passes every gradient through LabelConv's and
# SegHead's batch-statistics BatchNorms (over 8 clouds and 8,192 points):
# every leaf within STEP_HEAD_TOL, Group2Emb's within STEP_G2E_TOL; the
# eval logits (B=2, running statistics) within STEP_TOL.
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
    "attn_small_qkv_ln": ("vipformer_tpu_torch/csrc/attention.cu",
                          "vipformer_tpu/ops/pallas/attention.py:716 "
                          "fused_attention_packed_small_qkv_ln", "ft_cls eval"),
    "dense_grads": ("vipformer_tpu_torch/csrc/dense.cu",
                    "vipformer_tpu/ops/pallas/dense.py:76 dense_grads_pallas", "ft_cls"),
    "gather_rows": ("vipformer_tpu_torch/csrc/gather.cu",
                    "vipformer_tpu/ops/pallas/gather.py:180 gather_rows_pallas "
                    "(fwd :119, VJP :196)", "ft_partseg compat"),
    "attn_packed": ("vipformer_tpu_torch/csrc/attention.cu",
                    "vipformer_tpu/ops/pallas/attention.py:212 fused_attention_packed",
                    "perceiver feats img"),
    "attn_packed_kv": ("vipformer_tpu_torch/csrc/attention.cu",
                       "vipformer_tpu/ops/pallas/attention.py:325 fused_attention_packed_kv",
                       "perceiver feats pc512"),
    "layernorm": ("vipformer_tpu_torch/csrc/layernorm.cu",
                  "vipformer_tpu/ops/pallas/layernorm.py:180 layernorm_apply (fwd _fwd_call :95, "
                  "bwd _bwd_call :121)", "ft_semseg forced"),
    "batchnorm": ("vipformer_tpu_torch/csrc/batchnorm.cu",
                  "vipformer_tpu/ops/pallas/batchnorm.py:178 bn_train_apply (fwd bn_stats_pallas "
                  ":74, bwd bn_grad_reduces_pallas :111)", "ft_semseg forced"),
    "fps_knn": ("vipformer_tpu_torch/csrc/patchify.cu",
                "vipformer_tpu/ops/pallas/patchify.py:103 fps_knn_pallas", "eval_fewshot fps_knn"),
    "attn_head_split": ("vipformer_tpu_torch/csrc/mha.cu",
                        "vipformer_tpu/ops/pallas/attention.py:71 fused_attention",
                        "perceiver feats pc v128"),
}
SERVING_KERNELS = ("fps", "knn", "stem", "attn_kv_ln", "attn_small")
# the launch counters of the pretrain path (K10's backward never runs there)
PRETRAIN_COUNTERS = ("fps", "knn", "attn_train_kv_fwd", "attn_train_kv_bwd", "attn_train_fwd",
                     "attn_train_bwd", "g2e_train_fwd", "g2e_train_bwd", "gather_centered_fwd")
FT_COUNTERS = PRETRAIN_COUNTERS + ("dense_grads",)
FT_EVAL_COUNTERS = ("fps", "knn", "stem", "attn_kv_ln", "attn_small_qkv_ln")
PARTSEG_COUNTERS = FT_COUNTERS
PARTSEG_EVAL_COUNTERS = ("fps", "knn", "stem", "attn_kv_ln", "attn_small")


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


def device_ms(fn, iters: int = 20) -> float | None:
    """Device time per fn() call where the host's cost per call exceeds the
    kernels' (there cuda_ms measures the host): CUDA events around `iters`
    calls queued behind a spin kernel, so the card runs them back to back.
    The spin is lengthened until it outlasts the host's queueing; None if
    the host cannot queue ahead of the card (a call that synchronises)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 22
    while cycles <= 1 << 32:
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms + 0.1:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    return None


def queued_ms(fn, what: str, iters: int = 20) -> float:
    """device_ms, which must measure: the kernels of K5 and K11 take less
    time on the card than their wrappers on the host."""
    ms = device_ms(fn, iters)
    expect(ms is not None, f"{what}: the host could not queue ahead of the card")
    return ms


def rel_err(got, ref, floor: float = 1.0) -> tuple[float, float]:
    """(max abs error, max abs error / max(floor, max |ref|)) in f32.
    floor=0 holds the error against the reference's own scale (OWN_SCALE)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(floor, ref.float().abs().max().item())
    return err, (err / scale if scale > 0 else float(err > 0))


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
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}, "
              f"{100.0 * bnd['bound_ms'] / ms:.1f}% of it){lib}")


def sdpa_call(q, k, v, h, scale, rate=0.0):
    """One PyTorch call computing the same attention: SDPA on the
    head-split views of packed [B, N, H*dh] operands (with its own dropout
    draw at `rate`)."""
    import torch.nn.functional as F

    def split(t):
        return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

    return F.scaled_dot_product_attention(split(q), split(k), split(v), dropout_p=rate,
                                          scale=scale)


def sdpa_ms(q, k, v, h, scale, rate) -> float:
    return cuda_ms(lambda: sdpa_call(q, k, v, h, scale, rate))


def sdpa_fwd_bwd(q, k, v, do, h, scale, rate):
    """One call of SDPA's forward and backward (its own dropout draw at
    `rate`) on the head-split views, under torch.autograd.grad."""
    import torch.nn.functional as F

    def split(t):
        return t.view(t.shape[0], t.shape[1], h, -1).transpose(1, 2)

    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    doh = split(do)

    def run():
        out = F.scaled_dot_product_attention(*map(split, qkv), dropout_p=rate, scale=scale)
        return torch.autograd.grad(out, qkv, doh)

    return run


def _device_timing(rec, name: str, shape: str, kernel, library, plain_ms: float, bnd,
                   keep: bool = True) -> tuple[float, float]:
    """A kernel's and its library call's device time (queued_ms), printed
    with the plain twin's event time, the bound and the event times of the
    kernel and the library call (where a wrapper costs the host more than
    its kernel costs the card, events measure the host); recorded for the
    JSON line where `keep`. Returns the two device times."""
    ms, lib_ms = queued_ms(kernel, name), queued_ms(library, name + " library")
    host_ms, lib_host_ms = cuda_ms(kernel), cuda_ms(library)
    if keep:
        rec.timing(name, ms, plain_ms, bnd, lib_ms, shape=shape)
        rec.r[name].update(host_ms=host_ms, library_host_ms=lib_host_ms)
    else:
        print(f"  {name:18s} {shape:34s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) library_ms={lib_ms:.4f}")
    print(f"  {name:18s} {shape:34s} device times; events without the spin: kernel "
          f"{host_ms:.4f} ms, library {lib_host_ms:.4f} ms")
    return ms, lib_ms


def check_dropout_through_output(kf, seed, h: int, scale: float, rate: float) -> None:
    """The bf16 tensor-core K8 forward drops exactly the twin's elements:
    with v the identity on one 64-key window of M = 128 keys (zero rows
    elsewhere), output column c of a row is that row's p of key 64 w + c,
    after dropout: 0 exactly where the key was dropped (an undropped p is
    at least 2^-20 here, far above bf16's smallest normal). The zero
    pattern of each window equals keep_mask_plain bit for bit."""
    b, n, dh = 4, 128, 64
    dev = seed.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    q, k = (torch.randn((b, n, h * dh), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    keep = kf.keep_mask_plain(seed, b * h, n, n, rate)
    for w in range(n // dh):
        v = torch.zeros((b, n, h, dh), device=dev)
        v[:, w * dh:(w + 1) * dh] = torch.eye(dh, device=dev)[:, None, :]
        out, _ = kf.attention_fwd_kernel(q, k, v.reshape(b, n, h * dh).to(torch.bfloat16), seed,
                                         h, scale, rate)
        kept = (out.view(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh) != 0)
        expect(torch.equal(kept, keep[..., w * dh:(w + 1) * dh]),
               f"K8 bf16 forward: keys {w * dh}-{(w + 1) * dh - 1} dropped other elements "
               f"than the twin's mask")
    print(f"  {'attn_train_fwd':18s} bf16 dropout through the output: the kernel's dropped "
          f"elements equal the twin's mask bit for bit ([{b * h},{n},{n}], rate {rate}, "
          f"keep rate {keep.float().mean().item():.5f})")


def check_k7_dropout_through_output(kf, seed, h: int, scale: float, rate: float) -> None:
    """The bf16 K7 forward (the tile kernel) drops exactly the twin's
    elements, unsplit and split in two. The tokens of one 64-token window
    of M = 128 are one-hot rows x_p = e_(p - 64 w) over Din = 128 (the
    others zero), so their normalised rows are a e_j - c (zero rows stay
    zero) and, with wv[j, 64 h + j] = 1 and wv[64 + j, 64 h + j] = -1
    (columns summing to 0), token p's v in every head is a e_(p - 64 w):
    output column c of a row is its dropped p of key 64 w + c times a / l,
    0 exactly where the key was dropped."""
    b, n, din, dh = 4, 128, 128, 64
    d, dev = h * dh, seed.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    q = torch.randn((b, n, d), generator=gen, device=dev).to(torch.bfloat16)
    wk = (torch.randn((din, d), generator=gen, device=dev) * din ** -0.5).to(torch.bfloat16)
    wv = torch.zeros((din, h, dh), device=dev)
    wv[:dh], wv[dh:] = torch.eye(dh, device=dev)[:, None, :], -torch.eye(dh, device=dev)[:, None, :]
    wv = wv.view(din, d).to(torch.bfloat16)
    ones, zeros = torch.ones(din, device=dev), torch.zeros(din, device=dev)
    keep = kf.keep_mask_plain(seed, b * h, n, n, rate)
    for w in range(n // dh):
        x = torch.zeros((b, n, din), device=dev)
        x[:, w * dh:(w + 1) * dh, :dh] = torch.eye(dh, device=dev)
        for nsplit in (1, 2):
            out, _ = kf.attention_kv_fwd_kernel(q, x.to(torch.bfloat16), ones, zeros, wk, wv, seed,
                                                h, scale, rate, nsplit=nsplit)
            kept = (out.view(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh) != 0)
            expect(torch.equal(kept, keep[..., w * dh:(w + 1) * dh]),
                   f"K7 bf16 forward (split {nsplit}): keys {w * dh}-{(w + 1) * dh - 1} dropped "
                   f"other elements than the twin's mask")
    print(f"  {'attn_train_kv_fwd':18s} bf16 dropout through the output, unsplit and split in "
          f"two: the kernel's dropped elements equal the twin's mask bit for bit "
          f"([{b * h},{n},{n}], rate {rate})")


def check_k7_forward(rec: Recorder, kf, args, seed, h: int, scale: float, rate: float,
                     branch: str) -> None:
    """K7's bf16 forward against K7's projection (`kv_project_kernel`)
    followed by K8's bf16 forward on those k and v: unsplit (and past 128
    query rows, where it runs just those) out and lse bitwise equal; split
    2 and 3 ways (the merge pass writing lse) lse within 1e-5 of it and
    out within the bf16 bound of the twin. Up to 128 query rows one call
    allocates no k or v: its output, lse, xn and the row statistics."""
    q, x = args[0], args[1]
    b, g, d = q.shape
    m, din = x.shape[1], x.shape[2]
    k, v = kf.kv_project_kernel(*args[1:])
    out_8, lse_8 = kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate)
    out_1, lse_1 = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate, nsplit=1)
    expect(torch.equal(out_1, out_8) and torch.equal(lse_1, lse_8),
           f"K7 bf16 forward {branch}: not K7's projection + K8's forward bit for bit")
    print(f"  {'attn_train_kv_fwd':18s} {branch} bf16 p={rate}: unsplit, out and lse bitwise "
          f"equal to kv_project_kernel + K8's bf16 forward")
    del k, v, out_8, lse_8
    if g > 128:
        return
    out_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, rate)[0]
    for nsplit in (2, 3):
        out_s, lse_s = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate, nsplit=nsplit)
        lse_rel = ((lse_s - lse_1).abs() / lse_1.abs().clamp_min(1.0)).max().item()
        expect(lse_rel <= 1e-5, f"K7 bf16 forward {branch} split {nsplit}: lse {lse_rel:.3e} "
                                f"from the unsplit one")
        rec.check("attn_train_kv_fwd", f"{branch} bf16 split {nsplit} (lse {lse_rel:.1e})",
                  *rel_err(out_s, out_p), KERNEL_TOL["bfloat16"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, lse = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    own = nbytes(out, lse) + b * m * (din * x.element_size() + 8)  # + xn, the row statistics
    kv_bytes = 2 * b * m * d * x.element_size()
    print(f"  {'attn_train_kv_fwd':18s} {branch} bf16: one call allocates {grew} B (out, lse, xn "
          f"and the row statistics {own} B; k and v would be {kv_bytes} B more)")
    expect(grew < own + (1 << 20), f"K7 bf16 forward {branch} allocated {grew} B: more than "
                                   f"out, lse, xn and the row statistics")
    del out, lse, out_1, lse_1, out_p


# K7's bf16 forward by torch.profiler's kernel names: the LayerNorm pass
# and one tile-kernel launch up to 128 query rows; past them the
# projection and K8's forward; never the CUDA-core K8 forward in bf16
K7_FWD_LN = "vpt_flash::tc::ln_xn_kernel"
K7_FWD_TILE = "attn_kv_ln_tile_kernel"
K7_FWD_FAR = ("kv_proj_tc_kernel", "flash_fwd_tc_kernel")
SIMT_FLASH_BF16 = "flash_fwd_kernel<__nv_bfloat16>"


def check_k7_forward_kernels() -> None:
    """torch.profiler's kernels of one bf16 K7 forward at the pretrain
    point branch's q [96, 128, 256] x [96, 2,048, 256] (its planned split
    is 1): K7's LayerNorm pass once and the tile kernel once, nothing else
    (no kv_proj_tc_kernel, no K8 forward, no merge pass); and at 144 query
    rows (past the tile kernel's 128) the LayerNorm pass, the projection
    and K8's tensor-core forward; never the CUDA-core K8 forward. Run at
    the start of the script, as check_k15_kernels."""
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    seed = torch.tensor([SEED + 7], dtype=torch.int32, device="cuda")
    lnw, lnb = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    for b, g, m in ((2 * PRETRAIN_BATCH, 128, 2048), (PRETRAIN_BATCH, 144, 144)):
        q = torch.randn((b, g, 256), generator=gen, **bf)
        x = torch.randn((b, m, 256), generator=gen, **bf)
        wk, wv = (torch.randn((256, 256), generator=gen, **bf) * 0.0625 for _ in range(2))
        kernels = device_kernels(
            lambda: kf.attention_kv_fwd_kernel(q, x, lnw, lnb, wk, wv, seed, 4, 0.125, 0.1))
        print(f"K7 bf16 forward at q[{b},{g}] x[{b},{m},256], kernels a call: " + ", ".join(
            f"{k[:80]} {n:.0f}" for k, n in kernels.items()))
        expect(not any(SIMT_FLASH_BF16 in k for k in kernels),
               f"K7 bf16 forward: the CUDA-core K8 forward ran: {kernels}")
        ln = [n for k, n in kernels.items() if K7_FWD_LN in k]
        if g <= 128:
            tile = [n for k, n in kernels.items() if K7_FWD_TILE in k]
            expect(ln == [1] and tile == [1] and len(kernels) == 2,
                   f"K7 bf16 forward: not the LayerNorm pass and one tile kernel: {kernels}")
        else:
            far = [sum(n for k, n in kernels.items() if w in k) for w in K7_FWD_FAR]
            expect(ln == [1] and far == [1, 1] and len(kernels) == 3,
                   f"K7 bf16 forward past 128 rows: not LN, projection, K8: {kernels}")


def grads_of(models: dict) -> dict:
    """Every parameter's gradient on the host, keyed "<model>.<name>"."""
    return {f"{n}.{k}": p.grad.detach().cpu() for n, m in models.items()
            for k, p in m.named_parameters() if p.grad is not None}


def _counted(what: str, fn) -> dict:
    """Run fn() with every launch count at 0 before and read after."""
    from vipformer_tpu_torch.ops import cuda as kcuda

    kcuda.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    print(f"{what} launches:", json.dumps(counts))
    return counts


def _expect_counts(name: str, counts: dict, want: dict) -> None:
    """Every counter named in `want` launched exactly that often; every
    other counter not at all."""
    for c, n in counts.items():
        expect(n == want.get(c, 0), f"{name}: {c} launched {n} times, expected {want.get(c, 0)}")


def _expect_launched(name: str, counts: dict, counters) -> None:
    for c in counters:
        expect(counts[c] > 0, f"{c} was not launched on the {name} path")


def _moved_and_finite(name: str, model, state, before, metrics, may_stay=None) -> None:
    """The steps' metrics and the parameters finite, and every parameter
    moved, but those for which may_stay(name, value before) holds."""
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        print(f"  step {i}: " + " ".join(f"{k}={v:.5f}" for k, v in vals.items()))
        expect(all(np.isfinite(v) for v in vals.values()), f"{name} step {i}: non-finite metric")
    after = list(state.parameters())
    expect(all(bool(torch.isfinite(p).all()) for p in after), f"{name}: non-finite parameters")
    names = [k for k, _ in model.named_parameters()] if model is not None else range(len(after))
    still = [(k, b) for k, a, b in zip(names, after, before) if torch.equal(a, b)]
    print(f"  {len(after) - len(still)} of {len(after)} parameter tensors moved, all finite"
          + (f"; unmoved: {[k for k, _ in still]}" if still else ""))
    expect(all(may_stay is not None and may_stay(k, b) for k, b in still),
           f"{name}: a parameter the step should move did not change")


def _timed_steps(run, what: str, samples: int) -> float:
    """ms per step of run(n) (CUDA events over TIMED_STEPS after 2 warm-up
    steps; host clock beside), peak memory, and the profiler breakdown."""
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(TIMED_STEPS)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    ms = start.elapsed_time(end) / TIMED_STEPS
    print(f"{what}: {ms:.3f} ms (CUDA events; host clock {wall:.3f} ms), "
          f"{1000.0 * samples / ms:.1f} samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(2)
        torch.cuda.synchronize()
    print_breakdown(prof, 2, ms, what)
    return ms


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
        if dt_name == "bfloat16":
            expect(torch.equal(out_k, kattn.fused_attention_packed_kv_ln(
                *args, num_heads=h, scale=scale)), f"attn_kv_ln B={b}: two launches differ")
            print(f"  {'attn_kv_ln':18s} B={b} bf16 (tensor cores): two launches bitwise equal")
        if timed(b, dt_name, "attn_kv_ln"):
            time_kv_ln_tc(rec, args, out_k, h, scale, keep=True)

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
            if timed(b, "float32", "fps"):  # device time, the events beside
                run = lambda: kfps.fps(xyz, g)  # noqa: E731
                rec.timing("fps", queued_ms(run, "fps"),
                           cuda_ms(lambda: kfps.fps_plain(xyz, g, start), iters=3, warmup=1),
                           fps_bound(xyz, idx_k, cen_k), shape=f"xyz[{b},{NUM_POINTS},3] -> {g}")
                rec.r["fps"]["host_ms"] = cuda_ms(run)
            # K2 (queries: the FPS centers, as on the main path), in order
            nn_k = kknn.knn(s, xyz, cen_k)
            nn_p = kknn.knn_plain(s, xyz, cen_k)
            expect(torch.equal(nn_k, nn_p), f"knn B={b}: indices differ from the twin's")
            rec.check("knn", f"B={b} float32 (indices equal, in order)", 0.0, 0.0, 0.0)
            if timed(b, "float32", "knn"):  # device time, the events beside
                run = lambda: kknn.knn(s, xyz, cen_k)  # noqa: E731
                rec.timing("knn", queued_ms(run, "knn"),
                           cuda_ms(lambda: kknn.knn_plain(s, xyz, cen_k)),
                           knn_bound(xyz, cen_k, nn_k), shape=f"[{b},{NUM_POINTS}] x {g} queries, k={s}")
                rec.r["knn"]["host_ms"] = cuda_ms(run)
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                # K3
                ops = kstem.stem_operands(g2e, xyz, cen_k, nn_k, dt)
                out_k, out_p = kstem.stem_kernel(*ops), kstem.stem_plain(*ops)
                rec.check("stem", f"B={b} {dt_name}", *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                if dt_name == "bfloat16":
                    expect(torch.equal(out_k, kstem.stem_kernel(*ops)),
                           f"stem B={b}: two launches differ")
                    print(f"  {'stem':18s} B={b} bf16 (tensor cores): two launches bitwise equal")
                if timed(b, dt_name, "stem"):
                    time_stem_tc(rec, ops, out_k, keep=True)
                check_kv_ln(b, dt_name, dt)  # K4
                # K5
                qkv = (t((b, g, d), dt), t((b, g, d), dt), t((b, g, d), dt))
                out_k = kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale)
                out_p = kattn.attention_small_plain(*qkv, h, scale)
                rec.check("attn_small", f"B={b} {dt_name}", *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                if dt_name == "bfloat16":
                    check_small_tiles(rec, qkv, out_k, h, scale, b == max(BATCHES))


def fps_bound(xyz, idx, centers) -> dict:
    """K1's bound: its bytes, and each step's nine f32 operations a point
    (three differences, three squares, two sums and the running min)."""
    b, n, _ = xyz.shape
    return bound(nbytes(xyz, idx, centers), 9 * b * idx.shape[1] * n, "float32")


# K1 beyond the serving clouds (B, N): one warp a cloud, a ragged count,
# the Perceiver's and partseg's 2,048 points and the most the kernel
# takes; then semseg's [32, 4,096], also timed
FPS_WIDTHS = ((5, 200), (4, 1000), (3, 2048), (2, 8192))
FPS_TIMED = (SEMSEG_BATCH, SEMSEG_POINTS)


def check_fps_widths(rec: Recorder) -> None:
    """K1 at FPS_WIDTHS and FPS_TIMED from random starts, on clouds with
    exact ties (every fifth point a copy of the one before it, and the
    first cloud on a half-unit grid): indices and centers equal to the
    twin's; at FPS_TIMED on device time (a reading; the JSON line keeps
    serving's B = 64 from the serving phase)."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    g = 128
    print("K1 at more points:")
    with torch.inference_mode():
        for b, n in FPS_WIDTHS + (FPS_TIMED,):
            xyz = torch.randn((b, n, 3), generator=gen, device=dev)
            xyz[:, 1::5] = xyz[:, 0::5][:, :xyz[:, 1::5].shape[1]]
            xyz[0] = torch.round(xyz[0] * 2) / 2
            start = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
            want_i, want_c = kfps.fps_plain(xyz, g, start)
            run = lambda: kfps.fps(xyz, g, start)  # noqa: E731
            idx, cen = run()
            expect(torch.equal(idx, want_i) and torch.equal(cen, want_c),
                   f"fps [{b},{n}]: indices or centers differ from the twin's")
            rec.check("fps", f"[{b},{n}] float32 (indices equal)", 0.0, 0.0, 0.0)
            if (b, n) == FPS_TIMED:
                print(f"  {'fps':18s} xyz[{b},{n},3] -> {g} ({kfps.fps_warps(n)} warps a cloud): "
                      f"device {queued_ms(run, f'fps [{b},{n}]'):.4f} ms; bound "
                      f"{fps_bound(xyz, want_i, want_c)['bound_ms']:.4f}")


def knn_bound(xyz, queries, out) -> dict:
    """K2's bound: its bytes, and 8 f32 operations a (query, point) pair
    (three differences, three squares, two sums)."""
    b, n, _ = xyz.shape
    return bound(nbytes(xyz, queries, out), 8 * b * queries.shape[1] * n, "float32")


# K2 beyond the serving clouds (N, k): k = N, the validate scripts' (64,
# 4), a ragged cloud, k = 1, 4 and 33 at the flagship's 1,024 points, the
# pretrain and semseg clouds and the threshold select's largest k (128);
# then the main paths' clouds, timed: serving's [64, 1,024], pretrain's
# [48, 2,048] and semseg's [32, 4,096]
KNN_SHAPES = ((33, 33), (64, 4), (1000, 32), (1024, 1), (1024, 4), (1024, 33), (2048, 32),
              (4096, 32), (4096, 128))
KNN_CLOUDS = ("uniform", "tied", "lane")
KNN_TIMED = ((max(BATCHES), NUM_POINTS), (PRETRAIN_BATCH, 2048), (SEMSEG_BATCH, SEMSEG_POINTS))


def knn_cloud(gen, kind: str, b: int, n: int):
    """[B, N, 3] f32 on the card: "uniform" in [-1, 1]^3; "tied": every
    fifth point a copy of the one before it and the first cloud on a
    half-unit lattice; "lane": uniform with the points of one lane of K2's
    warps (index = 31 mod 32) moved 8 units away, so that lane's nearest
    key sets the selection's threshold above nearly every other key."""
    xyz = torch.rand((b, n, 3), generator=gen, device="cuda") * 2 - 1
    if kind == "tied":
        xyz[:, 1::5] = xyz[:, 0::5][:, :xyz[:, 1::5].shape[1]]
        xyz[0] = torch.round(xyz[0] * 2) / 2
    elif kind == "lane":
        xyz[:, 31::32, 0] += 8.0
    return xyz


def check_knn_clouds(rec: Recorder) -> None:
    """K2 at KNN_SHAPES on each of KNN_CLOUDS (4 clouds, the FPS centers of
    a random start as queries): equal to its twin in its order, and to a
    second launch; the count of queries that took the exact scan printed,
    at least one on the lane-adversarial clouds. Then device time (events
    beside) at KNN_TIMED, k = 32: a reading, the JSON line keeps serving's
    B = 64 from the serving phase."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import knn as kknn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    print("K2 on hard clouds (equal to the twin in order, twice):")
    scanned = 0
    with torch.inference_mode():
        for n, k in KNN_SHAPES:
            for kind in KNN_CLOUDS:
                b, g = 4, min(128, n)
                xyz = knn_cloud(gen, kind, b, n)
                start = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
                cen = kfps.fps(xyz, g, start)[1]
                over = torch.zeros(1, dtype=torch.int32, device=dev)
                got = kknn.knn(k, xyz, cen, overflow=over)
                expect(torch.equal(got, kknn.knn_plain(k, xyz, cen)),
                       f"knn N={n} k={k} {kind}: differs from the twin")
                expect(torch.equal(got, kknn.knn(k, xyz, cen)),
                       f"knn N={n} k={k} {kind}: two launches differ")
                scanned += over.item() if kind == "lane" else 0
                print(f"  knn N={n:5d} k={k:3d} {kind:8s}: equal; {over.item()} of {b * g} "
                      f"queries took the exact scan")
        expect(scanned > 0, "knn: no query of the lane-adversarial clouds took the exact scan")
        rec.check("knn", "hard clouds (equal, in order)", 0.0, 0.0, 0.0)
        for b, n in KNN_TIMED:
            xyz = knn_cloud(gen, "uniform", b, n)
            cen = kfps.fps(xyz, 128)[1]
            run = lambda: kknn.knn(32, xyz, cen)  # noqa: E731
            print(f"  {'knn':18s} [{b},{n}] x 128 queries, k=32: device "
                  f"{queued_ms(run, f'knn [{b},{n}]'):.4f} ms, events {cuda_ms(run):.4f} ms; bound "
                  f"{knn_bound(xyz, cen, run())['bound_ms']:.4f}")


def check_small_tiles(rec: Recorder, qkv, out_k, h: int, scale: float, keep: bool) -> None:
    """The bf16 K5 (tensor cores) at the serving shape: launched again,
    bitwise equal, and timed on device time beside SDPA in the same run
    (events without the spin beside them); its time goes into the JSON
    line where `keep`."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    b, g, d = qkv[0].shape
    run = lambda: kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale)  # noqa: E731
    expect(torch.equal(out_k, run()), f"attn_small B={b}: two launches differ")
    ms = queued_ms(run, f"attn_small B={b}", iters=50)
    sdpa = queued_ms(lambda: sdpa_call(*qkv, h, scale), f"SDPA B={b}", iters=50)
    host, sdpa_host = cuda_ms(run, iters=50), sdpa_ms(*qkv, h, scale, 0.0)
    print(f"  {'attn_small':18s} B={b} bf16 device time {ms:.4f} ms, SDPA {sdpa:.4f} ms; events "
          f"without the spin (host-bound): kernel {host:.4f} ms, SDPA {sdpa_host:.4f} ms; two "
          f"launches bitwise equal")
    if keep:
        rec.timing("attn_small", ms,
                   cuda_ms(lambda: kattn.attention_small_plain(*qkv, h, scale)),
                   bound(nbytes(*qkv, out_k), 4 * b * g * g * d, "bfloat16"), sdpa,
                   shape=f"[{b},{g},{d}] H={h} bfloat16")
        rec.r["attn_small"].update(host_ms=host, library_host_ms=sdpa_host)


def stem_flops(b: int, g: int, s: int, d: int) -> int:
    """K3's operations: the chain's three products a row and the pooled
    half once a group (the first layer's projection into t1ext is the
    wrapper's, outside the kernel)."""
    return 2 * b * g * s * (64 * 128 + 128 * 256 + 256 * d) + 2 * b * g * 128 * 256


def stem_library(ops):
    """K3's function as PyTorch calls (timed beside the kernel, never a path
    of the port): index_select of the neighbour and center rows of t1ext,
    the subtraction and ReLU, three bf16 cuBLAS products (addmm; the
    concat product as one), amax over each group and the cat of the pooled
    half."""
    t1ext, idx, w2, b2, w3, b3, w4, b4, n, g, s = ops
    b, _, c1 = t1ext.shape
    table = t1ext.reshape(-1, c1)
    base = torch.arange(b, device=t1ext.device)[:, None] * (n + g)
    rows = (idx.long() + base).reshape(-1)
    centers = (base + n + torch.arange(g, device=t1ext.device)).repeat_interleave(s, 1).reshape(-1)

    def run():
        x = torch.relu(table.index_select(0, rows) - table.index_select(0, centers))
        x1 = torch.addmm(b2, x, w2)
        gmax = x1.view(-1, s, x1.shape[1]).amax(1, keepdim=True).expand(-1, s, -1)
        x2 = torch.relu(torch.addmm(b3, torch.cat([gmax.reshape(x1.shape), x1], -1), w3))
        return torch.addmm(b4, x2, w4).view(b, g, s, -1).amax(2)

    return run


def time_stem_tc(rec: Recorder, ops, out_k, keep: bool) -> tuple[float, float]:
    """The bf16 K3 (tensor cores) on device time beside its PyTorch route
    (`stem_library`), the events beside; the twin's time and the bound;
    into the JSON line where `keep`. Returns the two device times."""
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    t1ext, n, g, s = ops[0], ops[8], ops[9], ops[10]
    b, d = t1ext.shape[0], ops[6].shape[1]
    tensors = [o for o in ops if isinstance(o, torch.Tensor)]
    return _device_timing(rec, "stem", f"B={b} G={g} S={s} D={d} bfloat16",
                          lambda: kstem.stem_kernel(*ops), stem_library(ops),
                          cuda_ms(lambda: kstem.stem_plain(*ops), iters=3),
                          bound(nbytes(*tensors, out_k), stem_flops(b, g, s, d), "bfloat16"),
                          keep)


def kv_ln_library(args, h: int, scale: float):
    """K4's function as PyTorch calls (timed beside the kernel, never a path
    of the port): F.layer_norm, one bf16 cuBLAS product onto [Wk | Wv], and
    F.scaled_dot_product_attention on the head-split views."""
    import torch.nn.functional as F

    from vipformer_tpu_torch.ops import cuda as kcuda

    q, x, lw, lb, wk, wv = args
    d = q.shape[-1]
    wkv = torch.cat([wk, wv], 1)
    lw, lb = lw.to(x.dtype), lb.to(x.dtype)

    def run():
        kv = F.layer_norm(x, (x.shape[-1],), lw, lb, eps=kcuda.LN_EPS) @ wkv
        return sdpa_call(q, kv[..., :d], kv[..., d:], h, scale)

    return run


def time_kv_ln_tc(rec: Recorder, args, out_k, h: int, scale: float,
                  keep: bool) -> tuple[float, float]:
    """The bf16 K4 (its statistics pass and tensor-core attention) on device
    time beside its PyTorch route (`kv_ln_library`), as time_stem_tc."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    q, x = args[0], args[1]
    (b, g, d), (m, din) = q.shape, x.shape[1:]
    ops = 2 * b * m * din * 2 * d + 4 * b * g * m * d
    return _device_timing(rec, "attn_kv_ln", f"q[{b},{g},{d}] x[{b},{m},{din}] H={h} bfloat16",
                          lambda: kattn.fused_attention_packed_kv_ln(*args, num_heads=h,
                                                                     scale=scale),
                          kv_ln_library(args, h, scale),
                          cuda_ms(lambda: kattn.attention_kv_ln_plain(*args, h, scale), iters=3),
                          bound(nbytes(*args, out_k), ops, "bfloat16"), keep)


# K3's and K4's bf16 shapes on the eval paths beyond serving's B = 32 and 64:
# the ft_cls eval (B = 330) and eval_zeroshot (B = 160) at the flagship's
# G = 128, S = 32, D = 256 over 1,024 points; K4 also at the Perceiver's
# point features (128 and 512 latents over 2,048 points, B = 64) and at
# Din = D = 384, H = 6 (partseg's 2,048 points, semseg's 4,096): (B, G, M,
# D, H)
K3_EVAL_BATCHES = (FT_BATCH, EVAL_BATCH)
K4_PERCEIVER_SHAPES = ((PERCEIVER_FEATS_BATCH, 128, 2048, 256, 4),
                       (PERCEIVER_FEATS_BATCH, 512, 2048, 256, 4))
K4_DIN384_SHAPES = ((PARTSEG_BATCH, 128, 2048, 384, 6), (SEMSEG_BATCH, 128, SEMSEG_POINTS, 384, 6))
# the kernels the bf16 K3 and K4 launch (csrc/stem.cu tc, csrc/attention.cu
# tc), and their CUDA-core kernels, which bf16 must not reach
K3_K4_TC_KERNELS = ("vpt_stem::tc::mid_kernel", "vpt_stem::tc::out_kernel",
                    "(anonymous namespace)::tc::ln_xn_kernel", "attn_kv_ln_tile_kernel")
K3_K4_SIMT_KERNELS = ("stem_kernel", "attn_flash_kernel")


def kv_ln_args(gen, b: int, g: int, m: int, d: int) -> tuple:
    """K4's bf16 operands on the card: q [b, g, d], x [b, m, d], the
    LayerNorm's f32 weight and bias, wk and wv [d, d]."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    return (torch.randn((b, g, d), generator=gen, device=dev).to(bf),
            torch.randn((b, m, d), generator=gen, device=dev).to(bf),
            torch.randn((d,), generator=gen, device=dev) * 0.2 + 1.0,
            torch.randn((d,), generator=gen, device=dev) * 0.1,
            *(torch.randn((d, d), generator=gen, device=dev).to(bf) * d ** -0.5
              for _ in range(2)))


def check_k3_k4_eval_shapes(rec: Recorder) -> None:
    """The bf16 K3 and K4 (tensor cores) against their twins at the eval
    paths' batches (K3_EVAL_BATCHES, and K4 at K4_PERCEIVER_SHAPES and
    K4_DIN384_SHAPES), two launches bitwise equal, with their device times
    and the PyTorch routes' (readings; the JSON line keeps serving's
    B = 64)."""
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    d, h, g, s = 256, 4, 128, 32
    g2e = init_weights(Group2Emb(3, d), SEED).to(dev).eval()
    print("K3 and K4 in bf16 at the eval paths' shapes:")
    with torch.inference_mode():
        for b in K3_EVAL_BATCHES:
            xyz = torch.randn((b, NUM_POINTS, 3), generator=gen, device=dev)
            _, cen = kfps.fps(xyz, g)
            ops = kstem.stem_operands(g2e, xyz, cen, kknn.knn(s, xyz, cen), bf)
            out_k = kstem.stem_kernel(*ops)
            rec.check("stem", f"B={b} bfloat16", *rel_err(out_k, kstem.stem_plain(*ops)),
                      KERNEL_TOL["bfloat16"])
            expect(torch.equal(out_k, kstem.stem_kernel(*ops)), f"stem B={b}: two launches differ")
            time_stem_tc(rec, ops, out_k, keep=False)
            del ops, out_k
            torch.cuda.empty_cache()
        shapes = [(b, g, NUM_POINTS, d, h) for b in K3_EVAL_BATCHES]
        for b, gq, m, dk, hk in shapes + list(K4_PERCEIVER_SHAPES + K4_DIN384_SHAPES):
            args = kv_ln_args(gen, b, gq, m, dk)
            out_k = kattn.fused_attention_packed_kv_ln(*args, num_heads=hk, scale=0.125)
            rec.check("attn_kv_ln", f"q[{b},{gq}] x[{b},{m},{dk}] bfloat16",
                      *rel_err(out_k, kattn.attention_kv_ln_plain(*args, hk, 0.125)),
                      KERNEL_TOL["bfloat16"])
            expect(torch.equal(out_k, kattn.fused_attention_packed_kv_ln(
                *args, num_heads=hk, scale=0.125)), f"attn_kv_ln q[{b},{gq}]: two launches differ")
            time_kv_ln_tc(rec, args, out_k, hk, 0.125, keep=False)
            del args, out_k
            torch.cuda.empty_cache()


def expect_k3_k4_tc(kernels: dict, what: str) -> None:
    """torch.profiler's kernels of a bf16 eval forward (`device_kernels`)
    hold the tensor-core K3 and K4 and none of their CUDA-core kernels."""
    names = list(kernels)
    ran = {k: sum(n for name, n in kernels.items() if k in name) for k in K3_K4_TC_KERNELS}
    print(f"  {what}: K3 / K4 kernels a forward " + ", ".join(
        f"{k} {n:.0f}" for k, n in ran.items()))
    expect(all(ran.values()), f"{what}: a tensor-core K3 or K4 kernel did not run: {names}")
    simt = [n for n in names if any(k in n for k in K3_K4_SIMT_KERNELS)]
    expect(not simt, f"{what}: the CUDA-core K3 or K4 ran: {simt}")


def serving_model(dt: str, device):
    from vipformer_tpu_torch.models.factory import build_ft_cls

    return build_ft_cls(config(compute_dtype=dt), device=device)


def drive_serving_path(counts_out: dict) -> None:
    from vipformer_tpu_torch.inference import classifier_predictor
    from vipformer_tpu_torch.ops import geometry

    cfg = config()
    rng = np.random.default_rng(SEED + 1)
    model = serving_model("bfloat16", "cuda")
    predictor = classifier_predictor(model, max_batch=64)
    requests = [rng.standard_normal((n, NUM_POINTS, 3)).astype(np.float32) for n in REQUESTS]

    outs = []
    counts = _counted("serving path", lambda: outs.extend(predictor(r) for r in requests))
    counts_out.update(counts)
    _expect_launched("serving", counts, SERVING_KERNELS)
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


def check_bwd_bitwise(bwd, bwd_args, name: str, what: str) -> None:
    """A backward kernel (K8's bf16 tensor-core backward, K10's and K12's
    VJPs) gives the same bits on two launches: no floating-point atomics,
    every sum runs in a fixed order."""
    first, again = bwd(*bwd_args), bwd(*bwd_args)
    if isinstance(first, torch.Tensor):
        first, again = (first,), (again,)
    expect(all(torch.equal(a, b) for a, b in zip(first, again)),
           f"{name} {what}: two launches differ")
    print(f"  {name:18s} {what}: two launches bitwise equal")


def check_vjp_launches() -> None:
    """K10's and K12's VJPs are one device kernel a call (one launch of
    csrc/gather.cu scatter_sorted_kernel; no zeroing, no cast), read from
    torch.profiler at every case their phases run (K10_VJP_SHAPES in bf16,
    the pretrain shape in f32 too; K12's compat stem gather and
    GATHER_CASES in both dtypes), on random indices with 8 rows of each
    cloud on one point. Run early: mid-run, traces of these calls have come
    back with one launch in three, as late traces of other kernels have
    come back empty (check_one_pass_launches)."""
    from vipformer_tpu_torch.ops.cuda import gather as kgather

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)

    def case(b, n, k, c, dt):
        idx = torch.randint(0, n, (b, k), generator=gen, device="cuda", dtype=torch.int32)
        idx[:, :8] = idx[:, :1]
        return torch.randn((b, k, c), generator=gen, device="cuda").to(dt), idx

    calls = []
    for b, n, c in K10_VJP_SHAPES:
        first = b == K10_VJP_SHAPES[0][0]
        for dt in (torch.float32, torch.bfloat16) if first else (torch.bfloat16,):
            grad, idx = case(b, n, 128 * 32, c, dt)
            calls.append((f"K10's VJP [{b},{n},{c}] {dt}", kgather.scatter_centered_kernel,
                          (grad, idx, n, 128, 32)))
    for b, n, c, k in ((PARTSEG_BATCH, NUM_POINTS, 3, 128 * 32),) + GATHER_CASES:
        for dt in (torch.float32, torch.bfloat16):
            grad, idx = case(b, n, k, c, dt)
            calls.append((f"K12's VJP [{b},{n},{c}] K={k} {dt}", kgather.scatter_rows_kernel,
                          (grad, idx, n)))
    for what, fn, args in calls:
        fn(*args)  # a warm call, outside the trace
        kernels = device_kernels(lambda: fn(*args))
        expect(len(kernels) == 1 and "scatter_sorted_kernel" in next(iter(kernels)) and
               list(kernels.values()) == [1.0],
               f"{what}: launches {kernels}, want one scatter_sorted_kernel a call")
        print(f"  {what}: one device kernel a call (torch.profiler)")
    print(f"  (the VJPs' launch checks took {time.perf_counter() - t0:.1f} s)")


def time_flash_bwd_ft_cls(kf, t, seed, n: int, d: int, h: int, scale: float,
                          rate: float) -> None:
    """K8's bf16 backward at the ft_cls step's self-attention, [330, 128,
    256] (B = FT_BATCH clouds), on device time beside SDPA's forward and
    backward together, held against its twin first."""
    b = FT_BATCH
    q, k, v, do = (t((b, n, d), torch.bfloat16) for _ in range(4))
    out, lse = kf.attention_fwd_plain(q, k, v, seed, h, scale, rate)
    bwd_args = (q, k, v, do, lse, kf.attention_delta(do, out, h), seed, h, scale, rate)
    grads = kf.attention_bwd_kernel(*bwd_args)
    for gname, gk, gp in zip(("dq", "dk", "dv"), grads, kf.attention_bwd_plain(*bwd_args)):
        err, rel = rel_err(gk, gp)
        print(f"  {'attn_train_bwd':18s} ft_cls B={b} bf16 p={rate} {gname:4s} "
              f"max_abs_err={err:.3e} rel={rel:.3e} (bound {GRAD_TOL['bfloat16']:.0e})")
        expect(rel <= GRAD_TOL["bfloat16"], f"K8 backward at B={b}: {gname} error {rel:.3e}")
    _device_timing(None, "attn_train_bwd", f"[{b},{n},{d}] H={h} p={rate} bf16",
                   lambda: kf.attention_bwd_kernel(*bwd_args),
                   sdpa_fwd_bwd(q, k, v, do, h, scale, rate),
                   cuda_ms(lambda: kf.attention_bwd_plain(*bwd_args), iters=5),
                   bound(nbytes(q, k, v, do, lse, bwd_args[5], *grads), 10 * b * n * n * d,
                         "bfloat16"), keep=False)


# K7's bf16 kernels by the names torch.profiler gives them (the projection
# in the forward and the backward; the attention backward, dx and the
# weight gradients in the backward), and what no bf16 K7 may launch: the
# CUDA cores' SIMT product of train_common.cuh
K7_TC_KERNELS = ("ln_xn_kernel", "kv_proj_tc_kernel", "flash_bwd_kv_tc_kernel",
                 "flash_bwd_dq_tc_kernel", "dxn_tc_kernel", "dw_tc_kernel")
SIMT_GEMM = "gemm_kernel"


def check_kv_projection(rec: Recorder, kf, args, branch: str) -> None:
    """K7's bf16 LN-folded k|v projection alone (the kernel its forward and
    backward launch) against `kv_project_plain`, and launched twice,
    bitwise equal."""
    x, lnw, lnb, wk, wv = args[1:]
    got = kf.kv_project_kernel(x, lnw, lnb, wk, wv)
    expect(all(torch.equal(a, b) for a, b in zip(got, kf.kv_project_kernel(x, lnw, lnb, wk, wv))),
           f"K7's projection {branch} bf16: two launches differ")
    for name, a, b in zip(("k", "v"), got, kf.kv_project_plain(x, lnw, lnb, wk, wv)):
        rec.check("attn_train_kv_fwd", f"{branch} bf16 projection {name} (twice equal)",
                  *rel_err(a, b), KERNEL_TOL["bfloat16"])


def time_flash_train_kv(rec: Recorder, kf, args, do, out_k, lse_k, lse_p, delta, seed, h: int,
                        scale: float, rate: float, shape: str, keep: bool) -> None:
    """K7's bf16 forward and backward timed (events, device time beside)
    with their twins and bounds, the projection alone on device time
    beside its route in PyTorch calls (LayerNorm, one cuBLAS product of
    [wk | wv]), and where the backward goes: its kernels by name from
    torch.profiler, the CUDA cores' SIMT product not among them. Recorded
    for the JSON line where `keep`."""
    import torch.nn.functional as F

    q, x, lnw, lnb, wk, wv = args
    b, gq, d = q.shape
    m, din = x.shape[1], x.shape[2]
    attn = 4 * b * gq * m * d
    proj = 2 * b * m * din * 2 * d
    bwd_args = (*args, do, lse_p, delta, seed, h, scale, rate)
    grads = kf.attention_kv_bwd_kernel(*bwd_args)
    fwd = lambda: kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)  # noqa: E731
    bwd = lambda: kf.attention_kv_bwd_kernel(*bwd_args)  # noqa: E731
    # the backward recomputes k and v (the forward keeps only the
    # logsumexp), then dx through the projections and the weight gradients:
    # three projection-sized products
    timings = dict(
        fwd=(cuda_ms(fwd, iters=10), queued_ms(fwd, "K7 forward", iters=10),
             cuda_ms(lambda: kf.attention_kv_fwd_plain(*args, seed, h, scale, rate), iters=3),
             bound(nbytes(*args, out_k, lse_k), proj + attn, "bfloat16")),
        bwd=(cuda_ms(bwd, iters=10), queued_ms(bwd, "K7 backward", iters=10),
             cuda_ms(lambda: kf.attention_kv_bwd_plain(*bwd_args), iters=3),
             bound(nbytes(*args, do, lse_p, delta, *grads), 3 * proj + 2.5 * attn, "bfloat16")))
    for way, (ms, dev_ms, plain_ms, bnd) in timings.items():
        name = f"attn_train_kv_{way}"
        if keep:
            rec.timing(name, ms, plain_ms, bnd, shape=shape)
            rec.r[name]["device_ms"] = dev_ms
        else:
            print(f"  {name:18s} {shape:34s} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})")
        print(f"  {name:18s} {shape:34s} device time {dev_ms:.4f} ms (events {ms:.4f})")
    w = torch.cat([wk, wv], 1)
    pj_ms, pj_lib_ms = queued_ms(lambda: kf.kv_project_kernel(x, lnw, lnb, wk, wv), "K7 proj"), \
        queued_ms(lambda: F.layer_norm(x, (din,), lnw.to(x.dtype), lnb.to(x.dtype),
                                       1e-5) @ w, "K7 proj library")
    pj_bnd = bound(nbytes(x, wk, wv) + 2 * b * m * d * 2, proj, "bfloat16")
    print(f"  {'kv_project':18s} {shape:34s} device time {pj_ms:.4f} ms, bound "
          f"{pj_bnd['bound_ms']:.4f} ({pj_bnd['bound_by']}, {100.0 * pj_bnd['bound_ms'] / pj_ms:.1f}"
          f"% of it), LayerNorm + one cuBLAS product {pj_lib_ms:.4f} ms")
    fsums = kernel_sums(fwd, 3, K7_FWD_LN, K7_FWD_TILE, "attn_kv_ln_stream_kernel",
                        "attn_combine_kernel")
    print(f"  {'attn_train_kv_fwd':18s} {shape}: {fsums[0]:.4f} ms of kernels a launch "
          f"(torch.profiler): LayerNorm pass {fsums[1]:.4f}, tile kernel {fsums[2]:.4f}, stream "
          f"kernel {fsums[3]:.4f}, merge pass {fsums[4]:.4f}")
    sums = kernel_sums(bwd, 3, *K7_TC_KERNELS, SIMT_GEMM)
    busy, parts, simt = sums[0], dict(zip(K7_TC_KERNELS, sums[1:-1])), sums[-1]
    print(f"  {'attn_train_kv_bwd':18s} {shape}: {busy:.4f} ms of kernels a launch "
          f"(torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; the rest {busy - sum(parts.values()):.4f} (LayerNorm backward, its column sums, "
          f"the split sums)")
    expect(simt == 0, f"K7 bf16 backward: the SIMT {SIMT_GEMM} ran ({simt:.4f} ms)")
    expect(all(parts[k] > 0 for k in K7_TC_KERNELS if k != "flash_bwd_dq_tc_kernel" or m > 128),
           f"K7 bf16 backward: a tensor-core kernel did not run: {parts}")


def time_k10_device(kgather, pts, centers, idx, s: int, shape: str) -> None:
    """K10's forward held bitwise against its twin and timed on device
    time (events beside) at a path's shape, with its bound."""
    out = kgather.gather_centered_kernel(pts, centers, idx, s)
    expect(torch.equal(out, kgather.gather_centered_plain(pts, centers, idx, s)),
           f"K10 at {shape} differs from its twin")
    k10 = lambda: kgather.gather_centered_kernel(pts, centers, idx, s)  # noqa: E731
    ms, bnd = queued_ms(k10, "K10"), bound(nbytes(pts, centers, idx, out), 3 * idx.numel(),
                                           "bfloat16")
    print(f"  {'gather_centered_fwd':18s} {shape:34s} (equal) device time {ms:.4f} ms, events "
          f"{cuda_ms(k10):.4f}; bound {bnd['bound_ms']:.4f} ({bnd['bound_by']}, "
          f"{100.0 * bnd['bound_ms'] / ms:.1f}% of it)")


def time_k10_ft_cls(kfps, kknn, kgather, g: int, s: int) -> None:
    """K10 at the ft_cls step's points [330, 1,024, 3], 128 groups of 32
    (FPS centers, kNN neighbourhoods), bf16; the points from a generator
    of their own, so that the phases after it see the data they did
    before it ran."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    xyz = torch.randn((FT_BATCH, NUM_POINTS, 3), generator=gen, device="cuda")
    _, centers = kfps.fps(xyz, g)
    idx = kknn.knn(s, xyz, centers).reshape(FT_BATCH, -1)
    time_k10_device(kgather, xyz.to(torch.bfloat16), centers, idx, s,
                    f"points[{FT_BATCH},{NUM_POINTS},3] idx[{FT_BATCH},{g * s}] bf16")


# K10's VJP at each path's points: pretrain (both views), ft_cls, semseg
# (xyz + rgb), 128 groups of 32 each
K10_VJP_SHAPES = ((2 * PRETRAIN_BATCH, 2048, 3), (FT_BATCH, NUM_POINTS, 3),
                  (SEMSEG_BATCH, SEMSEG_POINTS, 6))


def index_add_call(grad, idx, n: int):
    """One PyTorch call of d_points alone (K10's and K12's scatter-add):
    index_add_ of the rows of grad [B, K, C] into a zeroed [B N, C] table."""
    b, _, c = grad.shape
    flat = (idx.long() + n * torch.arange(b, device=grad.device)[:, None]).reshape(-1)
    rows = grad.reshape(-1, c)
    return lambda: torch.zeros((b * n, c), dtype=grad.dtype,
                               device=grad.device).index_add_(0, flat, rows)


def time_scatter(rec, name: str, kern, plain, library, bnd, shape: str, record: bool) -> None:
    """A VJP's device time (calls queued behind a spin kernel: the wrapper
    costs the host more than the kernel the card), its events, the twin's
    time, the bound and index_add_'s device time; `record` puts them in
    the JSON line."""
    ms, ev, lib = queued_ms(kern, name), cuda_ms(kern), device_ms(library)
    plain_ms = cuda_ms(plain)
    print(f"  {name:18s} {shape:34s} device time {ms:.4f} ms, events {ev:.4f}, twin "
          f"{plain_ms:.4f}; bound {bnd['bound_ms']:.4f} ({bnd['bound_by']}, "
          f"{100.0 * bnd['bound_ms'] / ms:.1f}% of it); index_add_ device time "
          + (f"{lib:.4f} ms" if lib is not None else "not measured"))
    if record:
        rec.timing(name, ms, plain_ms, bnd, shape=shape)
        rec.r[name].update(host_ms=ev, index_add_ms=lib)


def check_k10_vjp(rec: Recorder, kfps, kknn, kgather, g: int, s: int) -> None:
    """K10's VJP (one launch of csrc/gather.cu scatter_sorted_kernel) at
    each path's points, K10_VJP_SHAPES (FPS centers and kNN neighbourhoods
    of random clouds: a point sits in several groups; then again with the
    first 64 rows of every cloud on one point), bf16, and f32 at the
    pretrain shape: d_points and d_centers within GRAD_TOL of the twin,
    bitwise equal between two launches (one device kernel a call:
    check_vjp_launches, early in the run); timed at each shape (device
    time, events, bound, index_add_), the pretrain shape's in the JSON
    line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    print("K10's VJP (deterministic sorted scatter, one launch) at the paths' points:")
    for b, n, c in K10_VJP_SHAPES:
        xyz = torch.randn((b, n, 3), generator=gen, device="cuda")
        _, centers = kfps.fps(xyz, g)
        knn_idx = kknn.knn(s, xyz, centers).reshape(b, g * s)
        heavy = knn_idx.clone()
        heavy[:, :64] = heavy[:, :1]
        first = b == K10_VJP_SHAPES[0][0]
        for dt_name in ("float32", "bfloat16") if first else ("bfloat16",):
            dt = getattr(torch, dt_name)
            grad = torch.randn((b, g * s, c), generator=gen, device="cuda").to(dt)
            for kind, idx in (("kNN", knn_idx), ("64 rows on one point", heavy)):
                what = f"[{b},{n},{c}] {dt_name} {kind}"
                args = (grad, idx, n, g, s)
                dp, dc = kgather.scatter_centered_kernel(*args)
                expect(dp.dtype == dt and dc.dtype == torch.float32,
                       f"K10's VJP {what}: outputs {dp.dtype}, {dc.dtype}")
                for gname, gk, gp in zip(("d_points", "d_centers"), (dp, dc),
                                         kgather.scatter_centered_plain(*args)):
                    rec.check("gather_centered_bwd", f"{what} {gname}", *rel_err(gk, gp),
                              GRAD_TOL[dt_name])
                check_bwd_bitwise(kgather.scatter_centered_kernel, args, "gather_centered_bwd",
                                  what)
            if dt_name == "bfloat16":
                shape = f"points[{b},{n},{c}] idx[{b},{g * s}] bf16"
                time_scatter(rec, "gather_centered_bwd",
                             lambda: kgather.scatter_centered_kernel(grad, knn_idx, n, g, s),
                             lambda: kgather.scatter_centered_plain(grad, knn_idx, n, g, s),
                             index_add_call(grad, knn_idx, n),
                             bound(nbytes(grad, knn_idx, dp, dc), grad.numel(), dt_name), shape,
                             record=first)
    print(f"  (K10's VJP phase took {time.perf_counter() - t0:.1f} s)")


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
            if dt_name == "bfloat16":  # the tensor-core forward and backward: the same bits again
                out2, lse2 = kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate)
                expect(torch.equal(out_k, out2) and torch.equal(lse_k, lse2),
                       f"K8 forward {branch} bf16: two launches differ")
                print(f"  {'attn_train_fwd':18s} {branch} bf16 p={rate}: two launches bitwise "
                      f"equal")
                check_bwd_bitwise(kf.attention_bwd_kernel, bwd_args, "attn_train_bwd",
                                  f"{branch} bf16 p={rate}")
            if branch == "point" and dt_name == "bfloat16":
                shape = f"[{b},{n},{d}] H={h} p={rate} bf16"
                ops = 4 * b * n * n * d
                # device times (queued behind a spin: SDPA's and the bf16
                # forward's wrappers cost the host more than their kernels
                # cost the card), the event times beside them
                grads = kf.attention_bwd_kernel(*bwd_args)
                calls = dict(
                    fwd=(lambda: kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate),
                         lambda: sdpa_call(q, k, v, h, scale, rate),
                         lambda: kf.attention_fwd_plain(q, k, v, seed, h, scale, rate),
                         bound(nbytes(q, k, v, out_k, lse_k), ops, dt_name)),
                    bwd=(lambda: kf.attention_bwd_kernel(*bwd_args),
                         sdpa_fwd_bwd(q, k, v, do, h, scale, rate),
                         lambda: kf.attention_bwd_plain(*bwd_args),
                         bound(nbytes(q, k, v, do, lse_p, delta, *grads), 2.5 * ops, dt_name)))
                for way, (kernel, library, plain, bnd) in calls.items():
                    _device_timing(rec, f"attn_train_{way}", shape, kernel, library,
                                   cuda_ms(plain), bnd)
        if branch == "point":
            check_dropout_through_output(kf, seed, h, scale, rate)
            check_k7_dropout_through_output(kf, seed, h, scale, rate)
            time_flash_bwd_ft_cls(kf, t, seed, n, d, h, scale, rate)

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
            if dt_name == "bfloat16":  # the tensor-core products: the same bits again
                expect(all(torch.equal(a, b) for a, b in zip(
                    (out_k, lse_k), kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate))),
                    f"K7 forward {branch} bf16: two launches differ")
                first = kf.attention_kv_bwd_kernel(*bwd_args)
                expect(all(torch.equal(a, b) for a, b in zip(
                    first, kf.attention_kv_bwd_kernel(*bwd_args))),
                    f"K7 backward {branch} bf16: two launches differ")
                print(f"  {'attn_train_kv':18s} {branch} bf16 p={rate}: forward and backward, two "
                      f"launches each bitwise equal")
                del first
                check_kv_projection(rec, kf, args, branch)
                check_k7_forward(rec, kf, args, seed, h, scale, rate, branch)
            if branch == "point" and dt_name == "bfloat16":
                time_flash_train_kv(rec, kf, args, do, out_k, lse_k, lse_p, delta, seed, h, scale,
                                    rate, f"q[{b},{gq},{d}] x[{b},{m},{d}] H={h} p={rate} bf16",
                                    keep=True)
            del args, do, out_k, out_p
        if branch == "point":  # K7's bf16 backward at the ft_cls step's [330, 128] x [330, 1024]
            b, m = FT_BATCH, 1024
            args = (t((b, g, d), torch.bfloat16), t((b, m, d), torch.bfloat16),
                    t((d,), scale_=0.2) + 1.0, t((d,), scale_=0.1),
                    t((d, d), torch.bfloat16, d ** -0.5), t((d, d), torch.bfloat16, d ** -0.5))
            do = t((b, g, d), torch.bfloat16)
            out_k, lse_k = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)
            delta = kf.attention_delta(do, out_k, h)
            bwd_args = (*args, do, lse_k, delta, seed, h, scale, rate)
            for gname, gk, gp in zip(("dq", "dx", "dln_w", "dln_b", "dwk", "dwv"),
                                     kf.attention_kv_bwd_kernel(*bwd_args),
                                     kf.attention_kv_bwd_plain(*bwd_args)):
                rec.check("attn_train_kv_bwd", f"ft_cls B={b} bf16 p={rate} {gname}",
                          *rel_err(gk, gp), GRAD_TOL["bfloat16"])
            time_flash_train_kv(rec, kf, args, do, out_k, lse_k, lse_k, delta, seed, h, scale,
                                rate, f"q[{b},{g},{d}] x[{b},{m},{d}] H={h} p={rate} bf16",
                                keep=False)
            del args, do, out_k, bwd_args
            torch.cuda.empty_cache()

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
                      GRAD_TOL[dt_name])
        if dt_name == "bfloat16":
            shape = f"points[{nb},{npts},3] idx[{nb},{g * s}] bf16"
            # device time (the wrapper costs the host more than the kernel
            # costs the card), the event time beside
            k10 = lambda: kgather.gather_centered_kernel(pts, centers, idx, s)  # noqa: E731
            rec.timing("gather_centered_fwd", queued_ms(k10, "K10"),
                       cuda_ms(lambda: kgather.gather_centered_plain(pts, centers, idx, s)),
                       bound(nbytes(pts, centers, idx, out_k), 3 * idx.numel(), dt_name),
                       shape=shape)
            rec.r["gather_centered_fwd"]["host_ms"] = cuda_ms(k10)
            print(f"  {'gather_centered_fwd':18s} {shape:34s} device time; events "
                  f"{rec.r['gather_centered_fwd']['host_ms']:.4f} ms")
            time_k10_ft_cls(kfps, kknn, kgather, g, s)
    check_k10_vjp(rec, kfps, kknn, kgather, g, s)

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
        work = kg.bwd_workspace(rows, s, 3, d, dt, dev,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
        dx_k, gr_k = kg.g2e_bwd_kernel(*bwd_args, work=work)
        dx_p, gr_p, rss = kg.g2e_bwd_plain(*bwd_args, rss=True)
        rec.check("g2e_train_bwd", f"{dt_name} dx0", *rel_err(dx_k, dx_p), GRAD_TOL[dt_name])
        for i, (a, w) in enumerate(zip(gr_k, gr_p)):
            if i not in ZERO_GRADS:
                rec.check("g2e_train_bwd", f"{dt_name} grad {i}", *rel_err(a, w),
                          GRAD_TOL[dt_name])
        check_zero_grads(rec, "g2e_train_bwd", dt_name, gr_k, gr_p, rss, rows, dt)
        if dt_name == "bfloat16":
            check_k9_ties_and_zeros(rec, kg, x0, wb, stats, s, work, gr_k, gr_p, rss,
                                    f"x0[{nb},{g},{s},3]")
        del work
        if dt_name == "bfloat16":
            check_g2e_route(kg, x0, wb, s, bwd_args, got, (dx_k, gr_k))
            time_g2e(rec, kg, x0, wb, s, dy, got, (dx_k, gr_k), f"x0[{nb},{g},{s},3]")
            del got, want, dx_k, gr_k, dx_p, gr_p, bwd_args, h3p, amax, stats
            torch.cuda.empty_cache()
            for gb, gg, gs in K9_GROUPS:
                check_g2e_bf16(rec, kg, t((gb * gg * gs, 3), dt), wb, gs, d,
                               f"x0[{gb},{gg},{gs},3]")
            # tie-heavy: x0 on a grid of 5 values a channel, so that most
            # groups hold equal rows, whose h2 and h4 rows tie exactly
            grid = (t((rows, 3)) * 2).round().clamp(-2, 2) / 2
            dup = (grid.view(rows // s, s, 1, 3) == grid.view(rows // s, 1, s, 3)).all(-1)
            dup = (dup.sum((1, 2)) > s).float().mean().item()
            check_g2e_bf16(rec, kg, grid.to(dt), wb, s, d,
                           f"ties ({100 * dup:.1f}% of groups repeat a row)")
            for dw in K9_OTHER_WIDTHS:
                wbw = [w.to(dev) for w in g2e_case(rng, dw, 3, dev)]
                gb, gg = K9_OTHER_WIDTHS_GROUPS
                check_g2e_bf16(rec, kg, t((gb * gg * s, 3), dt), wbw, s, dw,
                               f"D={dw} x0[{gb},{gg},{s},3]")
            time_g2e_ft_cls(rec, kg, wb, s, d, t)


# K9's bf16 kernels by the names torch.profiler gives them: the forward's
# tensor-core passes, the backward's and its CUDA-core P3, and K11's kernel
# for dW2 and dW1; what no bf16 K9 may launch is SIMT_GEMM
K9_FWD_KERNELS = ("fwd_mid_kernel", "fwd_out_kernel")
K9_BWD_KERNELS = ("bwd_dy3_kernel", "bwd_mid_kernel", "bwd_in_kernel", "dw3_kernel",
                  "dense_grads_tc_kernel")
# the other group sizes the bf16 K9 holds in its 128-row tiles (5 groups
# of 24 in 120 rows; one of 128), as x0 [B, G, S, 3]
K9_GROUPS = ((96, 128, 24), (24, 128, 128))
# cotangents over which check_g2e_bf16 reads dx0
K9_DY_DRAWS = 10
# output widths the bf16 K9 takes padded with zero columns to a multiple of
# 64 (96) and, past 384 columns, in P1's chunks (512), at x0 [24, 128, S, 3]
K9_OTHER_WIDTHS = (96, 512)
K9_OTHER_WIDTHS_GROUPS = (24, 128)
# what the bf16 K9 never allocates: the final Dense's output and its
# gradient, and the backward's f32 intermediates of R rows
K9_NOT_ALLOCATED = ("h4", "dh4", "dy3", "dxc")


def check_k9_ties_and_zeros(rec: Recorder, kg, x0, wb, stats, s: int, work, grads, ref, rss,
                            what: str) -> None:
    """K9's one rule at a near-tie and at zero (bf16): every (group, column)
    whose tie set h2 == gmax differs between the kernel (its backward's
    workspace, `work`) and the twin is counted and printed, and the check
    fails unless the two competing h2 values lie within one bf16 ulp of
    each other; the exactly-zero gradients of b0, b1 and b2 are held to
    their rounding noise, 2^-8 sqrt(sum of their rows' squares) a column
    (`rss`, from the twin), against the reference `ref`."""
    n, ulps = kg.tie_flips(*kg.kernel_h2_pool(work, s), *kg.h2_pool(x0, wb, stats, s), s)
    groups = x0.shape[0] // s
    print(f"  {'g2e_train_bwd':18s} {what}: {n} of {groups * 128} (group, column) tie sets "
          f"h2 == gmax differ from the twin's; the competing h2 at most {ulps:.3f} bf16 ulp "
          f"apart (bound 1)")
    expect(ulps <= 1.0, f"K9 bf16 {what}: a tie flip where the competing h2 lie {ulps:.3f} "
                        f"ulp apart")
    for i, r in zip(ZERO_GRADS, rss):
        diff = (grads[i].double() - ref[i].double()).abs()
        ratio = (diff / (r.double().clamp_min(1e-30) * 2.0 ** -8)).max().item()
        rec.check("g2e_train_bwd", f"{what} grad {i} by rounding noise", diff.max().item(), ratio,
                  1.0)


def check_g2e_bf16(rec: Recorder, kg, x0, wb, s: int, d: int, what: str) -> None:
    """K9's bf16 forward and backward against the twin on x0 [R, 3], each
    launched twice and held bitwise equal (dy drawn from a seed, as every
    input here). Where a group's two largest h2 in a column lie one bf16
    rounding apart, the card and the twin may round them to a different
    maximum, and the tie split then sends that column's gradient to other
    rows: dx0 and dh2 differ there by far more than a rounding, within the
    bound; check_k9_ties_and_zeros holds every such flip to a true
    near-tie."""
    rows = x0.shape[0]
    got, again = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_kernel(x0, wb, s)
    want = kg.g2e_fwd_plain(x0, wb, s)
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"K9 bf16 forward {what}: two launches differ")
    share = (got[2] == want[2]).float().mean().item()
    rec.check("g2e_train_fwd", f"{what} out (twice equal)", *rel_err(got[0], want[0]),
              KERNEL_TOL["bfloat16"])
    rec.check("g2e_train_fwd", f"{what} h3p", *rel_err(got[1], want[1]), KERNEL_TOL["bfloat16"])
    rec.check("g2e_train_fwd", f"{what} batch statistics", *rel_err(got[3], want[3]), STATS_TOL)
    print(f"  {'g2e_train_fwd':18s} {what}: argmax equal to the twin's at {100 * share:.3f}% "
          f"of (group, column)")
    _, h3p, amax, stats = want
    # dx0 over K9_DY_DRAWS cotangents (a reading: where a group's two largest
    # h2 lie one rounding apart, how far its tie split moves depends on dy)
    errs = []
    for k in range(K9_DY_DRAWS):
        dy = torch.from_numpy(np.random.default_rng(SEED + 9 + k).standard_normal(
            (rows // s, d)).astype(np.float32)).to(x0.device, x0.dtype)
        errs.append(rel_err(kg.g2e_bwd_kernel(x0, wb, *want[1:], dy, s)[0],
                            kg.g2e_bwd_plain(x0, wb, *want[1:], dy, s)[0])[1])
    print(f"  {'g2e_train_bwd':18s} {what}: dx0 rel over {K9_DY_DRAWS} cotangents (dy seeds "
          f"{SEED + 9}..{SEED + 8 + K9_DY_DRAWS}): " + " ".join(f"{e:.3e}" for e in errs)
          + f"; at most {max(errs):.3e} (bound {GRAD_TOL['bfloat16']})")
    dy = torch.from_numpy(np.random.default_rng(SEED + 9).standard_normal(
        (rows // s, d)).astype(np.float32)).to(x0.device, x0.dtype)
    args = (x0, wb, h3p, amax, stats, dy, s)
    work = kg.bwd_workspace(rows, s, x0.shape[1], d, x0.dtype, x0.device,
                            torch.cuda.get_device_properties(x0.device).multi_processor_count)
    (dx_k, gr_k), (dx_k2, gr_k2) = kg.g2e_bwd_kernel(*args, work=work), kg.g2e_bwd_kernel(*args)
    expect(torch.equal(dx_k, dx_k2) and all(map(torch.equal, gr_k, gr_k2)),
           f"K9 bf16 backward {what}: two launches differ")
    dx_p, gr_p, rss = kg.g2e_bwd_plain(*args, rss=True)
    rec.check("g2e_train_bwd", f"{what} dx0 (twice equal)", *rel_err(dx_k, dx_p),
              GRAD_TOL["bfloat16"])
    for i, (a, w) in enumerate(zip(gr_k, gr_p)):
        if i not in ZERO_GRADS:
            rec.check("g2e_train_bwd", f"{what} grad {i}", *rel_err(a, w), GRAD_TOL["bfloat16"])
    check_zero_grads(rec, "g2e_train_bwd", what, gr_k, gr_p, rss, rows, torch.bfloat16)
    check_k9_ties_and_zeros(rec, kg, x0, wb, stats, s, work, gr_k, gr_p, rss, what)
    del got, again, want, args, dx_k, gr_k, dx_k2, gr_k2, dx_p, gr_p, work
    torch.cuda.empty_cache()


def check_g2e_route(kg, x0, wb, s: int, bwd_args, fwd_out, bwd_out) -> None:
    """The bf16 K9 at the pretrain shape: forward and backward bitwise equal
    on a second launch; torch.profiler's kernels of each (launches a call,
    no SIMT_GEMM, every tensor-core pass present); and what each call
    allocates: the forward its outputs and partial sums only (no h4), the
    backward its outputs and `bwd_workspace`, which holds none of
    K9_NOT_ALLOCATED and no f32 array of R rows."""
    from vipformer_tpu_torch.ops import cuda as kcuda

    rows, d = x0.shape[0], wb[10].shape[1]
    expect(all(torch.equal(a, b) for a, b in zip(fwd_out, kg.g2e_fwd_kernel(x0, wb, s))),
           "K9 bf16 forward: two launches differ")
    again = kg.g2e_bwd_kernel(*bwd_args)
    expect(torch.equal(bwd_out[0], again[0]) and all(map(torch.equal, bwd_out[1], again[1])),
           "K9 bf16 backward: two launches differ")
    print(f"  {'g2e_train':18s} bf16 forward and backward: two launches bitwise equal")
    for way, fn, names in (("fwd", lambda: kg.g2e_fwd_kernel(x0, wb, s), K9_FWD_KERNELS),
                           ("bwd", lambda: kg.g2e_bwd_kernel(*bwd_args), K9_BWD_KERNELS)):
        ks = device_kernels(fn)
        print(f"  {'g2e_train_' + way:18s} bf16: {sum(ks.values()):.0f} kernel launches a call: "
              + ", ".join(f"{k.split('(')[0].removeprefix('void ')} {n:.0f}"
                          for k, n in ks.items()))
        expect(not any(SIMT_GEMM in k for k in ks), f"K9 bf16 {way}: the SIMT {SIMT_GEMM} ran")
        expect(all(any(n in k for k in ks) for n in names),
               f"K9 bf16 {way}: a tensor-core pass did not run: {list(ks)}")
    work = kg.bwd_workspace(rows, s, x0.shape[1], d, torch.bfloat16, "meta",
                            kcuda.sm_count(x0.device.index))
    expect(not set(K9_NOT_ALLOCATED) & set(work), f"K9 bf16 workspace: {list(work)}")
    for name, w in work.items():
        expect(not (w.dtype != torch.bfloat16 and w.dim() > 1 and w.shape[0] == rows),
               f"K9 bf16 workspace: {name} is an array of R rows in {w.dtype}")
    print(f"  {'g2e_train_bwd':18s} bf16 workspace: " + ", ".join(
        f"{k} {tuple(w.shape)} {str(w.dtype)[6:]}" for k, w in work.items()))
    for way, fn, outs, extra in (
            ("fwd", lambda: kg.g2e_fwd_kernel(x0, wb, s), fwd_out, 0),
            ("bwd", lambda: kg.g2e_bwd_kernel(*bwd_args), [bwd_out[0], *bwd_out[1]],
             nbytes(*work.values()))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        allowed = nbytes(*outs) + extra + (4 << 20)  # + weights in bf16, partial sums
        print(f"  {'g2e_train_' + way:18s} bf16: a call allocates {grew / 2**20:.1f} MiB "
              f"(outputs and workspace {allowed / 2**20:.1f} MiB with 4 MiB of weights and "
              f"partials; an [R, D] bf16 array is {rows * d * 2 / 2**20:.1f} MiB)")
        expect(grew <= allowed, f"K9 bf16 {way}: a call allocated {grew} bytes, above {allowed}")


def g2e_library(kg, x0, wb, s: int, dy):
    """K9's function as PyTorch calls (timed beside it, never used by the
    port): bf16 torch.matmul for the four Dense, F.batch_norm in training
    mode for the two BatchNorms, amax over each group for both max pools;
    autograd for the backward. Returns the forward and the forward with
    its backward."""
    import torch.nn.functional as F

    r = x0.shape[0]
    w = [t.detach().to(torch.float32 if i in (2, 3, 8, 9) else x0.dtype).requires_grad_()
         for i, t in enumerate(wb)]
    x = x0.detach().clone().requires_grad_()

    def fwd():
        h1 = x @ w[0] + w[1]
        x1 = F.relu(F.batch_norm(h1, None, None, w[2], w[3], training=True, eps=kg.BN_EPS))
        h2 = x1 @ w[4] + w[5]
        gmax = h2.view(r // s, s, -1).amax(1, keepdim=True).expand(-1, s, -1).reshape(r, -1)
        h3 = torch.cat([gmax, h2], -1) @ w[6] + w[7]
        x3 = F.relu(F.batch_norm(h3, None, None, w[8], w[9], training=True, eps=kg.BN_EPS))
        return (x3 @ w[10] + w[11]).view(r // s, s, -1).amax(1)

    return fwd, lambda: torch.autograd.grad(fwd(), [x, *w], dy)


def time_g2e(rec: Recorder, kg, x0, wb, s: int, dy, got, grads, shape: str) -> None:
    """K9's bf16 forward and backward at the pretrain shape for the JSON
    line (CUDA events; device time beside), with the twin, the bound and
    the PyTorch route (`g2e_library`: the forward, and the forward with
    its backward)."""
    rows, d = x0.shape[0], wb[10].shape[1]
    macs = rows * (3 * 64 + 64 * 128 + 256 * 256 + 256 * d)
    _, h3p, amax, stats = got
    bwd_args = (x0, wb, h3p, amax, stats, dy, s)
    lib_fwd, lib_fwd_bwd = g2e_library(kg, x0, wb, s, dy)
    shape = f"{shape} ({rows} rows) bf16"
    for way, fn, plain, lib, bnd in (
            ("fwd", lambda: kg.g2e_fwd_kernel(x0, wb, s), lambda: kg.g2e_fwd_plain(x0, wb, s),
             lib_fwd, bound(nbytes(x0, *wb, *got), 2 * macs, "bfloat16")),
            ("bwd", lambda: kg.g2e_bwd_kernel(*bwd_args), lambda: kg.g2e_bwd_plain(*bwd_args),
             lib_fwd_bwd, bound(nbytes(x0, *wb, h3p, amax, stats, dy, grads[0], *grads[1]),
                                4 * macs, "bfloat16"))):
        name = f"g2e_train_{way}"
        rec.timing(name, cuda_ms(fn, iters=5), cuda_ms(plain, iters=3), bnd,
                   cuda_ms(lib, iters=5), shape=shape)
        rec.r[name]["library_route"] = ("bf16 torch.matmul x4, F.batch_norm (training) x2, "
                                        "amax x2" + (", autograd (forward included)"
                                                     if way == "bwd" else ""))
        rec.r[name]["device_ms"] = queued_ms(fn, f"K9 {way}", iters=5)
        print(f"  {name:18s} {shape:34s} device time {rec.r[name]['device_ms']:.4f} ms")


def time_g2e_ft_cls(rec: Recorder, kg, wb, s: int, d: int, t) -> None:
    """K9's bf16 forward and backward at the ft_cls step's x0 [330, 128, 32,
    3] (1,351,680 rows; events) with their bounds and the PyTorch route."""
    g = 128
    rows = FT_BATCH * g * s
    x0 = t((rows, 3), torch.bfloat16)
    dy = t((rows // s, d), torch.bfloat16)
    got = kg.g2e_fwd_kernel(x0, wb, s)
    _, h3p, amax, stats = got
    bwd_args = (x0, wb, h3p, amax, stats, dy, s)
    grads = kg.g2e_bwd_kernel(*bwd_args)
    macs = rows * (3 * 64 + 64 * 128 + 256 * 256 + 256 * d)
    lib_fwd, lib_fwd_bwd = g2e_library(kg, x0, wb, s, dy)
    shape = f"x0[{FT_BATCH},{g},{s},3] ({rows} rows) bf16"
    for way, fn, lib, bnd in (
            ("fwd", lambda: kg.g2e_fwd_kernel(x0, wb, s), lib_fwd,
             bound(nbytes(x0, *wb, *got), 2 * macs, "bfloat16")),
            ("bwd", lambda: kg.g2e_bwd_kernel(*bwd_args), lib_fwd_bwd,
             bound(nbytes(x0, *wb, h3p, amax, stats, dy, grads[0], *grads[1]), 4 * macs,
                   "bfloat16"))):
        ms, lib_ms = cuda_ms(fn, iters=5), cuda_ms(lib, iters=3)
        rec.r[f"g2e_train_{way}"]["ft_cls"] = dict(ms=ms, library_ms=lib_ms, shape=shape, **bnd)
        print(f"  {'g2e_train_' + way:18s} {shape:34s} kernel_ms={ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}, "
              f"{100.0 * bnd['bound_ms'] / ms:.1f}% of it) library_ms={lib_ms:.4f}")
    del x0, dy, got, h3p, amax, stats, bwd_args, grads, lib_fwd, lib_fwd_bwd
    torch.cuda.empty_cache()


# ---------------------------------------------------------- pretrain


def pretrain_batches(cfg, n: int, batch: int):
    """`n` batches from the synthetic ShapeNetRender set (numpy, host)."""
    from vipformer_tpu_torch.data.datasets import ShapeNetRender
    from vipformer_tpu_torch.data.pipeline import Loader, collate_pretrain

    ds = ShapeNetRender(cfg.data_dir, cfg.img_height, cfg.img_width, cfg.num_pt_points,
                        synthetic_size=n * batch)
    return list(Loader(ds, batch, collate_pretrain, shuffle=True, seed=cfg.seed,
                       drop_last=True, num_workers=8))


def pretrain_models(cfg, device):
    from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model

    return {"pc": build_pc_model(cfg, device=device), "img": build_img_model(cfg, device=device)}


def drive_pretrain_path(counts_out: dict, batches) -> None:
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = config()
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    before = [p.detach().clone() for p in state.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = []
    counts = _counted(f"pretrain path: {STEPS} steps", lambda: metrics.extend(
        step(state, batches[i % len(batches)], cfg.lr, gen)[1] for i in range(STEPS)))
    counts_out.update(counts)
    _expect_launched("pretrain", counts, PRETRAIN_COUNTERS)
    _moved_and_finite("pretrain", None, state, before, metrics)


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

    _timed_steps(run, f"pretrain step bf16 B={PRETRAIN_BATCH} ({2 * PRETRAIN_BATCH} clouds + "
                 f"{PRETRAIN_BATCH} images; samples = clouds)", 2 * PRETRAIN_BATCH)


# ------------------------------------------- device augmentation, the loop

AUG_TOL = 1e-5  # the chain on the card against the CPU, of max(1, max |cpu|)
# with a resize in the chain (not on the step's path, which ships images at
# their size): F.interpolate's antialiased bilinear weighs the taps in f32
# on the card, 2.2e-5 of max |cpu| at 137 -> 144 (NVIDIA H100 80GB HBM3)
AUG_RESIZE_TOL = 1e-4
LOOP_BATCHES = 6  # batches of PRETRAIN_BATCH in the pretrain loop's timed epochs
LOOP_PROFILED = 3  # batches in its profiled epoch (a trace's processing takes seconds)


class _Blocked:
    """Within the block, importing any of `names` raises ImportError (their
    sys.modules entries set to None), whether or not they were imported
    before; the entries are restored after."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = {m: sys.modules[m] for m in list(sys.modules)
                      if m.split(".")[0] in self.names}
        for m in self.saved:
            del sys.modules[m]
        for name in self.names:
            sys.modules[name] = None
        return self

    def __exit__(self, *exc):
        for name in self.names:
            del sys.modules[name]
        sys.modules.update(self.saved)
        return False


def check_device_augs_chain() -> None:
    """The `--device_augs` chain (data/augment_device.py) on the card
    against the same functions on the CPU, at the flagship pretrain batch
    (B = 48 clouds of 2,048 points, 144 x 144 uint8 images; and 137 x 137
    images resized to 144 x 144 in the chain), the draws made once on the
    CPU and moved: both views and the images within AUG_TOL of
    max(1, max |cpu|) (the resized ones within AUG_RESIZE_TOL), the
    dropout masks (from the draws, and read from
    the outputs: the points equal to their cloud's first) and the flips
    equal. Then the chain at that batch, drawn on the card: no
    synchronising call (torch.cuda's sync debug mode), its device time and
    launches (profiler) and its events."""
    from vipformer_tpu_torch.data import augment_device as aug

    cfg = config()
    b, n = PRETRAIN_BATCH, cfg.num_pt_points
    rng = np.random.default_rng(SEED + 21)
    pts = torch.from_numpy((rng.standard_normal((b, n, 3))
                            * rng.uniform(0.2, 3.0, (b, 1, 1))).astype(np.float32))
    gen = torch.Generator().manual_seed(SEED + 22)
    draws = [aug.draw_pretrain_view(b, n, gen), aug.draw_pretrain_view(b, n, gen)]
    img_draws = aug.draw_image_chain(b, gen)
    dev = torch.device("cuda")

    def on(d):
        return {k: v.to(dev) for k, v in d.items()}

    def dropped(v):
        return (v == v[:, :1]).all(-1)

    print(f"device augmentation chain, card against CPU (B={b}, {n} points, same draws; "
          f"bound {AUG_TOL:.0e} of max(1, max|cpu|)):")
    for i, d in enumerate(draws):
        cpu = aug.pretrain_view(pts, d)
        card = aug.pretrain_view(pts.to(dev), on(d)).cpu()
        err, rel = rel_err(card, cpu)
        print(f"  point view {i + 1}: max_abs_err={err:.3e} rel={rel:.3e}")
        expect(rel <= AUG_TOL, f"device augmentation: view {i + 1} off the CPU chain")
        mask = aug.input_dropout_mask(d["ratio"], d["u"])
        expect(torch.equal(aug.input_dropout_mask(d["ratio"].to(dev), d["u"].to(dev)).cpu(),
                           mask), f"view {i + 1}: dropout masks differ")
        expect(torch.equal(dropped(card), dropped(cpu))
               and torch.equal(dropped(cpu)[:, 1:], mask[:, 1:]),
               f"view {i + 1}: the dropped points differ")
        print(f"    dropout masks equal; {float(mask.float().mean()):.3f} of the points dropped")
    imgs = {hw: torch.from_numpy(rng.integers(0, 256, (b, *hw, 3)).astype(np.uint8))
            for hw in ((cfg.img_height, cfg.img_width), (137, 137))}
    for hw, x in imgs.items():
        tol = AUG_TOL if hw == (cfg.img_height, cfg.img_width) else AUG_RESIZE_TOL
        cpu = aug.image_pretrain_chain(x, img_draws, cfg.img_height, cfg.img_width)
        card = aug.image_pretrain_chain(x.to(dev), on(img_draws), cfg.img_height,
                                        cfg.img_width).cpu()
        err, rel = rel_err(card, cpu)
        print(f"  images {hw[0]}x{hw[1]} -> {cfg.img_height}x{cfg.img_width}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} (bound {tol:.0e}); flips equal "
              f"({int(img_draws['flip'].sum())} of {b})")
        expect(rel <= tol, f"device augmentation: images {hw} off the CPU chain")
        expect(torch.equal(on(img_draws)["flip"].cpu(), img_draws["flip"]), "flips differ")
    gen_d = torch.Generator(device=dev).manual_seed(SEED)
    raw, u8 = pts.to(dev), imgs[(cfg.img_height, cfg.img_width)].to(dev)
    chains = {"two point views": lambda: aug.pretrain_two_views(raw, gen_d),
              "image chain": lambda: aug.random_image_chain(u8, gen_d)}
    for what, fn in chains.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a synchronising call raises
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ev = _device_events(fn, 3)
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / 3
        launches = sum(e.count for e in ev) / 3
        print(f"  {what} on the card, draws included, a batch of {b}: device time "
              f"{dev_ms:.4f} ms ({launches:.0f} launches, profiler), events "
              f"{cuda_ms(fn):.4f} ms; no synchronising call")


def drive_device_augs_path(counts_out: dict, host_counts: dict) -> None:
    """Three `make_pretrain_step` steps with `device_augs` (B = 48, bf16):
    batches from `ShapeNetRender(raw_views=True)` through the pretrain
    CLI's loader and `prefetch_to_device`, with PIL and h5py unimportable
    meanwhile; every launch count equal to the host-augmented path's
    (phase 6), the losses finite and every parameter moved."""
    from vipformer_tpu_torch.cli.pretrain import train_loader
    from vipformer_tpu_torch.data.pipeline import prefetch_to_device
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = config(device_augs=True, synthetic_size=STEPS * PRETRAIN_BATCH)
    with _Blocked("PIL", "h5py"):
        loader = train_loader(cfg)
        models = pretrain_models(cfg, "cuda")
        state = create_state(cfg, models)
        step = make_pretrain_step(cfg, models["pc"], models["img"])
        before = [p.detach().clone() for p in state.parameters()]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        metrics = []

        def run():
            for batch in prefetch_to_device(iter(loader), "cuda"):
                expect(batch["pc_raw"].is_cuda and batch["imgs"].dtype == torch.uint8,
                       "device_augs: the batch is not raw clouds and uint8 images on the card")
                metrics.append(step(state, batch, cfg.lr, gen)[1])

        counts = _counted(f"device_augs pretrain path: {STEPS} steps", run)
    counts_out.update(counts)
    expect(len(metrics) == STEPS, f"device_augs: {len(metrics)} steps, expected {STEPS}")
    _expect_counts("device_augs pretrain", counts, host_counts)
    _moved_and_finite("device_augs pretrain", None, state, before, metrics)
    print("  PIL and h5py unimportable throughout; counts equal to the host-augmented path's")


def time_pretrain_loop() -> None:
    """The pretrain CLI's loop (`cli.pretrain.run_epoch`: the loader through
    `prefetch_to_device`, one step a batch) over an epoch of LOOP_BATCHES
    batches of B = 48, bf16, the CLI's default loader (no thread pool),
    with host augmentation and with `--device_augs`: the loader's host ms a
    batch alone; the epoch's clouds/s and the step's events a step from
    the end of its first step (the first step and the prefetcher's start
    left out), in two epochs around one with the loader iterated in series
    (no prefetcher) as the reference; a profiled epoch of LOOP_PROFILED
    batches: the device time a step (kernels and copies), the busy share
    (that over the step's events) and the host-to-device copies' device
    time a step (memcpy HtoD)."""
    from vipformer_tpu_torch.cli.pretrain import run_epoch, train_loader
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"pretrain loop (cli.pretrain.run_epoch, prefetch_to_device), {LOOP_BATCHES} batches "
          f"of {PRETRAIN_BATCH}, bf16, on {smi}:")
    models = pretrain_models(config(), "cuda")
    state = create_state(config(), models)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for device_augs in (False, True):
        cfg = config(device_augs=device_augs, synthetic_size=LOOP_BATCHES * PRETRAIN_BATCH)
        what = f"{'device' if device_augs else 'host'} augmentation"
        loader = train_loader(cfg)
        t0 = time.perf_counter()
        n_alone = sum(1 for _ in loader)
        loader_ms = (time.perf_counter() - t0) * 1e3 / n_alone
        step = make_pretrain_step(cfg, models["pc"], models["img"])
        marks = []

        def mark(i, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((time.perf_counter(), ev))

        def steady(n):
            """(clouds/s, host ms a step, events ms a step) from the end of
            the first step to the end of the last."""
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - marks[0][0]
            return (2 * (n - 1) * PRETRAIN_BATCH / wall, wall * 1e3 / (n - 1),
                    marks[0][1].elapsed_time(end) / (n - 1))

        def prefetched(epoch):
            marks.clear()
            loader.set_epoch(epoch)
            sums, n = run_epoch(step, state, loader, cfg.lr, gen, "cuda", mark, 1)
            expect(n == LOOP_BATCHES and np.isfinite(float(sums["loss"])),
                   f"pretrain loop, {what}: {n} steps, loss {float(sums['loss'])}")
            return steady(n)

        def in_series(epoch):
            marks.clear()
            loader.set_epoch(epoch)
            for i, batch in enumerate(loader):
                step(state, batch, cfg.lr, gen)
                mark(i, None)
            return steady(LOOP_BATCHES)

        runs = [prefetched(1), in_series(2), prefetched(3)]
        short = train_loader(cfg.replace(synthetic_size=LOOP_PROFILED * PRETRAIN_BATCH))
        ev = _device_events(lambda: run_epoch(step, state, short, cfg.lr, gen, "cuda"), 1)
        expect(bool(ev), f"pretrain loop, {what}: the trace has no device activity")
        busy = sum(e.self_device_time_total for e in ev) / 1e3 / LOOP_PROFILED
        htod = sum(e.self_device_time_total for e in ev
                   if "Memcpy HtoD" in e.key) / 1e3 / LOOP_PROFILED
        htod_n = sum(e.count for e in ev if "Memcpy HtoD" in e.key) / LOOP_PROFILED
        htod_kinds = ", ".join(sorted({e.key for e in ev if "Memcpy HtoD" in e.key}))
        ms = (runs[0][2] + runs[2][2]) / 2
        print(f"  {what}: " + " and ".join(f"{r[0]:.1f}" for r in runs[::2])
              + " clouds/s (host clock; " + " and ".join(f"{r[1]:.3f}" for r in runs[::2])
              + f" ms a step; step events {runs[0][2]:.3f} and {runs[2][2]:.3f} ms); no "
              f"prefetcher (the loader in series, between them): {runs[1][0]:.1f} clouds/s, "
              f"{runs[1][1]:.3f} ms a step; loader alone {loader_ms:.3f} ms a batch (host); "
              f"device time {busy:.3f} ms a step, {100.0 * busy / ms:.1f}% busy over the "
              f"prefetched steps' events; memcpy HtoD {htod:.4f} ms a step ({htod_n:.0f} "
              f"copies: {htod_kinds})")
        del loader, step
    del models, state
    torch.cuda.empty_cache()


# ------------------------------------------------------------ ft_cls


def ft_config(**over):
    """The flagship classification finetune configuration (scripts/finetune/
    ft-E1CL8SL-H4D256-L128-MR2.sh: B=330, 1024 points, AdamW 1e-3 with
    coswarm, atten_drop 0.1, mlp_drop 0.5, max_dpr 0), as the port's Config.
    Synthetic ModelNet40 and random weights from the seed stand in for the
    dataset and the pretrain checkpoint."""
    kw = dict(num_ft_points=NUM_POINTS, num_test_points=NUM_POINTS, batch_size=FT_BATCH,
              test_batch_size=FT_BATCH, scheduler="coswarm", step_size=100, max_lr=1e-3,
              min_lr=0.0, warm_epochs=5, gamma=0.6, ft_dataset="ModelNet40",
              num_obj_classes=40, modality="imc-only")
    kw.update(over)
    return config(**kw)


def check_ft_cls_kernels(rec: Recorder, route_ms: dict) -> None:
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    d, h, g = 256, 4, 128
    scale = (d // h) ** -0.5
    rows = FT_BATCH * g

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    print(f"finetune kernels K11 and K6 against their twins (ft_cls shapes, B={FT_BATCH}):")
    # K11: every (Cin, Cout) of the step at its rows, and an odd row count
    cases = [(rows, ci, co) for ci, co in DENSE_SITES] + [
        (DENSE_ODD_ROWS, 3, 128), (DENSE_ODD_ROWS, 256, 256)]
    per_step = 0.0
    for r, ci, co in cases:
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dy = t((r, ci), dt), t((r, co), dt)
            dw_k, db_k = kdense.dense_grads(x, dy)
            dw_p, db_p = kdense.dense_grads_plain(x, dy)
            what = f"R={r} {ci}->{co} {dt_name}"
            rec.check("dense_grads", what + " dW", *rel_err(dw_k, dw_p), GRAD_TOL[dt_name])
            rec.check("dense_grads", what + " db", *rel_err(db_k, db_p), GRAD_TOL[dt_name])
            if dt_name != "bfloat16" or r != rows:
                continue
            if (ci, co) in ((256, 256), (3, 128)):  # the tensor-core route: the same bits again
                dw2, db2 = kdense.dense_grads(x, dy)
                expect(torch.equal(dw_k, dw2) and torch.equal(db_k, db2),
                       f"dense_grads {what}: two launches differ")
                print(f"  {'dense_grads':18s} {what}: two launches bitwise equal")
            # device times (queued behind a spin: the wrapper's host cost
            # exceeds the kernel's), the host-bound event times beside them
            ms, _ = _device_timing(
                rec, "dense_grads", f"x[{r},{ci}] dy[{r},{co}] bf16",
                lambda: kdense.dense_grads(x, dy), lambda: (x.t() @ dy, dy.sum(0)),
                cuda_ms(lambda: kdense.dense_grads_plain(x, dy)),
                bound(nbytes(x, dy, dw_k, db_k), 2 * r * ci * co + r * co, dt_name),
                keep=(ci, co) == (256, 256))  # the step's most frequent site
            per_step += ms * DENSE_SITES[(ci, co)]
    rec.r["dense_grads"]["ms_per_step"] = per_step
    print(f"  K11 per ft_cls step (54 launches at the sites' shapes, device time): "
          f"{per_step:.4f} ms")

    # K6 at the eval batch and the serving batch; the route it replaces is
    # the plain LayerNorm, three cuBLAS projections and K5
    def replaced(x, lw, lb, wq, wk, wv):
        xn = kattn.layer_norm_f32(x, lw, lb, x.dtype)
        return kattn.fused_attention_packed_small(xn @ wq, xn @ wk, xn @ wv, num_heads=h,
                                                  scale=scale)

    def k6_args(b, gg, din, dt):
        return (t((b, gg, din), dt), t((din,), scale_=0.2) + 1.0, t((din,), scale_=0.1),
                t((din, d), dt, din ** -0.5), t((din, d), dt, din ** -0.5),
                t((din, d), dt, din ** -0.5))

    with torch.inference_mode():
        # the ends of what the gate admits: one row, and G = 178 at Din = 1024
        # (the bf16 kernel's two-pass mode); both dtypes
        for b, gg, din in ((FT_BATCH, 1, d), (8, 178, 1024)):
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                args = k6_args(b, gg, din, dt)
                rec.check("attn_small_qkv_ln", f"B={b} G={gg} Din={din} {dt_name}",
                          *rel_err(kattn.fused_attention_packed_small_qkv_ln(
                              *args, num_heads=h, scale=scale),
                              kattn.attention_small_qkv_ln_plain(*args, h, scale)),
                          KERNEL_TOL[dt_name])
        for b in (FT_BATCH, 64):
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                args = k6_args(b, g, d, dt)
                out_k = kattn.fused_attention_packed_small_qkv_ln(*args, num_heads=h, scale=scale)
                out_p = kattn.attention_small_qkv_ln_plain(*args, h, scale)
                rec.check("attn_small_qkv_ln", f"B={b} {dt_name}", *rel_err(out_k, out_p),
                          KERNEL_TOL[dt_name])
                if dt_name != "bfloat16":
                    continue
                # the tensor-core route: the same bits again
                expect(torch.equal(out_k, kattn.fused_attention_packed_small_qkv_ln(
                    *args, num_heads=h, scale=scale)), f"K6 B={b} bf16: two launches differ")
                print(f"  {'attn_small_qkv_ln':18s} B={b} bf16: two launches bitwise equal")
                # device times (queued behind a spin), the event times beside
                route_ms[b] = _device_timing(
                    rec, "attn_small_qkv_ln", f"x[{b},{g},{d}] H={h} bf16",
                    lambda: kattn.fused_attention_packed_small_qkv_ln(*args, num_heads=h,
                                                                      scale=scale),
                    lambda: replaced(*args),
                    cuda_ms(lambda: kattn.attention_small_qkv_ln_plain(*args, h, scale)),
                    bound(nbytes(*args, out_k), 2 * b * g * d * 3 * d + 4 * b * g * g * d,
                          dt_name), keep=b == FT_BATCH)


def ft_batches(cfg, split: str):
    """The synthetic ModelNet40 split in batches of B (host numpy): the
    train split shuffled, whole batches; the test split in order, the last
    batch padded (its mask returned beside it)."""
    from vipformer_tpu_torch.data.datasets import ModelNet40SVM
    from vipformer_tpu_torch.data.pipeline import Loader, collate_cls, pad_batch

    ds = ModelNet40SVM(cfg.data_dir, split, cfg.num_ft_points)
    if split == "train":
        return list(Loader(ds, cfg.batch_size, collate_cls, shuffle=True, seed=cfg.seed,
                           drop_last=True))
    return [pad_batch(b, cfg.test_batch_size)
            for b in Loader(ds, cfg.test_batch_size, collate_cls)]


def drive_ft_cls_path(counts_out: dict, eval_counts_out: dict, batches, test_batches) -> None:
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.train.trainer import create_state, make_cls_eval, make_cls_step

    cfg = ft_config()
    model = build_ft_cls(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_cls_step(cfg, model)
    before = [p.detach().clone() for p in state.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = []
    counts = _counted(f"ft_cls path: {FT_STEPS} steps at B={FT_BATCH}", lambda: metrics.extend(
        step(state, batches[i % len(batches)], cfg.lr, gen)[1] for i in range(FT_STEPS)))
    counts_out.update(counts)
    _expect_launched("ft_cls", counts, FT_COUNTERS)
    per_step = sum(DENSE_SITES.values())
    expect(counts["dense_grads"] == per_step * FT_STEPS,
           f"K11 launched {counts['dense_grads']} times, expected {per_step} per step")
    expect(counts["attn_small_qkv_ln"] == 0, "K6 launched in a train step")
    _moved_and_finite("ft_cls", None, state, before, metrics)

    eval_step = make_cls_eval(model)
    batch, mask = test_batches[0]
    out = {}
    counts = _counted(f"ft_cls eval: one forward at B={FT_BATCH}",
                      lambda: out.update(pred=eval_step(batch["points"])))
    pred = out["pred"]
    eval_counts_out.update(counts)
    _expect_launched("ft_cls eval", counts, FT_EVAL_COUNTERS)
    expect(counts["attn_small_qkv_ln"] == cfg.num_sa_layers,
           f"K6 launched {counts['attn_small_qkv_ln']} times, expected {cfg.num_sa_layers}")
    expect(counts["attn_small"] == 0, "K5 launched at B=330 although K6's gate holds")
    expect(tuple(pred.shape) == (FT_BATCH,), f"predictions of shape {tuple(pred.shape)}")
    pred = pred.cpu().numpy()
    expect(bool(((pred >= 0) & (pred < cfg.num_obj_classes)).all()), "labels out of range")
    acc = float((pred[mask] == batch["labels"][mask]).mean())
    print(f"  eval: {int(mask.sum())} test clouds (+{int((~mask).sum())} padding), "
          f"accuracy after {FT_STEPS} steps {acc:.4f}")


def compare_ft_cls_with_cpu(batch, step_batch) -> None:
    """The card's f32 ft_cls path against the plain path on the CPU: same
    weights, dropout 0, FPS from index 0, K11 and K6 forced on both sides
    (the CPU runs their twins), held as the pretrain step is
    (compare_step_with_cpu):

    * on `batch` (B=2): the eval logits (through K6 on the card) within
      STEP_TOL; below the head, where K11 runs, the train-mode backbone
      features and the gradient of every leaf under one fixed cotangent on
      them, within STEP_TOL (Group2Emb's leaves, behind its max pool,
      STEP_G2E_TOL);
    * on `step_batch` (B=8): the step's loss within STEP_TOL and every
      gradient leaf within STEP_HEAD_TOL (Group2Emb's STEP_G2E_TOL). The
      step runs through the finetune head's three batch-statistics
      BatchNorms; over 2 rows each normalises a channel to about +-1
      whatever its input, so the gradient that reaches the backbone comes
      from the few channels whose two rows nearly coincide, and differs in
      its leading digit between any two summation orders (measured: 0.56
      relative, with the loss at 5e-4). Over 8 rows the BatchNorms are
      well conditioned."""
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.train.trainer import create_state, make_cls_step

    cfg = ft_config(compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0)
    pts = torch.from_numpy(batch["points"])
    step_b = len(step_batch["points"])
    cot = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        (len(pts), 2 * cfg.num_latent_channels)).astype(np.float32))

    got: dict = {}
    saved = kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN
    kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = True, True
    try:
        for dev in ("cpu", "cuda"):
            model = build_ft_cls(cfg, device=dev)
            with torch.inference_mode():
                logits, _ = model(pts.to(dev))
            model.train()
            _, feats = model(pts.to(dev))
            (feats * cot.to(dev)).sum().backward()
            below_head = grads_of({"pc": model})
            model = build_ft_cls(cfg, device=dev)
            _, metrics = make_cls_step(cfg, model)(create_state(cfg, {"pc": model}), step_batch,
                                                   cfg.lr)
            got[dev] = dict(logits=logits.cpu(), feats=feats.detach().cpu(), below_head=below_head,
                            loss=float(metrics["loss"]), step=grads_of({"pc": model}))
    finally:
        kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = saved
    cpu, card = got["cpu"], got["cuda"]
    print(f"card f32 vs CPU plain path, ft_cls (B={len(pts)}, full width, K6 and K11 forced):")
    for what, label in (("logits", "eval logits"), ("feats", "train-mode backbone features")):
        err, rel = rel_err(card[what], cpu[what])
        print(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} (bound {STEP_TOL:.0e})")
        expect(rel <= STEP_TOL, f"ft_cls {label} off the CPU path")
    err = abs(card["loss"] - cpu["loss"])
    print(f"  step loss (B={step_b}): card {card['loss']:.6f} cpu {cpu['loss']:.6f} (abs err "
          f"{err:.3e}, bound {STEP_TOL:.0e} relative)")
    expect(err <= STEP_TOL * max(1.0, abs(cpu["loss"])), "ft_cls step loss off the CPU step")
    for what, tol in (("below_head", STEP_TOL), ("step", STEP_HEAD_TOL)):
        expect(set(card[what]) == set(cpu[what]), f"{what}: gradient leaves differ")
        bounds = {k: STEP_G2E_TOL if k.startswith("pc.stem.group2emb.") else tol
                  for k in cpu[what]}
        errs = sorted((rel_err(card[what][k], w)[1] / bounds[k], k)
                      for k, w in cpu[what].items())
        print(f"  {what}: {len(errs)} gradient leaves, bound {tol:.0e} (Group2Emb "
              f"{STEP_G2E_TOL:.0e}); worst error / bound "
              + ", ".join(f"{e:.3f} ({k})" for e, k in errs[:-4:-1]))
        expect(errs[-1][0] <= 1.0, f"ft_cls {what} gradient {errs[-1][1]} off the CPU step")


def time_ft_cls(batches, test_batches, route_ms: dict) -> None:
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.train.trainer import create_state, make_cls_eval, make_cls_step

    cfg = ft_config()
    model = build_ft_cls(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_cls_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    _timed_steps(run, f"ft_cls step bf16 B={FT_BATCH}", FT_BATCH)

    eval_step = make_cls_eval(model)
    points = {b: torch.from_numpy(test_batches[0][0]["points"][:b]).cuda() for b in (64, FT_BATCH)}
    expect_k3_k4_tc(device_kernels(lambda: eval_step(points[FT_BATCH])),
                    f"ft_cls eval bf16 B={FT_BATCH}")
    serving = serving_model("bfloat16", "cuda")
    with torch.inference_mode():
        for b in BATCHES:
            x = torch.randn((b, NUM_POINTS, 3), device="cuda", generator=gen)
            expect_k3_k4_tc(device_kernels(lambda: serving(x)), f"serving forward bf16 B={b}")
    del serving
    saved = kattn.USE_SA_QKV_LN
    try:
        for b in (64, FT_BATCH):
            times = {}  # (events, the kernels' device time) of each route
            for label, flag in (("auto gate", None), ("K6 forced", True),
                                ("LN + 3 cuBLAS + K5", False)):
                kattn.USE_SA_QKV_LN = flag
                run = lambda: eval_step(points[b])  # noqa: E731
                times[label] = (cuda_ms(run, iters=10), kernel_sums(run, 3)[0])
            k6, k5 = route_ms[b]
            auto = times["auto gate"][0]
            print(f"ft_cls eval forward bf16 B={b} ({1000.0 * b / auto:.0f} clouds/s through "
                  f"the auto gate), events / kernels' device time (profiler): " + ", ".join(
                      f"{label} {ev:.3f} / {dev:.3f} ms" for label, (ev, dev) in times.items())
                  + f" (one SA layer on device: K6 {k6:.4f} ms, the replaced route {k5:.4f} ms)")
    finally:
        kattn.USE_SA_QKV_LN = saved


# ------------------------------------------------------- K12, partseg


def check_gather_rows(rec: Recorder) -> None:
    """K12 against its twin: the compat stem's neighbour gather (FPS
    centers and kNN indices of random clouds, [96, 1024, 3] x 4096) in f32
    and bf16, then GATHER_CASES (their first 8 rows of each cloud on one
    point); the gather equal; its VJP (one launch of scatter_sorted_kernel,
    d_points in the table's dtype) within GRAD_TOL of the twin, bitwise
    equal between two launches (one device kernel a call:
    check_vjp_launches, early in the run); both timed at the compat stem's
    gather beside torch.gather and index_add_."""
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import gather as kgather
    from vipformer_tpu_torch.ops.cuda import knn as kknn

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    b, n, g, s = PARTSEG_BATCH, NUM_POINTS, 128, 32
    xyz = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(dev)
    _, centers = kfps.fps(xyz, g)
    stem_idx = kknn.knn(s, xyz, centers).reshape(b, g * s)
    print(f"K12 (row gather, scatter-add backward) against its twin, compat stem "
          f"[{b},{n},3] x {g * s} and {GATHER_CASES}:")
    cases = [(xyz, stem_idx)]
    for cb, cn, cc, ck in GATHER_CASES:
        pts32 = torch.from_numpy(rng.standard_normal((cb, cn, cc)).astype(np.float32)).to(dev)
        idx = rng.integers(0, cn, (cb, ck)).astype(np.int32)
        idx[:, :8] = idx[:, :1]
        cases.append((pts32, torch.from_numpy(idx).to(dev)))
    for pts32, idx in cases:
        cb, cn, cc = pts32.shape
        ck = idx.shape[1]
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            pts = pts32.to(dt)
            what = f"[{cb},{cn},{cc}] K={ck} {dt_name}"
            out_k = kgather.gather_rows_kernel(pts, idx)
            expect(torch.equal(out_k, kgather.gather_rows_plain(pts, idx)),
                   f"K12 gather {what}: differs from the twin")
            rec.check("gather_rows_fwd", f"{what} (equal)", 0.0, 0.0, 0.0)
            grad = torch.from_numpy(rng.standard_normal((cb, ck, cc)).astype(np.float32)).to(dev, dt)
            dp_k = kgather.scatter_rows_kernel(grad, idx, cn)
            expect(dp_k.dtype == dt, f"K12's VJP {what}: d_points {dp_k.dtype}")
            dp_p = kgather.scatter_rows_plain(grad, idx, cn)
            rec.check("gather_rows_bwd", f"{what} d_points", *rel_err(dp_k, dp_p),
                      GRAD_TOL[dt_name])
            check_bwd_bitwise(kgather.scatter_rows_kernel, (grad, idx, cn), "gather_rows_bwd",
                              what)
            if pts32 is not xyz or dt_name != "bfloat16":
                continue
            shape = f"points[{cb},{cn},{cc}] idx[{cb},{ck}] bf16"
            idx64 = idx.long()[..., None].expand(-1, -1, cc)
            kern, plain = (lambda: kgather.gather_rows_kernel(pts, idx),
                           lambda: kgather.gather_rows_plain(pts, idx))
            lib = lambda: torch.gather(pts, 1, idx64)  # noqa: E731
            # at this size a call costs the host more than the card: the
            # device times of the three calls stand beside the events'
            rec.timing("gather_rows_fwd", cuda_ms(kern), cuda_ms(plain),
                       bound(nbytes(pts, idx, out_k), 0, dt_name), cuda_ms(lib), shape=shape)
            dev_ms = {k: device_ms(f) for k, f in (("ms", kern), ("plain_ms", plain),
                                                  ("library_ms", lib))}
            rec.r["gather_rows_fwd"]["device_ms"] = dev_ms
            print(f"  {'gather_rows_fwd':18s} device time per call (queued behind a spin kernel): "
                  + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} not measured"
                              for k, v in dev_ms.items()))
            time_scatter(rec, "gather_rows_bwd", lambda: kgather.scatter_rows_kernel(grad, idx, cn),
                         lambda: kgather.scatter_rows_plain(grad, idx, cn),
                         index_add_call(grad, idx, cn),
                         bound(nbytes(grad, idx, dp_k), grad.numel(), dt_name), shape, record=True)
            rec.r["gather_rows_bwd"]["library_ms"] = rec.r["gather_rows_bwd"]["index_add_ms"]
    print(f"  (K12's phase took {time.perf_counter() - t0:.1f} s)")


def partseg_config(**over):
    """scripts/finetune/ft-partseg.sh as the port's Config: H6D384, 12 SA
    layers, MLP x4, taps 2/6/10, 128 groups of 32 among 1024 points,
    B=96, AdamW 1e-3 with coswarm (5 warm epochs), max_dpr 0.1, no
    dropout, gradient clip 10 (the CLI's default), bf16. The synthetic
    ShapeNetPart and random weights from the seed stand in for the dataset
    and the pretrain checkpoint."""
    from vipformer_tpu_torch.config import Config

    kw = dict(num_latent_channels=384, num_ca_heads=6, num_sa_heads=6, num_sa_layers=12,
              mlp_widen_factor=4, layer_idx=(2, 6, 10), num_pc_latents=128, group_size=32,
              num_ft_points=NUM_POINTS, num_test_points=NUM_POINTS, batch_size=PARTSEG_BATCH,
              test_batch_size=PARTSEG_BATCH, optim="adamw", lr=1e-3, scheduler="coswarm",
              step_size=100, max_lr=1e-3, min_lr=0.0, warm_epochs=5, gamma=0.6, max_dpr=0.1,
              atten_drop=0.0, mlp_drop=0.0, grad_clip_norm=10.0, compute_dtype="bfloat16",
              ft_dataset="ShapeNetPart", synthetic_data=True, seed=SEED)
    kw.update(over)
    return Config(**kw)


def check_partseg_widths(rec: Recorder) -> None:
    """The earlier kernels once at part segmentation's shapes (D=384, 6
    heads, B=96, 1024 points), f32 and bf16, against their twins; K11 at
    its five partseg sites, timed beside cuBLAS plus a column sum."""
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.ops.cuda import flash_train as kf
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg
    from vipformer_tpu_torch.ops.cuda import gather as kgather
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    b, n, g, s, d, h = PARTSEG_BATCH, NUM_POINTS, 128, 32, 384, 6
    scale = (d // h) ** -0.5
    seed = torch.tensor([20240613], dtype=torch.int32, device=dev)

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    print(f"earlier kernels against their twins at partseg widths (B={b}, D={d}, H={h}):")
    xyz = t((b, n, 3))
    _, centers = kfps.fps(xyz, g)
    nn_idx = kknn.knn(s, xyz, centers)
    g2e = init_weights(Group2Emb(3, d), SEED).to(dev).eval()
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol, gtol = KERNEL_TOL[dt_name], GRAD_TOL[dt_name]
        args = (t((b, g, d), dt), t((b, n, d), dt), t((d,), scale_=0.2) + 1.0,
                t((d,), scale_=0.1), t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5))
        qkv = (t((b, g, d), dt), t((b, g, d), dt), t((b, g, d), dt))
        with torch.inference_mode():
            ops = kstem.stem_operands(g2e, xyz, centers, nn_idx, dt)  # K3
            rec.check("stem", f"partseg D={d} {dt_name}",
                      *rel_err(kstem.stem_kernel(*ops), kstem.stem_plain(*ops)), tol)
            rec.check("attn_kv_ln", f"partseg D={d} H={h} {dt_name}",  # K4
                      *rel_err(kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=scale),
                               kattn.attention_kv_ln_plain(*args, h, scale)), tol)
            rec.check("attn_small", f"partseg D={d} H={h} {dt_name}",  # K5
                      *rel_err(kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale),
                               kattn.attention_small_plain(*qkv, h, scale)), tol)
        # K7: the CA of 128 latents over the 1024 point tokens (Din=384)
        do = t((b, g, d), dt)
        out_k, _ = kf.attention_kv_fwd_kernel(*args, seed, h, scale, 0.0)
        out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, 0.0)
        rec.check("attn_train_kv_fwd", f"partseg D={d} H={h} {dt_name}", *rel_err(out_k, out_p),
                  tol)
        bwd_args = (*args, do, lse_p, kf.attention_delta(do, out_p, h), seed, h, scale, 0.0)
        for gname, gk, gp in zip(("dq", "dx", "dln_w", "dln_b", "dwk", "dwv"),
                                 kf.attention_kv_bwd_kernel(*bwd_args),
                                 kf.attention_kv_bwd_plain(*bwd_args)):
            rec.check("attn_train_kv_bwd", f"partseg {dt_name} {gname}", *rel_err(gk, gp), gtol)
        del args, bwd_args, out_k, out_p
        # K8: the SA over the 128 latents, 6 heads
        out_k, _ = kf.attention_fwd_kernel(*qkv, seed, h, scale, 0.0)
        out_p, lse_p = kf.attention_fwd_plain(*qkv, seed, h, scale, 0.0)
        rec.check("attn_train_fwd", f"partseg D={d} H={h} {dt_name}", *rel_err(out_k, out_p), tol)
        bwd_args = (*qkv, do, lse_p, kf.attention_delta(do, out_p, h), seed, h, scale, 0.0)
        for gname, gk, gp in zip(("dq", "dk", "dv"), kf.attention_bwd_kernel(*bwd_args),
                                 kf.attention_bwd_plain(*bwd_args)):
            rec.check("attn_train_bwd", f"partseg {dt_name} {gname}", *rel_err(gk, gp), gtol)
        # K9 at D=384 on the stem's patches
        rows = b * g * s
        x0 = kgather.gather_centered_kernel(xyz.to(dt), centers, nn_idx.reshape(b, -1),
                                            s).reshape(rows, 3)
        wb = [g2e.Dense_0.weight.t(), g2e.Dense_0.bias, t((64,), scale_=0.2) + 1.0,
              t((64,), scale_=0.1), g2e.Dense_1.weight.t(), g2e.Dense_1.bias,
              g2e.Dense_2.weight.t(), g2e.Dense_2.bias, t((256,), scale_=0.2) + 1.0,
              t((256,), scale_=0.1), g2e.Dense_3.weight.t(), g2e.Dense_3.bias]
        wb = [w.detach().float().contiguous() for w in wb]
        got, want = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_plain(x0, wb, s)
        rec.check("g2e_train_fwd", f"partseg D={d} {dt_name} out", *rel_err(got[0], want[0]), tol)
        rec.check("g2e_train_fwd", f"partseg D={d} {dt_name} batch statistics",
                  *rel_err(got[3], want[3]), STATS_TOL)
        _, h3p, amax, stats = want
        bwd_args = (x0, wb, h3p, amax, stats, t((rows // s, d), dt), s)
        dx_k, gr_k = kg.g2e_bwd_kernel(*bwd_args)
        dx_p, gr_p, rss = kg.g2e_bwd_plain(*bwd_args, rss=True)
        rec.check("g2e_train_bwd", f"partseg D={d} {dt_name} dx0", *rel_err(dx_k, dx_p), gtol)
        for i, (a, w) in enumerate(zip(gr_k, gr_p)):
            if i not in ZERO_GRADS:
                rec.check("g2e_train_bwd", f"partseg D={d} {dt_name} grad {i}", *rel_err(a, w),
                          gtol)
        check_zero_grads(rec, "g2e_train_bwd", f"partseg D={d} {dt_name}", gr_k, gr_p, rss,
                         rows, dt)
        del got, want, h3p, bwd_args, dx_k, dx_p
        torch.cuda.empty_cache()
    # K11 at its partseg sites
    rows = b * n
    per_step = 0.0
    for ci, co in PARTSEG_DENSE_SITES:
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dy = t((rows, ci), dt), t((rows, co), dt)
            dw_k, db_k = kdense.dense_grads(x, dy)
            dw_p, db_p = kdense.dense_grads_plain(x, dy)
            what = f"partseg R={rows} {ci}->{co} {dt_name}"
            rec.check("dense_grads", what + " dW", *rel_err(dw_k, dw_p), GRAD_TOL[dt_name])
            rec.check("dense_grads", what + " db", *rel_err(db_k, db_p), GRAD_TOL[dt_name])
            if dt_name != "bfloat16":
                continue
            # device times, as at the ft_cls sites
            ms = queued_ms(lambda: kdense.dense_grads(x, dy), what)
            per_step += ms * PARTSEG_DENSE_SITES[(ci, co)]
            bnd = bound(nbytes(x, dy, dw_k, db_k), 2 * rows * ci * co + rows * co, dt_name)
            print(f"  {'dense_grads':18s} x[{rows},{ci}] dy[{rows},{co}] bf16{'':8s} "
                  f"kernel_ms={ms:.4f} plain_ms={cuda_ms(lambda: kdense.dense_grads_plain(x, dy)):.4f} "
                  f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}, "
                  f"{100.0 * bnd['bound_ms'] / ms:.1f}% of it) library_ms="
                  f"{queued_ms(lambda: (x.t() @ dy, dy.sum(0)), what + ' library'):.4f}")
    rec.r["dense_grads"]["ms_per_partseg_step"] = per_step
    print(f"  K11 per partseg step ({sum(PARTSEG_DENSE_SITES.values())} launches, device time): "
          f"{per_step:.4f} ms")


def partseg_batches(cfg, split: str):
    """The synthetic ShapeNetPart split in batches of B (host numpy): the
    trainval split shuffled, whole batches; the test split in order, the
    last batch padded (its mask beside it)."""
    from vipformer_tpu_torch.data.datasets import ShapeNetPart
    from vipformer_tpu_torch.data.pipeline import Loader, collate_partseg, pad_batch

    ds = ShapeNetPart(cfg.data_dir, split, cfg.num_ft_points)
    if split == "trainval":
        return list(Loader(ds, cfg.batch_size, collate_partseg, shuffle=True, seed=cfg.seed,
                           drop_last=True, num_workers=8))
    return [pad_batch(b, cfg.test_batch_size)
            for b in Loader(ds, cfg.test_batch_size, collate_partseg)]


def drive_partseg_path(counts_out: dict, batches, test_batches) -> None:
    """Three bf16 partseg steps (patch_compat off), one with patch_compat
    on, and one eval forward at B=96 in each mode; each run's launch
    counts into counts_out under its name."""
    from vipformer_tpu_torch.models.factory import build_ft_partseg
    from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step

    per_step = sum(PARTSEG_DENSE_SITES.values())
    for compat in (False, True):
        cfg = partseg_config(patch_compat=compat)
        model = build_ft_partseg(cfg, device="cuda")
        state = create_state(cfg, {"pc": model})
        step = make_partseg_step(cfg, model)
        before = [p.detach().clone() for p in state.parameters()]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        nsteps = 1 if compat else PARTSEG_STEPS
        metrics = []
        name = "ft_partseg compat" if compat else "ft_partseg"
        counts = _counted(f"{name}: {nsteps} step(s) at B={PARTSEG_BATCH}", lambda: metrics.extend(
            step(state, batches[i % len(batches)], cfg.lr, gen)[1] for i in range(nsteps)))
        counts_out[name] = counts
        _expect_launched(name, counts, [c for c in PARTSEG_COUNTERS
                                        if not (compat and c == "gather_centered_fwd")])
        expect(counts["dense_grads"] == per_step * nsteps,
               f"{name}: K11 launched {counts['dense_grads']} times, expected {per_step} per step")
        if compat:
            expect(counts["gather_rows_fwd"] == 1, f"{name}: K12 launched "
                   f"{counts['gather_rows_fwd']} times, expected once")
            expect(counts["gather_centered_fwd"] == 0, f"{name}: K10 launched with compat")
        else:
            expect(counts["gather_rows_fwd"] == 0, f"{name}: K12 launched with compat off")
        expect(counts["gather_rows_bwd"] == 0 and counts["attn_small_qkv_ln"] == 0,
               f"{name}: a kernel off the path launched")
        # the SA layers after the last tap get zero gradients: AdamW only
        # decays them, which leaves their zero-initialised LayerNorm biases
        # at zero; every other tensor moves
        unreached = tuple(f"encoder.sa_{i}." for i in range(max(cfg.layer_idx),
                                                             cfg.num_sa_layers))
        _moved_and_finite(name, model, state, before, metrics,
                          may_stay=lambda k, b: k.startswith(unreached) and not b.any())
        del before, state

        eval_step = make_partseg_eval(model)
        batch, mask = test_batches[0]
        out = {}
        name = "ft_partseg eval compat" if compat else "ft_partseg eval"
        counts = _counted(f"{name}: one forward at B={PARTSEG_BATCH}", lambda: out.update(
            zip(("logits", "refined"), eval_step(batch["points"], batch["obj_labels"]))))
        counts_out[name] = counts
        _expect_launched(name, counts, [c for c in PARTSEG_EVAL_COUNTERS
                                        if not (compat and c == "stem")])
        expect(counts["attn_small"] == cfg.num_sa_layers,
               f"{name}: K5 launched {counts['attn_small']} times, expected {cfg.num_sa_layers}")
        expect(counts["attn_kv_ln"] == 1, f"{name}: K4 launched {counts['attn_kv_ln']} times")
        if compat:
            expect(counts["gather_rows_fwd"] == 1 and counts["stem"] == 0,
                   f"{name}: K12 {counts['gather_rows_fwd']} and K3 {counts['stem']} launches")
        else:
            expect(counts["stem"] == 1 and counts["gather_rows_fwd"] == 0,
                   f"{name}: K3 {counts['stem']} and K12 {counts['gather_rows_fwd']} launches")
        logits, refined = out["logits"], out["refined"].cpu().numpy()
        expect(tuple(logits.shape) == (PARTSEG_BATCH, NUM_POINTS, cfg.num_part_classes),
               f"logits of shape {tuple(logits.shape)}")
        expect(bool(torch.isfinite(logits).all()), "non-finite partseg logits")
        from vipformer_tpu_torch.evaluation.iou import PartSegMetrics
        from vipformer_tpu_torch.train.trainer import category_part_mask

        allowed = category_part_mask()[batch["obj_labels"]]  # [B, 50]
        expect(bool(np.take_along_axis(allowed, refined, axis=1).all()),
               "a refined prediction outside its category's parts")
        metrics = PartSegMetrics()
        metrics.update(refined, batch["seg"], batch["obj_labels"], valid=mask)
        res = metrics.results()
        print(f"  eval: {int(mask.sum())} test clouds (+{int((~mask).sum())} padding): "
              + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
        del model, eval_step
        torch.cuda.empty_cache()


def compare_partseg_with_cpu(eval_batch, step_batch) -> None:
    """The card's f32 partseg path against the plain path on the CPU at full
    width: same weights, dropout, DropPath and the head's dropout 0, FPS
    from index 0, K11 forced on both sides (the CPU runs its twin; at B=8
    the rows lie below the auto window), for both patch_compat settings:
    the eval logits on `eval_batch` (B=2) within STEP_TOL; the step's loss
    on `step_batch` (B=8) within STEP_TOL and every gradient leaf within
    STEP_HEAD_TOL (Group2Emb's STEP_G2E_TOL)."""
    from vipformer_tpu_torch.models.factory import build_ft_partseg
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step

    saved = kdense.USE_DENSE_GRAD
    kdense.USE_DENSE_GRAD = True
    try:
        for compat in (False, True):
            cfg = partseg_config(compute_dtype="float32", max_dpr=0.0, patch_compat=compat)
            got: dict = {}
            for dev in ("cpu", "cuda"):
                model = build_ft_partseg(cfg, device=dev)
                model.seg_head.drop = 0.0
                logits, _ = make_partseg_eval(model)(eval_batch["points"],
                                                     eval_batch["obj_labels"])
                step_grads = {}
                for k, p in model.named_parameters():  # the gradients before the clip
                    p.register_hook(lambda g, k=k: step_grads.__setitem__(k, g.detach().cpu()))
                _, metrics = make_partseg_step(cfg, model)(create_state(cfg, {"pc": model}),
                                                           step_batch, cfg.lr)
                got[dev] = dict(logits=logits.cpu(), loss=float(metrics["loss"]),
                                step=step_grads)
                del model
            cpu, card = got["cpu"], got["cuda"]
            print(f"card f32 vs CPU plain path, partseg (patch_compat {compat}, full width, "
                  f"K11 forced):")
            err, rel = rel_err(card["logits"], cpu["logits"])
            print(f"  eval logits (B={len(eval_batch['points'])}): max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (bound {STEP_TOL:.0e})")
            expect(rel <= STEP_TOL, f"partseg eval logits off the CPU path (compat {compat})")
            err = abs(card["loss"] - cpu["loss"])
            print(f"  step loss (B={len(step_batch['points'])}): card {card['loss']:.6f} cpu "
                  f"{cpu['loss']:.6f} (abs err {err:.3e}, bound {STEP_TOL:.0e} relative)")
            expect(err <= STEP_TOL * max(1.0, abs(cpu["loss"])), "partseg step loss off the CPU")
            expect(set(card["step"]) == set(cpu["step"]), "partseg gradient leaves differ")
            bounds = {k: STEP_G2E_TOL if k.startswith("stem.group2emb.") else STEP_HEAD_TOL
                      for k in cpu["step"]}
            errs = sorted((rel_err(card["step"][k], w)[1] / bounds[k], k)
                          for k, w in cpu["step"].items())
            print(f"  step: {len(errs)} gradient leaves, bound {STEP_HEAD_TOL:.0e} (Group2Emb "
                  f"{STEP_G2E_TOL:.0e}); worst error / bound "
                  + ", ".join(f"{e:.3f} ({k})" for e, k in errs[:-4:-1]))
            expect(errs[-1][0] <= 1.0, f"partseg gradient {errs[-1][1]} off the CPU step")
    finally:
        kdense.USE_DENSE_GRAD = saved


def time_partseg(batches, test_batches) -> None:
    from vipformer_tpu_torch.models.factory import build_ft_partseg
    from vipformer_tpu_torch.train.trainer import create_state, make_partseg_eval, make_partseg_step

    cfg = partseg_config()
    model = build_ft_partseg(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_partseg_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    _timed_steps(run, f"partseg step bf16 B={PARTSEG_BATCH}", PARTSEG_BATCH)
    points = torch.from_numpy(test_batches[0][0]["points"]).cuda()
    obj = torch.from_numpy(test_batches[0][0]["obj_labels"]).cuda()
    for compat in (False, True):
        model.stem.patch_compat = compat
        eval_step = make_partseg_eval(model)
        _timed_steps(lambda n: [eval_step(points, obj) for _ in range(n)],
                     f"partseg eval forward bf16 B={PARTSEG_BATCH} patch_compat {compat}",
                     PARTSEG_BATCH)


# ---------------------------------------------- Perceiver family (--mp false)


def perceiver_config(**over):
    """The flagship pretrain configuration with `--mp false`: the generic
    Perceiver family at the script's widths (D=256, 4 CA and SA heads, MLP
    x2, 128 point and 128 image latents, one SA block of 6 layers, 144x144
    images with 64 Fourier bands: 20,736 tokens of 261 channels), the
    batch cut to 48 as for the mp pretrain phases."""
    return config(**dict(dict(mp=False), **over))


def perceiver_ft_config(**over):
    """ft-E1CL8SL-H4D256-L128-MR2.sh with `--mp false` (B=330, 1024 points,
    atten_drop 0.1, mlp_drop 0.5): the Perceiver classifier."""
    return ft_config(**dict(dict(mp=False), **over))


def check_perceiver_kernels(rec: Recorder) -> None:
    """(a) K13 and K15 against their twins on the card, f32 and bf16, each
    error relative to the twin's own scale (OWN_SCALE), K13 timed with CUDA
    events beside SDPA, K15 on device time beside its PyTorch route
    (`check_packed_kv`); K13's bf16 tensor-core route launched twice
    bitwise equal, and at the image shape with its kv split forced to 1
    (no merge pass) against the planned split, timed at each split; K8
    at the Fourier cross-attention's M = 20,736 (forward and backward, with
    dropout); K5-K8 at the decoder's single query."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import flash_train as kf

    cfg = perceiver_config()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    d, h, g = cfg.num_latent_channels, cfg.num_ca_heads, cfg.num_img_latents
    m_img = cfg.img_height * cfg.img_width
    b = PRETRAIN_BATCH
    scale = (d // h) ** -0.5
    rate = cfg.atten_drop
    seed = torch.tensor([20240613], dtype=torch.int32, device=dev)

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    print("Perceiver kernels K13 and K15 against their twins:")
    with torch.inference_mode():
        # K13: the Fourier cross-attention's shape, an odd M, a single query
        for bb, gg, mm in ((b, g, m_img), (8, 100, 1000), (16, 1, 4096)):
            for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                q, k, v = t((bb, gg, d), dt), t((bb, mm, d), dt), t((bb, mm, d), dt)
                out_k = kattn.fused_attention_packed(q, k, v, num_heads=h, scale=scale)
                out_p = kattn.attention_packed_plain(q, k, v, h, scale)
                rec.check("attn_packed", f"[{bb},{gg}]x[{bb},{mm}] {dt_name}",
                          *rel_err(out_k, out_p, OWN_SCALE), KERNEL_TOL[dt_name])
                if dt_name == "bfloat16":
                    expect(torch.equal(out_k, kattn.fused_attention_packed(
                        q, k, v, num_heads=h, scale=scale)),
                           f"attn_packed [{bb},{gg}]x[{bb},{mm}]: two launches differ")
                if mm == m_img and dt_name == "bfloat16":
                    check_packed_splits(rec, q, k, v, h, scale, out_k)
                    fn = lambda: kattn.fused_attention_packed(q, k, v, num_heads=h, scale=scale)  # noqa: E731
                    rec.timing("attn_packed", cuda_ms(fn, iters=10),
                               cuda_ms(lambda: kattn.attention_packed_plain(q, k, v, h, scale),
                                       iters=3, warmup=1),
                               bound(nbytes(q, k, v, out_k), 4 * bb * gg * mm * d, dt_name),
                               sdpa_ms(q, k, v, h, scale, 0.0),
                               shape=f"q[{bb},{gg},{d}] kv[{bb},{mm},{d}] bf16")
                del q, k, v, out_k, out_p
        check_packed_kv(rec, t)

    print("K8 at the Fourier cross-attention (M = 20,736) and K5-K8 at one query:")
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q, k, v, do = t((b, g, d), dt), t((b, m_img, d), dt), t((b, m_img, d), dt), t((b, g, d), dt)
        out_k, lse_k = kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate)
        out_p, lse_p = kf.attention_fwd_plain(q, k, v, seed, h, scale, rate)
        what = f"M={m_img} {dt_name} p={rate}"
        rec.check("attn_train_fwd", what, *rel_err(out_k, out_p, OWN_SCALE),
                  KERNEL_TOL[dt_name])
        rec.check("attn_train_fwd", what + " lse", *rel_err(lse_k, lse_p, OWN_SCALE),
                  KERNEL_TOL["float32"])
        delta = kf.attention_delta(do, out_p, h)
        bwd_args = (q, k, v, do, lse_p, delta, seed, h, scale, rate)
        for gname, gk, gp in zip(("dq", "dk", "dv"), kf.attention_bwd_kernel(*bwd_args),
                                 kf.attention_bwd_plain(*bwd_args)):
            rec.check("attn_train_bwd", f"{what} {gname}", *rel_err(gk, gp, OWN_SCALE),
                      GRAD_TOL[dt_name])
        if dt_name == "bfloat16":
            check_bwd_bitwise(kf.attention_bwd_kernel, bwd_args, "attn_train_bwd", what)
            ms_f = cuda_ms(lambda: kf.attention_fwd_kernel(q, k, v, seed, h, scale, rate), iters=5)
            ms_b = cuda_ms(lambda: kf.attention_bwd_kernel(*bwd_args), iters=5)
            print(f"  K8 at q[{b},{g},{d}] kv[{b},{m_img},{d}] bf16 p={rate}: forward "
                  f"{ms_f:.4f} ms, backward {ms_b:.4f} ms; SDPA forward "
                  f"{sdpa_ms(q, k, v, h, scale, rate):.4f} ms")
        del q, k, v, do, out_k, out_p, lse_k, lse_p, delta, bwd_args
        torch.cuda.empty_cache()
        # the decoder's single query: K7 (cross-attention over the latents)
        # and K8 (the 1x1 self-attention) in train mode, K5 and K6 in eval
        bq = FT_BATCH
        args = (t((bq, 1, d), dt), t((bq, g, d), dt), t((d,), scale_=0.2) + 1.0,
                t((d,), scale_=0.1), t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5))
        do = t((bq, 1, d), dt)
        out_k, _ = kf.attention_kv_fwd_kernel(*args, seed, h, scale, rate)
        out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, rate)
        rec.check("attn_train_kv_fwd", f"G=1 M={g} {dt_name}", *rel_err(out_k, out_p, OWN_SCALE),
                  KERNEL_TOL[dt_name])
        delta = kf.attention_delta(do, out_p, h)
        bwd = (*args, do, lse_p, delta, seed, h, scale, rate)
        for gname, gk, gp in zip(("dq", "dx", "dln_w", "dln_b", "dwk", "dwv"),
                                 kf.attention_kv_bwd_kernel(*bwd), kf.attention_kv_bwd_plain(*bwd)):
            rec.check("attn_train_kv_bwd", f"G=1 {dt_name} {gname}", *rel_err(gk, gp, OWN_SCALE),
                      GRAD_TOL[dt_name])
        q1, k1, v1, do1 = (t((bq, 1, d), dt) for _ in range(4))
        out_k, _ = kf.attention_fwd_kernel(q1, k1, v1, seed, h, scale, rate)
        out_p, lse_p = kf.attention_fwd_plain(q1, k1, v1, seed, h, scale, rate)
        rec.check("attn_train_fwd", f"1x1 {dt_name}", *rel_err(out_k, out_p, OWN_SCALE),
                  KERNEL_TOL[dt_name])
        bwd = (q1, k1, v1, do1, lse_p, kf.attention_delta(do1, out_p, h), seed, h, scale, rate)
        # over one key the softmax is exactly 1, so dq and dk are exactly 0:
        # each side is the rounding of a cancelling difference, held within
        # the bound absolutely (floor 1), as ZERO_GRADS are; dv at own scale
        for gname, gk, gp in zip(("dq", "dk", "dv"), kf.attention_bwd_kernel(*bwd),
                                 kf.attention_bwd_plain(*bwd)):
            floor = OWN_SCALE if gname == "dv" else 1.0
            rec.check("attn_train_bwd", f"1x1 {dt_name} {gname}", *rel_err(gk, gp, floor),
                      GRAD_TOL[dt_name])
        with torch.inference_mode():
            kv = t((bq, g, d), dt)
            rec.check("attn_small", f"G=1 M={g} {dt_name}",
                      *rel_err(kattn.fused_attention_packed_small(q1, kv, kv, num_heads=h,
                                                                  scale=scale),
                               kattn.attention_small_plain(q1, kv, kv, h, scale), OWN_SCALE),
                      KERNEL_TOL[dt_name])
            six = (q1, args[2], args[3], args[4], args[5], args[4])
            rec.check("attn_small_qkv_ln", f"G=1 {dt_name}",
                      *rel_err(kattn.fused_attention_packed_small_qkv_ln(*six, num_heads=h,
                                                                         scale=scale),
                               kattn.attention_small_qkv_ln_plain(*six, h, scale), OWN_SCALE),
                      KERNEL_TOL[dt_name])


# K15's shapes (B, G, M, Din, H): the point features' self-attention at 512
# latents (the main path's: the cluster kernel), a ragged 300 (its last
# block part-full), 512 queries at Din = 384 (the cluster kernel streams
# Din), then K4's passes: 512 queries over 2,048 tokens (projection, then
# K13's kernel) and one query over 700 at Din = 384 (the double-buffered
# attention pass)
K15_SHAPES = ((PERCEIVER_FEATS_BATCH, PERCEIVER_WIDE_LATENTS, PERCEIVER_WIDE_LATENTS, 256, 4),
              (3, 300, 300, 256, 4), (8, 512, 512, 384, 6), (8, 512, 2048, 256, 4),
              (4, 1, 700, 384, 6))
K15_CLUSTER_KERNEL = "attn_packed_kv_cluster_kernel"


def packed_kv_library(args, h: int, scale: float):
    """K15's function as PyTorch calls (timed beside the kernel, never a
    path of the port): one bf16 cuBLAS product onto [wk | wv] (F.linear)
    and SDPA on the head-split views."""
    import torch.nn.functional as F

    q, x, wk, wv = args
    d = q.shape[-1]
    wkv = torch.cat([wk, wv], 1).t().contiguous()

    def run():
        kv = F.linear(x, wkv)
        return sdpa_call(q, kv[..., :d], kv[..., d:], h, scale)

    return run


def packed_kv_ops(b: int, g: int, m: int, din: int, d: int) -> int:
    """K15's operations: the k and v projections of every token and the
    attention's two products."""
    return 2 * b * m * din * 2 * d + 4 * b * g * m * d


def check_packed_kv(rec: Recorder, t) -> None:
    """K15 against its twin at K15_SHAPES, f32 and bf16, relative to the
    twin's own scale (OWN_SCALE); the bf16 route launched twice, bitwise
    equal, with its plan, and timed on device time beside its PyTorch
    route (`packed_kv_library`), the twin's events and the bound (the JSON
    line keeps the main path's shape); there also K4's passes, against the
    planned kernel, torch.profiler's kernels (the cluster kernel, no
    CUDA-core attn_flash_kernel) and the memory the call allocates (its
    output only: no k or v)."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scale = 64 ** -0.5
    for i, (b, g, m, din, h) in enumerate(K15_SHAPES):
        d = 64 * h
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            args = (t((b, g, d), dt), t((b, m, din), dt), t((din, d), dt, din ** -0.5),
                    t((din, d), dt, din ** -0.5))
            run = lambda: kattn.fused_attention_packed_kv(*args, num_heads=h, scale=scale)  # noqa: E731
            out_k = run()
            out_p = kattn.attention_packed_kv_plain(*args, h, scale)
            shape = f"q[{b},{g},{d}] x[{b},{m},{din}] H={h} {dt_name}"
            rec.check("attn_packed_kv", shape, *rel_err(out_k, out_p, OWN_SCALE),
                      KERNEL_TOL[dt_name])
            if dt_name == "bfloat16":
                expect(torch.equal(out_k, run()), f"attn_packed_kv {shape}: two launches differ")
                cluster, nsplit, psplit = kattn.packed_kv_plan(dt, b, g, m, h, din, sms)
                plan = (f"cluster kernel, clusters of {cluster}"
                        if cluster else f"K4's passes, nsplit {nsplit}, psplit {psplit}")
                print(f"  {'attn_packed_kv':18s} {shape}: {plan}; two launches bitwise equal")
                plain_ms = cuda_ms(lambda: kattn.attention_packed_kv_plain(*args, h, scale),
                                   iters=3, warmup=1)
                _device_timing(rec, "attn_packed_kv", shape, run,
                               packed_kv_library(args, h, scale), plain_ms,
                               bound(nbytes(*args, out_k), packed_kv_ops(b, g, m, din, d), dt_name),
                               keep=i == 0)
                if i == 0:
                    check_packed_kv_main(rec, args, h, scale, out_k)
            del args, out_k, out_p
            torch.cuda.empty_cache()


def check_packed_kv_main(rec: Recorder, args, h: int, scale: float, out_k) -> None:
    """At K15's main shape: K4's passes (forced) against the planned
    kernel within KERNEL_TOL, on device time (a reading); and the device
    memory one call allocates beyond what was allocated before it: the
    output (and the stubs of the unused split and k|v scratch), not a k or
    v tensor. (Its profiler kernels are read at the start of the run,
    `check_k15_kernels`.)"""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    run = lambda: kattn.fused_attention_packed_kv(*args, num_heads=h, scale=scale)  # noqa: E731
    q, x = args[0], args[1]
    saved_plan = kattn.packed_kv_plan
    try:
        kattn.packed_kv_plan = lambda dt, b, g, m, hh, din, sms: (
            0, *kattn.kv_ln_plan(dt, b, g, m, hh, din, sms))
        rec.check("attn_packed_kv", "K4's passes vs the planned",
                  *rel_err(run(), out_k, OWN_SCALE), KERNEL_TOL["bfloat16"])
        passes_ms = queued_ms(run, "K15 on K4's passes")
    finally:
        kattn.packed_kv_plan = saved_plan
    print(f"  {'attn_packed_kv':18s} at the main shape, device ms: K4's passes (projection, "
          f"then K13) {passes_ms:.4f}; planned (the cluster kernel) "
          f"{rec.r['attn_packed_kv']['ms']:.4f}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    b, m, d = x.shape[0], x.shape[1], q.shape[-1]
    kv_bytes = 2 * b * m * d * out.element_size()
    print(f"  {'attn_packed_kv':18s} one call allocates {grew} B (its output {nbytes(out)} B; "
          f"k and v would be {kv_bytes} B)")
    expect(grew < nbytes(out) + (1 << 20), f"K15 bf16 allocated {grew} B: more than its output")
    del out


def check_k15_kernels() -> None:
    """torch.profiler's kernels of one bf16 K15 call at its main shape
    ([64, 512] x [64, 512, 256]): the cluster kernel once, and neither the
    CUDA-core attn_flash_kernel nor K4's passes. Run at the start of the
    script: late in it, traces have come back with no device activity
    (see check_one_pass_launches)."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    b, g, m, din, h = K15_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    q, x = (torch.randn((b, n, c), generator=gen, device="cuda").to(torch.bfloat16)
            for n, c in ((g, 64 * h), (m, din)))
    wk, wv = (torch.randn((din, 64 * h), generator=gen, device="cuda").to(torch.bfloat16)
              * din ** -0.5 for _ in range(2))
    with torch.inference_mode():
        kernels = device_kernels(lambda: kattn.fused_attention_packed_kv(
            q, x, wk, wv, num_heads=h, scale=64 ** -0.5))
    names = list(kernels)
    print(f"K15 bf16 at q[{b},{g}] x[{b},{m},{din}], kernels a call: " + ", ".join(
        f"{k[:90]} {n:.0f}" for k, n in kernels.items()))
    expect(len(names) == 1 and K15_CLUSTER_KERNEL in names[0] and kernels[names[0]] == 1,
           f"K15 bf16: not the cluster kernel alone, once: {kernels}")


def check_packed_splits(rec: Recorder, q, k, v, h: int, scale: float, out_k) -> None:
    """K13's bf16 route at the image shape with its kv split forced to 1
    (one block walks all of M, no merge pass) against the planned split,
    within KERNEL_TOL; each split's time, and the bytes the planned
    split's partial states add (written once, read once by the merge)."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn

    b, g, _ = q.shape
    m = k.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = kattn.packed_splits(v.dtype, b, g, m, h, sms)
    one = kattn.fused_attention_packed_split(q, k, v, num_heads=h, scale=scale, nsplit=1)
    rec.check("attn_packed", f"nsplit 1 vs {planned} bfloat16", *rel_err(one, out_k, OWN_SCALE),
              KERNEL_TOL["bfloat16"])
    times = {n: cuda_ms(lambda n=n: kattn.fused_attention_packed_split(
        q, k, v, num_heads=h, scale=scale, nsplit=n), iters=10) for n in (1, 2, 3, 4, 6, 8)}
    acc, ml = kattn.split_scratch_shapes(b, g, h, planned)
    part = 2 * 4 * (int(np.prod(acc)) + int(np.prod(ml))) if planned > 1 else 0
    print(f"  attn_packed bf16 kv split: planned {planned} on {sms} SMs; ms by split "
          + ", ".join(f"{n}: {t:.4f}" for n, t in times.items())
          + f"; the planned split's partials move {part / 1e6:.1f} MB "
          f"({part / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate)")


def drive_perceiver_pretrain(counts_out: dict, batches) -> None:
    """(b) three bf16 pretrain steps of both Perceiver branches at B=48:
    per step K7 once (the point cross-attention over 2,048 points), K8 13
    times (12 self-attention layers and the Fourier cross-attention at
    M = 20,736) forward and backward, and nothing else."""
    from vipformer_tpu_torch.train.trainer import create_state, make_pretrain_step

    cfg = perceiver_config()
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    before = [p.detach().clone() for p in state.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = []
    counts = _counted(f"perceiver pretrain: {STEPS} steps at B={PRETRAIN_BATCH}", lambda: metrics.extend(
        step(state, batches[i % len(batches)], cfg.lr, gen)[1] for i in range(STEPS)))
    counts_out.update(counts)
    sa = cfg.num_sa_layers_per_block * cfg.num_sa_blocks
    per_step = {"attn_train_kv_fwd": 1, "attn_train_kv_bwd": 1,
                "attn_train_fwd": 2 * sa + 1, "attn_train_bwd": 2 * sa + 1}
    _expect_counts("perceiver pretrain", counts, {k: v * STEPS for k, v in per_step.items()})
    _moved_and_finite("perceiver pretrain", None, state, before, metrics)


def drive_perceiver_ft_cls(counts_out: dict, eval_counts_out: dict, batches, test_batches) -> None:
    """(c) three bf16 ft_cls steps of the Perceiver classifier at B=330 (K7
    at the encoder's and the decoder's single-query cross-attention, K8 at
    the 6 encoder and 2 decoder 1x1 self-attention layers, K11 at the 40
    latent Denses), then one eval forward at B=330 (K4 once, K6 at the 6 +
    2 self-attention layers, K5 once at the decoder's cross-attention)."""
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.train.trainer import create_state, make_cls_eval, make_cls_step

    cfg = perceiver_ft_config()
    model = build_ft_cls(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_cls_step(cfg, model)
    before = [p.detach().clone() for p in state.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    metrics = []
    counts = _counted(f"perceiver ft_cls: {FT_STEPS} steps at B={FT_BATCH}", lambda: metrics.extend(
        step(state, batches[i % len(batches)], cfg.lr, gen)[1] for i in range(FT_STEPS)))
    counts_out.update(counts)
    sa = cfg.num_sa_layers_per_block * cfg.num_sa_blocks
    per_step = {"attn_train_kv_fwd": 2, "attn_train_kv_bwd": 2, "attn_train_fwd": sa + 2,
                "attn_train_bwd": sa + 2, "dense_grads": PERCEIVER_DENSE_PER_STEP}
    _expect_counts("perceiver ft_cls", counts, {k: v * FT_STEPS for k, v in per_step.items()})
    _moved_and_finite("perceiver ft_cls", None, state, before, metrics)

    eval_step = make_cls_eval(model)
    batch, mask = test_batches[0]
    out = {}
    counts = _counted(f"perceiver ft_cls eval: one forward at B={FT_BATCH}",
                      lambda: out.update(pred=eval_step(batch["points"])))
    eval_counts_out.update(counts)
    _expect_counts("perceiver ft_cls eval", counts,
                   {"attn_kv_ln": 1, "attn_small_qkv_ln": sa + 2, "attn_small": 1})
    pred = out["pred"].cpu().numpy()
    expect(pred.shape == (FT_BATCH,), f"predictions of shape {pred.shape}")
    expect(bool(((pred >= 0) & (pred < cfg.num_obj_classes)).all()), "labels out of range")
    print(f"  eval: {int(mask.sum())} test clouds (+{int((~mask).sum())} padding), accuracy "
          f"after {FT_STEPS} steps {float((pred[mask] == batch['labels'][mask]).mean()):.4f}")


def drive_perceiver_feats(counts_out: dict, batches) -> None:
    """(d) make_feats_fn on the Fourier image branch at B=48 (K13 once at
    the cross-attention over 20,736 tokens, K5 at the 6 self-attention
    layers) and on the point branch at 512 latents, B=64 (K4 once, K15 at
    the 6 self-attention layers)."""
    from vipformer_tpu_torch.models.factory import build_img_model, build_pc_model
    from vipformer_tpu_torch.train.trainer import make_feats_fn

    cfg = perceiver_config()
    sa = cfg.num_sa_layers_per_block * cfg.num_sa_blocks
    imgs = batches[0]["imgs"]
    pts = np.concatenate([b["pc_t1"] for b in batches])[:PERCEIVER_FEATS_BATCH]
    runs = (("perceiver feats img", build_img_model(cfg, device="cuda"), imgs,
             {"attn_packed": 1, "attn_small": sa}),
            ("perceiver feats pc512",
             build_pc_model(perceiver_config(num_pc_latents=PERCEIVER_WIDE_LATENTS),
                            device="cuda"), pts, {"attn_kv_ln": 1, "attn_packed_kv": sa}))
    for name, model, x, want in runs:
        feats_fn = make_feats_fn(model)
        out = {}
        counts = _counted(f"{name}: one forward at B={len(x)}", lambda: out.update(f=feats_fn(x)))
        counts_out[name] = counts
        _expect_counts(name, counts, want)
        f = out["f"]
        expect(tuple(f.shape) == (len(x), 2 * cfg.num_latent_channels), f"{name}: {f.shape}")
        expect(bool(torch.isfinite(f).all()), f"{name}: non-finite features")
        print(f"  {name}: features {tuple(f.shape)} finite, mean |f| {f.float().abs().mean():.4f}")


def compare_perceiver_with_cpu(pre_batch, ft_batch) -> None:
    """(e) the card's f32 Perceiver paths against the plain path on the CPU
    at full width, same weights, dropout 0; K11 and K6 forced on both
    sides in the ft_cls comparisons (the CPU runs their twins):

    * the eval features of the point branch (128 and 512 latents: K4 with
      K5 or K15 on the card) and of the Fourier image branch (K13, K5) and
      the ft_cls eval logits, B=2, within STEP_TOL;
    * each branch below its head (B=2): the train-mode backbone features
      and every gradient leaf under one fixed cotangent on them, within
      STEP_TOL (the image branch through K8 at M = 20,736);
    * the pretrain step at B=8 (each cloud and image with its own offset,
      so the heads' batch-statistics BatchNorms are well conditioned) and
      the ft_cls step at B=8: the losses within STEP_TOL, every gradient
      leaf within STEP_HEAD_TOL."""
    from vipformer_tpu_torch.models.factory import build_ft_cls, build_img_model, build_pc_model
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.train.trainer import (
        create_state,
        make_cls_step,
        make_feats_fn,
        make_pretrain_step,
    )

    f32 = dict(compute_dtype="float32", atten_drop=0.0, mlp_drop=0.0)
    cfg = perceiver_config(**f32)
    wide = perceiver_config(num_pc_latents=PERCEIVER_WIDE_LATENTS, **f32)
    ft_cfg = perceiver_ft_config(**f32)
    rng = np.random.default_rng(SEED + 11)
    two = {"pc": pre_batch["pc_t1"][:2], "img": pre_batch["imgs"][:2]}
    cots = {k: torch.from_numpy(rng.standard_normal((2, 2 * cfg.num_latent_channels))
                                .astype(np.float32)) for k in two}
    step_batch = {k: v[:8].copy() for k, v in pre_batch.items()}
    for k in ("pc_t1", "pc_t2"):
        step_batch[k] += rng.standard_normal((8, 1, 3)).astype(np.float32)
    step_batch["imgs"] += 0.5 * rng.standard_normal((8, 1, 1, 3)).astype(np.float32)

    got: dict = {}
    for dev in ("cpu", "cuda"):
        r: dict = {}
        models = {"pc": build_pc_model(cfg, device=dev), "img": build_img_model(cfg, device=dev)}
        r["feats pc"] = make_feats_fn(models["pc"])(two["pc"]).cpu()
        r["feats img"] = make_feats_fn(models["img"])(two["img"]).cpu()
        r["feats pc512"] = make_feats_fn(build_pc_model(wide, device=dev))(two["pc"]).cpu()
        for name, m in models.items():
            m.train()
            _, f = m(torch.from_numpy(two[name]).to(dev))
            (f * cots[name].to(dev)).sum().backward()
            r[f"train feats {name}"] = f.detach().cpu()
        r["below_head"] = grads_of(models)
        models = {"pc": build_pc_model(cfg, device=dev), "img": build_img_model(cfg, device=dev)}
        _, metrics = make_pretrain_step(cfg, models["pc"], models["img"])(
            create_state(cfg, models), step_batch, cfg.lr)
        r["pretrain losses"] = {k: float(v) for k, v in metrics.items()}
        r["pretrain step"] = grads_of(models)
        saved = kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN
        kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = True, True
        try:
            model = build_ft_cls(ft_cfg, device=dev)
            with torch.inference_mode():
                r["ft logits"] = model(torch.from_numpy(ft_batch["points"][:2]).to(dev))[0].cpu()
            _, metrics = make_cls_step(ft_cfg, model)(create_state(ft_cfg, {"pc": model}),
                                                      {k: v[:8] for k, v in ft_batch.items()},
                                                      ft_cfg.lr)
            r["ft_cls losses"] = {"loss": float(metrics["loss"])}
            r["ft_cls step"] = grads_of({"pc": model})
        finally:
            kdense.USE_DENSE_GRAD, kattn.USE_SA_QKV_LN = saved
        got[dev] = r
    cpu, card = got["cpu"], got["cuda"]
    print("card f32 vs CPU plain path, Perceiver (full width, dropout 0):")
    for what in ("feats pc", "feats img", "feats pc512", "train feats pc", "train feats img",
                 "ft logits"):
        err, rel = rel_err(card[what], cpu[what])
        print(f"  {what} (B=2): max_abs_err={err:.3e} rel={rel:.3e} (bound {STEP_TOL:.0e})")
        expect(rel <= STEP_TOL, f"Perceiver {what} off the CPU path")
    for what in ("pretrain losses", "ft_cls losses"):
        for k, v in cpu[what].items():
            err = abs(card[what][k] - v)
            print(f"  {what} {k} (B=8): card {card[what][k]:.6f} cpu {v:.6f} (abs err {err:.3e}, "
                  f"bound {STEP_TOL:.0e} relative)")
            expect(err <= STEP_TOL * max(1.0, abs(v)), f"Perceiver {what} {k} off the CPU step")
    for what, tol in (("below_head", STEP_TOL), ("pretrain step", STEP_HEAD_TOL),
                      ("ft_cls step", STEP_HEAD_TOL)):
        expect(set(card[what]) == set(cpu[what]), f"Perceiver {what}: gradient leaves differ")
        errs = sorted((rel_err(card[what][k], w)[1] / tol, k) for k, w in cpu[what].items())
        print(f"  {what}: {len(errs)} gradient leaves, bound {tol:.0e}; worst error / bound "
              + ", ".join(f"{e:.3f} ({k})" for e, k in errs[:-4:-1]))
        expect(errs[-1][0] <= 1.0, f"Perceiver {what} gradient {errs[-1][1]} off the CPU step")


def time_perceiver(pre_batches, ft_train, ft_test) -> None:
    """(f) the bf16 Perceiver pretrain step (B=48), ft_cls step and eval
    (B=330), and both feature forwards, each with its profiler breakdown."""
    from vipformer_tpu_torch.models.factory import build_ft_cls, build_img_model, build_pc_model
    from vipformer_tpu_torch.train.trainer import (
        create_state,
        make_cls_eval,
        make_cls_step,
        make_feats_fn,
        make_pretrain_step,
    )

    cfg = perceiver_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])

    def pre(n):
        for i in range(n):
            step(state, pre_batches[i % len(pre_batches)], cfg.lr, gen)

    _timed_steps(pre, f"perceiver pretrain step bf16 B={PRETRAIN_BATCH}", 2 * PRETRAIN_BATCH)
    imgs = torch.from_numpy(pre_batches[0]["imgs"]).cuda()
    feats_img = make_feats_fn(models["img"])
    _timed_steps(lambda n: [feats_img(imgs) for _ in range(n)],
                 f"perceiver image feats forward bf16 B={PRETRAIN_BATCH}", PRETRAIN_BATCH)
    del models, state, step
    torch.cuda.empty_cache()
    pts = torch.from_numpy(np.concatenate([b["pc_t1"] for b in pre_batches])
                           [:PERCEIVER_FEATS_BATCH]).cuda()
    feats_wide = make_feats_fn(build_pc_model(
        perceiver_config(num_pc_latents=PERCEIVER_WIDE_LATENTS), device="cuda"))
    _timed_steps(lambda n: [feats_wide(pts) for _ in range(n)],
                 f"perceiver point feats forward, {PERCEIVER_WIDE_LATENTS} latents, bf16 "
                 f"B={PERCEIVER_FEATS_BATCH}", PERCEIVER_FEATS_BATCH)
    ft_cfg = perceiver_ft_config()
    model = build_ft_cls(ft_cfg, device="cuda")
    state = create_state(ft_cfg, {"pc": model})
    step = make_cls_step(ft_cfg, model)

    def ft(n):
        for i in range(n):
            step(state, ft_train[i % len(ft_train)], ft_cfg.lr, gen)

    _timed_steps(ft, f"perceiver ft_cls step bf16 B={FT_BATCH}", FT_BATCH)
    eval_step = make_cls_eval(model)
    test_pts = torch.from_numpy(ft_test[0][0]["points"]).cuda()
    _timed_steps(lambda n: [eval_step(test_pts) for _ in range(n)],
                 f"perceiver ft_cls eval forward bf16 B={FT_BATCH}", FT_BATCH)


# ------------------------------------------------------ K17, K18, semseg


def _colsum_err(got, want, mag) -> tuple[float, float]:
    """(max abs error, max over channels of |got - want| / mag): a column
    sum held against the sum of its terms' magnitudes in that channel,
    which bounds what any summation order can change."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / mag.clamp_min(1e-30)).max().item()


def check_one_pass_launches() -> None:
    """K18's backward is one launch of one kernel (no second pass over its
    split partials, no sum_parts_kernel) at the semseg decode's widest
    BatchNorm in both dtypes, read from torch.profiler's trace. Run early:
    late in the script, right after the Perceiver timings, two traces in a
    row came back without any device event."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn

    r, c = BN_SHAPES[0]
    for dt in (torch.float32, torch.bfloat16):
        x, dy = (torch.randn((r, c), device="cuda").to(dt) for _ in range(2))
        mean, rstd = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        kbn.bn_grad_reduces(x, dy, mean, rstd)  # the first call zeroes the arrival counters
        launched = device_kernels(lambda: kbn.bn_grad_reduces(x, dy, mean, rstd))
        expect(len(launched) == 1 and list(launched.values()) == [1]
               and not any("sum_parts" in k for k in launched),
               f"K18 backward [{r},{c}] {dt}: not one launch of one kernel: {launched}")
        print(f"  {'batchnorm_bwd':18s} [{r},{c}] {dt}: one launch a call (torch.profiler): "
              f"{next(iter(launched))[:60]}")
        del x, dy


def check_norm_kernels(rec: Recorder) -> None:
    """K18's statistics and gradient reduces and K17's forward and backward
    against their twins on the card, each timed with CUDA events beside
    its twin, its bound and one PyTorch call (torch.var_mean,
    native_batch_norm_backward, F.layer_norm forward and backward), K17's
    forward also beside a copy of its input's bytes. Column sums within
    COLSUM_TOL of their channel's sum of magnitudes; y, mu, rsig and dx
    within KERNEL_TOL of the twin's own max; K18's statistics and K17's
    forward bitwise equal between two runs; K17's forward also at
    LN_EDGE_SHAPES."""
    import torch.nn.functional as F

    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def t(shape, dt=torch.float32, scale_=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale_ + shift).to(dt)

    print("norm kernels K18 (BatchNorm reductions) and K17 (LayerNorm) against their twins "
          "(K18's gradient reduces bitwise equal between two runs):")
    for (r, c), label in zip(BN_SHAPES, ("semseg",) * 4 + ("partseg",)):
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dy = t((r, c), dt, 2.0, 0.5), t((r, c), dt)
            what = f"{label} [{r},{c}] {dt_name}"
            s_k, ss_k = kbn.bn_stats(x)
            s_p, ss_p = kbn.bn_stats_plain(x)
            s_k2, ss_k2 = kbn.bn_stats(x)
            expect(torch.equal(s_k, s_k2) and torch.equal(ss_k, ss_k2),
                   f"K18 statistics differ between two runs at {what}")
            xf = x.float()
            rec.check("batchnorm_fwd", what + " sum",
                      *_colsum_err(s_k, s_p, xf.abs().sum(0)), COLSUM_TOL)
            rec.check("batchnorm_fwd", what + " sumsq",
                      *_colsum_err(ss_k, ss_p, (xf * xf).sum(0)), COLSUM_TOL)
            mean = s_p / r
            var = torch.clamp_min(ss_p / r - mean * mean, 0.0)
            rstd = torch.rsqrt(var + 1e-5)
            ds_k, db_k = kbn.bn_grad_reduces(x, dy, mean, rstd)
            ds_p, db_p = kbn.bn_grad_reduces_plain(x, dy, mean, rstd)
            ds_k2, db_k2 = kbn.bn_grad_reduces(x, dy, mean, rstd)
            expect(torch.equal(ds_k, ds_k2) and torch.equal(db_k, db_k2),
                   f"K18 gradient reduces differ between two runs at {what}")
            dyf = dy.float()
            rec.check("batchnorm_bwd", what + " dscale",
                      *_colsum_err(ds_k, ds_p, (dyf * (xf - mean) * rstd).abs().sum(0)),
                      COLSUM_TOL)
            rec.check("batchnorm_bwd", what + " dbias",
                      *_colsum_err(db_k, db_p, dyf.abs().sum(0)), COLSUM_TOL)
            del xf, dyf
            if dt_name == "bfloat16":
                w = torch.ones(c, device=dev)
                calls = dict(
                    fwd=(lambda: kbn.bn_stats(x), lambda: torch.var_mean(x, 0, correction=0),
                         cuda_ms(lambda: kbn.bn_stats_plain(x)),
                         bound(nbytes(x, s_k, ss_k), 3 * r * c, "float32")),
                    bwd=(lambda: kbn.bn_grad_reduces(x, dy, mean, rstd),
                         lambda: torch.ops.aten.native_batch_norm_backward(
                             dy, x, w, None, None, mean, rstd, True, 1e-5, [False, True, True]),
                         cuda_ms(lambda: kbn.bn_grad_reduces_plain(x, dy, mean, rstd)),
                         bound(nbytes(x, dy, mean, rstd, ds_k, db_k), 5 * r * c, "float32")))
                for way, call in calls.items():
                    _device_timing(rec, f"batchnorm_{way}", f"{label} [{r},{c}] bf16", *call,
                                   keep=(r, c) == BN_SHAPES[0])
            del x, dy
        torch.cuda.empty_cache()
    for r, d, dts in LN_SHAPES:
        for dt_name in dts:
            dt = getattr(torch, dt_name)
            x, dy = t((r, d), dt, 2.0, 0.5), t((r, d), dt)
            s, b = t((d,), scale_=0.2, shift=1.0), t((d,), scale_=0.1)
            what = f"[{r},{d}] {dt_name}"
            (y_k, mu_k, rs_k), (_, mu_p, rs_p) = check_ln_fwd(rec, kln, x, s, b, what)
            dx_k, ds_k, db_k = kln.ln_bwd(x, dy, mu_p, rs_p, s)
            dx_p, ds_p, db_p = kln.ln_bwd_plain(x, dy, mu_p, rs_p, s)
            again = kln.ln_bwd(x, dy, mu_p, rs_p, s)
            expect(all(torch.equal(a, b) for a, b in zip((dx_k, ds_k, db_k), again)),
                   f"K17 backward {what}: two runs differ")
            del again
            rec.check("layernorm_bwd", what + " dx", *rel_err(dx_k, dx_p, OWN_SCALE),
                      KERNEL_TOL[dt_name])
            dyf = dy.float()
            xhat = (x.float() - mu_p[:, None]) * rs_p[:, None]
            rec.check("layernorm_bwd", what + " dscale",
                      *_colsum_err(ds_k, ds_p, (dyf * xhat).abs().sum(0)), COLSUM_TOL)
            rec.check("layernorm_bwd", what + " dbias",
                      *_colsum_err(db_k, db_p, dyf.abs().sum(0)), COLSUM_TOL)
            del dyf, xhat
            if dt_name == "bfloat16":
                shape = f"[{r},{d}] bf16"
                # F.layer_norm takes its parameters in the input's dtype
                sl, bl = s.to(dt), b.to(dt)
                xg = x.detach().clone().requires_grad_()
                sg, bg = sl.clone().requires_grad_(), bl.clone().requires_grad_()
                yl = F.layer_norm(xg, (d,), sg, bg, kcuda.LN_EPS)
                calls = dict(
                    fwd=(lambda: kln.ln_fwd(x, s, b),
                         lambda: F.layer_norm(x, (d,), sl, bl, kcuda.LN_EPS),
                         cuda_ms(lambda: kln.ln_fwd_plain(x, s, b)),
                         bound(nbytes(x, s, b, y_k, mu_k, rs_k), 7 * r * d, "float32")),
                    bwd=(lambda: kln.ln_bwd(x, dy, mu_p, rs_p, s),
                         lambda: torch.autograd.grad(yl, (xg, sg, bg), dy, retain_graph=True),
                         cuda_ms(lambda: kln.ln_bwd_plain(x, dy, mu_p, rs_p, s)),
                         bound(nbytes(x, dy, mu_p, rs_p, s, dx_k, ds_k, db_k), 12 * r * d,
                               "float32")))
                for way, call in calls.items():
                    _device_timing(rec, f"layernorm_{way}", shape, *call,
                                   keep=(r, d) == LN_TIMED)
                # the floor at this size: a copy of the same bytes
                yc = torch.empty_like(x)
                print(f"  {'layernorm_fwd':18s} {shape:34s} the same bytes copied (yc.copy_(x)): "
                      f"device time {queued_ms(lambda: yc.copy_(x), 'copy'):.4f} ms")
                del xg, yl, yc
            del x, dy, y_k, dx_k, dx_p
        torch.cuda.empty_cache()
    for r, d in LN_EDGE_SHAPES:
        for dt_name in ("float32", "bfloat16"):
            x = t((r, d), getattr(torch, dt_name), 2.0, 0.5)
            s, b = t((d,), scale_=0.2, shift=1.0), t((d,), scale_=0.1)
            lanes, vec, nv, rows, staged = kln.fwd_plan(d, x.element_size(), x.data_ptr())
            check_ln_fwd(rec, kln, x, s, b, f"[{r},{d}] {dt_name} ({'staged, ' * staged}"
                         f"{lanes} lanes x {nv} vectors of {vec}, {rows} rows a block)")
            del x


def check_ln_fwd(rec: Recorder, kln, x, s, b, what: str):
    """K17's forward against its twin (y, mu, rsig within KERNEL_TOL of the
    twin's own max) and bitwise equal between two runs; returns the
    kernel's (y, mu, rsig) and the twin's."""
    got = kln.ln_fwd(x, s, b)
    want = kln.ln_fwd_plain(x, s, b)
    expect(all(torch.equal(a, c) for a, c in zip(got, kln.ln_fwd(x, s, b))),
           f"K17 forward {what}: two runs differ")
    for name, k, p, tol in zip(("y", "mu", "rsig"), got, want,
                               (KERNEL_TOL[str(x.dtype).removeprefix("torch.")],
                                KERNEL_TOL["float32"], KERNEL_TOL["float32"])):
        rec.check("layernorm_fwd", f"{what} {name}", *rel_err(k, p, OWN_SCALE), tol)
    return got, want


def semseg_config(**over):
    """scripts/finetune/ft-semseg.sh as the port's Config: H6D384, 12 SA
    layers, MLP x4, taps 2/6/10, 128 groups of 32 among 4,096 xyz+rgb
    points, 13 classes, B=32, AdamW 1e-3 with the cosine schedule,
    max_dpr 0.1, no dropout, bf16. The synthetic S3DIS and random weights
    from the seed stand in for the blocks and the pretrain checkpoint."""
    from vipformer_tpu_torch.config import Config

    kw = dict(num_latent_channels=384, num_ca_heads=6, num_sa_heads=6, num_sa_layers=12,
              mlp_widen_factor=4, layer_idx=(2, 6, 10), num_pc_latents=128, group_size=32,
              point_channels=6, num_obj_classes=13, num_ft_points=SEMSEG_POINTS,
              batch_size=SEMSEG_BATCH, test_batch_size=SEMSEG_BATCH, test_area=5,
              optim="adamw", lr=1e-3, scheduler="cos", max_dpr=0.1, atten_drop=0.0,
              mlp_drop=0.0, compute_dtype="bfloat16", ft_dataset="S3DIS", synthetic_data=True,
              seed=SEED)
    kw.update(over)
    return Config(**kw)


def check_semseg_widths(rec: Recorder) -> None:
    """The earlier kernels once at semantic segmentation's shapes (B=32
    clouds of 4,096 xyz+rgb points, D=384, 6 heads), f32 and bf16, against
    their twins: K1 and K2 at N = 4,096, K10 carrying rgb uncentered, K9 at
    Cin = 6, K7 over 4,096 point tokens, K8 over the 128 latents, K11 at
    its five semseg sites (131,072 rows); the eval's K3 at N = 4,096 and
    C = 6 (the limit of its gate), K4 at M = 4,096 and K5 at B = 32."""
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.ops.cuda import flash_train as kf
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg
    from vipformer_tpu_torch.ops.cuda import gather as kgather
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import stem as kstem

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 13)
    b, n, g, s, d, h, c = SEMSEG_BATCH, SEMSEG_POINTS, 128, 32, 384, 6, 6
    scale = (d // h) ** -0.5
    seed = torch.tensor([20240613], dtype=torch.int32, device=dev)

    def t(shape, dt=torch.float32, scale_=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale_).astype(np.float32)).to(dev, dt)

    print(f"earlier kernels against their twins at semseg widths (B={b}, N={n}, C={c}, D={d}):")
    pts = torch.from_numpy(rng.uniform(0, 1, (b, n, c)).astype(np.float32)).to(dev)
    start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(dev)
    idx_k, cen_k = kfps.fps(pts, g, start)  # K1 over the xyz of 4,096 points
    idx_p, cen_p = kfps.fps_plain(pts[..., :3].contiguous(), g, start)
    expect(torch.equal(idx_k, idx_p) and torch.equal(cen_k, cen_p), "K1 at N=4096 differs")
    rec.check("fps", f"semseg N={n} (equal)", 0.0, 0.0, 0.0)
    nn_k = kknn.knn(s, pts[..., :3], cen_k)  # K2
    nn_p = kknn.knn_plain(s, pts[..., :3].contiguous(), cen_k)
    expect(torch.equal(nn_k, nn_p), "K2 at N=4096 differs")
    rec.check("knn", f"semseg N={n} K={s} (equal)", 0.0, 0.0, 0.0)
    centers = torch.gather(pts, 1, idx_k.long()[..., None].expand(-1, -1, c))  # all 6 channels
    flat = nn_k.reshape(b, -1)
    g2e = init_weights(Group2Emb(c, d), SEED).to(dev).eval()
    with torch.no_grad():  # nontrivial eval statistics for K3's folds
        for bn in (g2e.BatchNorm_0, g2e.BatchNorm_1):
            bn.running_mean.uniform_(-0.1, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tol, gtol = KERNEL_TOL[dt_name], GRAD_TOL[dt_name]
        # K10: xyz centered, rgb carried as it is
        out_k = kgather.gather_centered_kernel(pts.to(dt), centers, flat, s)
        expect(torch.equal(out_k, kgather.gather_centered_plain(pts.to(dt), centers, flat, s)),
               f"K10 at C={c} {dt_name} differs")
        rec.check("gather_centered_fwd", f"semseg C={c} {dt_name} (equal)", 0.0, 0.0, 0.0)
        if dt_name == "bfloat16":
            time_k10_device(kgather, pts.to(dt), centers, flat, s,
                            f"semseg points[{b},{n},{c}] idx[{b},{flat.shape[1]}] bf16")
        # K9 at Cin = 6 on those patches
        rows = b * g * s
        x0 = out_k.reshape(rows, c)
        wb = [g2e.Dense_0.weight.t(), g2e.Dense_0.bias, t((64,), scale_=0.2) + 1.0,
              t((64,), scale_=0.1), g2e.Dense_1.weight.t(), g2e.Dense_1.bias,
              g2e.Dense_2.weight.t(), g2e.Dense_2.bias, t((256,), scale_=0.2) + 1.0,
              t((256,), scale_=0.1), g2e.Dense_3.weight.t(), g2e.Dense_3.bias]
        wb = [w.detach().float().contiguous() for w in wb]
        got, want = kg.g2e_fwd_kernel(x0, wb, s), kg.g2e_fwd_plain(x0, wb, s)
        rec.check("g2e_train_fwd", f"semseg Cin={c} {dt_name} out", *rel_err(got[0], want[0]),
                  tol)
        rec.check("g2e_train_fwd", f"semseg Cin={c} {dt_name} batch statistics",
                  *rel_err(got[3], want[3]), STATS_TOL)
        _, h3p, amax, stats = want
        bwd_args = (x0, wb, h3p, amax, stats, t((rows // s, d), dt), s)
        dx_k, gr_k = kg.g2e_bwd_kernel(*bwd_args)
        dx_p, gr_p, rss = kg.g2e_bwd_plain(*bwd_args, rss=True)
        # a second run gives the same bits (its column partials span D = 384)
        dx_k2, gr_k2 = kg.g2e_bwd_kernel(*bwd_args)
        expect(torch.equal(dx_k, dx_k2) and all(map(torch.equal, gr_k, gr_k2)),
               f"K9 backward at D={d} differs between two runs")
        rec.check("g2e_train_bwd", f"semseg Cin={c} {dt_name} dx0", *rel_err(dx_k, dx_p), gtol)
        for i, (a, w) in enumerate(zip(gr_k, gr_p)):
            if i not in ZERO_GRADS:
                rec.check("g2e_train_bwd", f"semseg Cin={c} {dt_name} grad {i}", *rel_err(a, w),
                          gtol)
        check_zero_grads(rec, "g2e_train_bwd", f"semseg Cin={c} {dt_name}", gr_k, gr_p, rss,
                         rows, dt)
        del out_k, x0, got, want, h3p, amax, bwd_args, dx_k, dx_p, gr_k, gr_p, dx_k2, gr_k2
        # K7: the CA of 128 latents over the 4,096 point tokens (Din=384)
        args = (t((b, g, d), dt), t((b, n, d), dt), t((d,), scale_=0.2) + 1.0,
                t((d,), scale_=0.1), t((d, d), dt, d ** -0.5), t((d, d), dt, d ** -0.5))
        do = t((b, g, d), dt)
        out_k, _ = kf.attention_kv_fwd_kernel(*args, seed, h, scale, 0.0)
        out_p, lse_p = kf.attention_kv_fwd_plain(*args, seed, h, scale, 0.0)
        rec.check("attn_train_kv_fwd", f"semseg M={n} Din={d} {dt_name}", *rel_err(out_k, out_p),
                  tol)
        bwd_args = (*args, do, lse_p, kf.attention_delta(do, out_p, h), seed, h, scale, 0.0)
        for gname, gk, gp in zip(("dq", "dx", "dln_w", "dln_b", "dwk", "dwv"),
                                 kf.attention_kv_bwd_kernel(*bwd_args),
                                 kf.attention_kv_bwd_plain(*bwd_args)):
            rec.check("attn_train_kv_bwd", f"semseg M={n} {dt_name} {gname}", *rel_err(gk, gp),
                      gtol)
        with torch.inference_mode():  # K4: the same CA in eval
            rec.check("attn_kv_ln", f"semseg M={n} Din={d} {dt_name}",
                      *rel_err(kattn.fused_attention_packed_kv_ln(*args, num_heads=h, scale=scale),
                               kattn.attention_kv_ln_plain(*args, h, scale)), tol)
        del args, bwd_args, out_k, out_p
        # K8 (train) and K5 (eval): the SA over the 128 latents of 32 clouds
        qkv = (t((b, g, d), dt), t((b, g, d), dt), t((b, g, d), dt))
        out_k, _ = kf.attention_fwd_kernel(*qkv, seed, h, scale, 0.0)
        out_p, lse_p = kf.attention_fwd_plain(*qkv, seed, h, scale, 0.0)
        rec.check("attn_train_fwd", f"semseg B={b} D={d} {dt_name}", *rel_err(out_k, out_p), tol)
        bwd_args = (*qkv, do, lse_p, kf.attention_delta(do, out_p, h), seed, h, scale, 0.0)
        for gname, gk, gp in zip(("dq", "dk", "dv"), kf.attention_bwd_kernel(*bwd_args),
                                 kf.attention_bwd_plain(*bwd_args)):
            rec.check("attn_train_bwd", f"semseg B={b} {dt_name} {gname}", *rel_err(gk, gp),
                      gtol)
        with torch.inference_mode():
            rec.check("attn_small", f"semseg B={b} D={d} {dt_name}",
                      *rel_err(kattn.fused_attention_packed_small(*qkv, num_heads=h, scale=scale),
                               kattn.attention_small_plain(*qkv, h, scale)), tol)
            # K3: the eval stem over 4,096 xyz+rgb points
            ops = kstem.stem_operands(g2e, pts, centers, nn_k, dt)
            rec.check("stem", f"semseg N={n} C={c} {dt_name}",
                      *rel_err(kstem.stem_kernel(*ops), kstem.stem_plain(*ops)), tol)
        del qkv, bwd_args, out_k, out_p, ops
        torch.cuda.empty_cache()
    # K11 at its semseg sites
    rows = b * n
    for ci, co in SEMSEG_DENSE_SITES:
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dy = t((rows, ci), dt), t((rows, co), dt)
            dw_k, db_k = kdense.dense_grads(x, dy)
            dw_p, db_p = kdense.dense_grads_plain(x, dy)
            what = f"semseg R={rows} {ci}->{co} {dt_name}"
            rec.check("dense_grads", what + " dW", *rel_err(dw_k, dw_p), GRAD_TOL[dt_name])
            rec.check("dense_grads", what + " db", *rel_err(db_k, db_p), GRAD_TOL[dt_name])
            del x, dy


def semseg_batches(cfg, split: str):
    """The synthetic S3DIS split's xyz+rgb in batches of B (host numpy): the
    train split shuffled, whole batches; the test split in order, the last
    batch padded (its mask beside it)."""
    from vipformer_tpu_torch.cli.ft_semseg import _SliceChannels
    from vipformer_tpu_torch.data.datasets import S3DIS
    from vipformer_tpu_torch.data.pipeline import Loader, collate_semseg, pad_batch

    ds = _SliceChannels(S3DIS(cfg.data_dir, split, cfg.test_area), cfg.point_channels)
    if split == "train":
        return list(Loader(ds, cfg.batch_size, collate_semseg, shuffle=True, seed=cfg.seed,
                           drop_last=True, num_workers=8))
    return [pad_batch(b, cfg.test_batch_size)
            for b in Loader(ds, cfg.test_batch_size, collate_semseg)]


def _forced_norms(on: bool):
    """Force K17 and K18 on (on=True) or leave them at their auto default;
    returns the flags as they were."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    saved = (kbn.USE_BN_TRAIN, kln.USE_LAYERNORM)
    kbn.USE_BN_TRAIN = kln.USE_LAYERNORM = True if on else None
    return saved


def _restore_norms(saved) -> None:
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln

    kbn.USE_BN_TRAIN, kln.USE_LAYERNORM = saved


def drive_semseg_path(counts_out: dict, batches, test_batches) -> None:
    """Three bf16 semseg steps with the default flags and three with K17
    and K18 forced (each from a fresh model), then one eval forward at
    B=32; every counter held to its exact count (SEMSEG_STEP_COUNTS,
    SEMSEG_FORCED_COUNTS, SEMSEG_EVAL_COUNTS)."""
    from vipformer_tpu_torch.evaluation.iou import semseg_miou
    from vipformer_tpu_torch.models.factory import build_ft_semseg
    from vipformer_tpu_torch.train.trainer import create_state, make_semseg_eval, make_semseg_step

    cfg = semseg_config()
    for forced in (False, True):
        name = "ft_semseg forced" if forced else "ft_semseg"
        saved = _forced_norms(forced)
        try:
            model = build_ft_semseg(cfg, device="cuda")
            state = create_state(cfg, {"pc": model})
            step = make_semseg_step(cfg, model)
            before = [p.detach().clone() for p in state.parameters()]
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            metrics = []
            counts = _counted(f"{name}: {SEMSEG_STEPS} steps at B={SEMSEG_BATCH}",
                              lambda: metrics.extend(
                                  step(state, batches[i % len(batches)], cfg.lr, gen)[1]
                                  for i in range(SEMSEG_STEPS)))
        finally:
            _restore_norms(saved)
        counts_out[name] = counts
        want = dict(SEMSEG_STEP_COUNTS, **(SEMSEG_FORCED_COUNTS if forced else {}))
        _expect_counts(name, counts, {k: v * SEMSEG_STEPS for k, v in want.items()})
        unreached = tuple(f"encoder.sa_{i}." for i in range(max(cfg.layer_idx),
                                                             cfg.num_sa_layers))
        _moved_and_finite(name, model, state, before, metrics,
                          may_stay=lambda k, b: k.startswith(unreached) and not b.any())
        del before, state
    eval_step = make_semseg_eval(model)
    batch, mask = test_batches[0]
    out = {}
    counts = _counted(f"ft_semseg eval: one forward at B={SEMSEG_BATCH}",
                      lambda: out.update(pred=eval_step(batch["points"])))
    counts_out["ft_semseg eval"] = counts
    _expect_counts("ft_semseg eval", counts, SEMSEG_EVAL_COUNTS)
    pred = out["pred"].cpu().numpy()
    expect(pred.shape == (SEMSEG_BATCH, SEMSEG_POINTS), f"predictions of shape {pred.shape}")
    expect(bool(((pred >= 0) & (pred < cfg.num_obj_classes)).all()), "classes out of range")
    res = semseg_miou(pred[mask], batch["seg"][mask])
    print(f"  eval: {int(mask.sum())} test blocks (+{int((~mask).sum())} padding): "
          + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
    del model, eval_step
    torch.cuda.empty_cache()


def _semseg_step_f32(cfg, init_state, batch, device, forced: bool):
    """One f32 semseg step from `init_state` (head dropout 0): (loss, every
    parameter's gradient, the running statistics after it), on the host."""
    from vipformer_tpu_torch.models.factory import build_ft_semseg
    from vipformer_tpu_torch.train.trainer import create_state, make_semseg_step

    saved = _forced_norms(forced)
    try:
        model = build_ft_semseg(cfg, device=device)
        model.load_state_dict(init_state)
        model.seg_head.drop = 0.0
        grads = {}
        for k, p in model.named_parameters():
            p.register_hook(lambda g, k=k: grads.__setitem__(k, g.detach().cpu()))
        _, metrics = make_semseg_step(cfg, model)(create_state(cfg, {"pc": model}), batch, cfg.lr)
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items() if "running_" in k}
        return float(metrics["loss"]), grads, stats
    finally:
        _restore_norms(saved)


def _worst(name: str, got: dict, want: dict, bounds) -> None:
    expect(set(got) == set(want), f"{name}: leaves differ")
    errs = sorted((rel_err(got[k], w)[1] / bounds(k), k) for k, w in want.items())
    print(f"  {name}: {len(errs)} leaves; worst error / bound "
          + ", ".join(f"{e:.3f} ({k})" for e, k in errs[:-4:-1]))
    expect(errs[-1][0] <= 1.0, f"{name}: {errs[-1][1]} off")


def compare_semseg_forced(step_batch) -> None:
    """One f32 step at B=8 with K17 and K18 forced against one with the
    default flags, on the card, from the same state and batch (head
    dropout and DropPath 0, FPS from index 0): the loss within 1e-5
    relative; the gradients that reach no batch-statistics BatchNorm's dx
    (the head's last Dense and last BatchNorm) within STEP_TOL, every other
    within STEP_HEAD_TOL; the running statistics within 1e-5."""
    from vipformer_tpu_torch.models.factory import build_ft_semseg

    cfg = semseg_config(compute_dtype="float32", max_dpr=0.0)
    init = {k: v.clone() for k, v in build_ft_semseg(cfg, device="cuda").state_dict().items()}
    base = _semseg_step_f32(cfg, init, step_batch, "cuda", False)
    forced = _semseg_step_f32(cfg, init, step_batch, "cuda", True)
    print(f"semseg step, K17 and K18 forced vs default (card, f32, B={len(step_batch['points'])}):")
    err = abs(forced[0] - base[0])
    print(f"  loss: forced {forced[0]:.7f} default {base[0]:.7f} (abs err {err:.3e}, bound 1e-05 "
          "relative)")
    expect(err <= 1e-5 * abs(base[0]), "forced semseg loss off the default step's")
    _worst("gradients", forced[1], base[1], lambda k: STEP_TOL if k.startswith(
        ("seg_head.Dense_2.", "seg_head.BatchNorm_1.")) else STEP_HEAD_TOL)
    _worst("running statistics", forced[2], base[2], lambda k: 1e-5)


def compare_semseg_with_cpu(eval_batch, step_batch) -> None:
    """The card's f32 semseg path against the plain path on the CPU at full
    width (same weights, head dropout and DropPath 0, FPS from index 0, K11
    forced on both sides): the eval logits at B=2 within STEP_TOL; the
    step's loss at B=8 within STEP_TOL and every gradient leaf within
    STEP_HEAD_TOL (Group2Emb's STEP_G2E_TOL), as the partseg phase."""
    from vipformer_tpu_torch.models.factory import build_ft_semseg
    from vipformer_tpu_torch.ops.cuda import dense as kdense

    cfg = semseg_config(compute_dtype="float32", max_dpr=0.0)
    saved = kdense.USE_DENSE_GRAD
    kdense.USE_DENSE_GRAD = True
    try:
        init = build_ft_semseg(cfg, device="cpu").state_dict()
        got = {}
        for dev in ("cpu", "cuda"):
            model = build_ft_semseg(cfg, device=dev)
            model.load_state_dict(init)
            with torch.inference_mode():
                logits = model(torch.from_numpy(eval_batch["points"]).to(dev)).cpu()
            got[dev] = (logits,) + _semseg_step_f32(cfg, init, step_batch, dev, False)
            del model
    finally:
        kdense.USE_DENSE_GRAD = saved
    cpu, card = got["cpu"], got["cuda"]
    print("card f32 vs CPU plain path, semseg (full width, K11 forced):")
    err, rel = rel_err(card[0], cpu[0])
    print(f"  eval logits (B={len(eval_batch['points'])}): max_abs_err={err:.3e} rel={rel:.3e} "
          f"(bound {STEP_TOL:.0e})")
    expect(rel <= STEP_TOL, "semseg eval logits off the CPU path")
    err = abs(card[1] - cpu[1])
    print(f"  step loss (B={len(step_batch['points'])}): card {card[1]:.6f} cpu {cpu[1]:.6f} "
          f"(abs err {err:.3e}, bound {STEP_TOL:.0e} relative)")
    expect(err <= STEP_TOL * max(1.0, abs(cpu[1])), "semseg step loss off the CPU")
    _worst("step gradients", card[2], cpu[2],
           lambda k: STEP_G2E_TOL if k.startswith("stem.group2emb.") else STEP_HEAD_TOL)


def time_semseg(batches, test_batches) -> None:
    """The bf16 semseg step at B=32 with the default flags and with K17 and
    K18 forced, and the eval forward, each with its profiler breakdown."""
    from vipformer_tpu_torch.models.factory import build_ft_semseg
    from vipformer_tpu_torch.train.trainer import create_state, make_semseg_eval, make_semseg_step

    cfg = semseg_config()
    model = build_ft_semseg(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_semseg_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    for forced in (False, True, True, False):  # in turns: default, forced, forced, default
        saved = _forced_norms(forced)
        try:
            _timed_steps(run, f"semseg step bf16 B={SEMSEG_BATCH} "
                         f"{'K17+K18 forced' if forced else 'default flags'}", SEMSEG_BATCH)
        finally:
            _restore_norms(saved)
    points = torch.from_numpy(test_batches[0][0]["points"]).cuda()
    eval_step = make_semseg_eval(model)
    _timed_steps(lambda n: [eval_step(points) for _ in range(n)],
                 f"semseg eval forward bf16 B={SEMSEG_BATCH}", SEMSEG_BATCH)


def time_partseg_forced_bn(batches) -> None:
    """The bf16 partseg step at B=96 with K18 forced against its default,
    in turns (default, forced, forced, default): the site K18 was built
    for (98,304 decode rows)."""
    from vipformer_tpu_torch.models.factory import build_ft_partseg
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.train.trainer import create_state, make_partseg_step

    cfg = partseg_config()
    model = build_ft_partseg(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_partseg_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(n):
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    for forced in (False, True, True, False):
        kbn.USE_BN_TRAIN = True if forced else None
        try:
            counts = _counted("partseg step, K18 " + ("forced" if forced else "default"),
                              lambda: run(1))
            expect(counts["batchnorm_fwd"] == (4 if forced else 0),
                   f"partseg: K18 launched {counts['batchnorm_fwd']} times")
            _timed_steps(run, f"partseg step bf16 B={PARTSEG_BATCH} "
                         f"{'K18 forced' if forced else 'default flags'}", PARTSEG_BATCH)
        finally:
            kbn.USE_BN_TRAIN = None


def check_probe() -> None:
    """The SVM probe (`fit_svm`, `score`) on the card against the CPU at the
    synthetic ModelNet40 probe's sizes ([800, 512] train, [200, 512] test)
    and at the real ModelNet40's ([9840, 512], [2468, 512]), on clustered
    random features: the predictions agree on at least PROBE_AGREE of the
    test rows; the fit timed on the card (host clock around a synchronised
    fit)."""
    from vipformer_tpu_torch.evaluation.svm import fit_svm

    rng = np.random.default_rng(SEED + 17)
    print("SVM probe, card vs CPU:")
    for n_tr, n_te in ((800, 200), (9840, 2468)):
        centers = rng.standard_normal((40, 512)).astype(np.float32) * 0.3
        y = rng.integers(0, 40, n_tr + n_te)
        x = (centers[y] + rng.standard_normal((n_tr + n_te, 512)).astype(np.float32))
        xtr, ytr, xte, yte = x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]
        cpu = fit_svm(xtr, ytr, c=1.0)
        xg = torch.from_numpy(xtr).cuda()
        fit_svm(xg, ytr, c=1.0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fit_svm(xg, ytr, c=1.0)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
        expect(card.w.is_cuda, "the probe did not fit on the card")
        p_card, p_cpu = card.predict(torch.from_numpy(xte).cuda()), cpu.predict(xte)
        agree = float((p_card == p_cpu).mean())
        print(f"  [{n_tr},512] -> [{n_te},512]: fit {fit_ms:.1f} ms on the card (300 Adam "
              f"steps), test acc card {card.score(xte, yte):.4f} cpu {cpu.score(xte, yte):.4f}, "
              f"predictions agree on {agree:.4f} of rows (bound {PROBE_AGREE})")
        expect(agree >= PROBE_AGREE, f"probe predictions agree on only {agree:.4f} of rows")


# ----------------------------------------------------------- evaluation
def eval_args(exp: str, root: str, *extra) -> list:
    """The eval CLIs' command line at the flagship (config.py's eval batch
    B=160, 1024 points, bf16), on the synthetic sets, with no checkpoint
    in `root`: the CLIs log their warning and evaluate the random init
    from the seed."""
    return ["--synthetic_data", "true", "--arch", ARCH, "--num_test_points", str(NUM_POINTS),
            "--test_batch_size", str(EVAL_BATCH), "--compute_dtype", "bfloat16",
            "--seed", str(SEED), "--run_dir", root, "--exp_name", exp, *extra]


def eval_forward_counts(batches: int, fused: bool) -> dict:
    """Exact launches of `batches` flagship eval forwards at B=160: the
    stem's FPS + kNN (K16 with USE_FPS_KNN forced, else K1 and K2), K3, K4,
    and K6 in the 8 self-attention layers (its gate holds at B >= 128)."""
    select = {"fps_knn": 1} if fused else {"fps": 1, "knn": 1}
    per = dict(select, stem=1, attn_kv_ln=1, attn_small_qkv_ln=8)
    return {k: v * batches for k, v in per.items()}


def check_patchify_and_head_split(rec: Recorder) -> None:
    """(a) K16 against its twin, against K1 followed by K2 and against a
    second launch on the card, bitwise, at the eval CLIs' [160, 1024] (G =
    128, K = 32) and semseg's [32, 4,096] xyz+rgb points, from index 0 and
    from random starts, and at K2's KNN_SHAPES and KNN_CLOUDS (3 clouds, G
    = 128 and, up to 1,024 points, G = N), timed on device time at
    KNN_TIMED and [160, 1,024] beside K1 + K2; K14 against its twin at dh = 64, dv = 32 and 64 and
    M = 128 and 2,048 (the Perceiver's unequal-width sites), f32 and
    bf16 (the tensor-core route launched twice, bitwise equal), timed at
    the point features' cross-attention beside SDPA."""
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 31)
    g, k = 128, 32

    def held(pts, gg, kk, start, what: str) -> int:
        """K16 on pts against its twin, K1 + K2 and a second launch; the
        count of centers that took the exact scan."""
        s0 = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev) if start is None else start
        over = torch.zeros(1, dtype=torch.int32, device=dev)
        cidx, nidx = kpatch.fps_knn(pts, gg, kk, start, overflow=over)
        want_c, want_n = kpatch.fps_knn_plain(pts[..., :3].contiguous(), gg, kk, s0)
        idx, centers = kfps.fps(pts, gg, start)
        expect(torch.equal(cidx, want_c) and torch.equal(nidx, want_n),
               f"fps_knn {what}: differs from its twin")
        expect(torch.equal(cidx, idx) and torch.equal(nidx, kknn.knn(kk, pts, centers)),
               f"fps_knn {what}: differs from K1 + K2")
        again = kpatch.fps_knn(pts, gg, kk, start)
        expect(torch.equal(cidx, again[0]) and torch.equal(nidx, again[1]),
               f"fps_knn {what}: two launches differ")
        return over.item()

    print("K16 (fused FPS + kNN) against its twin, K1 + K2 and a second launch:")
    with torch.inference_mode():
        for b, n, c in ((EVAL_BATCH, NUM_POINTS, 3), (SEMSEG_BATCH, SEMSEG_POINTS, 6)):
            pts = torch.from_numpy(rng.uniform(-1, 1, (b, n, c)).astype(np.float32)).to(dev)
            for start in (None, torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(dev)):
                what = f"[{b},{n},{c}] {'random' if start is not None else 'index 0'} start"
                held(pts, g, k, start, what)
                rec.check("fps_knn", f"{what} (equal to twin and K1+K2)", 0.0, 0.0, 0.0)
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        scanned = 0
        for n, kk in KNN_SHAPES:
            for kind in KNN_CLOUDS:
                for gg in sorted({min(g, n), n if n <= NUM_POINTS else min(g, n)}):
                    pts = knn_cloud(gen, kind, 3, n)
                    start = torch.randint(0, n, (3,), generator=gen, device=dev, dtype=torch.int32)
                    over = held(pts, gg, kk, start, f"N={n} G={gg} K={kk} {kind}")
                    scanned += over if kind == "lane" else 0
                    print(f"  fps_knn N={n:5d} G={gg:4d} K={kk:3d} {kind:8s}: equal; {over} of "
                          f"{3 * gg} centers took the exact scan")
        expect(scanned > 0, "fps_knn: no center of the lane-adversarial clouds took the exact scan")
        rec.check("fps_knn", "hard clouds (equal to twin and K1+K2)", 0.0, 0.0, 0.0)
        # device time (events beside) beside K1 + K2's; the JSON line keeps
        # the eval CLIs' [160, 1,024]
        for b, n in KNN_TIMED + ((EVAL_BATCH, NUM_POINTS),):
            xyz = knn_cloud(gen, "uniform", b, n)
            run = lambda: kpatch.fps_knn(xyz, g, k)  # noqa: E731
            cidx, nidx = run()
            s0 = torch.zeros(b, dtype=torch.int32, device=dev)
            expect(torch.equal(nidx, kpatch.fps_knn_plain(xyz, g, k, s0)[1]),
                   f"fps_knn [{b},{n}]: differs from its twin")
            ms, host = queued_ms(run, f"fps_knn [{b},{n}]"), cuda_ms(run)
            k1k2 = queued_ms(lambda: kknn.knn(k, xyz, kfps.fps(xyz, g)[1]), "K1 + K2")
            bnd = bound(nbytes(xyz, cidx, nidx), (9 + 8) * b * g * n, "float32")
            print(f"  {'fps_knn':18s} xyz[{b},{n},3] -> {g} x {k}: device {ms:.4f} ms, events "
                  f"{host:.4f} ms; K1 + K2 device {k1k2:.4f} ms; bound {bnd['bound_ms']:.4f}")
            if b == EVAL_BATCH:
                rec.timing("fps_knn", ms,
                           cuda_ms(lambda: kpatch.fps_knn_plain(xyz, g, k, s0), iters=3, warmup=1),
                           bnd, shape=f"xyz[{b},{n},3] -> {g} x {k}")
                rec.r["fps_knn"].update(host_ms=host, k1_k2_ms=k1k2)

    print("K14 (head-split eval attention) against its twin:")
    b, h = PERCEIVER_FEATS_BATCH, 4
    with torch.inference_mode():
        for m in (128, 2048):
            for dv in (32, 64):
                for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                    q = torch.from_numpy(rng.standard_normal((b, h, g, 64)).astype(
                        np.float32)).to(dev, dt)
                    kk = torch.from_numpy(rng.standard_normal((b, h, m, 64)).astype(
                        np.float32)).to(dev, dt)
                    v = torch.from_numpy(rng.standard_normal((b, h, m, dv)).astype(
                        np.float32)).to(dev, dt)
                    scale = 64 ** -0.5
                    out = kattn.fused_attention(q, kk, v, scale=scale)
                    ref = kattn.fused_attention_plain(q, kk, v, scale)
                    rec.check("attn_head_split", f"M={m} dv={dv} {dt_name}", *rel_err(out, ref),
                              KERNEL_TOL[dt_name])
                    if dt_name == "bfloat16":
                        expect(torch.equal(out, kattn.fused_attention(q, kk, v, scale=scale)),
                               f"attn_head_split M={m} dv={dv}: two launches differ")
                    if m == 2048 and dv == 32 and dt_name == "bfloat16":
                        import torch.nn.functional as F

                        ops = 2 * b * h * g * m * (64 + dv)
                        rec.timing("attn_head_split",
                                   cuda_ms(lambda: kattn.fused_attention(q, kk, v, scale=scale)),
                                   cuda_ms(lambda: kattn.fused_attention_plain(q, kk, v, scale)),
                                   bound(nbytes(q, kk, v, out), ops, dt_name),
                                   cuda_ms(lambda: F.scaled_dot_product_attention(
                                       q, kk, v, scale=scale)),
                                   shape=f"q[{b},{h},{g},64] kv[{m}] dv={dv} {dt_name}")


def drive_eval_clis(counts_out: dict, times: dict) -> None:
    """(b) the evaluation entry points in process, as a user calls them:
    eval_zeroshot on the synthetic ModelNet40 (complexity, the linear, RBF
    and grid-search probes on 800 / 200 clouds), eval_fewshot on
    ScanObjectNN at scripts/fewshot/eval_fewshot-SO.sh's 5-way 10-shot
    with 20 queries and 10 runs, and eval_fewshot again with USE_FPS_KNN
    forced: exact launches (K16 once per feature batch and K1 / K2 never),
    the results in range, and the forced run's features equal to the
    default run's bit for bit."""
    import tempfile

    from vipformer_tpu_torch.cli import eval_fewshot, eval_zeroshot
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch

    with tempfile.TemporaryDirectory() as root:
        cfg, device = eval_zeroshot.parse_args(eval_args("zs", root, "--pt_dataset",
                                                         "ModelNet40"))
        expect(device == "cuda", "the eval CLI does not default to the card")
        out: dict = {}
        t0 = time.perf_counter()
        counts = _counted("eval_zeroshot (ModelNet40, B=160)",
                          lambda: out.update(eval_zeroshot.main(cfg, device)))
        times["eval_zeroshot"] = time.perf_counter() - t0
        counts_out["eval_zeroshot"] = counts
        _expect_counts("eval_zeroshot", counts, eval_forward_counts(
            -(-800 // EVAL_BATCH) + -(-200 // EVAL_BATCH), fused=False))
        expect(set(out) == {"linear_acc", "rbf_acc", "grid_acc", "grid_best", "params",
                            "flops_per_batch"}, f"eval_zeroshot returned {sorted(out)}")
        expect(all(0.0 <= out[a] <= 1.0 for a in ("linear_acc", "rbf_acc", "grid_acc")),
               f"eval_zeroshot accuracies out of range: {out}")
        expect(out["params"] > 0 and out["flops_per_batch"] > 0, "empty complexity report")
        print(f"  eval_zeroshot: {json.dumps(out)} in {times['eval_zeroshot']:.1f} s")

        feats: dict = {}
        extract = eval_fewshot.extract_features
        for name, flag in (("eval_fewshot", None), ("eval_fewshot fps_knn", True)):
            cfg, device = eval_fewshot.parse_args(eval_args(
                name.replace(" ", "_"), root, "--ft_dataset", "ScanObjectNN", "--n_runs", "10",
                "--k_way", "5", "--n_shot", "10", "--n_query", "20"))
            saved = kpatch.USE_FPS_KNN
            kpatch.USE_FPS_KNN = flag
            eval_fewshot.extract_features = lambda *a, _n=name: feats.setdefault(
                _n, extract(*a))
            try:
                t0 = time.perf_counter()
                counts = _counted(f"{name} (ScanObjectNN 5w10s, 10 runs, B=160)",
                                  lambda: out.update(eval_fewshot.main(cfg, device)))
                times[name] = time.perf_counter() - t0
            finally:
                kpatch.USE_FPS_KNN = saved
                eval_fewshot.extract_features = extract
            counts_out[name] = counts
            _expect_counts(name, counts, eval_forward_counts(-(-600 // EVAL_BATCH),
                                                             fused=flag is True))
            accs = out["accs"]
            expect(len(accs) == 10 and all(0.0 <= a <= 100.0 for a in accs),
                   f"{name}: accuracies {accs}")
            print(f"  {name}: acc {out['mean']:.2f} +/- {out['std']:.2f} over 10 runs in "
                  f"{times[name]:.1f} s")
        (f0, l0), (f1, l1) = feats["eval_fewshot"], feats["eval_fewshot fps_knn"]
        expect(np.array_equal(l0, l1), "the two few-shot runs read other labels")
        expect(torch.equal(f0, f1), f"features with K16 differ from K1 + K2's by "
                                    f"{(f0.float() - f1.float()).abs().max().item():.3e}")
        print(f"  features {tuple(f0.shape)} {f0.dtype}: K16's route equal to K1 + K2's bit "
              f"for bit")


def time_eval_forward() -> None:
    """(e) the eval CLIs' feature forward at the flagship, B=160, bf16:
    the default route (K1 + K2) and K16 forced, in turns (default, forced,
    forced, default; CUDA events over 10 forwards each), and the
    profiler's breakdown of each route."""
    from torch.profiler import ProfilerActivity, profile

    from vipformer_tpu_torch.models.factory import build_pc_model
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch
    from vipformer_tpu_torch.train.trainer import make_feats_fn

    fn = make_feats_fn(build_pc_model(config(num_test_points=NUM_POINTS), device="cuda"))
    rng = np.random.default_rng(SEED + 41)
    pts = torch.from_numpy(rng.uniform(-1, 1, (EVAL_BATCH, NUM_POINTS, 3)).astype(
        np.float32)).cuda()
    saved = kpatch.USE_FPS_KNN
    ms: dict = {None: [], True: []}
    try:
        for flag in (None, True, True, None):
            kpatch.USE_FPS_KNN = flag
            ms[flag].append(cuda_ms(lambda: fn(pts), iters=10))
        print(f"eval forward at B={EVAL_BATCH} (bf16, CUDA events, in turns): K1 + K2 "
              f"{ms[None][0]:.3f} / {ms[None][1]:.3f} ms, K16 {ms[True][0]:.3f} / "
              f"{ms[True][1]:.3f} ms")
        for flag, what in ((None, "eval forward (K1 + K2)"), (True, "eval forward (K16)")):
            kpatch.USE_FPS_KNN = flag
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(pts)
                fn(pts)
                torch.cuda.synchronize()
            print_breakdown(prof, 2, float(np.mean(ms[flag])), what)
    finally:
        kpatch.USE_FPS_KNN = saved


def compare_eval_with_cpu() -> None:
    """(c) the zeroshot protocol at f32, card against CPU, the same weights:
    the backbone features of the synthetic ModelNet40's 800 / 200 clouds
    within STEP_TOL of max(1, max|cpu|), and the linear probes fitted on
    each side's features predicting the same label on >= PROBE_AGREE of
    the test rows."""
    from vipformer_tpu_torch.cli.common import extract_features
    from vipformer_tpu_torch.data.datasets import ModelNet40SVM
    from vipformer_tpu_torch.evaluation.svm import fit_svm
    from vipformer_tpu_torch.models.factory import build_pc_model
    from vipformer_tpu_torch.train.trainer import make_feats_fn

    cfg = config(compute_dtype="float32", num_test_points=NUM_POINTS)
    splits = [ModelNet40SVM(cfg.data_dir, s, NUM_POINTS) for s in ("train", "test")]
    feats = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fn = make_feats_fn(build_pc_model(cfg, device=d))
        feats[d] = [extract_features(fn, ds, EVAL_BATCH) for ds in splits]
        print(f"  f32 features on {d}: {time.perf_counter() - t0:.1f} s")
    for (fg, _), (fc, _), split in zip(feats["cuda"], feats["cpu"], ("train", "test")):
        err, rel = rel_err(fg.cpu(), fc)
        print(f"  eval features card vs cpu ({split}, f32): max_abs_err={err:.3e} rel={rel:.3e} "
              f"(bound {STEP_TOL:.0e})")
        expect(rel <= STEP_TOL, f"eval features ({split}) differ card vs cpu by {rel:.3e}")
    (tr_g, y_tr), (te_g, y_te) = feats["cuda"]
    (tr_c, _), (te_c, _) = feats["cpu"]
    p_card = fit_svm(tr_g, y_tr).predict(te_g)
    p_cpu = fit_svm(tr_c, y_tr).predict(te_c)
    agree = float((p_card == p_cpu).mean())
    print(f"  probe on those features: accuracy card {float((p_card == y_te).mean()):.4f} cpu "
          f"{float((p_cpu == y_te).mean()):.4f}, predictions agree on {agree:.4f} of rows "
          f"(bound {PROBE_AGREE})")
    expect(agree >= PROBE_AGREE, f"eval probe predictions agree on only {agree:.4f} of rows")


def drive_perceiver_head_split(counts_out: dict) -> None:
    """(d) the Perceiver sites whose v width differs from the q/k width,
    under a forced USE_FUSED_ATTENTION, at the flagship's D=256 with 4
    heads (dh 64, dv 32): the point feature forward through make_feats_fn
    with num_cross_attention_v_channels = 128 at B=64 over 2,048 points
    (K14 once at the cross-attention, K15 at the 6 equal-width self-
    attention layers), and a PerceiverEncoder with
    num_self_attention_v_channels = 128 over [64, 2,048, 256] tokens (K4 at
    its cross-attention, K14 at the 6 self-attention layers); finite
    outputs, exact launches, and each forward's time (CUDA events) with
    its profiler breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from vipformer_tpu_torch.models.factory import _perceiver_common
    from vipformer_tpu_torch.models.perceiver_models import PerceiverFeatsModel
    from vipformer_tpu_torch.nn.perceiver import PerceiverEncoder
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.train.trainer import make_feats_fn

    cfg = perceiver_config()
    common = _perceiver_common(cfg)
    sa = cfg.num_sa_layers_per_block * cfg.num_sa_blocks
    rng = np.random.default_rng(SEED + 37)
    b, n, d = PERCEIVER_FEATS_BATCH, cfg.num_pt_points, cfg.num_latent_channels
    pts = torch.from_numpy(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))
    feats_model = PerceiverFeatsModel("pointcloud", cfg.num_pc_latents, device="cuda",
                                      seed=SEED, num_cross_attention_v_channels=HEAD_SPLIT_V,
                                      **common)
    encoder = PerceiverEncoder(cfg.num_pc_latents, num_input_channels=d,
                               num_self_attention_v_channels=HEAD_SPLIT_V,
                               **common).cuda().eval()
    tokens = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).cuda()
    feats_fn = make_feats_fn(feats_model)
    runs = (("perceiver feats pc v128", lambda: feats_fn(pts),
             {"attn_head_split": 1, "attn_packed_kv": sa}),
            ("perceiver encoder sa v128", lambda: encoder(tokens.to(common["dtype"])),
             {"attn_kv_ln": 1, "attn_head_split": sa}))
    saved = kattn.USE_FUSED_ATTENTION
    kattn.USE_FUSED_ATTENTION = True
    try:
        for name, fn, want in runs:
            out = {}
            with torch.inference_mode():
                counts = _counted(f"{name}: one forward at B={b}", lambda: out.update(o=fn()))
            counts_out[name] = counts
            _expect_counts(name, counts, want)
            expect(bool(torch.isfinite(out["o"]).all()), f"{name}: non-finite output")
            with torch.inference_mode():
                ms = cuda_ms(fn, iters=10)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    fn()
                    torch.cuda.synchronize()
            print(f"  {name}: output {tuple(out['o'].shape)} finite; {ms:.3f} ms a forward "
                  f"(bf16, CUDA events)")
            print_breakdown(prof, 2, ms, name)
    finally:
        kattn.USE_FUSED_ATTENTION = saved


# the hand-written kernels by name: those of csrc/*.cu in the vpt*
# namespaces, and those in anonymous namespaces
OUR_KERNELS = ("vpt", "fps_kernel", "knn_kernel", "fps_knn_kernel", "mha_kernel", "mha_tc_kernel",
               "stem_kernel", "attn_flash_kernel", "attn_combine_kernel", "attn_packed_tc_kernel",
               "attn_packed_kv_cluster_kernel",
               "attn_small_kernel", "attn_small_tc_kernel", "attn_small_qkv_ln_kernel",
               "attn_small_qkv_ln_tc_kernel", "flash_fwd_tc_kernel", "flash_bwd_kv_tc_kernel",
               "flash_bwd_dq_tc_kernel", "dense_grads_tc_kernel", "ln_bwd_kernel",
               "attn_kv_ln_tile_kernel", "attn_kv_ln_stream_kernel", "ln_xn_kernel")


def ours_kernel(name: str) -> bool:
    return any(w in name for w in OUR_KERNELS)


def print_breakdown(prof, steps: int, ms: float, what: str) -> None:
    """Device time per step by kernel from a torch.profiler run over `steps`
    steps: totals of the hand-written kernels, library GEMMs and the rest,
    and the largest kernels."""
    # device events only; a user annotation (torch.optim's "Optimizer.step#...")
    # reports the time of the kernels inside it again
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    per_step = {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}
    busy = sum(per_step.values())
    ours = sum(v for k, v in per_step.items() if ours_kernel(k))
    gemm = sum(v for k, v in per_step.items()
               if not ours_kernel(k) and any(w in k.lower() for w in ("gemm", "nvjet", "cutlass")))
    print(f"where {what} goes (torch.profiler over {steps} steps, device time per step): kernels "
          f"{busy:.3f} ms of the {ms:.3f} ms step ({100.0 * busy / ms:.1f}% busy): "
          f"hand-written {ours:.3f} ms, library GEMMs {gemm:.3f} ms, other PyTorch kernels "
          f"{busy - ours - gemm:.3f} ms; launches per step "
          f"{sum(e.count for e in kernels) / steps:.0f}; top kernels:")
    expect(not any(SIMT_FLASH_BF16 in k for k in per_step),
           f"{what}: the CUDA-core {SIMT_FLASH_BF16} ran")
    counts = {e.key: e.count / steps for e in kernels}
    for k, v in sorted(per_step.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:9.3f} ms/step {counts[k]:6.0f}/step  {k[:110]}")
    k11 = sum(v for k, v in per_step.items() if K11_KERNEL in k)
    if k11 > 0:
        # the bf16 K9's backward runs its dW2 and dW1 on K11's kernel
        k9_ms, k9_n = kernels_launched_in(prof, K9_BWD_NODE, K11_KERNEL)
        k9_tc = any(K9_BWD_KERNELS[1] in k for k in per_step)
        expect(k9_n == (2 * steps if k9_tc else 0),
               f"{what}: K9's backward launched {k9_n} {K11_KERNEL} over {steps} steps")
        print(f"  {K11_KERNEL} (K11) {k11:.3f} ms/step: K9's backward's dW2 and dW1 "
              f"{k9_ms / steps:.3f} ms/step ({k9_n / steps:.0f}/step), K11's own sites "
              f"{k11 - k9_ms / steps:.3f} ms/step")


# the autograd node of K9 (ops/cuda/g2e_train.py _G2ETrain), which launches
# K9's backward, and K11's tensor-core kernel
K9_BWD_NODE = "_G2ETrainBackward"
K11_KERNEL = "dense_grads_tc_kernel"


def kernels_launched_in(prof, scope: str, pick: str) -> tuple[float, int]:
    """(device ms, launches) of the kernels whose name holds `pick` that
    were launched inside a host event whose name holds `scope`:
    torch.profiler links each kernel to the innermost host event around its
    launch."""
    ms, n = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and scope in e.name:
            for k in e.kernels:
                if pick in k.name:
                    ms += k.duration / 1e3
                    n += 1
    return ms, n


def kernel_line(rec: Recorder, counts: dict) -> list:
    """The per-kernel entries; `counts` maps each path to the launch counts
    of its run. `launches` counts the kernel's own path (the forward where
    it has a backward); `launches_by_path` every path that ran it."""
    out = []
    for name, (src, rep, path) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep, "path": path}
        paired = f"{name}_fwd" in rec.r
        counter = f"{name}_fwd" if paired else name
        if paired:
            fwd, bwd = rec.r[f"{name}_fwd"], rec.r[f"{name}_bwd"]
            entry.update(launches=counts[path][counter], **fwd)
            entry["backward"] = dict(launches=counts[path][f"{name}_bwd"], **bwd)
        else:
            entry.update(launches=counts[path][name], **rec.r[name])
        steps = {"pretrain": STEPS, "ft_cls": FT_STEPS, "ft_semseg forced": SEMSEG_STEPS}.get(path)
        if steps:
            entry["launches_per_step"] = counts[path][counter] / steps
        entry["launches_by_path"] = {p: c[counter] for p, c in counts.items() if c.get(counter)}
        out.append(entry)
    return out


# ------------------------------------------------------------ resume
RESUME_ARGV = ["--synthetic_data", "true", "--arch", "E1CL1SL-H2D128-L16-MR2", "--group_size",
               "8", "--num_ft_points", "128", "--batch_size", "64", "--test_batch_size", "100",
               "--compute_dtype", "bfloat16", "--save_freq", "1", "--exp_name", "resume"]


def check_resume_on_card() -> None:
    """The ft_cls CLI on the card at tiny widths (E1CL1SL-H2D128, 128
    points, bf16) with save_freq 1: two epochs, then, as after a kill,
    `--resume_training` to four. metrics.jsonl must read epochs 0, 1, 2, 3
    (none run twice) with a best that never falls, and the rolling
    snapshot put back into a fresh state on the card must hold its
    optimizer moments there, equal to the saved ones bit for bit."""
    import tempfile

    from vipformer_tpu_torch.cli import ft_cls
    from vipformer_tpu_torch.models.factory import build_ft_cls
    from vipformer_tpu_torch.train.checkpoint import load_checkpoint, restore_state
    from vipformer_tpu_torch.train.trainer import create_state

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = RESUME_ARGV + ["--run_dir", tmp, "--data_dir", os.path.join(tmp, "data")]
        cfg, dev = ft_cls.parse_args(argv + ["--epochs", "2"])
        expect(dev == "cuda", f"resume: the CLI runs on {dev}")
        ft_cls.main(cfg, dev)
        cfg, dev = ft_cls.parse_args(argv + ["--epochs", "4", "--resume_training", "true"])
        out = ft_cls.main(cfg, dev)
        root = os.path.join(tmp, cfg.proj_name, "resume")
        with open(os.path.join(root, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps, bests = [r["step"] for r in rows], [r["best_acc"] for r in rows]
        expect(steps == [0, 1, 2, 3], f"resume: metrics.jsonl epochs {steps}")
        expect(bests == sorted(bests) and out["best_acc"] == bests[-1],
               f"resume: best trackers {bests}, returned {out}")
        path = os.path.join(root, "models", "model_last.ckpt")
        state = create_state(cfg, {"pc": build_ft_cls(cfg, device=dev, seed=SEED + 1)})
        meta = restore_state(path, state)
        saved = load_checkpoint(path)["optimizer"]["state"]
        moments = [(i, k, v) for i, e in state.optimizer.state_dict()["state"].items()
                   for k, v in e.items() if k != "step"]
        where = sorted({str(v.device) for _, _, v in moments})
        expect(meta["epoch"] == 3 and moments and all(v.is_cuda for _, _, v in moments),
               f"resume: epoch {meta['epoch']}, moments on {where}")
        expect(all(torch.equal(v.cpu(), saved[i][k]) for i, k, v in moments),
               "resume: the restored moments differ from the saved ones")
        expect(all(p.is_cuda for p in state.parameters()), "resume: parameters left the card")
    print(f"resume on the card: ft_cls epochs {steps} (killed after 1, resumed to 3), best "
          f"{bests}; {len(moments)} moment tensors restored onto {dev}, bitwise equal to the "
          f"snapshot ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------ data parallelism
DP_WORLD = 2  # ranks of the data-parallel phase
DP_TIMED = 5  # timed steps a configuration (after 2 warm-up steps)
# counters the data-parallel steps must launch exactly as often as one
# process does over the same global batch: K9's and K18's, whose seams
# the ranks split (and K18 forced in the partseg step)
DP_EXACT = ("g2e_train_fwd", "g2e_train_bwd", "batchnorm_fwd", "batchnorm_bwd")
# the configurations: the flagship pretrain step (B = 48, both branches,
# one NT-Xent group a rank) and the ft_cls step (B = 330), both also in f32
# with the generator off against one process; partseg (B = 96) with K18
# forced, for its counts
DP_KINDS = ("pretrain", "ft_cls")


def dp_config(kind: str, dt: str):
    """The DP phase's configuration of `kind` in `dt`; f32 for the
    comparison with one process: no dropout (the steps run without a
    generator, so FPS starts at 0) and SGD at lr 1, so that each
    parameter's update is its gradient."""
    over = {} if dt == "bfloat16" else dict(compute_dtype="float32", atten_drop=0.0,
                                            mlp_drop=0.0, max_dpr=0.0, optim="sgd", lr=1.0)
    if kind == "pretrain":
        return config(**over)
    if kind == "ft_cls":
        return ft_config(**over)
    return partseg_config(**over)


def dp_build(kind: str, cfg, states=None):
    """(models, TrainState, step) of `kind` on the card, the models loaded
    from `states` where given, then sharded over the model axis (a no-op
    at model_axis 1), placed from rank 0 (`place_state`); the pretrain step
    with DP_WORLD NT-Xent groups over the global batch (one a rank of the
    data-parallel phase), so one process trains the same loss."""
    from vipformer_tpu_torch.models.factory import build_ft_cls, build_ft_partseg
    from vipformer_tpu_torch.parallel import place_state, shard_model
    from vipformer_tpu_torch.train.trainer import (create_state, make_cls_step,
                                                   make_partseg_step, make_pretrain_step)

    if kind == "pretrain":
        models = pretrain_models(cfg, "cuda")
    else:
        models = {"pc": (build_ft_cls if kind == "ft_cls" else build_ft_partseg)(cfg,
                                                                                  device="cuda")}
    for name, m in models.items():
        if states:
            m.load_state_dict(states[name])
        shard_model(m, print)
    state = create_state(cfg, models)
    place_state(state)
    if kind == "pretrain":
        step = make_pretrain_step(cfg, models["pc"], models["img"], neg_groups=DP_WORLD)
    else:
        step = (make_cls_step if kind == "ft_cls" else make_partseg_step)(cfg, models["pc"])
    return models, state, step


def dp_host(models: dict) -> dict:
    """Every tensor of the models (parameters and BatchNorm statistics) on
    the host, keyed "<model>.<name>"."""
    return {f"{n}.{k}": v.detach().cpu() for n, m in models.items()
            for k, v in m.state_dict().items()}


def dp_run(inp: dict, who: str, before_bf16=None) -> dict:
    """The DP phase's work in one process, on this rank's slice of every
    global batch (the whole batch outside a group): the f32 step of each
    DP_KINDS from the given weights (metrics, new tensors); one bf16 step
    of each, and of partseg with K18 forced, with every launch count at 0
    before it (counts, the metrics finite, the parameters finite and every
    reached one moved); the bf16 ms a step (host clock around synchronised
    steps, ranks aligned by barriers)."""
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.parallel import barrier, rank_seed, shard_batch

    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    out: dict = {}
    k9 = inp["k9"]
    mine = shard_batch({k: k9[k] for k in ("x0", "dy")})
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x0 = torch.from_numpy(mine["x0"]).to("cuda", dt).reshape(-1, 3)
        dy = torch.from_numpy(mine["dy"]).to("cuda", dt).reshape(-1, 256)
        wb = [torch.from_numpy(w).cuda() for w in k9["wb"]]
        o, h3p, amax, stats = kg.g2e_fwd_kernel(x0, wb, k9["s"])
        row = dict(out=o.cpu(), stats=stats.cpu(), amax=amax.cpu(), h3p=h3p.cpu())
        # the backward from one process's forward (this rank's rows of its
        # h3p and argmax, its statistics), so that an argmax that a rank's
        # statistics, a rounding apart, move to another row of a near-tie
        # does not send a gradient elsewhere (STEP_G2E_TOL's case)
        if "fwd" in k9:
            fwd = shard_batch({k: k9["fwd"][dt_name][k] for k in ("h3p", "amax")})
            h3p, amax = (fwd[k].reshape(-1, fwd[k].shape[-1]).cuda() for k in ("h3p", "amax"))
            stats = k9["fwd"][dt_name]["stats"].cuda()
        dx, grads = kg.g2e_bwd_kernel(x0, wb, h3p, amax, stats, dy, k9["s"])
        out[f"k9 {dt_name}"] = dict(row, dx=dx.cpu(), grads=[g.cpu() for g in grads])
        del x0, dy, wb, o, h3p, amax, stats, dx, grads
    for kind in DP_KINDS:
        cfg = dp_config(kind, "float32")
        models, state, step = dp_build(kind, cfg, inp["states"][kind])
        _, metrics = step(state, shard_batch(inp["batches"][kind]), cfg.lr)
        out[f"{kind} f32"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                                  tensors=dp_host(models))
        del models, state, step
        torch.cuda.empty_cache()
    if before_bf16 is not None:
        before_bf16()
    for kind in DP_KINDS + ("partseg",):
        cfg = dp_config(kind, "bfloat16")
        models, state, step = dp_build(kind, cfg)
        batch = shard_batch(inp["batches"][kind + " bf16"])
        gen = torch.Generator(device="cuda").manual_seed(rank_seed(SEED))
        before = [p.detach().clone() for p in state.parameters()]
        kbn.USE_BN_TRAIN = True if kind == "partseg" else None
        try:
            metrics = []
            counts = _counted(f"  {who}: {kind} bf16 step", lambda: metrics.append(
                step(state, batch, cfg.lr, gen)[1]))
        finally:
            kbn.USE_BN_TRAIN = None
        model, may_stay = None, None
        if kind == "partseg":  # as drive_partseg_path: the layers past the last tap
            unreached = tuple(f"encoder.sa_{i}." for i in range(max(cfg.layer_idx),
                                                                 cfg.num_sa_layers))
            model = models["pc"]
            may_stay = lambda k, b: k.startswith(unreached) and not b.any()  # noqa: E731
        _moved_and_finite(f"{who}: {kind}", model, state, before, metrics, may_stay)
        row = dict(counts=counts)
        if kind in DP_KINDS:
            def run(n):
                for _ in range(n):
                    step(state, batch, cfg.lr, gen)
                torch.cuda.synchronize()

            run(2)
            barrier()
            t0 = time.perf_counter()
            run(DP_TIMED)
            barrier()
            row["ms"] = (time.perf_counter() - t0) * 1e3 / DP_TIMED
        out[f"{kind} bf16"] = row
        del models, state, step, before
        torch.cuda.empty_cache()
    return out


def dp_rank(d: str) -> None:
    """One rank of the DP phase: dp_run on this rank's slices, saved to
    d/rank{r}.pt with the group's backend and size."""
    import torch.distributed as dist

    from vipformer_tpu_torch.parallel import data_axis_size, rank

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = dp_run(inp, f"rank {rank()}")
    out.update(backend=dist.get_backend(), world=data_axis_size(),
               card=torch.cuda.current_device())
    torch.save(out, os.path.join(d, f"rank{rank()}.pt"))


def dp_nccl_rank() -> dict:
    """A one-rank NCCL group on this card: its bring-up, an all-reduce and
    one step (`parallel/dryrun.py`'s: the tiny bf16 pretrain step from the
    placed state)."""
    import torch.distributed as dist

    from vipformer_tpu_torch.parallel.dryrun import _dryrun_rank

    x = torch.arange(4.0, device="cuda")
    dist.all_reduce(x)
    expect(x.tolist() == [0.0, 1.0, 2.0, 3.0], f"NCCL all-reduce over one rank gave {x}")
    return _dryrun_rank("cuda")


def check_data_parallel(main_counts: dict) -> None:
    """Data parallelism at full width over DP_WORLD ranks (parallel/), NCCL
    over two cards where there are two, else both ranks on card 0 over
    gloo and a one-rank NCCL group beside (bring-up, all-reduce, a step).
    The f32 pretrain (B = 48) and ft_cls (B = 330) steps on two ranks
    against one process on this card over the same global batch: the loss
    within STEP_TOL, every updated parameter within STEP_HEAD_TOL
    (Group2Emb's STEP_G2E_TOL; every leaf's gradient passes through a
    batch-statistics BatchNorm) and the running statistics within
    STATS_TOL, equal on both ranks. In bf16, one step of each and of
    partseg (K18 forced): finite, every parameter moved, K9's and K18's
    launches (DP_EXACT) exactly those of one process and the one process's
    those of the main paths (`main_counts`, per step); ms a step at both
    sizes."""
    import shutil
    import tempfile

    from vipformer_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP_WORLD else "gloo"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"data parallel: backend {backend}, W = {DP_WORLD}, {cards} card(s) ({smi})")
    torch.cuda.empty_cache()
    nccl = None
    if backend == "gloo":
        # the one-rank NCCL group starts now and is joined before any step
        # is timed (its process would share the host with the timing)
        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(1)
        nccl = pool.submit(mesh.spawn, dp_nccl_rank, 1, "cuda", (), backend="nccl")
    inp = {"states": {}, "batches": {}}
    one: dict = {}
    rng = np.random.default_rng(SEED + 41)
    for kind in DP_KINDS:
        cfg = dp_config(kind, "float32")
        batch = (pretrain_batches(cfg, 1, PRETRAIN_BATCH) if kind == "pretrain"
                 else ft_batches(cfg, "train"))[0]
        models, state, step = dp_build(kind, cfg)
        inp["states"][kind] = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                               for n, m in models.items()}
        inp["batches"][kind + " bf16"] = batch
        if kind == "pretrain":
            # each image its own colour offset in the f32 comparison: at
            # random init the image head's batch-statistics BatchNorms see
            # channels that barely vary over the 48 renders, and the fast
            # variance there turns two summation orders' f32 roundings into
            # 3e-2 of a leaf on an H100 (compare_step_with_cpu leaves the
            # CMID step out for the same reason; the CPU tests offset their
            # images so too)
            batch = dict(batch, imgs=(batch["imgs"] + 2.0 * rng.standard_normal(
                (len(batch["imgs"]), 1, 1, 3))).astype(np.float32))
        inp["batches"][kind] = batch
        del models, state, step
    pcfg = partseg_config()
    inp["batches"]["partseg bf16"] = partseg_batches(pcfg, "trainval")[0]
    # K9 at the pretrain step's patches: x0 [96, 128, 32, 3], D = 256
    inp["k9"] = dict(x0=rng.standard_normal((2 * PRETRAIN_BATCH, 128, 32, 3)).astype(np.float32),
                     dy=rng.standard_normal((2 * PRETRAIN_BATCH, 128, 256)).astype(np.float32),
                     wb=[w.cpu().numpy() for w in g2e_case(rng, 256, 3, "cuda")], s=32)
    print("  one process (W = 1):")

    def join_nccl():
        nonlocal nccl
        if nccl is not None:
            got = nccl.result()
            pool.shutdown()
            print(f"  one-rank NCCL group: backend {got['backend']}, all-reduce exact, "
                  f"parallel/dryrun.py's step (world {got['world']}), loss {got['loss']:.4f} "
                  f"(joined {time.perf_counter() - t_phase:.1f} s into the phase)")
            nccl = got

    one = dp_run(inp, "one process", join_nccl)
    inp["k9"]["fwd"] = {dt: {k: one[f"k9 {dt}"][k].reshape((2 * PRETRAIN_BATCH, -1)
                                                          + one[f"k9 {dt}"][k].shape[1:])
                             for k in ("h3p", "amax")} | {"stats": one[f"k9 {dt}"]["stats"]}
                        for dt in ("float32", "bfloat16")}
    d = tempfile.mkdtemp(prefix="vpt_dp_")
    try:
        torch.save(inp, os.path.join(d, "inputs.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        print(f"  {DP_WORLD} ranks over {backend} (the ranks' own lines below):", flush=True)
        mesh.spawn(dp_rank, DP_WORLD, "cuda", (d,), backend=backend)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for r, got in enumerate(ranks):
        expect(got["backend"] == backend and got["world"] == DP_WORLD,
               f"rank {r}: backend {got['backend']}, world {got['world']}")
    expect(backend == "nccl" or nccl["backend"] == "nccl", "the one-rank group is not NCCL")
    print(f"  ranks on cards {[g['card'] for g in ranks]}, {spawn_s:.1f} s with their spawn "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    k9 = inp["k9"]
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want, got = one[f"k9 {dt_name}"], [g[f"k9 {dt_name}"] for g in ranks]
        x0 = torch.from_numpy(k9["x0"]).to("cuda", dt).reshape(-1, 3)
        rows = x0.shape[0]
        wb = [torch.from_numpy(w).cuda() for w in k9["wb"]]
        _, h3p, amax, stats = kg.g2e_fwd_plain(x0, wb, k9["s"])
        dy = torch.from_numpy(k9["dy"]).to("cuda", dt).reshape(-1, 256)
        rss = [r.cpu() for r in kg.g2e_bwd_plain(x0, wb, h3p, amax, stats, dy, k9["s"],
                                                   rss=True)[2]]
        del x0, wb, h3p, amax, stats, dy
        share = (torch.cat([g["amax"] for g in got]) == want["amax"]).float().mean().item()
        errs = {"out": rel_err(torch.cat([g["out"] for g in got]), want["out"])[1]
                / KERNEL_TOL[dt_name],
                "dx0": rel_err(torch.cat([g["dx"] for g in got]), want["dx"])[1]
                / GRAD_TOL[dt_name],
                "stats": max(rel_err(g["stats"], want["stats"])[1] for g in got) / STATS_TOL}
        expect(torch.equal(got[0]["stats"], got[1]["stats"]),
               f"DP K9 {dt_name}: the ranks' batch statistics differ")
        for i, w in enumerate(want["grads"]):
            total = sum(g["grads"][i] for g in got)
            if i in ZERO_GRADS:
                r = rss[ZERO_GRADS.index(i)]
                e = ((total.double() - w.double()).abs() / zero_grad_bound(r, rows, dt)).max()
                errs[f"grad {i} (zero)"] = e.item()
            else:
                errs[f"grad {i}"] = rel_err(total, w)[1] / GRAD_TOL[dt_name]
        worst = max(errs, key=errs.get)
        print(f"  K9 {dt_name} x0[{2 * PRETRAIN_BATCH},128,32,3] on {DP_WORLD} ranks against one "
              f"process (rows, statistics; the backward from one process's forward, the ranks' "
              f"gradients summed), error / bound: "
              + ", ".join(f"{k} {v:.3f}" for k, v in errs.items())
              + f"; statistics equal on both ranks; argmax equal at {100 * share:.4f}% of "
              f"(group, column)")
        expect(errs[worst] <= 1.0, f"DP K9 {dt_name}: {worst} off one process")
    for kind in DP_KINDS:
        want = one[f"{kind} f32"]
        for k, v in want["metrics"].items():
            errs = [abs(g[f"{kind} f32"]["metrics"][k] - v) for g in ranks]
            print(f"  {kind} f32 {k}: one process {v:.6f}, ranks' abs err "
                  + ", ".join(f"{e:.3e}" for e in errs) + f" (bound {STEP_TOL:.0e} relative)")
            expect(max(errs) <= STEP_TOL * max(1.0, abs(v)), f"DP {kind} f32 {k} off one process")
        worst: dict = {}
        for key, w in want["tensors"].items():
            stat = "running_" in key
            bnd = STATS_TOL if stat else (STEP_G2E_TOL if ".group2emb." in key else STEP_HEAD_TOL)
            for g in ranks:
                rel = rel_err(g[f"{kind} f32"]["tensors"][key], w)[1] / bnd
                cls = "statistics" if stat else "parameters"
                if rel >= worst.get(cls, (0.0, ""))[0]:
                    worst[cls] = (rel, key)
            if stat:
                expect(torch.equal(ranks[0][f"{kind} f32"]["tensors"][key],
                                   ranks[1][f"{kind} f32"]["tensors"][key]),
                       f"DP {kind}: running statistic {key} differs between the ranks")
        print(f"  {kind} f32, {len(want['tensors'])} tensors after one SGD step (lr 1): worst "
              "error / bound " + "; ".join(f"{c} {r:.3f} ({k})" for c, (r, k) in worst.items())
              + "; running statistics equal on both ranks")
        expect(all(r <= 1.0 for r, _ in worst.values()), f"DP {kind} f32 off one process")
    for kind in DP_KINDS + ("partseg",):
        w1 = one[f"{kind} bf16"]["counts"]
        for r, g in enumerate(ranks):
            c = g[f"{kind} bf16"]["counts"]
            for name in DP_EXACT:
                expect(c[name] == w1[name], f"DP {kind} rank {r}: {name} launched {c[name]} "
                                            f"times, one process {w1[name]}")
        other = {k: (w1[k], ranks[0][f"{kind} bf16"]["counts"][k]) for k in w1
                 if k not in DP_EXACT and w1[k] != ranks[0][f"{kind} bf16"]["counts"][k]}
        print(f"  {kind} bf16 step: K9/K18 launches a rank "
              + ", ".join(f"{n} {ranks[0][f'{kind} bf16']['counts'][n]}" for n in DP_EXACT)
              + " (one process the same)"
              + (f"; other counters (one process, a rank) where a gate reads the rank's rows: "
                 f"{other}" if other else ""))
        if kind in main_counts:
            steps, counts = main_counts[kind]
            for name in DP_EXACT:
                expect(w1[name] * steps == counts[name], f"one process {kind}: {name} "
                       f"{w1[name]} a step, the main path {counts[name]} over {steps}")
    print("  one process's K9/K18 launches a step equal the main paths' (pretrain, ft_cls)")
    for kind in DP_KINDS:
        ms1, ms2 = one[f"{kind} bf16"]["ms"], [g[f"{kind} bf16"]["ms"] for g in ranks]
        print(f"  {kind} bf16 step over the global batch: W = 1 {ms1:.2f} ms; W = {DP_WORLD} "
              f"({backend}, {cards} card(s)) " + ", ".join(f"{m:.2f}" for m in ms2)
              + f" ms (ranks' host clock, {smi})")
    print(f"phase data parallel took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------- tensor parallelism
TP_AXIS = 2  # model ranks of the tensor-parallel phase: 2 of the flagship's 4 heads each
TP_WIDE = 4  # ranks of its 2 data x 2 model f32 ft_cls check
TP_STEPS = 5  # bf16 steps a configuration on each rank (the first counted, the rest timed)
# the counters each rank must launch, on the ft_cls step and its eval: K4,
# K6 (eval), K7, K8 (forward and backward) and K11
TP_LAUNCHED = ("attn_kv_ln", "attn_small_qkv_ln", "attn_train_kv_fwd", "attn_train_kv_bwd",
               "attn_train_fwd", "attn_train_bwd", "dense_grads")
# 3 heads of 64, which do not divide TP_AXIS: every attention stays whole
# on each model rank (K8 on all 3 heads, the same dropout draws), its MLPs
# shard
TP_WHOLE_ARCH = "E1CL1SL-H3D192-L128-MR2"


def tp_run(inp: dict, who: str, wide: bool = False) -> dict:
    """The TP phase's work in one process, or on a rank on its heads (and
    its rows of every global batch): the f32 step of each DP_KINDS from the
    given weights (metrics, the full tensors gathered over the model
    group); unless `wide`, for each kind in bf16 from the seed's weights:
    the ft_cls eval forward's logits at B = FT_BATCH with its launch counts
    first, then TP_STEPS steps, the first counted and the ms a step of the
    others (host clock around synchronised steps, ranks aligned by
    barriers), the metrics finite, the parameters finite and moved, the
    replicated ones on the host."""
    from vipformer_tpu_torch.parallel import barrier, full_state_dict, rank_seed, shard_batch
    from vipformer_tpu_torch.parallel.sharding import sharded

    out: dict = {}
    for kind in ("ft_cls",) if wide else DP_KINDS:
        cfg = dp_config(kind, "float32")
        models, state, step = dp_build(kind, cfg, inp["states"][kind])
        _, metrics = step(state, shard_batch(inp["batches"][kind]), cfg.lr)
        out[f"{kind} f32"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                                  tensors={f"{n}.{k}": v.detach().cpu() for n, m in models.items()
                                           for k, v in full_state_dict(m).items()})
        del models, state, step
        torch.cuda.empty_cache()
    if wide:
        return out
    for kind in DP_KINDS:
        cfg = dp_config(kind, "bfloat16")
        models, state, step = dp_build(kind, cfg)
        row: dict = {}
        if kind == "ft_cls":
            model = models["pc"].eval()
            pts = torch.as_tensor(inp["batches"]["ft_cls eval"]["points"], device="cuda")
            logits = []

            def forward():
                with torch.inference_mode():
                    logits.append(model(pts)[0].float().cpu())

            row["eval_counts"] = _counted(f"  {who}: ft_cls bf16 eval forward", forward)
            row["logits"] = logits[0]
        batch = shard_batch(inp["batches"][kind + " bf16"])
        gen = torch.Generator(device="cuda").manual_seed(rank_seed(SEED))
        before = [p.detach().clone() for p in state.parameters()]
        metrics = []
        row["counts"] = _counted(f"  {who}: {kind} bf16 step", lambda: metrics.append(
            step(state, batch, cfg.lr, gen)[1]))
        barrier()
        t0 = time.perf_counter()
        metrics += [step(state, batch, cfg.lr, gen)[1] for _ in range(TP_STEPS - 1)]
        torch.cuda.synchronize()
        barrier()
        row["ms"] = (time.perf_counter() - t0) * 1e3 / (TP_STEPS - 1)
        _moved_and_finite(f"{who}: {kind} bf16", None, state, before, metrics)
        row["replicated"] = {f"{n}.{k}": p.detach().cpu() for n, m in models.items()
                             for k, p in m.named_parameters() if not sharded(p)}
        out[f"{kind} bf16"] = row
        del models, state, step, before
        torch.cuda.empty_cache()
    return out


def tp_whole(inp: dict, who: str) -> dict:
    """Two bf16 ft_cls steps of TP_WHOLE_ARCH with attention dropout,
    residual dropout and DropPath on, over this rank's rows of the ft_cls
    batch: the launch counts, the heads of each attention and whether it
    is sharded, and the replicated parameters on the host."""
    from vipformer_tpu_torch.config import decode_arch_name
    from vipformer_tpu_torch.nn.layers import MultiHeadAttention
    from vipformer_tpu_torch.parallel import rank_seed, shard_batch
    from vipformer_tpu_torch.parallel.sharding import sharded

    cfg = ft_config(**decode_arch_name(TP_WHOLE_ARCH), atten_drop=0.1, mlp_drop=0.1,
                    max_dpr=0.1)
    models, state, step = dp_build("ft_cls", cfg)
    batch = shard_batch(inp["batches"]["ft_cls bf16"])
    gen = torch.Generator(device="cuda").manual_seed(rank_seed(SEED))
    before = [p.detach().clone() for p in state.parameters()]
    metrics: list = []
    counts = _counted(f"  {who}: {TP_WHOLE_ARCH} bf16 ft_cls, 2 steps with dropout", lambda: [
        metrics.append(step(state, batch, cfg.lr, gen)[1]) for _ in range(2)])
    _moved_and_finite(f"{who}: {TP_WHOLE_ARCH}", None, state, before, metrics)
    model = models["pc"]
    out = {"counts": counts,
           "heads": [(m.num_heads, m.model_axis) for m in model.modules()
                     if isinstance(m, MultiHeadAttention)],
           "replicated": {k: p.detach().cpu() for k, p in model.named_parameters()
                          if not sharded(p)},
           "shards": sum(sharded(p) for p in model.parameters())}
    del models, state, step, before
    torch.cuda.empty_cache()
    return out


def tp_rank(d: str) -> None:
    """One rank of the TP phase: tp_run on its heads and rows (the ft_cls
    f32 step alone on the TP_WIDE ranks), saved to d/rank{r}.pt with the
    group's backend, layout and card."""
    import torch.distributed as dist

    from vipformer_tpu_torch.parallel import data_axis_size, model_axis_size, rank, world_size

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = tp_run(inp, f"rank {rank()}", wide=world_size() == TP_WIDE)
    if world_size() != TP_WIDE:
        out["whole"] = tp_whole(inp, f"rank {rank()}")
    out.update(backend=dist.get_backend(), layout=(data_axis_size(), model_axis_size()),
               card=torch.cuda.current_device())
    torch.save(out, os.path.join(d, f"rank{rank()}.pt"))


def _tp_spawn(inp: dict, world: int) -> tuple[list, str, float]:
    """tp_rank on `world` ranks at model_axis TP_AXIS, NCCL a card a rank
    where there are `world` cards, else all on card 0 over gloo: (the
    ranks' results, the backend, the seconds with the spawn)."""
    import shutil
    import tempfile

    from vipformer_tpu_torch.parallel import mesh

    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    d = tempfile.mkdtemp(prefix="vpt_tp_")
    try:
        torch.save(inp, os.path.join(d, "inputs.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        print(f"  {world} ranks ({world // TP_AXIS} data x {TP_AXIS} model) over {backend} "
              "(the ranks' own lines below):", flush=True)
        mesh.spawn(tp_rank, world, "cuda", (d,), backend=backend, model_axis=TP_AXIS)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for r, got in enumerate(ranks):
        expect(got["backend"] == backend and got["layout"] == (world // TP_AXIS, TP_AXIS),
               f"TP rank {r}: backend {got['backend']}, layout {got['layout']}")
    return ranks, backend, time.perf_counter() - t0


def _tp_f32_against_one(kind: str, one: dict, ranks: list, what: str) -> None:
    """Every rank's f32 step of `kind` against one process: the metrics
    within STEP_TOL, the gathered tensors within the DP phase's bounds
    (STEP_HEAD_TOL, Group2Emb's STEP_G2E_TOL, STATS_TOL)."""
    want = one[f"{kind} f32"]
    for k, v in want["metrics"].items():
        errs = [abs(g[f"{kind} f32"]["metrics"][k] - v) for g in ranks]
        print(f"  {what} {kind} f32 {k}: one process {v:.6f}, ranks' abs err "
              + ", ".join(f"{e:.3e}" for e in errs) + f" (bound {STEP_TOL:.0e} relative)")
        expect(max(errs) <= STEP_TOL * max(1.0, abs(v)), f"TP {what} {kind} f32 {k} off one "
                                                         "process")
    worst: dict = {}
    for key, w in want["tensors"].items():
        stat = "running_" in key
        bnd = STATS_TOL if stat else (STEP_G2E_TOL if ".group2emb." in key else STEP_HEAD_TOL)
        cls = "statistics" if stat else "parameters"
        for g in ranks:
            rel = rel_err(g[f"{kind} f32"]["tensors"][key], w)[1] / bnd
            if rel >= worst.get(cls, (0.0, ""))[0]:
                worst[cls] = (rel, key)
    print(f"  {what} {kind} f32, {len(want['tensors'])} tensors (shards gathered) after one SGD "
          "step (lr 1): worst error / bound "
          + "; ".join(f"{c} {r:.3f} ({k})" for c, (r, k) in worst.items()))
    expect(all(r <= 1.0 for r, _ in worst.values()), f"TP {what} {kind} f32 off one process")


def check_tensor_parallel() -> None:
    """Tensor parallelism at full width (parallel/, `--model_axis`): the
    flagship's heads and MLP hidden units over TP_AXIS model ranks (NCCL
    over two cards where there are two, else both on card 0 over gloo).
    The f32 pretrain (B = 48) and ft_cls (B = 330) steps against one
    process on this card (the DP phase's bounds, the shards gathered);
    in bf16 the ft_cls eval forward (K4, K6 on each rank's 2 heads) against
    one process's logits within MODEL_TOL, then TP_STEPS steps of each:
    finite, every parameter moved, the replicated ones bitwise equal on
    the ranks, each rank's launches of every counter equal to one
    process's (the gates read the same shapes) and K4, K6, K7, K8 and K11
    launched; ms a step at T = 1 and 2; two bf16 steps with dropout of
    TP_WHOLE_ARCH, whose 3 heads stay whole on each rank (K8 on all of
    them): its replicated parameters bitwise equal on the ranks. Last, the
    f32 ft_cls step on TP_WIDE ranks, 2 data x 2 model, against one
    process."""
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"tensor parallel: model_axis {TP_AXIS}, {cards} card(s) ({smi})")
    torch.cuda.empty_cache()
    inp: dict = {"states": {}, "batches": {}}
    rng = np.random.default_rng(SEED + 43)
    for kind in DP_KINDS:
        cfg = dp_config(kind, "float32")
        batch = (pretrain_batches(cfg, 1, PRETRAIN_BATCH) if kind == "pretrain"
                 else ft_batches(cfg, "train"))[0]
        models, state, step = dp_build(kind, cfg)
        inp["states"][kind] = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                               for n, m in models.items()}
        inp["batches"][kind + " bf16"] = batch
        if kind == "pretrain":  # the renders' colour offsets, as the DP phase's
            batch = dict(batch, imgs=(batch["imgs"] + 2.0 * rng.standard_normal(
                (len(batch["imgs"]), 1, 1, 3))).astype(np.float32))
        inp["batches"][kind] = batch
        del models, state, step
    inp["batches"]["ft_cls eval"] = ft_batches(ft_config(), "test")[0][0]  # (batch, mask)
    print("  one process (T = 1):")
    one = tp_run(inp, "one process")
    ranks, backend, spawn_s = _tp_spawn(inp, TP_AXIS)
    print(f"  ranks on cards {[g['card'] for g in ranks]}, {spawn_s:.1f} s with their spawn "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    for kind in DP_KINDS:
        _tp_f32_against_one(kind, one, ranks, f"T = {TP_AXIS}")
    err = max(rel_err(g["ft_cls bf16"]["logits"], one["ft_cls bf16"]["logits"])[1]
              for g in ranks)
    print(f"  ft_cls bf16 eval logits [{FT_BATCH}, classes] on {TP_AXIS} model ranks against one "
          f"process: {err:.3e} (bound {MODEL_TOL['bfloat16']:.0e} relative)")
    expect(err <= MODEL_TOL["bfloat16"], "TP ft_cls bf16 eval logits off one process")
    for kind in DP_KINDS:
        w1 = one[f"{kind} bf16"]
        for r, g in enumerate(ranks):
            got = g[f"{kind} bf16"]
            pairs = [("step", got["counts"], w1["counts"])]
            if kind == "ft_cls":
                pairs.append(("eval", got["eval_counts"], w1["eval_counts"]))
            for what, c, want in pairs:
                for name, n in want.items():
                    expect(c[name] == n, f"TP {kind} {what} rank {r}: {name} launched {c[name]} "
                                         f"times, one process {n}")
            if kind == "ft_cls":
                launched = {**got["counts"], **{k: v for k, v in got["eval_counts"].items() if v}}
                expect(all(launched[n] > 0 for n in TP_LAUNCHED),
                       f"TP rank {r}: not every one of {TP_LAUNCHED} launched: {launched}")
        rep = [g[f"{kind} bf16"]["replicated"] for g in ranks]
        differ = [k for k, v in rep[0].items() if not torch.equal(v, rep[1][k])]
        print(f"  {kind} bf16, {TP_STEPS} steps: launches a rank "
              + ", ".join(f"{n} {ranks[0][f'{kind} bf16']['counts'][n]}" for n in TP_LAUNCHED
                          if n in w1["counts"])
              + (", eval " + ", ".join(f"{n} {ranks[0]['ft_cls bf16']['eval_counts'][n]}"
                                       for n in ("attn_kv_ln", "attn_small_qkv_ln"))
                 if kind == "ft_cls" else "")
              + f" (one process the same); {len(rep[0])} replicated parameter tensors, "
              f"{len(differ)} differ between the ranks")
        expect(not differ, f"TP {kind} bf16: replicated parameters differ between the ranks: "
                           f"{differ[:5]}")
    whole = [g["whole"] for g in ranks]
    differ = [k for k, v in whole[0]["replicated"].items()
              if not torch.equal(v, whole[1]["replicated"][k])]
    print(f"  {TP_WHOLE_ARCH} (heads do not divide {TP_AXIS}), 2 bf16 steps with dropout: "
          f"attentions (heads, model axis) {sorted(set(whole[0]['heads']))}, "
          f"{whole[0]['shards']} sharded tensors a rank; K8 launches a rank "
          + ", ".join(str(w["counts"]["attn_train_fwd"]) for w in whole)
          + f"; {len(whole[0]['replicated'])} replicated parameter tensors, {len(differ)} "
          "differ between the ranks")
    expect(all(set(w["heads"]) == {(3, 1)} and w["shards"] > 0 for w in whole),
           f"TP {TP_WHOLE_ARCH}: attentions not whole or MLPs not sharded")
    expect(all(w["counts"]["attn_train_fwd"] > 0 and w["counts"]["attn_train_bwd"] > 0
               for w in whole), f"TP {TP_WHOLE_ARCH}: K8 not launched on the whole attentions")
    expect(not differ, f"TP {TP_WHOLE_ARCH}: replicated parameters differ between the ranks: "
                       f"{differ[:5]}")
    for kind in DP_KINDS:
        ms1, ms2 = one[f"{kind} bf16"]["ms"], [g[f"{kind} bf16"]["ms"] for g in ranks]
        print(f"  {kind} bf16 step: T = 1 {ms1:.2f} ms; T = {TP_AXIS} ({backend}, {cards} "
              "card(s)) " + ", ".join(f"{m:.2f}" for m in ms2) + f" ms (ranks' host clock, {smi})")
    wide, backend, spawn_s = _tp_spawn(inp, TP_WIDE)
    print(f"  ranks on cards {[g['card'] for g in wide]}, {spawn_s:.1f} s with their spawn")
    _tp_f32_against_one("ft_cls", one, wide, f"W = {TP_WIDE} ({TP_WIDE // TP_AXIS} x {TP_AXIS})")
    print(f"phase tensor parallel took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ A/B mode
AB_ITERS = 20  # serving forwards a sample
AB_HOST_CALLS = 200  # wrapper calls whose host time is averaged


def _profile(fn, n: int):
    """torch.profiler over n fn() calls. The host's activity is traced too:
    a trace of the card alone came back empty for a call that launches
    through ctypes only (K18's backward)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def _device_events(fn, n: int) -> list:
    """torch.profiler's device kernels over n fn() calls (no user
    annotations, no optimizer ranges: they report their kernels' time
    again). On the card's machine a trace now and then comes back with no
    device activity at all (seen at K18's one-launch check and K9's route
    check): such a trace is taken again, up to twice, and reported."""
    for attempt in range(3):
        prof = _profile(fn, n)
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
        if ev:
            return ev
        print(f"  (torch.profiler: a trace with no device activity, attempt {attempt + 1})")
    return ev


def kernel_sums(fn, n: int, *names: str) -> list[float]:
    """torch.profiler's device time per fn() over n calls, in ms: of every
    kernel, then of those whose name holds each of `names`."""
    ev = _device_events(fn, n)
    return [sum(e.self_device_time_total for e in ev if pick in e.key) / 1e3 / n
            for pick in ("", *names)]


def device_kernels(fn, n: int = 3) -> dict[str, float]:
    """The kernels an fn() call launches, by name, with their launches a
    call (over n calls)."""
    return {e.key: e.count / n for e in _device_events(fn, n)}


def host_us(fn, calls: int = AB_HOST_CALLS, busy: bool = False) -> float:
    """Host time per fn() call in microseconds, the calls queued, not
    waited for. With the card idle, a launch may find it idle; with
    `busy`, the calls queue behind a spin kernel that outlasts them, so
    each launch only joins a queue (the wrapper's own cost)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if busy:
        torch.cuda._sleep(1 << 27)  # about 70 ms at the H100's clock
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def wrapper_us_in(module, name: str, fn, n: int) -> float:
    """Host time in microseconds a call of `module.<name>` (a kernel's
    wrapper) over the calls that n fn() calls make, the attribute replaced
    by a timed wrapper meanwhile."""
    orig, spent = getattr(module, name), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
    expect(bool(spent), f"{name} was never called")
    return sum(spent) * 1e6 / len(spent)


def time_tree(root: str) -> dict:
    """One A/B sample of the port in the checkout at `root`, imported from
    there (its kernels built there): the host time of a K5, K6, K8 forward
    and K11 wrapper call (the card idle, and busy; K6's and K8's device
    time), K8's backward on device time at B = 96 and 330 ([B, 128, 256]),
    K7's forward and backward at the pretrain point shape (events and
    device time) and at the ft_cls step's [330, 128] x [330, 1,024] (the
    backward's events, the forward's device time), K10 at the pretrain,
    ft_cls and semseg points (device time), K18's backward at BN_SHAPES[0] and K17's
    at LN_TIMED on device time, K9's bf16 forward and backward at the
    pretrain shape (x0 [96, 128, 32, 3], events), K3 and K4 at the serving
    shape B = 64 (device time, events beside; K4 also at the ft_cls
    eval's B = 330), K1 and K2 there, K2 at
    semseg's [32, 4,096] (k = 32, k = 200 and the lane-adversarial cloud:
    device time) and its wrapper's host time there and at [48, 2,048], K16 at [64,
    1,024], [160, 1,024] and [32, 4,096] and K15 at the 512-latent
    self-attention [64, 512] x [64, 512, 256] (device time), the
    serving forward at each of BATCHES (events, and its kernels' and K5's
    device time from torch.profiler), the Perceiver point feature forward
    at 512 latents, B = 64 (events), the ft_cls step (events over TIMED_STEPS steps, and
    its kernels', K11's and the attention backward kernels' device time a step), the
    ft_cls eval forward at B = 330 (events, its kernels' and K6's device
    time), the pretrain step at B = 48 (with its kernels', K1's and K2's
    device time and the K2 wrapper's host time a call), the partseg step
    at B = 96, the semseg step at B = 32 with K17 and K18 forced (events
    over TIMED_STEPS steps; the K2 wrapper's host time; its kernels' and
    K17's forward's device time a step), K17's forward at LN_SHAPES and
    K12's forward at the compat stem's gather (device time), and one
    eval_zeroshot run."""
    sys.path.insert(0, root)
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.models.factory import (build_ft_cls, build_ft_partseg,
                                                    build_ft_semseg, build_pc_model)
    from vipformer_tpu_torch.nn.pointnet import Group2Emb
    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.ops.cuda import attention as kattn
    from vipformer_tpu_torch.ops.cuda import batchnorm as kbn
    from vipformer_tpu_torch.ops.cuda import dense as kdense
    from vipformer_tpu_torch.ops.cuda import flash_train as kflash
    from vipformer_tpu_torch.ops.cuda import fps as kfps
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg9
    from vipformer_tpu_torch.ops.cuda import gather as kgather
    from vipformer_tpu_torch.ops.cuda import knn as kknn
    from vipformer_tpu_torch.ops.cuda import layernorm as kln
    from vipformer_tpu_torch.ops.cuda import patchify as kpatch
    from vipformer_tpu_torch.ops.cuda import stem as kstem
    from vipformer_tpu_torch.train.trainer import (create_state, make_cls_eval, make_cls_step,
                                                   make_feats_fn, make_partseg_step,
                                                   make_pretrain_step, make_semseg_step)

    expect(kcuda.__file__.startswith(root), f"imported {kcuda.__file__}, not the tree at {root}")
    kcuda.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out: dict = {}
    bf = dict(dtype=torch.bfloat16, device="cuda")
    with torch.inference_mode():
        q, k, v = (torch.randn((64, 128, 256), generator=gen, **bf) for _ in range(3))
        k5 = lambda: kattn.fused_attention_packed_small(q, k, v, num_heads=4,  # noqa: E731
                                                        scale=0.125)
        out["K5 wrapper us"], out["K5 wrapper us, card busy"] = host_us(k5), host_us(k5, busy=True)
        x = torch.randn((FT_BATCH, 128, 256), generator=gen, **bf)
        ln = [torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")]
        w = [torch.randn((256, 256), generator=gen, **bf) * 0.0625 for _ in range(3)]
        k6 = lambda: kattn.fused_attention_packed_small_qkv_ln(  # noqa: E731
            x, *ln, *w, num_heads=4, scale=0.125)
        out["K6 wrapper us"] = host_us(k6, calls=50)
        out["K6 wrapper us, card busy"] = host_us(k6, calls=50, busy=True)
        out[f"K6 B={FT_BATCH} device ms"] = queued_ms(k6, "K6")
        seed = torch.tensor([SEED + 1], dtype=torch.int32, device="cuda")
        qkv = [torch.randn((2 * PRETRAIN_BATCH, 128, 256), generator=gen, **bf) for _ in range(3)]
        k8 = lambda: kflash.attention_fwd_kernel(*qkv, seed, 4, 0.125, 0.1)  # noqa: E731
        out["K8 fwd wrapper us"] = host_us(k8)
        out["K8 fwd wrapper us, card busy"] = host_us(k8, busy=True)
        out["K8 fwd device ms"] = queued_ms(k8, "K8 forward")
        # K8's backward at the pretrain point shape and at the ft_cls step's
        for b in (2 * PRETRAIN_BATCH, FT_BATCH):
            qkv = [torch.randn((b, 128, 256), generator=gen, **bf) for _ in range(4)]
            o8, lse8 = kflash.attention_fwd_kernel(*qkv[:3], seed, 4, 0.125, 0.1)
            args = (*qkv, lse8, kflash.attention_delta(qkv[3], o8, 4), seed, 4, 0.125, 0.1)
            out[f"K8 bwd B={b} device ms"] = queued_ms(
                lambda: kflash.attention_bwd_kernel(*args), "K8 backward")
        # K7's backward at the pretrain point branch's cross-attention (events)
        b = 2 * PRETRAIN_BATCH
        q7, do7 = (torch.randn((b, 128, 256), generator=gen, **bf) for _ in range(2))
        x7 = torch.randn((b, 2048, 256), generator=gen, **bf)
        lnw = [torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")]
        w7 = [torch.randn((256, 256), generator=gen, **bf) * 0.0625 for _ in range(2)]
        o7, lse7 = kflash.attention_kv_fwd_kernel(q7, x7, *lnw, *w7, seed, 4, 0.125, 0.1)
        args = (q7, x7, *lnw, *w7, do7, lse7, kflash.attention_delta(do7, o7, 4), seed, 4, 0.125,
                0.1)
        k7 = lambda: kflash.attention_kv_fwd_kernel(q7, x7, *lnw, *w7, seed, 4, 0.125,  # noqa: E731
                                                    0.1)
        out["K7 fwd ms"] = cuda_ms(k7, iters=5)
        out["K7 fwd device ms"] = queued_ms(k7, "K7 forward", iters=5)
        out["K7 bwd ms"] = cuda_ms(lambda: kflash.attention_kv_bwd_kernel(*args), iters=5)
        out["K7 bwd device ms"] = queued_ms(lambda: kflash.attention_kv_bwd_kernel(*args),
                                            "K7 backward", iters=5)
        del x7
        # and at the ft_cls step's [330, 128] x [330, 1,024] (events)
        q7, do7 = (torch.randn((FT_BATCH, 128, 256), generator=gen, **bf) for _ in range(2))
        x7 = torch.randn((FT_BATCH, 1024, 256), generator=gen, **bf)
        o7, lse7 = kflash.attention_kv_fwd_kernel(q7, x7, *lnw, *w7, seed, 4, 0.125, 0.1)
        args = (q7, x7, *lnw, *w7, do7, lse7, kflash.attention_delta(do7, o7, 4), seed, 4, 0.125,
                0.1)
        out[f"K7 bwd B={FT_BATCH} ms"] = cuda_ms(lambda: kflash.attention_kv_bwd_kernel(*args),
                                                 iters=5)
        out[f"K7 fwd B={FT_BATCH} device ms"] = queued_ms(k7, "K7 forward", iters=5)
        # K10 at the pretrain, ft_cls and semseg points (device time)
        for b10, n10, c10 in ((2 * PRETRAIN_BATCH, 2048, 3), (FT_BATCH, NUM_POINTS, 3),
                              (SEMSEG_BATCH, SEMSEG_POINTS, 6)):
            p10 = torch.randn((b10, n10, c10), generator=gen, **bf)
            c10_ = torch.randn((b10, 128, 3), generator=gen, device="cuda")
            i10 = torch.randint(0, n10, (b10, 128 * 32), generator=gen, device="cuda",
                                dtype=torch.int32)
            out[f"K10 [{b10},{n10},{c10}] device ms"] = queued_ms(
                lambda: kgather.gather_centered_kernel(p10, c10_, i10, 32), "K10")
        del p10, c10_, i10
        # K18's backward at the semseg decode's widest BatchNorm (device time)
        r, c = BN_SHAPES[0]
        x18, dy18 = (torch.randn((r, c), generator=gen, **bf) for _ in range(2))
        m18, s18 = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        out["K18 bwd device ms"] = queued_ms(lambda: kbn.bn_grad_reduces(x18, dy18, m18, s18),
                                             "K18 backward")
        del x18, dy18
        # K17's backward at the semseg latents' LayerNorm
        r, d = LN_TIMED
        x17, dy17 = (torch.randn((r, d), generator=gen, **bf) for _ in range(2))
        s17 = torch.ones(d, device="cuda")
        _, mu17, rs17 = kln.ln_fwd(x17, s17, torch.zeros(d, device="cuda"))
        out["K17 bwd device ms"] = queued_ms(lambda: kln.ln_bwd(x17, dy17, mu17, rs17, s17),
                                             "K17 backward")
        # K17's forward at each of LN_SHAPES, bf16
        for r, d, _ in LN_SHAPES:
            xf = torch.randn((r, d), generator=gen, **bf)
            sf, bf_ = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            out[f"K17 fwd [{r},{d}] device ms"] = queued_ms(lambda: kln.ln_fwd(xf, sf, bf_),
                                                            "K17 forward")
            del xf
        # K12's forward at the compat stem's gather, [96, 1,024, 3] x 4,096, bf16
        p12 = torch.randn((PARTSEG_BATCH, NUM_POINTS, 3), generator=gen, **bf)
        i12 = torch.randint(0, NUM_POINTS, (PARTSEG_BATCH, 128 * 32), generator=gen,
                            device="cuda", dtype=torch.int32)
        out["K12 fwd device ms"] = queued_ms(lambda: kgather.gather_rows_kernel(p12, i12), "K12")
        del p12, i12
        # K9's bf16 forward and backward at the pretrain shape (events)
        r9 = 2 * PRETRAIN_BATCH * 128 * 32
        x9 = torch.randn((r9, 3), generator=gen, **bf)
        wb9 = [torch.randn(shape, generator=gen, device="cuda") * sc for shape, sc in (
            ((3, 64), 0.5), ((64,), 0.1), ((64,), 0.2), ((64,), 0.1), ((64, 128), 0.125),
            ((128,), 0.1), ((256, 256), 0.0625), ((256,), 0.1), ((256,), 0.2), ((256,), 0.1),
            ((256, 256), 0.0625), ((256,), 0.1))]
        wb9[2], wb9[8] = wb9[2] + 1.0, wb9[8] + 1.0
        _, h9, a9, st9 = kg9.g2e_fwd_kernel(x9, wb9, 32)
        dy9 = torch.randn((r9 // 32, 256), generator=gen, **bf)
        out["K9 fwd ms"] = cuda_ms(lambda: kg9.g2e_fwd_kernel(x9, wb9, 32), iters=5)
        out["K9 bwd ms"] = cuda_ms(lambda: kg9.g2e_bwd_kernel(x9, wb9, h9, a9, st9, dy9, 32),
                                   iters=5)
        del x9, h9, a9, dy9
        # K3 and K4 at the serving shape, B = 64 (device time; events beside)
        xyz = torch.randn((64, NUM_POINTS, 3), generator=gen, device="cuda")
        _, cen = kfps.fps(xyz, 128)
        ops3 = kstem.stem_operands(init_weights(Group2Emb(3, 256), SEED).cuda().eval(), xyz, cen,
                                   kknn.knn(32, xyz, cen), torch.bfloat16)
        k3 = lambda: kstem.stem_kernel(*ops3)  # noqa: E731
        out["K3 B=64 device ms"], out["K3 B=64 ms"] = queued_ms(k3, "K3"), cuda_ms(k3)
        q4 = torch.randn((64, 128, 256), generator=gen, **bf)
        x4 = torch.randn((64, NUM_POINTS, 256), generator=gen, **bf)
        k4 = lambda: kattn.fused_attention_packed_kv_ln(  # noqa: E731
            q4, x4, *ln, w[0], w[1], num_heads=4, scale=0.125)
        out["K4 B=64 device ms"], out["K4 B=64 ms"] = queued_ms(k4, "K4"), cuda_ms(k4)
        q4 = torch.randn((FT_BATCH, 128, 256), generator=gen, **bf)
        x4 = torch.randn((FT_BATCH, NUM_POINTS, 256), generator=gen, **bf)
        out[f"K4 B={FT_BATCH} device ms"] = queued_ms(k4, "K4")
        del ops3, q4, x4
        # K1 at the serving shape, and K15 at the point features' 512-latent
        # self-attention (device time)
        out["K1 B=64 device ms"] = queued_ms(lambda: kfps.fps(xyz, 128), "K1")
        out["K2 B=64 device ms"] = queued_ms(lambda: kknn.knn(32, xyz, cen), "K2")
        # K2 at semseg's [32, 4,096]: k = 32, the exact scan past the
        # threshold select's k (200) and on the lane-adversarial cloud (device
        # time); its wrapper's host time there and at pretrain's [48, 2,048]
        for kind, k2 in (("uniform", 32), ("uniform", 200), ("lane", 32)):
            x2 = knn_cloud(gen, kind, SEMSEG_BATCH, SEMSEG_POINTS)
            _, c2 = kfps.fps(x2, 128)
            out[f"K2 {kind} [{SEMSEG_BATCH},{SEMSEG_POINTS}] k={k2} device ms"] = queued_ms(
                lambda: kknn.knn(k2, x2, c2), "K2")
        out[f"K2 [{SEMSEG_BATCH},{SEMSEG_POINTS}] wrapper us"] = host_us(
            lambda: kknn.knn(32, x2, c2))
        x2 = torch.randn((PRETRAIN_BATCH, 2048, 3), generator=gen, device="cuda")
        _, c2 = kfps.fps(x2, 128)
        out[f"K2 [{PRETRAIN_BATCH},2048] wrapper us"] = host_us(lambda: kknn.knn(32, x2, c2))
        del x2, c2
        # K16 at the serving batch, the eval CLIs' and semseg's clouds
        for b16, n16 in ((64, NUM_POINTS), (EVAL_BATCH, NUM_POINTS), (SEMSEG_BATCH, SEMSEG_POINTS)):
            x16 = torch.randn((b16, n16, 3), generator=gen, device="cuda")
            out[f"K16 [{b16},{n16}] device ms"] = queued_ms(
                lambda: kpatch.fps_knn(x16, 128, 32), "K16")
        del x16
        q15, x15 = (torch.randn((PERCEIVER_FEATS_BATCH, PERCEIVER_WIDE_LATENTS, 256),
                                generator=gen, **bf) for _ in range(2))
        out["K15 device ms"] = queued_ms(lambda: kattn.fused_attention_packed_kv(
            q15, x15, w[0], w[1], num_heads=4, scale=0.125), "K15")
        del q15, x15
        # K4 at eval_zeroshot's B = 160, the Perceiver's 512 latents and Din =
        # 384 (device time)
        k4_shapes = ((EVAL_BATCH, 128, NUM_POINTS, 256, 4),) + K4_PERCEIVER_SHAPES[1:]
        for b4, g4, m4, d4, h4 in k4_shapes + K4_DIN384_SHAPES:
            a4 = kv_ln_args(gen, b4, g4, m4, d4)
            out[f"K4 q[{b4},{g4}] x[{b4},{m4},{d4}] device ms"] = queued_ms(
                lambda: kattn.fused_attention_packed_kv_ln(*a4, num_heads=h4, scale=0.125), "K4")
            del a4
    del x, ln, w, qkv, args, x7, x17, dy17
    x, dy = torch.randn((42240, 256), generator=gen, **bf), torch.randn((42240, 256), generator=gen,
                                                                          **bf)
    k11 = lambda: kdense.dense_grads(x, dy)  # noqa: E731
    out["K11 wrapper us"] = host_us(k11, calls=50)
    out["K11 wrapper us, card busy"] = host_us(k11, calls=50, busy=True)
    del q, k, v, x, dy
    model = serving_model("bfloat16", "cuda")
    with torch.inference_mode():
        for b in BATCHES:
            pts = torch.randn((b, NUM_POINTS, 3), device="cuda", generator=gen)
            out[f"serve B={b} ms"] = cuda_ms(lambda: model(pts), iters=AB_ITERS)
            busy, k5 = kernel_sums(lambda: model(pts), 4, "attn_small")
            out[f"serve B={b} kernels ms"], out[f"serve B={b} K5 ms"] = busy, k5
    del model
    # the Perceiver point features at 512 latents (K4 once, K15 six times)
    feats = make_feats_fn(build_pc_model(
        perceiver_config(num_pc_latents=PERCEIVER_WIDE_LATENTS), device="cuda"))
    pts = torch.randn((PERCEIVER_FEATS_BATCH, perceiver_config().num_pt_points, 3),
                      generator=gen, device="cuda")
    with torch.inference_mode():
        out["perceiver feats pc512 ms"] = cuda_ms(lambda: feats(pts), iters=AB_ITERS)
    del feats
    cfg = ft_config()
    batches = ft_batches(cfg, "train")[:2]
    model = build_ft_cls(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_cls_step(cfg, model)

    def run(n: int) -> None:
        for i in range(n):
            step(state, batches[i % len(batches)], cfg.lr, gen)

    run(2)
    out["ft_cls step ms"] = cuda_ms(lambda: run(1), iters=TIMED_STEPS, warmup=0)
    out["ft_cls step kernels ms"] = kernel_sums(lambda: run(1), 2)[0]
    # K11 at its own sites: the bf16 K9's backward runs dW2 and dW1 on K11's kernel
    prof = _profile(lambda: run(1), 2)
    k11, flash = (sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and pick in e.key)
                  / 1e3 / 2 for pick in (K11_KERNEL, "flash_bwd_"))
    k9_k11 = kernels_launched_in(prof, K9_BWD_NODE, K11_KERNEL)[0] / 2
    out["ft_cls K11 ms"], out["ft_cls K9 bwd K11 ms"] = k11 - k9_k11, k9_k11
    out["ft_cls flash bwd ms"] = flash
    del prof
    eval_step = make_cls_eval(model)
    pts = torch.from_numpy(ft_batches(cfg, "test")[0][0]["points"]).cuda()
    out[f"ft_cls eval B={FT_BATCH} ms"] = cuda_ms(lambda: eval_step(pts), iters=AB_ITERS)
    out[f"ft_cls eval B={FT_BATCH} kernels ms"], out[f"ft_cls eval B={FT_BATCH} K6 ms"] = \
        kernel_sums(lambda: eval_step(pts), 4, "attn_small_qkv_ln")
    del model, state, step, eval_step
    torch.cuda.empty_cache()
    cfg = config()  # the pretrain step at B = 48
    batches = pretrain_batches(cfg, 2, PRETRAIN_BATCH)
    models = pretrain_models(cfg, "cuda")
    state = create_state(cfg, models)
    step = make_pretrain_step(cfg, models["pc"], models["img"])
    run(2)
    out["pretrain step ms"] = cuda_ms(lambda: run(1), iters=TIMED_STEPS, warmup=0)
    # inside the step: K2's wrapper's host time a call, and the device time
    # of the step's kernels, K2's and K1's
    out["pretrain knn wrapper us"] = wrapper_us_in(kknn, "knn", lambda: run(1), TIMED_STEPS)
    (out["pretrain step kernels ms"], out["pretrain K2 device ms"],
     out["pretrain K1 device ms"]) = kernel_sums(lambda: run(1), 2, "knn_kernel", "fps_kernel")
    del models, state, step, batches
    torch.cuda.empty_cache()
    cfg = partseg_config()  # the partseg step at B = 96
    batches = partseg_batches(cfg, "trainval")[:2]
    model = build_ft_partseg(cfg, device="cuda")
    state = create_state(cfg, {"pc": model})
    step = make_partseg_step(cfg, model)
    run(2)
    out["partseg step ms"] = cuda_ms(lambda: run(1), iters=TIMED_STEPS, warmup=0)
    del model, state, step, batches
    torch.cuda.empty_cache()
    cfg = semseg_config()  # the semseg step at B = 32 with K17 and K18 forced
    batches = semseg_batches(cfg, "train")[:2]
    saved = _forced_norms(True)
    try:
        model = build_ft_semseg(cfg, device="cuda")
        state = create_state(cfg, {"pc": model})
        step = make_semseg_step(cfg, model)
        run(2)
        out["semseg forced step ms"] = cuda_ms(lambda: run(1), iters=TIMED_STEPS, warmup=0)
        out["semseg knn wrapper us"] = wrapper_us_in(kknn, "knn", lambda: run(1), TIMED_STEPS)
        (out["semseg forced step kernels ms"], out["semseg forced K17 fwd ms"]) = kernel_sums(
            lambda: run(1), 2, "ln_fwd_kernel")
    finally:
        _restore_norms(saved)
    del model, state, step, batches
    torch.cuda.empty_cache()
    out["eval_zeroshot s"] = time_eval_zeroshot()
    return out


def time_eval_zeroshot() -> float:
    """Host seconds of one `cli.eval_zeroshot` run at the flagship (B=160,
    the synthetic ModelNet40, the probes included), as drive_eval_clis
    runs it."""
    import tempfile

    from vipformer_tpu_torch.cli import eval_zeroshot

    with tempfile.TemporaryDirectory() as root:
        cfg, device = eval_zeroshot.parse_args(eval_args("zs", root, "--pt_dataset",
                                                         "ModelNet40"))
        t0 = time.perf_counter()
        eval_zeroshot.main(cfg, device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def ab(other: str, pairs: int) -> int:
    """Time `other` (another checkout) and this one in turns, `pairs` pairs
    in the order other, this, this, other, other, this, ...: each sample in
    a process of its own (`--time-tree`), so that each imports its own
    package. Prints each sample and, per metric, both trees' samples, their
    medians and this tree's difference in each pair."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"A/B on {smi}: this tree {here} against {other}, {pairs} pairs")
    samples: dict = {here: [], other: []}
    for i in range(pairs):
        for tree in ((other, here) if i % 2 == 0 else (here, other)):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                                 capture_output=True, text=True)
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
            if res.returncode or not lines:
                print(f"chip_smoke --ab FAILED on {tree}:\n{res.stdout}\n{res.stderr}",
                      file=sys.stderr)
                return 1
            samples[tree].append(json.loads(lines[-1]))
            print(f"pair {i} {'this' if tree == here else 'other'}: {lines[-1]}", flush=True)
    for key in samples[here][0]:
        mine, theirs = ([s[key] for s in samples[t]] for t in (here, other))
        diffs = [a - b for a, b in zip(mine, theirs)]
        print(f"{key}: this median {float(np.median(mine)):.4f}, other median "
              f"{float(np.median(theirs)):.4f}, this - other by pair "
              f"{' '.join(f'{d:+.4f}' for d in diffs)} (faster in "
              f"{sum(d < 0 for d in diffs)} of {len(diffs)})")
    return 0


# sources whose kernels --ptxas also reads the SASS of (instruction counts)
SASS_SOURCES = ("fps", "knn", "patchify")


def sass_counts(cubin: str) -> dict[str, tuple[int, int, int]]:
    """Each kernel of a cubin: (SASS instructions, LDS.128 loads, REDUX
    warp reductions), from `cuobjdump -sass`, names demangled."""
    import re

    from vipformer_tpu_torch.ops import cuda as kcuda

    tool = os.path.join(os.path.dirname(kcuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
        demangled = subprocess.run(["c++filt", name.strip()], capture_output=True, text=True)
        kernel = demangled.stdout.strip().replace("(anonymous namespace)::", "")
        kernel = kernel.removeprefix("void ").split("(")[0] or name.strip()
        out[kernel] = (len(ins), sum("LDS.128" in i for i in ins), sum("REDUX" in i for i in ins))
    return out


def ptxas(out_dir: str) -> int:
    """Compile every csrc/*.cu as the build does, with `-Xptxas -v` (one
    nvcc per source, all started together), write each source's report to
    OUT_DIR/ptxas_<source>.txt, and print each kernel's registers, spilled
    bytes and shared memory; for SASS_SOURCES also each kernel's SASS
    instructions, LDS.128 loads and REDUX reductions (the cubin kept in
    OUT_DIR)."""
    import re

    from vipformer_tpu_torch.ops import cuda as kcuda

    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in (p for p in kcuda.sources() if p.endswith(".cu")):
        name = os.path.splitext(os.path.basename(src))[0]
        out = (["-cubin", "-o", os.path.join(out_dir, f"{name}.cubin")] if name in SASS_SOURCES
               else ["-c", "-o", os.devnull])
        cmd = [kcuda._nvcc(), *kcuda.NVCC_FLAGS, "-Xptxas", "-v", *out, src]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = 0
    for src, proc in procs:
        log, _ = proc.communicate()
        name = os.path.splitext(os.path.basename(src))[0]
        with open(os.path.join(out_dir, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
        if proc.returncode:
            print(f"ptxas: {name} failed:\n{log[-4000:]}", file=sys.stderr)
            failed += 1
            continue
        kernel = spill = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
                demangled = subprocess.run(["c++filt", kernel], capture_output=True, text=True)
                name_ = demangled.stdout.strip().replace("(anonymous namespace)::", "")
                kernel = name_.removeprefix("void ").split("(")[0] or kernel
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spill = f"spills {m.group(1)}/{m.group(2)} B" if m else spill
            m = re.search(r"Used (\d+) registers(.*)", line)
            if m and kernel:
                print(f"{name:12s} {m.group(1):>4s} registers, {spill:18s} {kernel[:90]}"
                      f"{m.group(2).replace(', used', ';')[:50]}")
                kernel = ""
        if name in SASS_SOURCES:
            for kernel, (n_ins, lds, redux) in sass_counts(
                    os.path.join(out_dir, f"{name}.cubin")).items():
                print(f"{name:12s} SASS {n_ins:6d} instructions, {lds:4d} LDS.128, {redux:4d} "
                      f"REDUX  {kernel[:90]}")
    return 1 if failed else 0


# (case, B, G, S, D, Cin, the seed of the data): the card tests' K9 cases
# (tests/test_torch_port_cuda.py builds them from these seeds), and two
# widths the bf16 kernels take padded to a multiple of 64
K9_NUMERICS_CASES = (
    ("test_g2e_train_kernel_matches_twin[2-5-7-64]", 2, 5, 7, 64, 3, 3),
    ("test_g2e_train_kernel_matches_twin[1-8-32-256]", 1, 8, 32, 256, 3, 3),
    ("test_g2e_train_kernel_at_segmentation_width[3]", 8, 64, 32, 384, 3, 4),
    ("test_g2e_train_kernel_at_segmentation_width[6]", 8, 64, 32, 384, 6, 4),
    ("test_g2e_bf16_takes_any_width[96]", 8, 64, 32, 96, 3, 5),
    ("test_g2e_bf16_takes_any_width[512]", 8, 64, 32, 512, 3, 5))
K9_GRAD_NAMES = ("dx0", "dW0", "db0", "dgamma0", "dbeta0", "dW1", "db1", "dW2", "db2",
                 "dgamma1", "dbeta1", "dW3", "db3")


def g2e_case(rng, d: int, cin: int, dev):
    """Group2Emb's 12 f32 parameters as the card tests draw them: the
    Dense layers from init_weights (seed 0), the BatchNorm scales and
    shifts from rng."""
    from vipformer_tpu_torch.models.crossformer import init_weights
    from vipformer_tpu_torch.nn.pointnet import Group2Emb

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    m = init_weights(Group2Emb(cin, d), 0).to(dev)
    wb = [m.Dense_0.weight.t(), m.Dense_0.bias, t((64,), 0.2) + 1.0, t((64,), 0.1),
          m.Dense_1.weight.t(), m.Dense_1.bias, m.Dense_2.weight.t(), m.Dense_2.bias,
          t((256,), 0.2) + 1.0, t((256,), 0.1), m.Dense_3.weight.t(), m.Dense_3.bias]
    return [w.detach().float().contiguous() for w in wb]


def k9_readings(kg, x0, wb, s: int, dy) -> list[tuple[str, float, float, float]]:
    """(name, kernel vs f32 twin, f32 twin vs f64 twin, kernel vs f64 twin)
    for dx0 and the 12 gradients of the bf16 backward, each as max abs
    error over max(1, max |reference|), the forward from the twin."""
    _, h3p, amax, stats = kg.g2e_fwd_plain(x0, wb, s)
    args = (x0, wb, h3p, amax, stats, dy, s)
    dx_k, gr_k = kg.g2e_bwd_kernel(*args)
    dx_f, gr_f = kg.g2e_bwd_plain(*args)
    dx_d, gr_d, rss = kg.g2e_bwd_plain(*args, acc=torch.float64, rss=True)
    out = [(name, rel_err(k, f)[1], rel_err(f, r)[1], rel_err(k, r)[1])
           for name, k, f, r in zip(K9_GRAD_NAMES, (dx_k, *gr_k), (dx_f, *gr_f),
                                    (dx_d, *gr_d))]
    # the exactly-zero gradients against their rounding noise: 2^-8 times
    # the column's root sum of squares of its rows
    for i, rs in zip(ZERO_GRADS, rss):
        noise = rs.clamp_min(1e-30) * 2.0 ** -8
        col = [((a - b).abs() / noise).max().item()
               for a, b in ((gr_k[i], gr_f[i]), (gr_f[i], gr_d[i]), (gr_k[i], gr_d[i]))]
        out.append((K9_GRAD_NAMES[i + 1] + " by rounding noise", *col))
    return out


# the chip_smoke sites that hold K9's exactly-zero gradients, as (name, B,
# G, S, D, Cin): the pretrain step's patches, K9_GROUPS, K9_OTHER_WIDTHS and
# the partseg and semseg widths
K9_ZERO_SITES = (
    ("pretrain x0[96,128,32,3]", 96, 128, 32, 256, 3),
    ("x0[96,128,24,3]", 96, 128, 24, 256, 3),
    ("x0[24,128,128,3]", 24, 128, 128, 256, 3),
    ("D=96 x0[24,128,32,3]", 24, 128, 32, 96, 3),
    ("D=512 x0[24,128,32,3]", 24, 128, 32, 512, 3),
    ("partseg D=384 x0[96,128,32,3]", 96, 128, 32, 384, 3),
    ("semseg D=384 x0[32,128,32,6]", 32, 128, 32, 384, 6))
K9_ZERO_SEEDS = 10  # seeds a case in --k9-numerics
ZERO_NAMES = ("db0", "db1", "db2")


def zero_grad_unit(rss: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A column's rounding-noise unit of K9's exactly-zero gradients: the
    compute dtype's unit roundoff (2^-8 bf16, 2^-24 f32) times the root sum
    of squares of the column's rows (`g2e_bwd_plain(..., rss=True)`)."""
    u = 2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -24
    return rss.double().clamp_min(1e-30) * u


def zero_grad_bound(rss: torch.Tensor, rows: int, dt: torch.dtype) -> torch.Tensor:
    """The bound of a column of K9's exactly-zero gradients, kernel against
    twin (ZERO_GRADS): ZERO_LAMBDA (u_dt + u32 sqrt(R)) rss, rss the root
    sum of squares of the column's rows (`g2e_bwd_plain(..., rss=True)`)."""
    u = 2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -24
    return rss.double().clamp_min(1e-30) * (ZERO_LAMBDA * (u + 2.0 ** -24 * rows ** 0.5))


def check_zero_grads(rec: Recorder, kernel: str, what: str, grads, ref, rss, rows: int,
                     dt: torch.dtype) -> None:
    """K9's exactly-zero gradients against the twin's by `zero_grad_bound`,
    column by column (the reading is the largest column's share of its
    bound)."""
    for i, r in zip(ZERO_GRADS, rss):
        diff = (grads[i].double() - ref[i].double()).abs()
        rec.check(kernel, f"{what} grad {i} (zero)", diff.max().item(),
                  (diff / zero_grad_bound(r, rows, dt)).max().item(), 1.0)


def k9_zero_readings(kg, x0, wb, s: int, dy) -> dict:
    """K9's exactly-zero gradients (db0, db1, db2) on one draw, by both
    rules: "sqrtR", max |kernel - f32 twin| over GRAD_TOL["float32"]
    sqrt(R) (the older bound), and "noise", the largest column's |kernel -
    f32 twin| in units of zero_grad_unit (check_k9_ties_and_zeros' rule in
    bf16); "bound", the same over zero_grad_bound; in bf16 also the kernel
    and the f32 twin against the f64 twin in zero_grad_unit."""
    rows = x0.shape[0]
    _, h3p, amax, stats = kg.g2e_fwd_plain(x0, wb, s)
    args = (x0, wb, h3p, amax, stats, dy, s)
    _, gr_k = kg.g2e_bwd_kernel(*args)
    _, gr_f, rss = kg.g2e_bwd_plain(*args, rss=True)
    gr_d = None
    if x0.dtype == torch.bfloat16:
        _, gr_d = kg.g2e_bwd_plain(*args, acc=torch.float64)
    out = {}
    for i, name, r in zip(ZERO_GRADS, ZERO_NAMES, rss):
        bnd = zero_grad_unit(r, x0.dtype)
        k, f = gr_k[i].double(), gr_f[i].double()
        got = {"sqrtR": (k - f).abs().max().item() / (GRAD_TOL["float32"] * rows ** 0.5),
               "noise": ((k - f).abs() / bnd).max().item(),
               "bound": ((k - f).abs() / zero_grad_bound(r, rows, x0.dtype)).max().item()}
        if gr_d is not None:
            dd = gr_d[i].double()
            got["k-f64"] = ((k - dd).abs() / bnd).max().item()
            got["f32-f64"] = ((f - dd).abs() / bnd).max().item()
        out[name] = got
    return out


def k9_numerics() -> int:
    """The readings of `--k9-numerics` (module docstring)."""
    from vipformer_tpu_torch.ops import cuda as kcuda
    from vipformer_tpu_torch.ops.cuda import g2e_train as kg

    kcuda.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    tol = GRAD_TOL["bfloat16"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"K9's exactly-zero db0, db1, db2 at {K9_ZERO_SEEDS} seeds a case, f32 and bf16: "
          f"sqrtR = max|kernel - f32 twin| / ({GRAD_TOL['float32']} sqrt(R)), noise = the "
          f"largest column's |kernel - f32 twin| / zero_grad_bound; bf16 also kernel and f32 "
          f"twin against the f64 twin in units of zero_grad_bound; each fails above 1 ('!')")
    cases = [(c, b, g, s, d, cin, seed) for c, b, g, s, d, cin, seed in K9_NUMERICS_CASES]
    cases += [(c, b, g, s, d, cin, SEED + 60 + j) for j, (c, b, g, s, d, cin)
              in enumerate(K9_ZERO_SITES)]
    for case, b, g, s, d, cin, seed in cases:
        worst: dict = {}
        fails: dict = {}
        for dt_name, dt in (("float32", torch.float32), ("bfloat16", bf)):
            for sd in range(seed, seed + 100 * K9_ZERO_SEEDS, 100):
                rng = np.random.default_rng(sd)
                wb = [w.to(dev) for w in g2e_case(rng, d, cin, dev)]
                x0 = torch.from_numpy(rng.standard_normal((b * g * s, cin)).astype(np.float32))
                dy = torch.from_numpy(rng.standard_normal((b * g, d)).astype(np.float32))
                got = k9_zero_readings(kg, x0.to(dev, dt), wb, s, dy.to(dev, dt))
                print(f"ZERO {case} R={b * g * s} {dt_name} seed {sd}: " + "; ".join(
                    f"{n} " + " ".join(f"{k} {v:.3e}{'!' if v > 1.0 else ''}"
                                       for k, v in vals.items()) for n, vals in got.items()),
                      flush=True)
                for vals in got.values():
                    for k, v in vals.items():
                        key = (dt_name, k)
                        worst[key] = max(worst.get(key, 0.0), v)
                        fails[key] = fails.get(key, 0) + (v > 1.0)
                del wb, x0, dy, got
                torch.cuda.empty_cache()
        print(f"ZERO {case} over {K9_ZERO_SEEDS} seeds: " + "; ".join(
            f"{dt} {k} at most {v:.3e} ({fails[(dt, k)]} of {3 * K9_ZERO_SEEDS} readings "
            f"above 1)" for (dt, k), v in worst.items()), flush=True)
    print(f"K9 bf16 backward: kernel-f32 / f32-f64 / kernel-f64, rel to max(1, max|ref|), "
          f"bound {tol} ('!' above it)")
    for case, b, g, s, d, cin, seed in K9_NUMERICS_CASES:
        rng = np.random.default_rng(seed)
        wb = [w.to(dev) for w in g2e_case(rng, d, cin, dev)]
        x0 = torch.from_numpy(rng.standard_normal((b * g * s, cin)).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((b * g, d)).astype(np.float32))
        got = k9_readings(kg, x0.to(dev, bf), wb, s, dy.to(dev, bf))
        print(f"{case} seed {seed}: " + "; ".join(
            f"{n} " + " / ".join(f"{v:.3e}{'!' if v > tol else ''}" for v in vals)
            for n, *vals in got), flush=True)
    # dx0 over ten cotangents at the chip_smoke group sizes, two inputs each
    for b, g, s in ((96, 128, 24), (96, 128, 32), (24, 128, 128)):
        rows, worst = b * g * s, [0.0, 0.0, 0.0]
        for xs in (SEED + 50, SEED + 51):
            rng = np.random.default_rng(xs)
            wb = g2e_case(rng, 256, 3, dev)
            x0 = torch.from_numpy(rng.standard_normal((rows, 3)).astype(np.float32)).to(dev, bf)
            for ds in range(SEED + 9, SEED + 19):
                dy = torch.from_numpy(np.random.default_rng(ds).standard_normal(
                    (rows // s, 256)).astype(np.float32)).to(dev, bf)
                _, a, f, k = k9_readings(kg, x0, wb, s, dy)[0]
                worst = [max(w, v) for w, v in zip(worst, (a, f, k))]
                del dy
            del x0, wb
            torch.cuda.empty_cache()
        print(f"x0[{b},{g},{s},3]: dx0 at most {worst[0]:.3e} / {worst[1]:.3e} / {worst[2]:.3e} "
              f"over 20 (input, cotangent) draws, bound {tol}")
    return 0


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

    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        kcuda.lib()
        print(f"built kernels in {time.perf_counter() - t0:.1f} s: {kcuda.build()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rec = Recorder()
        check_one_pass_launches()
        check_vjp_launches()
        check_k15_kernels()
        check_k7_forward_kernels()
        check_serving_kernels(rec)
        check_fps_widths(rec)
        check_knn_clouds(rec)
        check_k3_k4_eval_shapes(rec)
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
        del batches
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        check_device_augs_chain()
        device_augs_counts: dict = {}
        drive_device_augs_path(device_augs_counts, pretrain_counts)
        time_pretrain_loop()
        torch.cuda.empty_cache()
        print(f"phases 8a-8c (device augmentation, the pretrain loop) took "
              f"{time.perf_counter() - t0:.1f} s")
        route_ms: dict = {}
        check_ft_cls_kernels(rec, route_ms)
        torch.cuda.empty_cache()
        cfg = ft_config()
        ft_train, ft_test = ft_batches(cfg, "train"), ft_batches(cfg, "test")
        ft_counts: dict = {}
        ft_eval_counts: dict = {}
        drive_ft_cls_path(ft_counts, ft_eval_counts, ft_train, ft_test)
        compare_ft_cls_with_cpu({k: v[:2] for k, v in ft_train[0].items()},
                                {k: v[:8] for k, v in ft_train[0].items()})
        time_ft_cls(ft_train, ft_test, route_ms)
        del ft_train, ft_test
        torch.cuda.empty_cache()
        check_gather_rows(rec)
        check_partseg_widths(rec)
        torch.cuda.empty_cache()
        cfg = partseg_config()
        ps_train, ps_test = partseg_batches(cfg, "trainval"), partseg_batches(cfg, "test")
        partseg_counts: dict = {}
        drive_partseg_path(partseg_counts, ps_train, ps_test)
        compare_partseg_with_cpu({k: v[:2] for k, v in ps_test[0][0].items()},
                                 {k: v[:8] for k, v in ps_train[0].items()})
        time_partseg(ps_train, ps_test)
        time_partseg_forced_bn(ps_train)
        del ps_train, ps_test
        torch.cuda.empty_cache()
        check_perceiver_kernels(rec)
        torch.cuda.empty_cache()
        pcfg = perceiver_config()
        p_batches = pretrain_batches(pcfg, 2, PRETRAIN_BATCH)
        p_ft_train = ft_batches(perceiver_ft_config(), "train")
        p_ft_test = ft_batches(perceiver_ft_config(), "test")
        perceiver_counts: dict = {"perceiver pretrain": {}, "perceiver ft_cls": {},
                                  "perceiver ft_cls eval": {}}
        drive_perceiver_pretrain(perceiver_counts["perceiver pretrain"], p_batches)
        drive_perceiver_ft_cls(perceiver_counts["perceiver ft_cls"],
                               perceiver_counts["perceiver ft_cls eval"], p_ft_train, p_ft_test)
        drive_perceiver_feats(perceiver_counts, p_batches)
        torch.cuda.empty_cache()
        compare_perceiver_with_cpu(p_batches[0], p_ft_train[0])
        time_perceiver(p_batches, p_ft_train, p_ft_test)
        del p_batches, p_ft_train, p_ft_test
        torch.cuda.empty_cache()
        check_norm_kernels(rec)
        check_semseg_widths(rec)
        torch.cuda.empty_cache()
        scfg = semseg_config()
        ss_train, ss_test = semseg_batches(scfg, "train"), semseg_batches(scfg, "test")
        semseg_counts: dict = {}
        drive_semseg_path(semseg_counts, ss_train, ss_test)
        compare_semseg_forced({k: v[:8] for k, v in ss_train[0].items()})
        compare_semseg_with_cpu({k: v[:2] for k, v in ss_test[0][0].items()},
                                {k: v[:8] for k, v in ss_train[0].items()})
        time_semseg(ss_train, ss_test)
        del ss_train, ss_test
        torch.cuda.empty_cache()
        check_probe()
        check_patchify_and_head_split(rec)
        torch.cuda.empty_cache()
        eval_counts: dict = {}
        eval_times: dict = {}
        drive_eval_clis(eval_counts, eval_times)
        time_eval_forward()
        compare_eval_with_cpu()
        drive_perceiver_head_split(eval_counts)
        check_resume_on_card()
        check_data_parallel({"pretrain": (STEPS, pretrain_counts), "ft_cls": (FT_STEPS, ft_counts)})
        check_tensor_parallel()
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
    counts = {"serve": serve_counts, "pretrain": pretrain_counts,
              "pretrain device_augs": device_augs_counts, "ft_cls": ft_counts,
              "ft_cls eval": ft_eval_counts, **partseg_counts, **perceiver_counts,
              **semseg_counts, **eval_counts}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_line(rec, counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--time-tree":
        if not torch.cuda.is_available():
            sys.exit(2)
        print(json.dumps(time_tree(os.path.abspath(sys.argv[2]))))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--ptxas":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(ptxas(sys.argv[2]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--ab":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10))
    if len(sys.argv) == 2 and sys.argv[1] == "--k9-numerics":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(k9_numerics())
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
