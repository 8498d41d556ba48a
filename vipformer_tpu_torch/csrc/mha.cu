// K14: head-split eval attention, the whole key axis per (batch, head).
//
// Replaces vipformer_tpu/ops/pallas/attention.py:71 fused_attention
// (`_mha_kernel`, attention.py:34-50).
//
// q [BH, G, dh], k [BH, M, dh], v [BH, M, dv] -> o [BH, G, dv], no mask
// and no dropout: logits q.k * scale and the softmax in f32, p normalised
// BEFORE the PV product and rounded to v's dtype, PV accumulated in f32,
// the output in v's dtype (the Pallas kernel's numerics).
//
// The dtype picks the kernel (ops/cuda/__init__.py `tc_route`):
//
// * bf16: `mha_tc_kernel`, on the tensor cores (mma.sync m16n8k16 and
//   ldmatrix from csrc/mma.cuh, cp.async loads).
// * f32: `mha_kernel`, f32 FMAs on the CUDA cores. A tensor-core f32
//   product is TF32, which keeps about 3 decimal digits and would break
//   the f32 bound of 2e-5 against the twin and the 1e-4 card-vs-CPU
//   checks, so f32 stays here.
//
// Bound on the H100 at the point features' cross-attention with v 128
// (q [64, 4, 128, 64] over M = 2,048, dv = 32, bf16): bytes. q, k, v and
// o are 107 MB, 0.032 ms at 3.35 TB/s; the products are 2 * BH * G * M *
// (dh + dv) = 12.9 GFLOP (0.013 ms at 989 TFLOP/s), 21.5 GFLOP as this
// kernel runs them (the logits twice).
//
// Design, bf16: the TPU kernel holds a (batch, head) slice's whole
// [G, M] score block in VMEM; a Hopper block cannot, so it streams the
// keys twice. One block of 8 warps per (batch x head, 128 query rows),
// each warp 16 rows; at G = 128 that is one block per (b, h), 256 blocks,
// two to an SM. q goes into registers once, as ldmatrix A fragments.
// Pass 1 streams 64-key tiles of k through a ring of 3 cp.async stages
// (one barrier a tile), computes the logits on mma.sync (dh/16 k steps)
// and keeps each row's running max and sum in registers, per lane and
// combined over the quad of lanes that shares the row. Pass 2 streams k
// and v tiles through the same ring (the first pass-2 tiles load while
// pass 1 ends), recomputes the logits with the same instruction sequence
// (so the same bits: the max of pass 1 is the max of what pass 2 sees),
// forms p = exp(s - max) * (1 / sum), rounds it to bf16 in registers as
// the A fragments of P.V (two n8 accumulator tiles make one k16
// fragment), and reads v through ldmatrix.trans. The logits are kept in
// log2 units (s * scale * log2 e), so each exp is one ex2.approx (within
// 2 ulp). Shared rows are padded to width + 8 bf16, so the ldmatrix row
// addresses hit distinct banks. Rows past M are zero-filled by cp.async
// and get -inf logits; query rows past G are computed on zeros and not
// written, and a warp whose rows all lie past G skips the products. The
// helpers (csrc/mma.cuh) take MT row tiles a warp; K13 runs 2, this
// kernel 1, which measured 3% faster here (PERF.md).
// Pass 2 reads k again: 256 KB a block at M = 2,048, 67 MB for the 256
// blocks, more than the 50 MB L2, so much of that second read may come
// from device memory; no profiler here counts the bytes, and no one-pass
// variant was timed. The kernel takes 1.9x the byte time of both reads
// from device memory (PERF.md), so the second read does not bound it.
// Per -Xptxas -v on the card (sm_90a): 90 / 118 / 122 / 122 registers at
// (dh, dv) = (32, 32) / (32, 64) / (64, 32) / (64, 64), no spills; shared
// memory 40,960 / 53,248 / 61,440 / 73,728 bytes a block.
//
// Design, f32: one block of 256 threads per (batch x head, 64-query
// tile); thread (ty, tx) of the 16 x 16 grid owns score rows ty + 16 i
// and columns tx + 16 j (i, j < 4) of a 64 x 64 tile, and output rows
// ty + 16 i, columns tx + 16 j. Pass 1 streams the k tiles through shared
// memory and keeps each row's running max and sum over the thread's own
// columns (combined over the 16 threads of a row at the end). Pass 2
// recomputes the same logits (the same function, so the same bits),
// forms p = exp(s - max) / sum into shared memory, and accumulates p.V
// from the v tile. The key axis may have any length; a ragged last tile
// is masked.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16

// The 4 x 4 logits of thread (ty, tx) in the current tile: explicit FMAs
// in d order, then the scale, so both passes compute the same bits.
template <int DH>
__device__ __forceinline__ void tile_logits(const float* qs, const float* ks, int ty, int tx,
                                            float scale, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], scale);
}

// rows [r0, r0 + R) of a [rows, W] tensor -> shared memory with row
// stride `stride`; rows at or past `rows` are zero
template <int W>
__device__ __forceinline__ void load_rows(float* dst, int stride, const float* __restrict__ src,
                                          int r0, int rows, int R) {
  for (int e = threadIdx.x; e < R * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    dst[r * stride + c] = r0 + r < rows ? src[(size_t)(r0 + r) * W + c] : 0.0f;
  }
}

// exp(a - m) where a may be -inf (a thread with no column yet): 0 then
__device__ __forceinline__ float rescale(float a, float m) {
  return a == -CUDART_INF_F ? 0.0f : expf(a - m);
}

template <int DH, int DV>
__global__ void __launch_bounds__(THREADS)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, int g, int m, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // [QT][DH + 1]
  float* ks = qs + QT * (DH + 1);  // [KT][DH + 1]
  float* vs = ks + KT * (DH + 1);  // [KT][DV]
  float* ps = vs + KT * DV;        // [QT][KT + 1]
  constexpr int NJ = DV / 16;      // output columns a thread
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kb = k + (size_t)bh * m * DH;
  const float* vb = v + (size_t)bh * m * DV;
  load_rows<DH>(qs, DH + 1, q + (size_t)bh * g * DH, q0, g, QT);

  // ---- pass 1: each row's max and sum of exp, over this thread's columns
  float mx[4], sm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -CUDART_INF_F;
    sm[i] = 0.0f;
  }
  float s[4][4];
  for (int t0 = 0; t0 < m; t0 += KT) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<DH>(ks, DH + 1, kb, t0, m, KT);
    __syncthreads();
    tile_logits<DH>(qs, ks, ty, tx, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t0 + tx + 16 * j >= m) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[i][j];
        if (x > mx[i]) {
          sm[i] = __fadd_rn(__fmul_rn(sm[i], rescale(mx[i], x)), 1.0f);
          mx[i] = x;
        } else {
          sm[i] = __fadd_rn(sm[i], expf(x - mx[i]));
        }
      }
    }
  }
  // combine the 16 threads of each row (lanes tx = 0..15 of a half warp);
  // every step is symmetric in its two operands, so all 16 get equal bits
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, sm[i], off);
      const float nm = fmaxf(mx[i], om);
      sm[i] = __fadd_rn(__fmul_rn(sm[i], rescale(mx[i], nm)), __fmul_rn(os, rescale(om, nm)));
      mx[i] = nm;
    }
  }

  // ---- pass 2: p = exp(s - max) / sum, then p.V
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  for (int t0 = 0; t0 < m; t0 += KT) {
    __syncthreads();  // the previous tile's p.V reads are done
    load_rows<DH>(ks, DH + 1, kb, t0, m, KT);
    load_rows<DV>(vs, DV, vb, t0, m, KT);
    __syncthreads();
    tile_logits<DH>(qs, ks, ty, tx, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = t0 + c < m ? __fdiv_rn(expf(s[i][j] - mx[i]), sm[i]) : 0.0f;
        ps[(ty + 16 * i) * (KT + 1) + c] = p;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * (KT + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }
  float* ob = out + (size_t)bh * g * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= g) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[(size_t)r * DV + tx + 16 * j] = acc[i][j];
  }
}

// ------------------------------------------------------------ bf16
namespace tc {

using vpt::mma::bf16;
using vpt::mma::KT;
using vpt::mma::NT;
constexpr int MT = 1;         // row tiles of 16 a warp
constexpr int WARPS = 8;
constexpr int QT = WARPS * MT * 16;  // query rows a block: 128
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;     // key tiles in flight

template <int DH, int DV>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)QT * (DH + 8) + (size_t)STAGES * KT * (DH + 8 + DV + 8));
}

template <int DH, int DV>
__global__ void __launch_bounds__(THREADS, 2)
mha_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ out, int g, int m, float scale) {
  namespace mm = vpt::mma;
  constexpr int LQ = DH + 8, LV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QT][LQ]
  bf16* ks = qs + QT * LQ;                       // [STAGES][KT][LQ]
  bf16* vs = ks + STAGES * KT * LQ;              // [STAGES][KT][LV]
  const int bh = blockIdx.x, q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = k + (size_t)bh * m * DH;
  const bf16* vb = v + (size_t)bh * m * DV;
  const int nt = (m + KT - 1) / KT;
  // virtual tile vt < nt is pass 1's k tile vt; vt >= nt pass 2's k and
  // v tile vt - nt
  auto load = [&](int vt) {
    const bool second = vt >= nt;
    const int t0 = (second ? vt - nt : vt) * KT, slot = vt % STAGES;
    mm::cp_rows<DH, KT, THREADS>(ks + slot * KT * LQ, LQ, kb, DH, t0, m, tid);
    if (second) mm::cp_rows<DV, KT, THREADS>(vs + slot * KT * LV, LV, vb, DV, t0, m, tid);
  };
  // group 0: q and the first tile; then one group a tile
  mm::cp_rows<DH, QT, THREADS>(qs, LQ, q + (size_t)bh * g * DH, DH, q0, g, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < 2 * nt) load(st);
    mm::cp_async_commit();
  }

  const int row0 = warp * MT * 16;  // the warp's first row in the block
  const bool active = q0 + row0 < g;
  const float c = scale * mm::LOG2E;  // logits in log2 units
  uint32_t qa[MT][DH / 16][4];
  float mx[MT][2], sum[MT][2], inv[MT][2], o[MT][DV / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mx[mt][0] = mx[mt][1] = -CUDART_INF_F;
    sum[mt][0] = sum[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
  }
  for (int vt = 0; vt < 2 * nt; ++vt) {
    mm::cp_async_wait<STAGES - 2>();  // tile vt has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; and tile vt - 1 is consumed
    if (vt + STAGES - 1 < 2 * nt) load(vt + STAGES - 1);
    mm::cp_async_commit();
    if (!active) continue;
    if (vt == 0) mm::warp_a_frags<DH, MT>(qa, qs, LQ, row0, lane);
    const bool second = vt >= nt;
    const int slot = vt % STAGES, t0 = (second ? vt - nt : vt) * KT;
    float s[MT][NT][4];
    mm::warp_scores<DH, MT>(s, qa, ks + slot * KT * LQ, LQ, lane);
    if (!second) {
      // running max and this lane's share of the sum
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mm::scale_and_mask(s[mt], c, t0, m, lane);
        float tm[2];
        mm::tile_max(s[mt], tm);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float nm = fmaxf(mx[mt][r], tm[r]);
          float ps = 0.0f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            ps += mm::exp2_approx(s[mt][n][2 * r] - nm) +
                  mm::exp2_approx(s[mt][n][2 * r + 1] - nm);
          // 2^-inf = 0 on the first tile
          sum[mt][r] = sum[mt][r] * mm::exp2_approx(mx[mt][r] - nm) + ps;
          mx[mt][r] = nm;
        }
      }
      continue;
    }
    uint32_t pa[MT][KT / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (vt == nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[mt][r] = 1.0f / mm::quad_sum(sum[mt][r]);
      }
      mm::scale_and_mask(s[mt], c, t0, m, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][n][e] = mm::exp2_approx(s[mt][n][e] - mx[mt][e >> 1]) * inv[mt][e >> 1];  // p
      mm::p_frags(pa[mt], s[mt]);
    }
    mm::warp_pv<DV, MT>(o, pa, vs + slot * KT * LV, LV, lane);
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  bf16* ob = out + (size_t)bh * g * DV + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * mt + 8 * r + (lane >> 2);
      if (row >= g) continue;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * DV + 8 * n) =
            mm::pack_bf16x2(o[mt][n][2 * r], o[mt][n][2 * r + 1]);
    }
}

template <int DH, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int g, int m,
           float scale, cudaStream_t stream) {
  auto kernel = mha_tc_kernel<DH, DV>;
  constexpr size_t smem = smem_bytes<DH, DV>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(bh, (g + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                          (bf16*)out, g, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int DH, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int g, int m,
               float scale, cudaStream_t stream) {
  auto kernel = mha_kernel<DH, DV>;
  const size_t smem = sizeof(float) * ((QT + KT) * (DH + 1) + KT * DV + QT * (KT + 1));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid(bh, (g + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                          (float*)out, g, m, scale);
  return (int)cudaGetLastError();
}

// the kernel of (dh, dv), each 32 or 64: on the tensor cores (bf16) or
// on the CUDA cores (f32)
template <bool TC>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int g, int m,
             int dh, int dv, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bh < 1 || g < 1 || m < 1) return (int)cudaErrorInvalidValue;
#define VPT_MHA_CASE(DH, DV)                                                    \
  if (dh == DH && dv == DV)                                                     \
    return TC ? tc::launch<DH, DV>(q, k, v, out, bh, g, m, scale, st)            \
              : launch_f32<DH, DV>(q, k, v, out, bh, g, m, scale, st);
  VPT_MHA_CASE(64, 64)
  VPT_MHA_CASE(64, 32)
  VPT_MHA_CASE(32, 64)
  VPT_MHA_CASE(32, 32)
#undef VPT_MHA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [BH, G, dh], k [BH, M, dh], v [BH, M, dv] -> out [BH, G, dv], all in
// one dtype, contiguous (bf16 pointers 16-byte aligned); dh and dv each
// 32 or 64, G and M >= 1.
extern "C" int mha_f32(const void* q, const void* k, const void* v, void* out, int bh, int g,
                       int m, int dh, int dv, float scale, void* stream) {
  return dispatch<false>(q, k, v, out, bh, g, m, dh, dv, scale, stream);
}

extern "C" int mha_tc_bf16(const void* q, const void* k, const void* v, void* out, int bh,
                           int g, int m, int dh, int dv, float scale, void* stream) {
  return dispatch<true>(q, k, v, out, bh, g, m, dh, dv, scale, stream);
}
