// K14: head-split eval attention, the whole key axis per (batch, head).
//
// Replaces vipformer_tpu/ops/pallas/attention.py:fused_attention
// (`_mha_kernel`, attention.py:34-50).
//
// q [BH, G, dh], k [BH, M, dh], v [BH, M, dv] -> o [BH, G, dv], no mask
// and no dropout: logits q.k * scale and the softmax in f32, p normalised
// BEFORE the PV product and rounded to v's dtype, PV accumulated in f32,
// the output in v's dtype (the Pallas kernel's numerics).
//
// Bound on the H100: operations. 2 * BH * G * M * (dh + dv) multiply-adds
// against bytes of q, k, v and o; at the Perceiver's cross-attention (G =
// 512 latents over M = 2,048 points, dh 64, dv 32) that is ~100 FLOP per
// byte, above the f32 CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design: the TPU kernel holds a (batch, head) slice's whole [G, M] score
// block in VMEM; a Hopper block cannot, so it streams the keys. One block
// of 256 threads per (batch x head, 64-query tile); thread (ty, tx) of the
// 16 x 16 grid owns score rows ty + 16 i and columns tx + 16 j (i, j < 4)
// of a 64 x 64 tile, and output rows ty + 16 i, columns tx + 16 j. Pass 1
// streams the k tiles through shared memory and keeps each row's running
// max and sum over the thread's own columns (combined over the 16 threads
// of a row at the end). Pass 2 recomputes the same logits (the same
// function, so the same bits), forms p = exp(s - max) / sum, rounds it to
// v's dtype into shared memory, and accumulates p.V from the v tile. The
// key axis may have any length; a ragged last tile is masked. Products on
// the CUDA cores in f32 (mma tiles are later work: PERF.md).
#include "common.cuh"

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

// rows [r0, r0 + R) of a [rows, W] tensor in T -> f32 shared memory with
// row stride `stride`; rows at or past `rows` are zero
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          int r0, int rows, int R) {
  for (int e = threadIdx.x; e < R * W; e += THREADS) {
    const int r = e / W, c = e - r * W;
    dst[r * stride + c] = r0 + r < rows ? vpt::to_f32(src[(size_t)(r0 + r) * W + c]) : 0.0f;
  }
}

// exp(a - m) where a may be -inf (a thread with no column yet): 0 then
__device__ __forceinline__ float rescale(float a, float m) {
  return a == -CUDART_INF_F ? 0.0f : expf(a - m);
}

template <typename T, int DH, int DV>
__global__ void __launch_bounds__(THREADS)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int g, int m, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // [QT][DH + 1]
  float* ks = qs + QT * (DH + 1);  // [KT][DH + 1]
  float* vs = ks + KT * (DH + 1);  // [KT][DV]
  float* ps = vs + KT * DV;        // [QT][KT + 1]
  constexpr int NJ = DV / 16;      // output columns a thread
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + (size_t)bh * m * DH;
  const T* vb = v + (size_t)bh * m * DV;
  load_rows<T, DH>(qs, DH + 1, q + (size_t)bh * g * DH, q0, g, QT);

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
    load_rows<T, DH>(ks, DH + 1, kb, t0, m, KT);
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

  // ---- pass 2: p = exp(s - max) / sum in v's dtype, then p.V in f32
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  for (int t0 = 0; t0 < m; t0 += KT) {
    __syncthreads();  // the previous tile's p.V reads are done
    load_rows<T, DH>(ks, DH + 1, kb, t0, m, KT);
    load_rows<T, DV>(vs, DV, vb, t0, m, KT);
    __syncthreads();
    tile_logits<DH>(qs, ks, ty, tx, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = t0 + c < m ? __fdiv_rn(expf(s[i][j] - mx[i]), sm[i]) : 0.0f;
        ps[(ty + 16 * i) * (KT + 1) + c] = vpt::round_to<T>(p);
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
  T* ob = out + (size_t)bh * g * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= g) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[(size_t)r * DV + tx + 16 * j] = vpt::from_f32<T>(acc[i][j]);
  }
}

template <typename T, int DH, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int g, int m,
           float scale, cudaStream_t stream) {
  auto kernel = mha_kernel<T, DH, DV>;
  const size_t smem = sizeof(float) * ((QT + KT) * (DH + 1) + KT * DV + QT * (KT + 1));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid(bh, (g + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, g, m,
                                          scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int g, int m,
             int dh, int dv, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64 && dv == 64) return launch<T, 64, 64>(q, k, v, out, bh, g, m, scale, st);
  if (dh == 64 && dv == 32) return launch<T, 64, 32>(q, k, v, out, bh, g, m, scale, st);
  if (dh == 32 && dv == 64) return launch<T, 32, 64>(q, k, v, out, bh, g, m, scale, st);
  if (dh == 32 && dv == 32) return launch<T, 32, 32>(q, k, v, out, bh, g, m, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [BH, G, dh], k [BH, M, dh], v [BH, M, dv] -> out [BH, G, dv], all in
// one dtype, contiguous; dh and dv each 32 or 64, G and M >= 1.
extern "C" int mha_f32(const void* q, const void* k, const void* v, void* out, int bh, int g,
                       int m, int dh, int dv, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, bh, g, m, dh, dv, scale, stream);
}

extern "C" int mha_bf16(const void* q, const void* k, const void* v, void* out, int bh, int g,
                        int m, int dh, int dv, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, g, m, dh, dv, scale, stream);
}
