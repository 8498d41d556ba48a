// Building blocks shared by the training kernels (K7-K9): a register-tiled
// SIMT matrix product over loader functors, column reductions into
// per-block partials, and the fixed-order passes that sum those partials.
//
// The TPU kernels these serve carried sums across a sequential grid in
// VMEM scratch (weight gradients, BatchNorm sums). Blocks on Hopper run in
// no order, so every cross-block sum here is written as per-block (or
// per-split) partials and summed by a second pass in a fixed order: the
// results are deterministic, run to run.
//
// The product C = A . B takes A(m, k) and B(k, n) as functors that return
// f32 values, so an operand can be recomputed on the fly from what the
// kernel keeps (a BatchNorm affine and ReLU on a cached activation, a
// LayerNorm of raw tokens) instead of being stored. Tiles of 64 x 64
// outputs, 256 threads, 4 x 4 outputs per thread, k steps of 16 staged in
// shared memory as f32. Plain CUDA-core FMAs: the SIMT product serves only
// the f32 paths of K7 and K9; their bf16 products run on the tensor cores
// (mma.cuh), which would round an f32 operand to TF32.
#pragma once

#include <stdint.h>

#include "common.cuh"

// Named namespace, not an anonymous one: nvcc's host stubs break on kernel
// templates instantiated with types of an anonymous namespace. The few
// non-template definitions are static or inline, so including this header
// in several sources defines nothing twice.
namespace vpt {

constexpr int GEMM_BM = 64, GEMM_BN = 64, GEMM_BK = 16, GEMM_THREADS = 256;
constexpr int GEMM_LDA = GEMM_BM + 4, GEMM_LDB = GEMM_BN + 4;

// C[m, n] = sum over k in this split of A(m, k) * B(k, n), handed to
// ep(m, n, split, acc). AK: neighbouring threads load neighbouring k of A
// (A's contiguous axis is k), else neighbouring m. BNC: neighbouring
// threads load neighbouring n of B, else neighbouring k.
template <bool AK, bool BNC, class AL, class BL, class EP>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(int M, int N, int K, int k_split, AL a, BL b, EP ep) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_LDA];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_LDB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += GEMM_BK) {
#pragma unroll
    for (int it = 0; it < GEMM_BM * GEMM_BK / GEMM_THREADS; ++it) {
      const int e = tid + it * GEMM_THREADS;
      const int r = AK ? e / GEMM_BK : e % GEMM_BM;
      const int kk = AK ? e % GEMM_BK : e / GEMM_BM;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < ke) ? a(m, k) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < GEMM_BN * GEMM_BK / GEMM_THREADS; ++it) {
      const int e = tid + it * GEMM_THREADS;
      const int c = BNC ? e % GEMM_BN : e / GEMM_BK;
      const int kk = BNC ? e / GEMM_BN : e % GEMM_BK;
      const int n = n0 + c, k = k0 + kk;
      Bs[kk][c] = (n < N && k < ke) ? b(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) ep(m, n, (int)blockIdx.z, acc[i][j]);
    }
}

// Launch C = A . B with the k range cut into `splits` parts (grid z).
template <bool AK, bool BNC, class AL, class BL, class EP>
void gemm(int M, int N, int K, int splits, AL a, BL b, EP ep, cudaStream_t st) {
  const int per = (K + splits - 1) / splits;
  const int k_split = (per + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
  const dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, splits);
  gemm_kernel<AK, BNC><<<grid, GEMM_THREADS, 0, st>>>(M, N, K, k_split, a, b, ep);
}

// ----------------------------------------------------------- operands

// A(m, k) or B(k, n) read from a row-major [rows, ld] array: (i, j) -> p[i*ld + j].
template <typename T> struct RowMajor {
  const T* p;
  int ld;
  __device__ float operator()(int i, int j) const { return to_f32(p[(size_t)i * ld + j]); }
};
// The transpose of a row-major [.., ld] array: (i, j) -> p[j*ld + i].
template <typename T> struct Transposed {
  const T* p;
  int ld;
  __device__ float operator()(int i, int j) const { return to_f32(p[(size_t)j * ld + i]); }
};

// ---------------------------------------------------------- epilogues

// nn.layers.Dense's emit: the f32-accumulated product rounded to T, THEN
// the bias (a T value) added and rounded again. bias may be null.
template <typename T> struct StoreDense {
  T* out;
  const T* bias;
  int ld;
  __device__ void operator()(int m, int n, int, float acc) const {
    float y = round_to<T>(acc);
    if (bias != nullptr) y = y + to_f32(bias[n]);
    out[(size_t)m * ld + n] = from_f32<T>(y);
  }
};
// Raw f32 product.
struct StoreF32 {
  float* out;
  int ld;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * ld + n] = acc;
  }
};
// One split's partial of a [M, N] product: part[split][m][n].
struct StoreSplit {
  float* part;
  int M, N;
  __device__ void operator()(int m, int n, int s, float acc) const {
    part[((size_t)s * M + m) * N + n] = acc;
  }
};

// out[i] = sum over s of part[s][i], in split order.
static __global__ void sum_splits_kernel(int splits, int n, const float* __restrict__ part,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

inline void sum_splits(int splits, int n, const float* part, float* out, cudaStream_t st) {
  sum_splits_kernel<<<(n + 255) / 256, 256, 0, st>>>(splits, n, part, out);
}

// ---------------------------------------------------- column reductions

// Two column sums of f(r, c) = (x, y) over rows: block bx covers rows
// [bx*rpb, (bx+1)*rpb) and 64 columns (grid y), 4 row lanes per column;
// writes part[bx][0][c] = sum x, part[bx][1][c] = sum y.
template <class F>
__global__ void __launch_bounds__(256)
    colsum2_kernel(int R, int C, int rpb, F f, float* __restrict__ part) {
  __shared__ float red[2][4][64];
  const int cl = threadIdx.x % 64, lane = threadIdx.x / 64;
  const int c = blockIdx.y * 64 + cl;
  const int r0 = blockIdx.x * rpb, r1 = min(R, r0 + rpb);
  float sx = 0.f, sy = 0.f;
  if (c < C) {
    for (int r = r0 + lane; r < r1; r += 4) {
      const float2 v = f(r, c);
      sx += v.x;
      sy += v.y;
    }
  }
  red[0][lane][cl] = sx;
  red[1][lane][cl] = sy;
  __syncthreads();
  if (lane == 0 && c < C) {
    part[((size_t)blockIdx.x * 2 + 0) * C + c] =
        ((red[0][0][cl] + red[0][1][cl]) + red[0][2][cl]) + red[0][3][cl];
    part[((size_t)blockIdx.x * 2 + 1) * C + c] =
        ((red[1][0][cl] + red[1][1][cl]) + red[1][2][cl]) + red[1][3][cl];
  }
}

template <class F>
void colsum2(int R, int C, int nblk, F f, float* part, cudaStream_t st) {
  const int rpb = (R + nblk - 1) / nblk;
  colsum2_kernel<<<dim3(nblk, (C + 63) / 64), 256, 0, st>>>(R, C, rpb, f, part);
}

// out0[c] = sum over blocks of part[blk][0][c], out1[c] likewise of
// part[blk][1][c] (out1 may be null), in block order, added in the
// partials' type P (float, or double where the sums must keep more bits)
// and rounded to f32 once.
template <typename P>
static __global__ void sum_parts_kernel(int nblk, int C, const P* __restrict__ part,
                                        float* __restrict__ out0, float* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * C) return;
  const int j = i / C, c = i % C;
  float* out = j == 0 ? out0 : out1;
  if (out == nullptr) return;
  P s = 0;
  for (int k = 0; k < nblk; ++k) s += part[((size_t)k * 2 + j) * C + c];
  out[c] = (float)s;
}

template <typename P>
inline void sum_parts(int nblk, int C, const P* part, float* out0, float* out1, cudaStream_t st) {
  sum_parts_kernel<P><<<(2 * C + 255) / 256, 256, 0, st>>>(nblk, C, part, out0, out1);
}

// The rows [begin, end) of split `split`: whole steps of `step` rows, split
// s of S taking steps [s n / S, (s + 1) n / S) of the n, so that no split
// is empty when S <= n (ops/cuda/dense.py `split_rows` mirrors it).
__device__ __forceinline__ int2 split_range(int r, int step, int split, int splits) {
  const long long n = (r + step - 1) / step;
  const int b = (int)(split * n / splits) * step, e = (int)((split + 1) * n / splits) * step;
  return make_int2(b, min(r, e));
}

// ------------------------------------------- one-pass column reductions
// The one-pass backwards (K17's ln_bwd_kernel, K18's grad_kernel) read
// their rows once, VEC adjacent columns a load, and sum each block's
// slice of the rows into its partial part[block][2][C]; the partials are
// then summed without a second launch by last_block_sums.

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// VEC adjacent elements as one load / store (p aligned to their size);
// unpack_vec converts a vector already in registers
template <typename T, int VEC>
__device__ __forceinline__ void unpack_vec(const typename Raw<VEC * sizeof(T)>::type& raw,
                                           float (&out)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
}
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);  // one load, into registers
  unpack_vec<T, VEC>(raw, out);
}
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<R*>(p) = raw;
}

// Called by every thread of every block after the block wrote its partial
// part[blockIdx.x][2][C]: the last block of each group of `group` blocks
// to arrive (an integer counter, not a float atomic) sums its group's
// partials in block order into part[gridDim.x + group index], and the
// last of those sums the group sums in group order into out0 (the first
// C) and out1 (the second C), then resets the counters `arrive` [groups +
// 1] to 0 for the next launch. Every sum runs in a fixed order, so the
// bits are the same run to run.
__device__ __forceinline__ void last_block_sums(float* __restrict__ part, int* __restrict__ arrive,
                                                int group, int C, float* __restrict__ out0,
                                                float* __restrict__ out1) {
  __shared__ int last;
  const int splits = gridDim.x, ngroups = (splits + group - 1) / group;
  const int gi = blockIdx.x / group, first = gi * group, members = min(group, splits - first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&arrive[gi], 1) == members - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* gsum = part + ((size_t)splits + gi) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float t = 0.f;
    for (int k = first; k < first + members; ++k) t += __ldcg(part + (size_t)k * 2 * C + i);
    gsum[i] = t;
  }
  if (threadIdx.x == 0) arrive[gi] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&arrive[ngroups], 1) == ngroups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < ngroups; ++k) t += __ldcg(part + ((size_t)splits + k) * 2 * C + i);
    if (i < C) out0[i] = t;
    else out1[i - C] = t;
  }
  if (threadIdx.x == 0) arrive[ngroups] = 0;
}

}  // namespace vpt
