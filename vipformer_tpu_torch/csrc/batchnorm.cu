// K18: the column reductions of train-mode BatchNorm over x [R, C]:
// the forward statistics (sum x, sum x^2) and the backward's (sum dy*xhat,
// sum dy), f32-accumulated in one read of the inputs.
//
// Replaces vipformer_tpu/ops/pallas/batchnorm.py:bn_stats_pallas (:74,
// kernel :60-71) and bn_grad_reduces_pallas (:111, kernel :89-108): the TPU
// kernels stream [BR, C] row blocks through VMEM along a sequential grid
// and accumulate [1, C] f32 sums in resident output blocks. The normalize
// and dx stay elementwise outside, as there (ops/cuda/batchnorm.py).
//
// Bound on the H100: the bytes. The decode's [131,072, 1536] bf16
// activation is 403 MB, 0.12 ms at 3.35 TB/s; the sums are 2-4 flops a
// byte, far below the card's ratio.
//
// Design: Hopper blocks carry nothing between them, so the sequential row
// grid becomes split rows. Block (split, column tile) owns 64 columns and
// one contiguous slice of the rows; each of its 256 threads owns two
// neighbouring columns (one 4- or 8-byte load a row, so a warp reads 64
// contiguous columns of a row) and one of 8 row lanes, and sums its rows in
// order. The 8 lanes are summed in a fixed order into the block's partial
// [split][2][C]; a second pass (train_common.cuh sum_parts) sums the splits
// in split order. No float atomics: two runs give bitwise equal sums, which
// matters because the running statistics feed the eval.
#include "train_common.cuh"

namespace vpt_bn {

constexpr int COLS = 64, LANES = 8, THREADS = (COLS / 2) * LANES;

// Two neighbouring elements (c, c+1) of row-major [., C] at flat index i =
// r*C + c as f32; the vector load needs C even (then i is even and the
// pair aligned), else two scalar loads. c+1 past C reads as 0.
__device__ __forceinline__ float2 load2(const float* __restrict__ p, size_t i, int c, int C) {
  if ((C & 1) == 0 && c + 1 < C) return *reinterpret_cast<const float2*>(p + i);
  return make_float2(p[i], c + 1 < C ? p[i + 1] : 0.f);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* __restrict__ p, size_t i, int c,
                                        int C) {
  if ((C & 1) == 0 && c + 1 < C)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
  return make_float2(__bfloat162float(p[i]), c + 1 < C ? __bfloat162float(p[i + 1]) : 0.f);
}

// Per-lane sums of two columns, reduced over the 8 lanes in lane order and
// written as this block's partial: part[split][0][c..c+1], part[split][1][..].
__device__ __forceinline__ void write_partial(float4 acc, int c, int C, float* __restrict__ part) {
  __shared__ float4 red[LANES][COLS / 2];
  const int pair = threadIdx.x % (COLS / 2), lane = threadIdx.x / (COLS / 2);
  red[lane][pair] = acc;
  __syncthreads();
  if (lane != 0 || c >= C) return;
  float4 s = red[0][pair];
#pragma unroll
  for (int l = 1; l < LANES; ++l) {
    const float4 v = red[l][pair];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  float* p0 = part + (size_t)blockIdx.x * 2 * C;
  p0[c] = s.x;
  p0[C + c] = s.z;
  if (c + 1 < C) {
    p0[c + 1] = s.y;
    p0[C + c + 1] = s.w;
  }
}

// acc = (sum x[c], sum x[c+1], sum x[c]^2, sum x[c+1]^2) over this block's rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ x, int R, int C, int rows_per_split, float* __restrict__ part) {
  const int pair = threadIdx.x % (COLS / 2), lane = threadIdx.x / (COLS / 2);
  const int c = blockIdx.y * COLS + 2 * pair;
  const int r0 = blockIdx.x * rows_per_split, r1 = min(R, r0 + rows_per_split);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < C) {
#pragma unroll 4
    for (int r = r0 + lane; r < r1; r += LANES) {
      const float2 v = load2(x, (size_t)r * C + c, c, C);
      acc.x += v.x;
      acc.y += v.y;
      acc.z = fmaf(v.x, v.x, acc.z);
      acc.w = fmaf(v.y, v.y, acc.w);
    }
  }
  write_partial(acc, c, C, part);
}

// acc = (sum dy*xhat [c, c+1], sum dy [c, c+1]), xhat = (x - mean) * rstd
// recomputed from the saved f32 statistics.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, int R, int C, int rows_per_split,
            float* __restrict__ part) {
  const int pair = threadIdx.x % (COLS / 2), lane = threadIdx.x / (COLS / 2);
  const int c = blockIdx.y * COLS + 2 * pair;
  const int r0 = blockIdx.x * rows_per_split, r1 = min(R, r0 + rows_per_split);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < C) {
    const float m0 = mean[c], s0 = rstd[c];
    const float m1 = c + 1 < C ? mean[c + 1] : 0.f, s1 = c + 1 < C ? rstd[c + 1] : 0.f;
#pragma unroll 4
    for (int r = r0 + lane; r < r1; r += LANES) {
      const size_t i = (size_t)r * C + c;
      const float2 xv = load2(x, i, c, C), g = load2(dy, i, c, C);
      acc.x = fmaf(g.x, (xv.x - m0) * s0, acc.x);
      acc.y = fmaf(g.y, (xv.y - m1) * s1, acc.y);
      acc.z += g.x;
      acc.w += g.y;
    }
  }
  write_partial(acc, c, C, part);
}

inline dim3 grid_for(int splits, int C) { return dim3(splits, (C + COLS - 1) / COLS); }

template <typename T>
int launch_stats(const void* x, void* sum, void* sumsq, void* part, int R, int C, int splits,
                 cudaStream_t st) {
  if (R < 1 || C < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int per = (R + splits - 1) / splits;
  stats_kernel<T><<<grid_for(splits, C), THREADS, 0, st>>>((const T*)x, R, C, per,
                                                           (float*)part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_parts(splits, C, (const float*)part, (float*)sum, (float*)sumsq, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* x, const void* dy, const void* mean, const void* rstd, void* dscale,
                void* dbias, void* part, int R, int C, int splits, cudaStream_t st) {
  if (R < 1 || C < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int per = (R + splits - 1) / splits;
  grad_kernel<T><<<grid_for(splits, C), THREADS, 0, st>>>(
      (const T*)x, (const T*)dy, (const float*)mean, (const float*)rstd, R, C, per,
      (float*)part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_parts(splits, C, (const float*)part, (float*)dscale, (float*)dbias, st);
  return (int)cudaGetLastError();
}

}  // namespace vpt_bn

using namespace vpt_bn;

// x [R, C] (T) -> sum, sumsq f32 [C]; part f32 [splits, 2, C] is scratch.
extern "C" int bn_stats_f32(const void* x, void* sum, void* sumsq, void* part, int r, int c,
                            int splits, void* stream) {
  return launch_stats<float>(x, sum, sumsq, part, r, c, splits, (cudaStream_t)stream);
}

extern "C" int bn_stats_bf16(const void* x, void* sum, void* sumsq, void* part, int r, int c,
                             int splits, void* stream) {
  return launch_stats<__nv_bfloat16>(x, sum, sumsq, part, r, c, splits, (cudaStream_t)stream);
}

// x, dy [R, C] (T), mean, rstd f32 [C] -> dscale = sum dy*xhat, dbias = sum
// dy, f32 [C]; part f32 [splits, 2, C] is scratch.
extern "C" int bn_grad_reduces_f32(const void* x, const void* dy, const void* mean,
                                   const void* rstd, void* dscale, void* dbias, void* part, int r,
                                   int c, int splits, void* stream) {
  return launch_grad<float>(x, dy, mean, rstd, dscale, dbias, part, r, c, splits,
                            (cudaStream_t)stream);
}

extern "C" int bn_grad_reduces_bf16(const void* x, const void* dy, const void* mean,
                                    const void* rstd, void* dscale, void* dbias, void* part,
                                    int r, int c, int splits, void* stream) {
  return launch_grad<__nv_bfloat16>(x, dy, mean, rstd, dscale, dbias, part, r, c, splits,
                                    (cudaStream_t)stream);
}
