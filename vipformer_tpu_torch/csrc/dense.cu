// K11: the Dense backward's weight and bias gradients, dW = x^T . dy and
// db = colsum(dy), f32-accumulated in one pass over the rows.
//
// Replaces vipformer_tpu/ops/pallas/dense.py:dense_grads_pallas (kernel
// :44-63): the TPU kernel streams row blocks through VMEM along a
// sequential grid and accumulates the MXU product and the bias column sum
// in resident f32 output blocks, so x and dy are read once.
//
// Bound on the H100: at the latent sites (R = 42,240 rows of Cin, Cout <=
// 512) the bytes: x and dy are read once (43 MB at Cin = Cout = 256 in
// bf16, 13 us at 3.35 TB/s) against 5.5 GFLOP (6 us at the bf16 tensor
// rate). This kernel runs its products on CUDA cores in f32, so it is
// bound by those FMAs (67 TFLOP/s at best); wgmma tiles are later work.
//
// Design: Hopper blocks carry nothing between them, so the sequential row
// grid becomes split-K over R. Block (n-tile, m-tile, split) owns a 64 x 64
// tile of dW and one contiguous slice of the rows; it streams that slice
// 16 rows at a time through shared memory (x transposed into As, dy into
// Bs; neighbouring threads read neighbouring columns of a row) and keeps
// 4 x 4 f32 accumulators per thread. The blocks of m-tile 0 also sum the
// dy rows they stage into the db column partials, so dy is read once for
// both gradients. Each split writes its partials; a second pass sums them
// in split order (train_common.cuh), so the result is deterministic, with
// no atomics. Rows past R and columns past Cin / Cout are masked, so any
// R and any width work, Cin = 3 included.
#include "train_common.cuh"

namespace vpt_dense {

constexpr int TM = 64, TN = 64, TK = 16, THREADS = 256;
constexpr int LDA = TM + 4, LDB = TN + 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_grads_kernel(const T* __restrict__ x, const T* __restrict__ dy, int r, int cin, int cout,
                   int rows_per_split, float* __restrict__ wpart, float* __restrict__ bpart) {
  __shared__ __align__(16) float As[TK][LDA];  // x rows, transposed: As[row][cin]
  __shared__ __align__(16) float Bs[TK][LDB];  // dy rows: Bs[row][cout]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, split = blockIdx.z;
  const int r0 = split * rows_per_split, r1 = min(r, r0 + rows_per_split);
  const bool with_bias = blockIdx.y == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;  // db partial of column n0 + tid (threads 0-63)

  for (int k0 = r0; k0 < r1; k0 += TK) {
#pragma unroll
    for (int it = 0; it < TM * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e % TM, kk = e / TM;
      const int row = k0 + kk, col = m0 + c;
      As[kk][c] = (row < r1 && col < cin) ? vpt::to_f32(x[(size_t)row * cin + col]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < TN * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e % TN, kk = e / TN;
      const int row = k0 + kk, col = n0 + c;
      Bs[kk][c] = (row < r1 && col < cout) ? vpt::to_f32(dy[(size_t)row * cout + col]) : 0.f;
    }
    __syncthreads();
    if (with_bias && tid < TN) {
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) bsum += Bs[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
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
  float* wp = wpart + (size_t)split * cin * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < cin && n < cout) wp[(size_t)m * cout + n] = acc[i][j];
    }
  if (with_bias && tid < TN && n0 + tid < cout) bpart[(size_t)split * cout + n0 + tid] = bsum;
}

template <typename T>
int launch_dense_grads(const void* x, const void* dy, void* dw, void* db, void* wpart,
                       void* bpart, int r, int cin, int cout, int splits, cudaStream_t st) {
  if (r < 1 || cin < 1 || cout < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  // rows per split, a whole number of 16-row steps, no split left empty
  const int per = ((r + splits - 1) / splits + TK - 1) / TK * TK;
  if ((splits - 1) * per >= r) return (int)cudaErrorInvalidValue;
  const dim3 grid((cout + TN - 1) / TN, (cin + TM - 1) / TM, splits);
  dense_grads_kernel<T><<<grid, THREADS, 0, st>>>((const T*)x, (const T*)dy, r, cin, cout, per,
                                                  (float*)wpart, (float*)bpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_splits(splits, cin * cout, (const float*)wpart, (float*)dw, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_splits(splits, cout, (const float*)bpart, (float*)db, st);
  return (int)cudaGetLastError();
}

}  // namespace vpt_dense

using namespace vpt_dense;

// x [R, Cin], dy [R, Cout] (both T) -> dw f32 [Cin, Cout], db f32 [Cout].
// wpart f32 [splits, Cin, Cout] and bpart f32 [splits, Cout] are scratch;
// `splits` must leave no split empty (the wrapper picks it).
extern "C" int dense_grads_f32(const void* x, const void* dy, void* dw, void* db, void* wpart,
                               void* bpart, int r, int cin, int cout, int splits, void* stream) {
  return launch_dense_grads<float>(x, dy, dw, db, wpart, bpart, r, cin, cout, splits,
                                   (cudaStream_t)stream);
}

extern "C" int dense_grads_bf16(const void* x, const void* dy, void* dw, void* db, void* wpart,
                                void* bpart, int r, int cin, int cout, int splits, void* stream) {
  return launch_dense_grads<__nv_bfloat16>(x, dy, dw, db, wpart, bpart, r, cin, cout, splits,
                                           (cudaStream_t)stream);
}
