// K17: row LayerNorm over x [R, D], forward and backward.
//
// Replaces vipformer_tpu/ops/pallas/layernorm.py:_fwd_call (:95, kernel
// :62-72) and _bwd_call (:121, kernel :74-93), reached through
// layernorm_apply (:180): the forward reads a block of rows once and
// writes y (in x's dtype) and the per-row f32 mu and rsig; the backward
// reads (x, dy) once, writes dx and accumulates the [D] dscale / dbias
// column sums in resident f32 blocks across its sequential grid.
//
// Numerics as flax's LayerNorm: f32 statistics with the fast variance
// max(0, E[x^2] - E[x]^2), eps (vpt::LN_EPS) inside the rsqrt, y = (x -
// mu) * (rsig * scale) + bias in f32 and cast at the end; dx = rsig *
// (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dy * scale.
//
// Bound on the H100: the bytes (x read, y written; x, dy read, dx
// written); the arithmetic is a few flops a byte.
//
// Design: one warp per row, its lanes on neighbouring columns; the row's
// sums are reduced across the warp by shuffles, and the row is read a
// second time (from L1/L2) for the normalised output. The backward's
// column sums cannot ride a sequential grid on Hopper: a block owns one
// contiguous slice of the rows, each of its 8 warps adds its rows' dy *
// xhat and dy into its own f32 slice of shared memory (a lane owns its
// columns, so no two threads touch one address), the 8 slices are summed
// in warp order into the block's partial [split][2][D], and a second
// pass (train_common.cuh sum_parts) sums the splits in split order. No
// float atomics: the sums are the same bits run to run.
#include "train_common.cuh"

namespace vpt_ln {

constexpr int WARPS = 8, THREADS = 32 * WARPS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
              T* __restrict__ y, float* __restrict__ mu_out, float* __restrict__ rsig_out, int R,
              int D) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= R) return;
  const T* xr = x + (size_t)r * D;
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = vpt::to_f32(xr[c]);
    sum += v;
    sq = fmaf(v, v, sq);
  }
  // xor shuffles give every lane the same sums in the same order
  const float mu = warp_sum(sum) / (float)D;
  const float mu2 = warp_sum(sq) / (float)D;
  const float rsig = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
  T* yr = y + (size_t)r * D;
  for (int c = lane; c < D; c += 32)
    yr[c] = vpt::from_f32<T>((vpt::to_f32(xr[c]) - mu) * (rsig * s[c]) + b[c]);
  if (lane == 0) {
    mu_out[r] = mu;
    rsig_out[r] = rsig;
  }
}

// Dynamic shared memory: acc[WARPS][2][D] f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mu,
              const float* __restrict__ rsig, const float* __restrict__ s, T* __restrict__ dx,
              int R, int D, int rows_per_split, float* __restrict__ part) {
  extern __shared__ float acc[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* ds = acc + (size_t)warp * 2 * D;
  float* db = ds + D;
  for (int c = lane; c < D; c += 32) ds[c] = db[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_split, r1 = min(R, r0 + rows_per_split);
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const size_t off = (size_t)r * D;
    const float m = mu[r], rs = rsig[r];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xh = (vpt::to_f32(x[off + c]) - m) * rs;
      const float dxh = vpt::to_f32(dy[off + c]) * s[c];
      m1 += dxh;
      m2 = fmaf(dxh, xh, m2);
    }
    m1 = warp_sum(m1) / (float)D;
    m2 = warp_sum(m2) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const float g = vpt::to_f32(dy[off + c]);
      const float xh = (vpt::to_f32(x[off + c]) - m) * rs;
      dx[off + c] = vpt::from_f32<T>(rs * (g * s[c] - m1 - xh * m2));
      ds[c] = fmaf(g, xh, ds[c]);
      db[c] += g;
    }
  }
  __syncthreads();
  float* p = part + (size_t)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += THREADS) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += acc[(size_t)w * 2 * D + i];
    p[i] = t;
  }
}

inline size_t bwd_smem(int D) { return (size_t)WARPS * 2 * D * sizeof(float); }

template <typename T>
int launch_fwd(const void* x, const void* s, const void* b, void* y, void* mu, void* rsig, int R,
               int D, cudaStream_t st) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  ln_fwd_kernel<T><<<(R + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const T*)x, (const float*)s, (const float*)b, (T*)y, (float*)mu, (float*)rsig, R, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* mu, const void* rsig, const void* s,
               void* dx, void* dscale, void* dbias, void* part, int R, int D, int splits,
               cudaStream_t st) {
  if (R < 1 || D < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = (R + splits - 1) / splits;
  ln_bwd_kernel<T><<<splits, THREADS, smem, st>>>(
      (const T*)x, (const T*)dy, (const float*)mu, (const float*)rsig, (const float*)s, (T*)dx,
      R, D, per, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_parts(splits, D, (const float*)part, (float*)dscale, (float*)dbias, st);
  return (int)cudaGetLastError();
}

}  // namespace vpt_ln

using namespace vpt_ln;

// x [R, D] (T), scale, bias f32 [D] -> y [R, D] (T), mu, rsig f32 [R].
extern "C" int ln_fwd_f32(const void* x, const void* s, const void* b, void* y, void* mu,
                          void* rsig, int r, int d, void* stream) {
  return launch_fwd<float>(x, s, b, y, mu, rsig, r, d, (cudaStream_t)stream);
}

extern "C" int ln_fwd_bf16(const void* x, const void* s, const void* b, void* y, void* mu,
                           void* rsig, int r, int d, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, s, b, y, mu, rsig, r, d, (cudaStream_t)stream);
}

// x, dy [R, D] (T), mu, rsig f32 [R], scale f32 [D] -> dx [R, D] (T),
// dscale, dbias f32 [D]; part f32 [splits, 2, D] is scratch.
extern "C" int ln_bwd_f32(const void* x, const void* dy, const void* mu, const void* rsig,
                          const void* s, void* dx, void* dscale, void* dbias, void* part, int r,
                          int d, int splits, void* stream) {
  return launch_bwd<float>(x, dy, mu, rsig, s, dx, dscale, dbias, part, r, d, splits,
                           (cudaStream_t)stream);
}

extern "C" int ln_bwd_bf16(const void* x, const void* dy, const void* mu, const void* rsig,
                           const void* s, void* dx, void* dscale, void* dbias, void* part, int r,
                           int d, int splits, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, mu, rsig, s, dx, dscale, dbias, part, r, d, splits,
                                   (cudaStream_t)stream);
}
