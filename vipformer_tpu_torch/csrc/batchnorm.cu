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
// Design, forward (stats_kernel): Hopper blocks carry nothing between
// them, so the sequential row grid becomes split rows. Block (split,
// column tile) owns 64 columns and one contiguous slice of the rows; each
// of its 256 threads owns two neighbouring columns (one 4- or 8-byte load
// a row, so a warp reads 64 contiguous columns of a row) and one of 8 row
// lanes, and sums its rows in order. The 8 lanes are summed in a fixed
// order into the block's partial [split][2][C]; a second pass
// (train_common.cuh sum_parts) sums the splits in split order.
//
// Design, backward (grad_kernel, one pass): at the decode's [131,072,
// 1536] bf16 it reads 805 MB, so it must stream at the memory rate. One
// block of 16 warps an SM, each over one contiguous slice of the rows;
// the block walks all C columns in tiles of 32 vectors (a lane owns VEC
// adjacent columns, one 16-byte load a row: 8 bf16 or 4 f32, narrower
// where C or a pointer is not a multiple; a warp reads 512 contiguous
// bytes of a row), warp w taking rows w, w + 16, ... of the slice, eight
// rows' loads in flight at once (128 KB an SM). The lane's column sums
// stay in registers; at the end of a tile the 16 warps' sums combine in
// warp order through shared memory into the block's partial [2][C], and
// the partials are summed by the last blocks to arrive behind an integer
// counter (train_common.cuh last_block_sums): one launch.
//
// No float atomics anywhere: two runs give bitwise equal sums, which
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

// ------------------------------------------------------------ backward
constexpr int GRAD_WARPS = 16, GRAD_THREADS = 32 * GRAD_WARPS;
constexpr int GRAD_ROWS = 8;  // rows a warp has in flight

// part[blockIdx.x] = (sum dy*xhat, sum dy) over the block's rows [r0, r0 +
// per), xhat = (x - mean) * rstd recomputed from the saved f32 statistics;
// then dscale, dbias [C] from the partials (part [splits + groups][2][C]).
template <typename T, int VEC>
__global__ void __launch_bounds__(GRAD_THREADS)
grad_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, int R, int C, int per, int group,
            float* __restrict__ part, int* __restrict__ arrive, float* __restrict__ dscale,
            float* __restrict__ dbias) {
  constexpr int TW = 32 * VEC;  // columns of a tile
  __shared__ float red[GRAD_WARPS][2][TW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * per, r1 = min(R, r0 + per), nv = C / VEC;
  float* mine = part + (size_t)blockIdx.x * 2 * C;
  for (int v0 = 0; v0 < nv; v0 += 32) {
    const bool cv = v0 + lane < nv;
    const size_t col = (size_t)(cv ? v0 + lane : 0) * VEC;
    float m[VEC], s[VEC], ds[VEC], db[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = cv ? mean[col + i] : 0.f;
      s[i] = cv ? rstd[col + i] : 0.f;
      ds[i] = db[i] = 0.f;
    }
    if (cv) {
      int r = r0 + warp;
      for (; r + (GRAD_ROWS - 1) * GRAD_WARPS < r1; r += GRAD_ROWS * GRAD_WARPS) {
        float xv[GRAD_ROWS][VEC], g[GRAD_ROWS][VEC];
#pragma unroll
        for (int u = 0; u < GRAD_ROWS; ++u) {  // all loads first: they are in flight together
          const size_t off = (size_t)(r + u * GRAD_WARPS) * C + col;
          vpt::load_vec<T, VEC>(x + off, xv[u]);
          vpt::load_vec<T, VEC>(dy + off, g[u]);
        }
#pragma unroll
        for (int u = 0; u < GRAD_ROWS; ++u)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            ds[i] = fmaf(g[u][i], (xv[u][i] - m[i]) * s[i], ds[i]);
            db[i] += g[u][i];
          }
      }
      for (; r < r1; r += GRAD_WARPS) {
        float xv[VEC], g[VEC];
        vpt::load_vec<T, VEC>(x + (size_t)r * C + col, xv);
        vpt::load_vec<T, VEC>(dy + (size_t)r * C + col, g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          ds[i] = fmaf(g[i], (xv[i] - m[i]) * s[i], ds[i]);
          db[i] += g[i];
        }
      }
    }
    // the tile's 16 warps -> the block's partial, in warp order
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[warp][0][lane * VEC + i] = ds[i];
      red[warp][1][lane * VEC + i] = db[i];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * TW; j += GRAD_THREADS) {
      const int which = j / TW, c = v0 * VEC + j % TW;
      if (c >= C) continue;
      float t = 0.f;
      for (int w = 0; w < GRAD_WARPS; ++w) t += red[w][which][j % TW];
      mine[(size_t)which * C + c] = t;
    }
    __syncthreads();
  }
  vpt::last_block_sums(part, arrive, group, C, dscale, dbias);
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

template <typename T, int VEC>
int launch_grad_vec(const void* x, const void* dy, const void* mean, const void* rstd,
                    void* dscale, void* dbias, void* part, void* arrive, int R, int C, int per,
                    int group, cudaStream_t st) {
  grad_kernel<T, VEC><<<(R + per - 1) / per, GRAD_THREADS, 0, st>>>(
      (const T*)x, (const T*)dy, (const float*)mean, (const float*)rstd, R, C, per, group,
      (float*)part, (int*)arrive, (float*)dscale, (float*)dbias);
  return (int)cudaGetLastError();
}

// The plan comes from the wrapper (ops/cuda/batchnorm.py `bwd_plan`): VEC
// columns a vector (C a multiple of it, x and dy aligned to it), `per`
// rows a split, `group` splits a group.
template <typename T>
int launch_grad(const void* x, const void* dy, const void* mean, const void* rstd, void* dscale,
                void* dbias, void* part, void* arrive, int R, int C, int per, int group, int vec,
                cudaStream_t st) {
  if (R < 1 || C < 1 || per < 1 || group < 1 || vec < 1 || C % vec ||
      vec * (int)sizeof(T) > 16)
    return (int)cudaErrorInvalidValue;
#define BN_GRAD_VEC(V)                                                                        \
  case V:                                                                                     \
    return launch_grad_vec<T, (V * sizeof(T) <= 16 ? V : 1)>(x, dy, mean, rstd, dscale, dbias, \
                                                             part, arrive, R, C, per, group,  \
                                                             st);
  switch (vec) {
    BN_GRAD_VEC(1)
    BN_GRAD_VEC(2)
    BN_GRAD_VEC(4)
    BN_GRAD_VEC(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BN_GRAD_VEC
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
// dy, f32 [C]; part f32 [splits + groups, 2, C] is scratch and arrive
// int32 [groups + 1] counters that are 0 before and after a launch.
extern "C" int bn_grad_reduces_f32(const void* x, const void* dy, const void* mean,
                                   const void* rstd, void* dscale, void* dbias, void* part,
                                   void* arrive, int r, int c, int per, int group, int vec,
                                   void* stream) {
  return launch_grad<float>(x, dy, mean, rstd, dscale, dbias, part, arrive, r, c, per, group, vec,
                            (cudaStream_t)stream);
}

extern "C" int bn_grad_reduces_bf16(const void* x, const void* dy, const void* mean,
                                    const void* rstd, void* dscale, void* dbias, void* part,
                                    void* arrive, int r, int c, int per, int group, int vec,
                                    void* stream) {
  return launch_grad<__nv_bfloat16>(x, dy, mean, rstd, dscale, dbias, part, arrive, r, c, per,
                                    group, vec, (cudaStream_t)stream);
}
