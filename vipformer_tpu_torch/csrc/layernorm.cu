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
// Design: the forward takes one warp per row, its lanes on neighbouring
// columns; the row's sums are reduced across the warp by shuffles, and the
// row is read a second time (from L1/L2) for the normalised output. The
// backward reads each row once, into registers (ln_bwd_kernel below): its
// column sums cannot ride a sequential grid on Hopper, so each block keeps
// its lanes' column sums in registers, combines them once into a partial,
// and the last blocks to finish sum the partials in a fixed order (an
// integer arrival counter, no float atomics, no second launch): the sums
// are the same bits run to run.
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

// ------------------------------------------------------------ backward
// One pass: BWD_WARPS warps a block, a block per split of the rows. A warp
// (or, at D > 512, a group of `wpr` warps) owns one row at a time; its
// lanes hold fixed columns for the whole run, in chunks of VEC adjacent
// columns loaded and stored as one vector: chunk c = (j * wpr + w) * 32 +
// lane of the row, for j < LANE_COLS / VEC. Each row's x and dy are read
// once into registers; the row sums of dy * scale and dy * scale * xhat
// reduce by shuffles (and, across the warps of a group, through shared
// memory behind a named barrier), dx is written from the registers, and
// the lane's columns' sums of dy * xhat and dy stay in registers across
// all the rows it sees. At the end the block's row slots combine once
// through shared memory in slot order into the block's partial [2][D].
// The partials are summed without a second launch: the last block of
// each group of `group` splits to arrive (an integer counter, not a float
// atomic) sums its group's partials in split order, and the last of those
// sums the group sums in group order into dscale and dbias, then resets
// the counters to 0 for the next launch. Every sum runs in a fixed order,
// so the bits are the same run to run.
constexpr int BWD_WARPS = 16, BWD_THREADS = 32 * BWD_WARPS;
constexpr int LANE_COLS = 16;  // columns a lane holds: a warp covers 512

// Dynamic shared memory: acc[BWD_WARPS / wpr][2][D] f32, then the row
// sums red[2][BWD_WARPS][2] (double buffered).
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mu,
              const float* __restrict__ rsig, const float* __restrict__ s, T* __restrict__ dx,
              int R, int D, int per, int wpr, int group, float* __restrict__ part,
              int* __restrict__ arrive, float* __restrict__ dscale, float* __restrict__ dbias) {
  constexpr int NCH = LANE_COLS / VEC;
  // the lane's scale values stay in registers where the vectors are wide;
  // with VEC <= 2 (16 loads in flight a row) they come from L1 instead, so
  // that the 512 threads' 128 registers hold the rest without spilling
  constexpr bool SC_REGS = VEC >= 4;
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = BWD_WARPS / wpr, slot = warp / wpr, w = warp % wpr;
  const int nch = D / VEC;
  float* acc = sm;
  float* red = sm + (size_t)slots * 2 * D;
  float sc[SC_REGS ? NCH : 1][VEC], ds[NCH][VEC], db[NCH][VEC];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = (j * wpr + w) * 32 + lane;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (SC_REGS) sc[SC_REGS ? j : 0][i] = c < nch ? s[c * VEC + i] : 0.f;
      ds[j][i] = db[j][i] = 0.f;
    }
  }
  auto scale_at = [&](int j, int i) {
    return SC_REGS ? sc[SC_REGS ? j : 0][i]
                   : __ldg(s + min((j * wpr + w) * 32 + lane, nch - 1) * VEC + i);
  };
  const int r0 = blockIdx.x * per, r1 = min(R, r0 + per);
  const int iters = (r1 - r0 + slots - 1) / slots;
  for (int it = 0; it < iters; ++it) {
    const int r = r0 + it * slots + slot;
    const bool rv = r < r1;
    const float m = rv ? mu[r] : 0.f, rs = rv ? rsig[r] : 0.f;
    const size_t off = (size_t)(rv ? r : 0) * D;
    float xh[NCH][VEC], g[NCH][VEC];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {  // all loads first: they are in flight together
      const int c = (j * wpr + w) * 32 + lane;
      if (rv && c < nch) {
        vpt::load_vec<T, VEC>(x + off + c * VEC, xh[j]);
        vpt::load_vec<T, VEC>(dy + off + c * VEC, g[j]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[j][i] = g[j][i] = 0.f;
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const bool cv = rv && (j * wpr + w) * 32 + lane < nch;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        xh[j][i] = cv ? (xh[j][i] - m) * rs : 0.f;
        const float dxh = g[j][i] * scale_at(j, i);
        s1 += dxh;
        s2 = fmaf(dxh, xh[j][i], s2);
        ds[j][i] = fmaf(g[j][i], xh[j][i], ds[j][i]);
        db[j][i] += g[j][i];
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (wpr > 1) {  // the row's other warps: through shared memory, in warp order
      float* rd = red + (it & 1) * 2 * BWD_WARPS;
      if (lane == 0) {
        rd[2 * warp] = s1;
        rd[2 * warp + 1] = s2;
      }
      asm volatile("bar.sync %0, %1;" ::"r"(1 + slot), "r"(32 * wpr) : "memory");
      s1 = s2 = 0.f;
      for (int k = 0; k < wpr; ++k) {
        s1 += rd[2 * (slot * wpr + k)];
        s2 += rd[2 * (slot * wpr + k) + 1];
      }
    }
    if (!rv) continue;
    const float m1 = s1 / (float)D, m2 = s2 / (float)D;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = (j * wpr + w) * 32 + lane;
      if (c >= nch) continue;
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = rs * (g[j][i] * scale_at(j, i) - m1 - xh[j][i] * m2);
      vpt::store_vec<T, VEC>(dx + off + c * VEC, o);
    }
  }
  // the block's row slots -> its partial [2][D], in slot order
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = (j * wpr + w) * 32 + lane;
    if (c >= nch) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[(size_t)slot * 2 * D + c * VEC + i] = ds[j][i];
      acc[(size_t)slot * 2 * D + D + c * VEC + i] = db[j][i];
    }
  }
  __syncthreads();
  float* mine = part + (size_t)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += BWD_THREADS) {
    float t = 0.f;
    for (int k = 0; k < slots; ++k) t += acc[(size_t)k * 2 * D + i];
    mine[i] = t;
  }
  vpt::last_block_sums(part, arrive, group, D, dscale, dbias);
}

inline size_t bwd_smem(int D, int wpr) {
  return sizeof(float) * ((size_t)(BWD_WARPS / wpr) * 2 * D + 2 * BWD_WARPS * 2);
}

template <typename T>
int launch_fwd(const void* x, const void* s, const void* b, void* y, void* mu, void* rsig, int R,
               int D, cudaStream_t st) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  ln_fwd_kernel<T><<<(R + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const T*)x, (const float*)s, (const float*)b, (T*)y, (float*)mu, (float*)rsig, R, D);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_vec(const void* x, const void* dy, const void* mu, const void* rsig, const void* s,
                   void* dx, void* dscale, void* dbias, void* part, void* arrive, int R, int D,
                   int per, int group, int wpr, cudaStream_t st) {
  const size_t smem = bwd_smem(D, wpr);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel<T, VEC><<<(R + per - 1) / per, BWD_THREADS, smem, st>>>(
      (const T*)x, (const T*)dy, (const float*)mu, (const float*)rsig, (const float*)s, (T*)dx,
      R, D, per, wpr, group, (float*)part, (int*)arrive, (float*)dscale, (float*)dbias);
  return (int)cudaGetLastError();
}

// The plan comes from the wrapper (ops/cuda/layernorm.py `bwd_plan`): VEC
// columns a vector (D a multiple of it, x, dy and dx aligned to it), wpr
// warps a row (D <= 512 wpr), `per` rows a split, `group` splits a group.
template <typename T>
int launch_bwd(const void* x, const void* dy, const void* mu, const void* rsig, const void* s,
               void* dx, void* dscale, void* dbias, void* part, void* arrive, int R, int D,
               int per, int group, int vec, int wpr, cudaStream_t st) {
  if (R < 1 || D < 1 || per < 1 || group < 1 || vec < 1 || D % vec ||
      (wpr != 1 && wpr != 2 && wpr != 4) || D > LANE_COLS * 32 * wpr ||
      vec * (int)sizeof(T) > 16)
    return (int)cudaErrorInvalidValue;
#define LN_BWD_VEC(V)                                                                        \
  case V:                                                                                    \
    return launch_bwd_vec<T, (V * sizeof(T) <= 16 ? V : 1)>(x, dy, mu, rsig, s, dx, dscale,   \
                                                            dbias, part, arrive, R, D, per,  \
                                                            group, wpr, st);
  switch (vec) {
    LN_BWD_VEC(1)
    LN_BWD_VEC(2)
    LN_BWD_VEC(4)
    LN_BWD_VEC(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LN_BWD_VEC
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
// dscale, dbias f32 [D]; part f32 [splits + groups, 2, D] is scratch and
// arrive int32 [groups + 1] counters that are 0 before and after a launch.
extern "C" int ln_bwd_f32(const void* x, const void* dy, const void* mu, const void* rsig,
                          const void* s, void* dx, void* dscale, void* dbias, void* part,
                          void* arrive, int r, int d, int per, int group, int vec, int wpr,
                          void* stream) {
  return launch_bwd<float>(x, dy, mu, rsig, s, dx, dscale, dbias, part, arrive, r, d, per, group,
                           vec, wpr, (cudaStream_t)stream);
}

extern "C" int ln_bwd_bf16(const void* x, const void* dy, const void* mu, const void* rsig,
                           const void* s, void* dx, void* dscale, void* dbias, void* part,
                           void* arrive, int r, int d, int per, int group, int vec, int wpr,
                           void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, mu, rsig, s, dx, dscale, dbias, part, arrive, r, d, per,
                                   group, vec, wpr, (cudaStream_t)stream);
}
