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
// Design: each row is read once, in both directions. The forward gives a
// row to a group of `lanes` lanes (a power of two, 2 to 32; 32 / lanes
// rows a warp), and a persistent grid of about one wave walks the warps
// over their rows (ops/cuda/layernorm.py `fwd_plan` plans it). Where a
// row's bytes are a multiple of 16 (D = 384, 64 in bf16), ln_fwd_kernel
// loads the row into registers, each lane `nv` vectors of VEC adjacent
// columns (16 bytes; narrower only where a pointer is off the boundary):
// vector j lanes + g of the row for the lane at place g of its group, so
// that a group's loads are neighbouring vectors; the lane's columns of
// scale and bias stay in registers for the whole launch, and each warp's
// next rows are loaded before the current ones are normalised and stored.
// Where they are not (D = 261, odd widths), ln_fwd_staged_kernel takes
// tiles of the fewest rows whose bytes are a multiple of 16 (8 at an odd
// bf16 width): a tile starts and ends on 16-byte boundaries, so it moves
// in 16-byte cp.async copies into shared memory (the warp's next tile in
// flight meanwhile) and 16-byte stores, and its rows are normalised in
// place there. In both, the row sums reduce inside the group by xor
// shuffles in a fixed order, so that every lane of the group ends with the
// same bits and a launch's output is the same bits run to run. The
// backward reads each row once too (ln_bwd_kernel below):
// its column sums cannot ride a sequential grid on Hopper, so each block
// keeps its lanes' column sums in registers, combines them once into a
// partial, and the last blocks to finish sum the partials in a fixed order
// (an integer arrival counter, no float atomics, no second launch): the
// sums are the same bits run to run.
#include "mma.cuh"
#include "train_common.cuh"

namespace vpt_ln {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------- forward
// FWD_WARPS warps a block. LC is the most columns a lane holds (8, 16, 32
// or 64: nv VEC <= LC), so NV = LC / VEC vector slots, of which the first
// nv are used. The lane loads its first rows, then its columns of scale
// and bias, which it keeps in registers up to 32 columns (above that they
// come from L1), and loads its next row group's vectors before it stores
// the current one's where they take at most 32 registers (every 16-byte
// instance).
constexpr int FWD_WARPS = 8, FWD_THREADS = 32 * FWD_WARPS;

// VEC adjacent f32 values (p aligned to 4 min(VEC, 4) bytes) in loads of
// up to 16 bytes
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&out)[VEC]) {
  constexpr int W = VEC < 4 ? VEC : 4;
  using Rw = typename vpt::Raw<4 * W>::type;
#pragma unroll
  for (int k = 0; k < VEC; k += W) {
    const Rw raw = __ldg(reinterpret_cast<const Rw*>(p + k));
    const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < W; ++i) out[k + i] = e[i];
  }
}

template <typename T, int VEC, int LC>
__global__ void __launch_bounds__(FWD_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
              T* __restrict__ y, float* __restrict__ mu_out, float* __restrict__ rsig_out, int R,
              int D, int lanes, int nv) {
  constexpr int NV = LC / VEC;
  constexpr bool SB_REGS = LC <= 32;
  constexpr int SLOT_REGS = VEC * sizeof(T) < 4 ? 1 : VEC * sizeof(T) / 4;
  constexpr bool PREFETCH = NV * SLOT_REGS <= 32;
  using Rw = typename vpt::Raw<VEC * sizeof(T)>::type;
  const int lane = threadIdx.x & 31;
  const int g = lane & (lanes - 1);  // the lane's place in its row's group
  const int rpw = 32 / lanes;        // rows a warp holds at once
  const int sub = lane / lanes;      // the lane's row among them
  const int nvec = D / VEC;
  const int groups = (R + rpw - 1) / rpw, stride = gridDim.x * FWD_WARPS;
  int grp = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  // vector slot j of the lane holds the row's vector j lanes + g
  auto col_ok = [&](int j) { return j < nv && j * lanes + g < nvec; };
  auto load = [&](int gi, Rw (&buf)[NV]) {
    const int r = gi * rpw + sub;
    if (r >= R) return;
    const T* xr = x + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (col_ok(j)) buf[j] = *reinterpret_cast<const Rw*>(xr + (j * lanes + g) * VEC);
  };
  Rw cur[NV], nxt[PREFETCH ? NV : 1];
  if (grp < groups) load(grp, cur);  // the first rows in flight before scale and bias
  float sc[SB_REGS ? NV : 1][VEC], bi[SB_REGS ? NV : 1][VEC];
  if constexpr (SB_REGS) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (col_ok(j)) {
        load_f32<VEC>(s + (j * lanes + g) * VEC, sc[j]);
        load_f32<VEC>(b + (j * lanes + g) * VEC, bi[j]);
      }
    }
  }
  for (; grp < groups; grp += stride) {
    if constexpr (PREFETCH) {
      if (grp + stride < groups) load(grp + stride, nxt);
    }
    const int r = grp * rpw + sub;
    const bool rv = r < R;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!rv || !col_ok(j)) continue;
      float v[VEC];
      vpt::unpack_vec<T, VEC>(cur[j], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sum += v[i];
        sq = fmaf(v[i], v[i], sq);
      }
    }
    // xor shuffles inside the group: every lane of a row gets the same
    // sums in the same order
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / (float)D, mu2 = sq / (float)D;
    const float rsig = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
    if (rv) {
      T* yr = y + (size_t)r * D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!col_ok(j)) continue;
        const int c0 = (j * lanes + g) * VEC;
        float o[VEC];
        vpt::unpack_vec<T, VEC>(cur[j], o);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float sv = SB_REGS ? sc[SB_REGS ? j : 0][i] : __ldg(s + c0 + i);
          const float bv = SB_REGS ? bi[SB_REGS ? j : 0][i] : __ldg(b + c0 + i);
          o[i] = (o[i] - mu) * (rsig * sv) + bv;
        }
        vpt::store_vec<T, VEC>(yr + c0, o);
      }
      if (g == 0) {
        mu_out[r] = mu;
        rsig_out[r] = rsig;
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
    } else if (grp + stride < groups) {
      load(grp + stride, cur);
    }
  }
}

// The staged route: a warp's tile is `tile_rows` consecutive rows, the
// fewest whose bytes are a multiple of 16 (staged_tile_rows), x and y
// 16-byte aligned; a group of 32 / tile_rows lanes a row (4 at an odd
// bf16 width), so that the warp normalises all the tile's rows at once,
// from shared memory (at an odd width the rows' groups fall on other
// banks). In bf16 a lane reads the tile two elements a 32-bit word: lane g
// of a group takes the row's whole words g, g + lanes, ..., and where the
// row starts (ends) mid-word its first (last) lane takes that lone column
// (written alone, beside the neighbouring row's half); in f32 one element
// at a time.
// The tile's x is overwritten with y in place. Dynamic shared memory:
// (scale[k], bias[k], scale[k + 1], bias[k + 1]) a column k, so that a
// pair's four values are one aligned 16-byte read, then two tile buffers
// a warp, the next tile in flight while the current one is normalised.
__host__ __device__ inline int staged_head_bytes(int D) { return 16 * D; }
__host__ __device__ inline int staged_tile_rows(int D, int size) {
  int r = 1;
  while ((r * D * size) % 16) r *= 2;
  return r;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
ln_fwd_staged_kernel(const T* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
                     float* __restrict__ rsig_out, int R, int D) {
  constexpr int U = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr bool PAIRS = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int tile_rows = staged_tile_rows(D, sizeof(T)), tile_el = tile_rows * D;
  float4* sb4 = reinterpret_cast<float4*>(smem_raw);
  T* bufs = reinterpret_cast<T*>(smem_raw + staged_head_bytes(D)) + (size_t)warp * 2 * tile_el;
  const int lanes = 32 / tile_rows, g = lane & (lanes - 1), sub = lane / lanes;
  const int tiles = (R + tile_rows - 1) / tile_rows, stride = gridDim.x * warps;
  int t = blockIdx.x * warps + warp;
  // tile ti's elements [ti tile_el, + n) into buf: whole 16-byte vectors
  // by cp.async, the last tile's ragged end (if any) element by element
  auto fetch = [&](int ti, T* buf) {
    const size_t base = (size_t)ti * tile_el;
    const int n = min(tile_rows, R - ti * tile_rows) * D, nvec = n / U;
    for (int q = lane; q < nvec; q += 32)
      vpt::mma::cp_async16(buf + q * U, x + base + (size_t)q * U, true);
    for (int e = nvec * U + lane; e < n; e += 32) buf[e] = x[base + e];
  };
  if (t < tiles) fetch(t, bufs);
  vpt::mma::cp_async_commit();
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    sb4[i] = make_float4(s[i], b[i], i + 1 < D ? s[i + 1] : 0.f, i + 1 < D ? b[i + 1] : 0.f);
  __syncthreads();
  for (int k = 0; t < tiles; t += stride, ++k) {
    T* cur = bufs + (k & 1) * tile_el;
    if (t + stride < tiles) fetch(t + stride, bufs + ((k + 1) & 1) * tile_el);
    vpt::mma::cp_async_commit();
    vpt::mma::cp_async_wait<1>();  // tile t has landed (this lane's copies)
    __syncwarp();
    const int rows = min(tile_rows, R - t * tile_rows);
    const bool rv = sub < rows;
    const int e0 = sub * D;  // the row's first element in the tile
    float sum = 0.f, sq = 0.f;
    // bf16: word w holds the row's columns 2w - e0 (low half) and 2w - e0 +
    // 1; its whole words are [wa, wb), and a row that starts (ends) mid-word
    // has its first (last) column alone in the word before (at) them
    const int wa = (e0 + 1) >> 1, wb = (e0 + D) >> 1;
    const bool head = e0 & 1, tail = (e0 + D) & 1;
    if constexpr (PAIRS) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(cur);
      if (rv) {
        for (int w = wa + g; w < wb; w += lanes) {
          const uint32_t u = words[w];
          const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
          sum += lo;
          sq = fmaf(lo, lo, sq);
          sum += hi;
          sq = fmaf(hi, hi, sq);
        }
        if (g == 0 && head) {
          const float v = vpt::to_f32(cur[e0]);
          sum += v;
          sq = fmaf(v, v, sq);
        }
        if (g == lanes - 1 && tail) {
          const float v = vpt::to_f32(cur[e0 + D - 1]);
          sum += v;
          sq = fmaf(v, v, sq);
        }
      }
    } else if (rv) {
      for (int c = g; c < D; c += lanes) {
        const float v = vpt::to_f32(cur[e0 + c]);
        sum += v;
        sq = fmaf(v, v, sq);
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / (float)D, mu2 = sq / (float)D;
    const float rsig = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
    if (rv) {
      if constexpr (PAIRS) {
        uint32_t* words = reinterpret_cast<uint32_t*>(cur);
        for (int w = wa + g; w < wb; w += lanes) {
          const uint32_t u = words[w];
          const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
          const float4 p = sb4[2 * w - e0];
          const __nv_bfloat162 o = __floats2bfloat162_rn((lo - mu) * (rsig * p.x) + p.y,
                                                         (hi - mu) * (rsig * p.z) + p.w);
          words[w] = *reinterpret_cast<const uint32_t*>(&o);
        }
        // the lone columns: a 16-bit store each, beside the other row's half
        if (g == 0 && head) {
          const float4 p = sb4[0];
          cur[e0] = vpt::from_f32<T>((vpt::to_f32(cur[e0]) - mu) * (rsig * p.x) + p.y);
        }
        if (g == lanes - 1 && tail) {
          const float4 p = sb4[D - 1];
          cur[e0 + D - 1] =
              vpt::from_f32<T>((vpt::to_f32(cur[e0 + D - 1]) - mu) * (rsig * p.x) + p.y);
        }
      } else {
        for (int c = g; c < D; c += lanes) {
          const float4 p = sb4[c];
          cur[e0 + c] = vpt::from_f32<T>((vpt::to_f32(cur[e0 + c]) - mu) * (rsig * p.x) + p.y);
        }
      }
      if (g == 0) {
        mu_out[t * tile_rows + sub] = mu;
        rsig_out[t * tile_rows + sub] = rsig;
      }
    }
    __syncwarp();
    // the tile out: 16 bytes a lane, then the last tile's ragged end
    const size_t base = (size_t)t * tile_el;
    const int n = rows * D, nvec = n / U;
    const uint4* src = reinterpret_cast<const uint4*>(cur);
    uint4* dst = reinterpret_cast<uint4*>(y + base);
    for (int q = lane; q < nvec; q += 32) dst[q] = src[q];
    for (int e = nvec * U + lane; e < n; e += 32) y[base + e] = cur[e];
    __syncwarp();  // every lane has read the buffer before it is refilled
  }
  vpt::mma::cp_async_wait<0>();
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

template <typename T, int VEC, int LC>
int launch_fwd_vec(const void* x, const void* s, const void* b, void* y, void* mu, void* rsig,
                   int R, int D, int lanes, int nv, int sms, cudaStream_t st) {
  // a persistent grid of about one wave: the blocks an SM holds at the
  // kernel's registers (asked once an instance), no more than the rows fill
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_fwd_kernel<T, VEC, LC>, FWD_THREADS, 0);
    return n > 0 ? n : 1;
  }();
  const int rows_block = FWD_WARPS * (32 / lanes);
  const int blocks = min((R + rows_block - 1) / rows_block, sms * per_sm);
  ln_fwd_kernel<T, VEC, LC><<<blocks, FWD_THREADS, 0, st>>>(
      (const T*)x, (const float*)s, (const float*)b, (T*)y, (float*)mu, (float*)rsig, R, D, lanes,
      nv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_staged(const void* x, const void* s, const void* b, void* y, void* mu, void* rsig,
                      int R, int D, int warps, int sms, cudaStream_t st) {
  const size_t smem =
      staged_head_bytes(D) + (size_t)warps * 2 * staged_tile_rows(D, sizeof(T)) * D * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(ln_fwd_staged_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_fwd_staged_kernel<T>,
                                                      32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_block = warps * staged_tile_rows(D, sizeof(T));
  const int blocks = min((R + rows_block - 1) / rows_block, sms * max(per_sm, 1));
  ln_fwd_staged_kernel<T><<<blocks, 32 * warps, smem, st>>>(
      (const T*)x, (const float*)s, (const float*)b, (T*)y, (float*)mu, (float*)rsig, R, D);
  return (int)cudaGetLastError();
}

// The plan comes from the wrapper (ops/cuda/layernorm.py `fwd_plan`):
// `lanes` lanes a row (a power of two, 2 to 32; 32 / lanes rows a warp at
// a time), VEC columns a vector and nv vectors a lane (lanes nv VEC >= D,
// at most 64 columns a lane), `rows_block` rows a block, `sms` the card's
// SMs. Directly (staged 0): D a multiple of VEC, x and y aligned to it,
// scale and bias to 16 bytes, FWD_WARPS warps a block. Staged (1): VEC 1,
// 16 lanes a row up to 32 columns a lane, else 32; x and y 16-byte
// aligned; rows_block a whole number (at most FWD_WARPS) of tiles of
// staged_tile_rows rows.
template <typename T>
int launch_fwd(const void* x, const void* s, const void* b, void* y, void* mu, void* rsig, int R,
               int D, int lanes, int vec, int nv, int rows_block, int staged, int sms,
               cudaStream_t st) {
  const int lc = nv * vec;
  if (R < 1 || D < 1 || D > 2048 || sms < 1 || lanes < 2 || lanes > 32 || (lanes & (lanes - 1)) ||
      vec < 1 || nv < 1 || lanes * lc < D || vec * (int)sizeof(T) > 16 || rows_block < 1)
    return (int)cudaErrorInvalidValue;
  if (staged) {
    const int tile_rows = staged_tile_rows(D, sizeof(T)), warps = rows_block / tile_rows;
    if (staged != 1 || vec != (sizeof(T) == 2 ? 2 : 1) || rows_block % tile_rows ||
        warps > FWD_WARPS || lanes * tile_rows != 32)
      return (int)cudaErrorInvalidValue;
    return launch_fwd_staged<T>(x, s, b, y, mu, rsig, R, D, warps, sms, st);
  }
  if (D % vec || lc > 64 || rows_block * lanes != 32 * FWD_WARPS) return (int)cudaErrorInvalidValue;
#define LN_FWD(V, LC)                                                                       \
  return launch_fwd_vec<T, (V * sizeof(T) <= 16 ? V : 1), LC>(x, s, b, y, mu, rsig, R, D, \
                                                              lanes, nv, sms, st)
#define LN_FWD_LC(V)                 \
  case V:                            \
    if (lc <= 8) LN_FWD(V, 8);       \
    if (lc <= 16) LN_FWD(V, 16);     \
    if (lc <= 32) LN_FWD(V, 32);     \
    LN_FWD(V, 64);
  switch (vec) {
    LN_FWD_LC(1)
    LN_FWD_LC(2)
    LN_FWD_LC(4)
    LN_FWD_LC(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LN_FWD_LC
#undef LN_FWD
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

// x [R, D] (T), scale, bias f32 [D] -> y [R, D] (T), mu, rsig f32 [R]; the
// plan (lanes, vec, nv, rows_block, staged) and the card's SMs as
// launch_fwd takes them.
extern "C" int ln_fwd_f32(const void* x, const void* s, const void* b, void* y, void* mu,
                          void* rsig, int r, int d, int lanes, int vec, int nv, int rows_block,
                          int staged, int sms, void* stream) {
  return launch_fwd<float>(x, s, b, y, mu, rsig, r, d, lanes, vec, nv, rows_block, staged, sms,
                           (cudaStream_t)stream);
}

extern "C" int ln_fwd_bf16(const void* x, const void* s, const void* b, void* y, void* mu,
                           void* rsig, int r, int d, int lanes, int vec, int nv, int rows_block,
                           int staged, int sms, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, s, b, y, mu, rsig, r, d, lanes, vec, nv, rows_block, staged,
                                   sms, (cudaStream_t)stream);
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
