// K3: fused eval patch stem (neighbour gather + Group2Emb mini-PointNet).
//
// Replaces vipformer_tpu/ops/pallas/stem.py:_stem_call (:96, kernel
// _stem_kernel :58; reached through group2emb_fused_apply). The BatchNorm
// folds and the extended first-layer table t1ext = [pts @ W1 + b1 |
// centers @ W1 - b1] stay in the PyTorch wrapper, as in stem.py:170-203.
// Per group of S rows: x0 = relu(t1ext[neighbour] - t1ext[center]), x1 =
// x0 W2 + b2 (128), x2 = relu(concat[max_S x1, x1] W3 + b3) (256), out =
// max_S (x2 W4 + b4) (D).
//
// Bound on the H100: arithmetic. Per row the chain is 64x128 + 128x256
// (the local half of the concat product) + 256xD multiply-adds, and the
// pooled half 128x256 once per group: 0.44 GMAC per cloud at the flagship
// shapes (G = 128, S = 32, D = 256), 0.057 ms at B = 64 on the bf16
// tensor cores (989 TFLOP/s) but 0.84 ms at least on the f32 CUDA cores
// (67 TFLOP/s); the inputs are 32 gathered 64-wide rows a group and the
// weights (L2 resident), the output one D-wide row a group.
//
// The dtype picks the kernel (ops/cuda/__init__.py `tc_route`): f32 runs
// stem_kernel<float> below on the CUDA cores (a tensor-core f32 product is
// TF32, which would break the f32 bound of 2e-5 against the twin); bf16
// runs namespace vpt_stem::tc.
//
// Design, f32: one block per (cloud, group). Hopper gathers rows directly,
// so the 32 neighbour rows of t1ext are read by index and the group's
// center row subtracted (the Pallas signed one-hot MXU trick, stem.py:66-79,
// is not ported). W3 and W4 do not fit a block's shared memory, so they
// stream from global/L2 (L1 serves the block's warps after the first):
// each thread owns a 4-row x 8-column register tile of a layer's output, so
// one k step costs 4 broadcast shared-memory reads and one 32-byte weight
// load for 32 FMAs. The global (max-pooled) half of concat[global, local] @
// W3 is the same for every row of a group, so its f32 partial sum is
// computed once per group and seeds each row's accumulator.
// Rounding follows nn.layers.Dense: f32 accumulation, round to the compute
// dtype, then add the bias in that dtype.
//
// Design, bf16 (namespace tc): K9's tile passes (g2e_train.cu tc) in eval
// form. Persistent blocks of 16 warps, one an SM, walk 128-row tiles of
// whole groups (min(floor(128 / S), 16) groups a tile), every product on
// mma.sync through mma.cuh's block tile (the tensor cores accumulate: an
// eval forward has no batch statistics or cancelling sums to keep close
// to the twin's, unlike K9's). W2, W3 and W4 in bf16 take 272 KB at D =
// 256 (336 KB at 384), more than the 227 KB a block can use, so the chain
// runs in two passes with x2 written once between them:
//   mid  W2 and W3 (152,576 B) stay in shared memory for the launch; per
//        tile the neighbour rows are gathered 16 bytes a load by index
//        (the indices read a tile ahead, so that the gather waits on one
//        round trip), centered and rounded as the twin rounds them (x0),
//        x1 = x0 W2 + b2, each group's max of x1, the pooled half gmax
//        W3[:128] once a group (its 16 groups as one m16 tile: warp_ab),
//        which seeds the accumulators of x2 = relu(gpart + x1 W3[128:] +
//        b3), and x2 is written as bf16 [R, 256];
//   out  W4's column slice (256, 192, 128 or 64 columns; D padded with zero
//        columns to a multiple of 64 by the wrapper) stays in shared memory;
//        per tile x2 is copied in (cp.async), h = x2 W4 + b4, and each
//        group's max of h is written: only [B, G, D] leaves the tile.
// x2 costs 512 bytes a row each way (134 MB at B = 64, 0.04 ms at 3.35
// TB/s; measured, about 0.07 of the 0.38 ms); one launch that streams
// W3's pooled half and W4 through a ring per tile instead would read 192
// KB of weights from L2 a tile (PERF.md).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int S_MAX = 32;    // rows (group size) per block
constexpr int THREADS = 256;
constexpr int RT = 4;        // rows of a thread's register tile
constexpr int CT = 8;        // columns of a thread's register tile

// Eight consecutive weights w[0..7] (two 16-byte loads; the caller keeps w
// 16-byte aligned).
__device__ __forceinline__ void load8(const float* w, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  const float4 b = *reinterpret_cast<const float4*>(w + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
// Register-tiled dense layer over the group's S_MAX rows:
//   y[r][c] = act(round(round(pre[c] + sum_k in[r][k] * w[k][c]) + bias[c]))
// in: [S_MAX, kdim] f32 row-major in shared memory; w: [kdim, cout] in
// storage type T (row stride ldw); pre: optional f32 [cout] partial sum
// shared by every row. Each thread owns RT rows x CT columns: per k it
// reads RT activations (broadcast within a warp) and CT weights (one
// vector load, coalesced across the warp) for RT*CT FMAs.
// With max_out == nullptr, y goes to out [S_MAX, cout] (row-major, float4
// stores); otherwise the max over each tile's valid rows goes to
// max_out[row_group][c] and y is not stored.
template <typename T>
__device__ void dense_tile(const float* in, int kdim, const T* __restrict__ w, int ldw,
                           const T* __restrict__ bias, int cout, int srows, const float* pre,
                           bool relu, float* out, float* max_out) {
  const int ncg = cout / CT;
  const int ntiles = (S_MAX / RT) * ncg;
  for (int tile = threadIdx.x; tile < ntiles; tile += blockDim.x) {
    const int cg = tile % ncg, rg = tile / ncg;
    const int r0 = rg * RT, c0 = cg * CT;
    float acc[RT][CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float p0 = pre ? pre[c0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][j] = p0;
    }
#pragma unroll 4
    for (int kk = 0; kk < kdim; ++kk) {
      float wv[CT];
      load8(w + (size_t)kk * ldw + c0, wv);
      float xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = in[(r0 + i) * kdim + kk];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    float bj[CT];
    load8(bias + c0, bj);
    float m[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) m[j] = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float y[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        y[j] = vpt::round_to<T>(vpt::round_to<T>(acc[i][j]) + bj[j]);
        if (relu) y[j] = fmaxf(y[j], 0.f);
        if (r0 + i < srows) m[j] = fmaxf(m[j], y[j]);
      }
      if (!max_out) {
        float4* o = reinterpret_cast<float4*>(out + (r0 + i) * cout + c0);
        o[0] = make_float4(y[0], y[1], y[2], y[3]);
        o[1] = make_float4(y[4], y[5], y[6], y[7]);
      }
    }
    if (max_out) {
      float4* o = reinterpret_cast<float4*>(max_out + rg * cout + c0);
      o[0] = make_float4(m[0], m[1], m[2], m[3]);
      o[1] = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const T* __restrict__ t1ext, const int* __restrict__ idx, const T* __restrict__ w2,
            const T* __restrict__ b2, const T* __restrict__ w3, const T* __restrict__ b3,
            const T* __restrict__ w4, const T* __restrict__ b4, T* __restrict__ out, int n, int g,
            int s, int c1, int c2, int c3, int d) {
  extern __shared__ __align__(16) float smem[];
  float* x0 = smem;                 // [S, c1]   gathered, centered, ReLU
  float* x1 = x0 + S_MAX * c1;      // [S, c2]   @W2 + b2
  float* x2 = x1 + S_MAX * c2;      // [S, c3]   ReLU(concat @W3 + b3)
  float* gmax = x2 + S_MAX * c3;    // [c2]      max over the group of x1
  float* gpart = gmax + c2;         // [c3]      gmax @ W3[:c2], f32
  float* pmax = gpart + c3;         // [S/RT, d] per-row-group maxima of the output

  const int b = blockIdx.y, grp = blockIdx.x;
  const T* table = t1ext + (size_t)b * (n + g) * c1;
  const int* gi = idx + ((size_t)b * g + grp) * s;
  const T* crow = table + (size_t)(n + grp) * c1;

  // 1. gather + center: x0 = relu(round(t1[p] - c1[g])); rows >= S are 0
  for (int e = threadIdx.x; e < S_MAX * c1; e += blockDim.x) {
    const int r = e / c1, c = e - r * c1;
    float v = 0.f;
    if (r < s) v = vpt::to_f32(table[(size_t)gi[r] * c1 + c]) - vpt::to_f32(crow[c]);
    x0[e] = fmaxf(vpt::round_to<T>(v), 0.f);
  }
  __syncthreads();

  // 2. x1 = x0 @ W2 + b2
  dense_tile<T>(x0, c1, w2, c2, b2, c2, s, nullptr, false, x1, nullptr);
  __syncthreads();

  // 3. group max of x1
  for (int j = threadIdx.x; j < c2; j += blockDim.x) {
    float m = x1[j];
    for (int r = 1; r < s; ++r) m = fmaxf(m, x1[r * c2 + j]);
    gmax[j] = m;
  }
  __syncthreads();

  // 4. pooled half of concat[gmax, x1] @ W3, once per group (f32 partial
  //    sum; the row's local half is added to it before the one rounding)
  for (int j = threadIdx.x; j < c3; j += blockDim.x) {
    float acc = 0.f;
    for (int kk = 0; kk < c2; ++kk) acc = fmaf(gmax[kk], vpt::to_f32(w3[(size_t)kk * c3 + j]), acc);
    gpart[j] = acc;
  }
  __syncthreads();

  // 5. x2 = relu(concat[gmax, x1] @ W3 + b3)
  dense_tile<T>(x1, c2, w3 + (size_t)c2 * c3, c3, b3, c3, s, gpart, true, x2, nullptr);
  __syncthreads();

  // 6. out = max over the group of (x2 @ W4 + b4)
  dense_tile<T>(x2, c3, w4, d, b4, d, s, nullptr, false, nullptr, pmax);
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float m = pmax[j];
    for (int rg = 1; rg < S_MAX / RT; ++rg) m = fmaxf(m, pmax[rg * d + j]);
    out[((size_t)b * g + grp) * d + j] = vpt::from_f32<T>(m);
  }
}

template <typename T>
int launch(const void* t1ext, const void* idx, const void* w2, const void* b2, const void* w3,
           const void* b3, const void* w4, const void* b4, void* out, int b, int n, int g, int s,
           int c1, int d, cudaStream_t stream) {
  const int c2 = 128, c3 = 256;  // Group2Emb's fixed widths (pointnet.py:60-70)
  if (s > S_MAX || s < 1 || c1 % 4 || d % CT) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)S_MAX * (c1 + c2 + c3) + c2 + c3 + (size_t)(S_MAX / RT) * d);
  cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(g, b);
  stem_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)t1ext, (const int*)idx, (const T*)w2, (const T*)b2, (const T*)w3, (const T*)b3,
      (const T*)w4, (const T*)b4, (T*)out, n, g, s, c1, c2, c3, d);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------ bf16, on the tensor cores
// Two persistent passes over 128-row tiles of whole groups (the design note
// at the top); 16 warps a block, each 32 rows x N/4 columns of a product
// (mma.cuh block_mma), rows in shared memory padded by 8 bf16 so that
// ldmatrix meets no bank conflict.
namespace vpt_stem {
namespace tc {

namespace mm = vpt::mma;
using bf16 = mm::bf16;
using vpt::round_to;
using vpt::to_f32;

constexpr int C1 = 64, C2 = 128, C3 = 256;  // Group2Emb's widths (pointnet.py:60-70)
constexpr int TR = 128;                     // rows of a tile
constexpr int MAX_GROUPS = 16;              // groups of a tile: one m16 tile of gmax
constexpr int WARPS = 16, THREADS = 32 * WARPS;
constexpr int LD1 = C1 + 8, LD2 = C2 + 8, LD3 = C3 + 8;  // padded bf16 rows
constexpr int LDP = C3 + 4;                              // f32 rows of the pooled half
// the mid pass's shared memory, bytes: W2 [64][136], W3 [256][264], a tile [128][264]
constexpr int T_SMEM = 2 * TR * LD3;
constexpr int MID_SMEM = 2 * C1 * LD2 + 2 * C3 * LD3 + T_SMEM;  // 220,160
// inside the tile (bf16 elements): x0 [128][72] at 0, where the pooled half
// f32 [16][260] goes once x0 is consumed, x1 [128][136], gmax [16][136];
// x2 [128][264] takes the whole tile once x1 and the pooled half are read
constexpr int X1_OFF = TR * LD1, GMAX_OFF = X1_OFF + TR * LD2;
static_assert(4 * MAX_GROUPS * LDP <= 2 * TR * LD1, "the pooled half fits x0's place");
static_assert(GMAX_OFF + MAX_GROUPS * LD2 <= TR * LD3, "x0, x1 and gmax fit a tile");
// the out pass: W4's column slice [256][N + 8] and a tile
constexpr int out_smem(int n) { return 2 * C3 * (n + 8) + T_SMEM; }
static_assert(MID_SMEM <= 232448 && out_smem(256) <= 232448, "one block an SM");

// groups a tile holds: floor(128 / S), at most 16
__host__ __device__ constexpr int tile_groups(int s) {
  return TR / s < MAX_GROUPS ? TR / s : MAX_GROUPS;
}
__host__ __device__ inline int num_tiles(int s, int ng) {
  return (ng + tile_groups(s) - 1) / tile_groups(s);
}
struct Tile {
  int g0, groups, valid;  // the first of the B*G groups, groups, rows
};
__device__ __forceinline__ Tile tile_at(int t, int s, int ng) {
  const int g0 = t * tile_groups(s), groups = min(tile_groups(s), ng - g0);
  return Tile{g0, groups, groups * s};
}

__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mm::pack_bf16x2(a, b);
}
// Dense's emit: the product rounded to bf16, then the bias added and rounded.
__device__ __forceinline__ float dense_out(float acc, float bias) {
  return round_to<bf16>(round_to<bf16>(acc) + bias);
}
// rows x cols (a multiple of 8) of a row-major bf16 matrix (rows `stride`
// apart) -> shared rows of `ld`, as 16-byte cp.async.
__device__ __forceinline__ void cp_mat(bf16* dst, int ld, const bf16* src, int stride, int rows,
                                       int cols, int tid) {
  const int cpr = cols >> 3;
  for (int e = tid; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, q = e - r * cpr;
    mm::cp_async16(dst + r * ld + 8 * q, src + (size_t)r * stride + 8 * q, true);
  }
}

// mid: per tile, x0 (gathered, centered, rounded, ReLU), x1 = x0 W2 + b2,
// gmax, the pooled half, x2 = relu(concat[gmax, x1] W3 + b3) -> x2g [R, 256].
__global__ void __launch_bounds__(THREADS, 1)
    mid_kernel(const bf16* __restrict__ t1ext, const int* __restrict__ idx,
               const bf16* __restrict__ w2, const bf16* __restrict__ b2,
               const bf16* __restrict__ w3, const bf16* __restrict__ b3, bf16* __restrict__ x2g,
               int n, int g, int s, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  bf16* w3s = w2s + C1 * LD2;
  bf16* T = w3s + C3 * LD3;
  bf16* x0 = T;
  float* gpart = reinterpret_cast<float*>(T);
  bf16* x1 = T + X1_OFF;
  bf16* gmax = T + GMAX_OFF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  cp_mat(w2s, LD2, w2, C2, C1, C2, tid);
  cp_mat(w3s, LD3, w3, C3, C3, C3, tid);
  mm::cp_async_commit();
  mm::cp_async_wait<0>();
  __syncthreads();
  const int ntiles = num_tiles(s, ng);
  static_assert(TR * (C1 / 8) == 2 * THREADS, "two rows' 16-byte pieces a thread");
  // the neighbour index of this thread's two rows (tid / 8 and 64 + tid /
  // 8) of tile t, 0 past its rows: loaded a tile ahead, so that a tile's
  // gather waits on one round trip to memory, not two
  auto neighbours = [&](int t, int (&nb)[2]) {
    const Tile tl = tile_at(t < ntiles ? t : 0, s, ng);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = (tid >> 3) + 64 * k;
      nb[k] = t < ntiles && r < tl.valid ? idx[(size_t)tl.g0 * s + r] : 0;
    }
  };
  int next[2];
  neighbours(blockIdx.x, next);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_at(t, s, ng);
    const size_t row0 = (size_t)tl.g0 * s;
    const int nb[2] = {next[0], next[1]};
    neighbours(t + gridDim.x, next);
    // x0 = relu(round(t1ext[neighbour] - t1ext[center])) as stem_plain
    // rounds it, 8 columns a step; rows past the tile's groups are 0
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = tid + k * THREADS, r = e >> 3, q = (e & 7) * 8;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (r < tl.valid) {
        const int gg = tl.g0 + r / s, cloud = gg / g;
        const bf16* table = t1ext + (size_t)cloud * (n + g) * C1;
        const uint4 a = *reinterpret_cast<const uint4*>(table + (size_t)nb[k] * C1 + q);
        const uint4 c =
            *reinterpret_cast<const uint4*>(table + (size_t)(n + gg - cloud * g) * C1 + q);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 fa = __bfloat1622float2(pa[k]), fc = __bfloat1622float2(pc[k]);
          v[k] = mm::pack_bf16x2(fmaxf(round_to<bf16>(__fsub_rn(fa.x, fc.x)), 0.f),
                                 fmaxf(round_to<bf16>(__fsub_rn(fa.y, fc.y)), 0.f));
        }
      }
      *reinterpret_cast<uint4*>(x0 + r * LD1 + q) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    {  // x1 = x0 W2 + b2 (x0 and x1 do not overlap: no barrier between)
      float c[2][C2 / 32][4];
      mm::block_mma<C2, false, false>(c, x0, LD1, w2s, LD2, C1, warp, lane);
      mm::for_pairs<C2>(c, warp, lane, [&](int r, int col, float v0, float v1) {
        st_pair(x1 + r * LD2 + col, dense_out(v0, to_f32(b2[col])),
                dense_out(v1, to_f32(b2[col + 1])));
      });
    }
    __syncthreads();
    // each group's max of x1 (rows of gmax past the tile's groups: 0)
    for (int p = tid; p < MAX_GROUPS * C2; p += THREADS) {
      const int gi = p >> 7, col = p & (C2 - 1);
      float m = 0.f;
      if (gi < tl.groups) {
        const bf16* rows = x1 + gi * s * LD2 + col;
        m = to_f32(rows[0]);
        for (int r = 1; r < s; ++r) m = fmaxf(m, to_f32(rows[r * LD2]));
      }
      gmax[gi * LD2 + col] = __float2bfloat16_rn(m);
    }
    __syncthreads();
    {  // the pooled half gmax W3[:128] in f32, once a group: warp w takes
       // columns 16 w .. + 16 of the 16 groups' m16 tile
      float c[1][2][4] = {};
      mm::warp_ab<1, 2>(c, gmax, LD2, w3s + 16 * warp, LD3, C2, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = gpart + (8 * h + (lane >> 2)) * LDP + 16 * warp + 8 * j + 2 * (lane & 3);
          dst[0] = c[0][j][2 * h];
          dst[1] = c[0][j][2 * h + 1];
        }
    }
    __syncthreads();
    {  // x2 = relu(concat[gmax, x1] W3 + b3): each row's accumulators start
       // at its group's pooled half, then x1 W3[128:] adds the local half
      float c[2][C3 / 32][4];
      mm::for_pairs<C3>(c, warp, lane, [&](int r, int col, float& v0, float& v1) {
        const float* p = gpart + min(r / s, MAX_GROUPS - 1) * LDP + col;
        v0 = p[0];
        v1 = p[1];
      });
      mm::block_mma<C3, false, false>(c, x1, LD2, w3s + C2 * LD3, LD3, C2, warp, lane, true);
      __syncthreads();  // x1 and the pooled half are read: x2 takes the tile
      mm::for_pairs<C3>(c, warp, lane, [&](int r, int col, float v0, float v1) {
        st_pair(T + r * LD3 + col, fmaxf(dense_out(v0, to_f32(b3[col])), 0.f),
                fmaxf(dense_out(v1, to_f32(b3[col + 1])), 0.f));
      });
    }
    __syncthreads();
    for (int e = tid; e < tl.valid * (C3 / 8); e += THREADS) {
      const int r = e >> 5, q = (e & 31) * 8;
      *reinterpret_cast<uint4*>(x2g + (row0 + r) * C3 + q) =
          *reinterpret_cast<const uint4*>(T + r * LD3 + q);
    }
    __syncthreads();  // the next tile's x0 goes where x2 was
  }
}

// out: block b owns columns [n0, n0 + N) of the padded D, n0 = N (b % (D /
// N)), and walks the tiles; per tile x2 is copied in, h = x2 W4 + b4 is
// rounded into the tile and each group's max of h written.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    out_kernel(const bf16* __restrict__ x2g, const bf16* __restrict__ w4,
               const bf16* __restrict__ b4, bf16* __restrict__ out, int s, int ng, int d) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w4s = reinterpret_cast<bf16*>(smem);
  bf16* T = w4s + C3 * LDN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nct = d / N, n0 = (blockIdx.x % nct) * N, nb = gridDim.x / nct;
  cp_mat(w4s, LDN, w4 + n0, d, C3, N, tid);
  mm::cp_async_commit();
  const int ntiles = num_tiles(s, ng);
  for (int t = blockIdx.x / nct; t < ntiles; t += nb) {
    const Tile tl = tile_at(t, s, ng);
    const bf16* src = x2g + (size_t)tl.g0 * s * C3;
    for (int e = tid; e < TR * (C3 / 8); e += THREADS) {
      const int r = e >> 5, q = (e & 31) * 8;
      const bool ok = r < tl.valid;  // rows past the tile's groups: zero-filled, never read
      mm::cp_async16(T + r * LD3 + q, ok ? src + (size_t)r * C3 + q : src, ok);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<0>();
    __syncthreads();
    float c[2][N / 32][4];
    mm::block_mma<N, false, false>(c, T, LD3, w4s, LDN, C3, warp, lane);
    __syncthreads();
    mm::for_pairs<N>(c, warp, lane, [&](int r, int cc, float v0, float v1) {
      st_pair(T + r * LDN + cc, dense_out(v0, to_f32(b4[n0 + cc])),
              dense_out(v1, to_f32(b4[n0 + cc + 1])));
    });
    __syncthreads();
    for (int p = tid; p < tl.groups * N; p += THREADS) {
      const int gi = p / N, cc = p - gi * N;
      const bf16* rows = T + gi * s * LDN + cc;
      float m = to_f32(rows[0]);
      for (int r = 1; r < s; ++r) m = fmaxf(m, to_f32(rows[r * LDN]));
      out[(size_t)(tl.g0 + gi) * d + n0 + cc] = __float2bfloat16_rn(m);
    }
    __syncthreads();
  }
  mm::cp_async_wait<0>();
}

template <int N>
cudaError_t launch_out(const bf16* x2g, const bf16* w4, const bf16* b4, bf16* out, int s,
                       int ng, int d, int blocks, cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(
      out_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem(N));
  if (attr != cudaSuccess) return attr;
  out_kernel<N><<<blocks, THREADS, out_smem(N), st>>>(x2g, w4, b4, out, s, ng, d);
  return cudaGetLastError();
}

// F3's column slice of g2e_train.cu: the widest of 256, 192, 128, 64 that divides d
constexpr int out_cols(int d) {
  return d % 256 == 0 ? 256 : d % 192 == 0 ? 192 : d % 128 == 0 ? 128 : 64;
}

int launch(const void* t1ext, const void* idx, const void* w2, const void* b2, const void* w3,
           const void* b3, const void* w4, const void* b4, void* out, void* x2g, int b, int n,
           int g, int s, int c1, int d, int mid_blocks, int out_blocks, cudaStream_t st) {
  if (b < 1 || n < 1 || g < 1 || s < 1 || s > TR || c1 != C1 || d < 64 || d % 64 ||
      mid_blocks < 1 || out_blocks < 1 || out_blocks % (d / out_cols(d)))
    return (int)cudaErrorInvalidValue;
  const int ng = b * g;
  const cudaError_t attr =
      cudaFuncSetAttribute(mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MID_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  mid_kernel<<<mid_blocks, THREADS, MID_SMEM, st>>>(
      (const bf16*)t1ext, (const int*)idx, (const bf16*)w2, (const bf16*)b2, (const bf16*)w3,
      (const bf16*)b3, (bf16*)x2g, n, g, s, ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16 *x2 = (const bf16*)x2g, *w = (const bf16*)w4, *bb = (const bf16*)b4;
  bf16* o = (bf16*)out;
  switch (out_cols(d)) {
    case 256: err = launch_out<256>(x2, w, bb, o, s, ng, d, out_blocks, st); break;
    case 192: err = launch_out<192>(x2, w, bb, o, s, ng, d, out_blocks, st); break;
    case 128: err = launch_out<128>(x2, w, bb, o, s, ng, d, out_blocks, st); break;
    default: err = launch_out<64>(x2, w, bb, o, s, ng, d, out_blocks, st); break;
  }
  return (int)err;
}

}  // namespace tc
}  // namespace vpt_stem

// t1ext [B, N+G, C1], idx int32 [B, G*S], w2 [C1, 128], b2 [128],
// w3 [256, 256] (BN folded), b3 [256], w4 [256, D], b4 [D] -> out [B, G, D].
// f32 on the CUDA cores: operands 16-byte aligned; S <= 32, C1 % 4 == 0
// and D % 8 == 0.
extern "C" int stem_f32(const void* t1ext, const void* idx, const void* w2, const void* b2,
                        const void* w3, const void* b3, const void* w4, const void* b4, void* out,
                        int b, int n, int g, int s, int c1, int d, void* stream) {
  return launch<float>(t1ext, idx, w2, b2, w3, b3, w4, b4, out, b, n, g, s, c1, d,
                       (cudaStream_t)stream);
}

// bf16 on the tensor cores: the same operands in bf16 (t1ext and the
// weights 16-byte aligned), C1 = 64, S <= 128, D a multiple of 64 (the
// wrapper pads W4 and b4 with zero columns), x2 bf16 [B*G*S, 256] scratch,
// the two passes' persistent grids (out_blocks a multiple of D / N).
extern "C" int stem_tc_bf16(const void* t1ext, const void* idx, const void* w2, const void* b2,
                            const void* w3, const void* b3, const void* w4, const void* b4,
                            void* out, void* x2, int b, int n, int g, int s, int c1, int d,
                            int mid_blocks, int out_blocks, void* stream) {
  return vpt_stem::tc::launch(t1ext, idx, w2, b2, w3, b3, w4, b4, out, x2, b, n, g, s, c1, d,
                              mid_blocks, out_blocks, (cudaStream_t)stream);
}
