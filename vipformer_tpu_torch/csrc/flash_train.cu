// K8 and K7: training attention with in-kernel dropout, forward and
// backward, on the packed [B, tokens, H*dh] layout.
//
// K8 replaces vipformer_tpu/ops/pallas/flash_train.py:flash_attention_train
// (forward _fwd_kernel :135 via _fwd_call :238, backward _bwd_kernel :185
// via _bwd_call :276). K7 replaces flash_train.py:flash_attention_train_kv
// (:916; forward :701, backward :747): the same attention with the kv
// LayerNorm and the bias-free k/v projections inside, whose backward also
// gives dx, dWk, dWv and the LN scale/bias gradients.
//
// Semantics (torch's, as the Pallas kernels): softmax -> dropout -> @V;
// the softmax denominator uses the UNdropped p, so the forward saves only
// the per-row logsumexp; the backward recomputes p = exp(s - lse) and uses
// delta = rowsum(dO * O), which holds under post-softmax dropout:
//   dV = Pd^T dO,  dPd = dO V^T,  dS = (Pd * dPd - P * delta) * scale,
//   dQ = dS K,     dK = dS^T Q,   with Pd = P * keep / (1 - rate).
//
// Dropout. The TPU kernel drew its mask from the TPU's PRNG, which cannot
// be reproduced. Here the keep bit of element (row g, column m) of
// (cloud b, head h) is a pure function of (seed, b*H + h, g, m):
//   bits = mix(m + mix(g + mix(bh + mix(seed))))  (all mod 2^32),
//   keep = bits >= thresh,  thresh = round(rate * 2^32),
// with mix the 32-bit integer hash below. The backward regenerates the
// same bits; no mask is stored. The plain PyTorch twin computes the same
// bits with int64 tensor ops (ops/cuda/flash_train.py), so the kernel and
// the twin agree mask for mask.
//
// Bound on the H100: operations. Per (cloud, head) the attention does
// 2 x G x M x dh MACs forward and 5 x G x M x dh backward (two recomputes
// of the scores, dV, dPd, dK in one kernel and scores, dPd, dQ in the
// other); K7 adds the k/v projection of every kv token (M x Din x 2D MACs,
// twice: forward and the backward's recompute) and its backward products.
// Everything but K8's bf16 forward runs on CUDA cores in f32 (67 TFLOP/s
// peak), so the bound that matters there is that rate, not the 989
// TFLOP/s of the tensor cores. K8's bf16 forward (tc::flash_fwd_tc_kernel)
// runs its products on the tensor cores; at the pretrain point branch's
// [96, 128, 256], H = 4, they are 1.6 GFLOP (0.002 ms at 989 TFLOP/s)
// against 25.4 MB of q, k, v, out and lse (0.0076 ms at 3.35 TB/s), and the
// dropout hash and the exp of each of its 6.3 M scores run beside them on
// the CUDA cores. The dtype picks the forward's kernel
// (ops/cuda/__init__.py `tc_route`): f32 stays on flash_fwd_kernel<float>,
// since a tensor-core f32 product is TF32; K7's forward and both
// backwards keep the CUDA-core kernels in both dtypes.
//
// Design: one block per (cloud*head, 64 query rows) in the forward and in
// the dQ pass, one block per (cloud*head, 64 kv rows) in the dK/dV pass,
// so nothing is carried between blocks: the TPU kernel accumulated dQ
// across its sequential kv grid axis, here the dQ pass walks the kv tiles
// itself (at the cost of recomputing the scores once more) and the result
// is deterministic without atomics. Tiles of 64 x 64 in shared memory as
// f32 with rows padded to 68 floats; 256 threads, each owning a 4 x 4
// register tile, so a row's max and sum reduce over 16 lanes by shuffles.
// K7's projections, LN backward and weight gradients run through the SIMT
// product of train_common.cuh; its weight gradients are split over the
// token axis into partials summed in a fixed order.
#include "mma.cuh"
#include "train_common.cuh"

namespace vpt_flash {

using namespace vpt;

constexpr int DH = 64;       // head width of these kernels
constexpr int BT = 64;       // rows per tile (queries or kv tokens)
constexpr int LD = BT + 4;   // padded shared-memory row stride (floats)
constexpr int THREADS = 256;
constexpr int TILE = DH * LD;  // floats per [64][68] tile

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x045d9f3bu;
  x ^= x >> 16;
  x *= 0x045d9f3bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t bh, uint32_t row) {
  return mix32(row + mix32(bh + mix32(seed)));
}
__device__ __forceinline__ bool keep_bit(uint32_t rkey, uint32_t col, uint32_t thresh) {
  return mix32(col + rkey) >= thresh;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// [64 rows][64 d] of a packed [B, N, H*DH] tensor -> tile, either
// transposed (t[d*LD + r]) or row-major (t[r*LD + d]); rows >= n are 0.
template <typename T, bool TRANS>
__device__ __forceinline__ void load_tile(float* t, const T* __restrict__ src, int b, int n,
                                          int row0, int h, int H) {
  const int D = H * DH;
  for (int e = threadIdx.x; e < BT * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    const int g = row0 + r;
    const float v = g < n ? to_f32(src[((size_t)b * n + g) * D + h * DH + d]) : 0.f;
    if (TRANS) t[d * LD + r] = v; else t[r * LD + d] = v;
  }
}

// s[i][j] = sum_d A[d][r0+i] * B[d][c0+j] over two transposed tiles.
__device__ __forceinline__ void tile_dot_t(const float* At, const float* Bt, int r0, int c0,
                                           float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float4 a = ld4(At + d * LD + r0), b = ld4(Bt + d * LD + c0);
    const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[c][r0+i] * V[c][c0+j]  (P stored [c][row], V [c][d]).
__device__ __forceinline__ void tile_acc(const float* P, const float* V, int r0, int c0,
                                         float acc[4][4]) {
#pragma unroll 8
  for (int c = 0; c < BT; ++c) {
    const float4 a = ld4(P + c * LD + r0), b = ld4(V + c * LD + c0);
    const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------ forward
// Block (query tile, b*H+h). Thread (ty, tx) owns query rows ty*4..+3 and,
// per kv tile, columns tx*4..+3 of the scores and d columns tx*4..+3 of
// the output.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seed, T* __restrict__ out, float* __restrict__ lse,
                     int G, int M, int H, float scale, float keep_p, uint32_t thresh, int drop) {
  extern __shared__ __align__(16) float sm[];
  float* QsT = sm;           // [d][row]
  float* KsT = QsT + TILE;   // [d][col]
  float* Vs = KsT + TILE;    // [col][d]
  float* PsT = Vs + TILE;    // [col][row]: dropped p in v's dtype
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, r0 = ty * 4, c0 = tx * 4;
  load_tile<T, true>(QsT, q, b, G, q0, h, H);
  uint32_t rk[4];
  const uint32_t s0 = drop ? (uint32_t)seed[0] : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) rk[i] = row_key(s0, bh, q0 + r0 + i);
  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int j0 = 0; j0 < M; j0 += BT) {
    __syncthreads();
    load_tile<T, true>(KsT, k, b, M, j0, h, H);
    load_tile<T, false>(Vs, v, b, M, j0, h, H);
    __syncthreads();
    float s[4][4];
    tile_dot_t(QsT, KsT, r0, c0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (j0 + c0 + j < M) ? s[i][j] * scale : -CUDART_INF_F;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], max16(rmax));
      const float corr = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        float pd = p;
        if (drop) pd = keep_bit(rk[i], j0 + c0 + j, thresh) ? p / keep_p : 0.f;
        PsT[(c0 + j) * LD + r0 + i] = round_to<T>(pd);
      }
      l_run[i] = l_run[i] * corr + sum16(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_acc(PsT, Vs, r0, c0, acc);
  }
  const int D = H * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = q0 + r0 + i;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[((size_t)b * G + g) * D + h * DH + c0 + j] = from_f32<T>(acc[i][j] / l_run[i]);
    if (tx == 0) lse[(size_t)bh * G + g] = m_run[i] + logf(l_run[i]);
  }
}

// ------------------------------------------------------ backward dK, dV
// Block (kv tile, b*H+h) walks the query tiles. Thread (ty, tx) owns kv
// rows ty*4..+3; in the score phase query columns tx*4..+3, in the
// accumulation phase d columns tx*4..+3.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seed, TO* __restrict__ dk, TO* __restrict__ dv,
                          int G, int M, int H, float scale, float keep_p, uint32_t thresh,
                          int drop) {
  extern __shared__ __align__(16) float sm[];
  float* KsT = sm;            // [d][kv]
  float* VsT = KsT + TILE;    // [d][kv]
  float* QsT = VsT + TILE;    // [d][q]
  float* Qs = QsT + TILE;     // [q][d]
  float* dOsT = Qs + TILE;    // [d][q]
  float* dOs = dOsT + TILE;   // [q][d]
  float* Pds = dOs + TILE;    // [q][kv]
  float* dSs = Pds + TILE;    // [q][kv]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, j0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, r0 = ty * 4, c0 = tx * 4;
  load_tile<T, true>(KsT, k, b, M, j0, h, H);
  load_tile<T, true>(VsT, v, b, M, j0, h, H);
  const uint32_t s0 = drop ? (uint32_t)seed[0] : 0u;
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;
  for (int i0 = 0; i0 < G; i0 += BT) {
    __syncthreads();
    load_tile<T, true>(QsT, q, b, G, i0, h, H);
    load_tile<T, false>(Qs, q, b, G, i0, h, H);
    load_tile<T, true>(dOsT, dout, b, G, i0, h, H);
    load_tile<T, false>(dOs, dout, b, G, i0, h, H);
    __syncthreads();
    float st[4][4], dpt[4][4];  // [kv row i][query col j]
    tile_dot_t(KsT, QsT, r0, c0, st);
    tile_dot_t(VsT, dOsT, r0, c0, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = i0 + c0 + j;
      const bool gv = g < G;
      const float l = gv ? lse[(size_t)bh * G + g] : 0.f;
      const float dl = gv ? delta[(size_t)bh * G + g] : 0.f;
      const uint32_t rk = row_key(s0, bh, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = j0 + r0 + i;
        const float p = (gv && m < M) ? expf(st[i][j] * scale - l) : 0.f;
        float pd = p;
        if (drop) pd = keep_bit(rk, m, thresh) ? p / keep_p : 0.f;
        Pds[(c0 + j) * LD + r0 + i] = pd;
        dSs[(c0 + j) * LD + r0 + i] = (pd * dpt[i][j] - p * dl) * scale;
      }
    }
    __syncthreads();
    tile_acc(Pds, dOs, r0, c0, dva);
    tile_acc(dSs, Qs, r0, c0, dka);
  }
  const int D = H * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = j0 + r0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t off = ((size_t)b * M + m) * D + h * DH + c0 + j;
      dk[off] = from_f32<TO>(dka[i][j]);
      dv[off] = from_f32<TO>(dva[i][j]);
    }
  }
}

// ----------------------------------------------------------- backward dQ
// Block (query tile, b*H+h) walks the kv tiles and recomputes the scores.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seed, T* __restrict__ dq, int G, int M, int H,
                        float scale, float keep_p, uint32_t thresh, int drop) {
  extern __shared__ __align__(16) float sm[];
  float* QsT = sm;            // [d][q]
  float* dOsT = QsT + TILE;   // [d][q]
  float* KsT = dOsT + TILE;   // [d][kv]
  float* VsT = KsT + TILE;    // [d][kv]
  float* Ks = VsT + TILE;     // [kv][d]
  float* dSsT = Ks + TILE;    // [kv][q]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, r0 = ty * 4, c0 = tx * 4;
  load_tile<T, true>(QsT, q, b, G, q0, h, H);
  load_tile<T, true>(dOsT, dout, b, G, q0, h, H);
  const uint32_t s0 = drop ? (uint32_t)seed[0] : 0u;
  float l[4], dl[4], dqa[4][4];
  uint32_t rk[4];
  bool gv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = q0 + r0 + i;
    gv[i] = g < G;
    l[i] = gv[i] ? lse[(size_t)bh * G + g] : 0.f;
    dl[i] = gv[i] ? delta[(size_t)bh * G + g] : 0.f;
    rk[i] = row_key(s0, bh, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;
  }
  for (int j0 = 0; j0 < M; j0 += BT) {
    __syncthreads();
    load_tile<T, true>(KsT, k, b, M, j0, h, H);
    load_tile<T, true>(VsT, v, b, M, j0, h, H);
    load_tile<T, false>(Ks, k, b, M, j0, h, H);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot_t(QsT, KsT, r0, c0, s);
    tile_dot_t(dOsT, VsT, r0, c0, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = j0 + c0 + j;
        const float p = (gv[i] && m < M) ? expf(s[i][j] * scale - l[i]) : 0.f;
        float pd = p;
        if (drop) pd = keep_bit(rk[i], m, thresh) ? p / keep_p : 0.f;
        dSsT[(c0 + j) * LD + r0 + i] = (pd * dp[i][j] - p * dl[i]) * scale;
      }
    __syncthreads();
    tile_acc(dSsT, Ks, r0, c0, dqa);
  }
  const int D = H * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!gv[i]) continue;
    const int g = q0 + r0 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[((size_t)b * G + g) * D + h * DH + c0 + j] = from_f32<T>(dqa[i][j]);
  }
}

// The keep bits of every (b*H+h, g, m), for checking the twin's mask.
__global__ void dropout_mask_kernel(const int* __restrict__ seed, int BH, int G, int M,
                                    uint32_t thresh, unsigned char* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)BH * G * M) return;
  const int m = i % M, g = (i / M) % G, bh = i / ((size_t)M * G);
  out[i] = keep_bit(row_key((uint32_t)seed[0], bh, g), m, thresh) ? 1 : 0;
}

constexpr int FWD_SMEM = 4 * TILE * 4, DKDV_SMEM = 8 * TILE * 4, DQ_SMEM = 6 * TILE * 4;

template <typename T>
int flash_fwd(const T* q, const T* k, const T* v, const int* seed, T* out, float* lse, int B,
              int G, int M, int H, float scale, float keep_p, uint32_t thresh, int drop,
              cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T><<<dim3((G + BT - 1) / BT, B * H), THREADS, FWD_SMEM, st>>>(
      q, k, v, seed, out, lse, G, M, H, scale, keep_p, thresh, drop);
  return cudaGetLastError();
}

// ------------------------------------------- K8 forward, bf16, on the tensor cores
// K13's tiles (attention.cu) with K8's dropout and log-sum-exp: one block
// of TC_WARPS warps per (64 query rows, cloud * head), 16 rows a warp with
// its q in registers as ldmatrix A fragments; the k and v tiles of 64 keys
// x this head's 64 columns stream through a 3-stage cp.async ring, one
// barrier a tile, the next two tiles' loads in flight during a tile's
// products. s = q.k on mma.sync (bf16 in, f32 out), in log2 units (s *
// scale * log2 e), then the online softmax of flash_fwd_kernel in
// registers: the tile's row max over the quad of lanes that shares a row,
// corr = 2^(m - m_new), p = 2^(t - m_new) in f32, l summing the undropped
// unrounded p; then the keep bit of each p from the same hash (keep_bit,
// row_key of the row, the key's column), kept p / (1 - rate) and dropped
// 0, rounded to bf16 in registers as the A fragments of P.V (v through
// ldmatrix.trans); acc rescaled by corr, divided by l at the end, and
// lse = m ln 2 + log l for the backward (f32, natural units, as the
// CUDA-core kernels keep it). Keys past M get -inf logits and zero-filled
// k/v rows; query rows past G are computed from zero rows, not written.
namespace tc {

using vpt::mma::bf16;
using vpt::mma::KT;
using vpt::mma::NT;
constexpr int TC_WARPS = 4;              // 16 query rows a warp
constexpr int TC_QT = 16 * TC_WARPS;     // query rows a block: 64
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_STAGES = 3;             // k/v tiles in flight
constexpr int TC_LD = DH + 8;            // padded shared row (bf16)
constexpr size_t TC_SMEM = sizeof(bf16) * (size_t)(TC_QT + 2 * TC_STAGES * KT) * TC_LD;

__global__ void __launch_bounds__(TC_THREADS, 3)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seed,
                    bf16* __restrict__ out, float* __restrict__ lse, int G, int M, int H,
                    float scale, float keep_p, uint32_t thresh, int drop) {
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_QT][TC_LD]
  bf16* ks = qs + TC_QT * TC_LD;                 // [TC_STAGES][KT][TC_LD]
  bf16* vs = ks + TC_STAGES * KT * TC_LD;        // [TC_STAGES][KT][TC_LD]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * TC_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = H * DH, nt = (M + KT - 1) / KT;
  const bf16* kb = k + (size_t)b * M * D + h * DH;
  const bf16* vb = v + (size_t)b * M * D + h * DH;
  auto load = [&](int t) {
    const int slot = t % TC_STAGES;
    mm::cp_rows<DH, KT, TC_THREADS>(ks + slot * KT * TC_LD, TC_LD, kb, D, t * KT, M, tid);
    mm::cp_rows<DH, KT, TC_THREADS>(vs + slot * KT * TC_LD, TC_LD, vb, D, t * KT, M, tid);
  };
  // group 0: q and the first tile; then one group a tile
  mm::cp_rows<DH, TC_QT, TC_THREADS>(qs, TC_LD, q + (size_t)b * G * D + h * DH, D, q0, G, tid);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nt) load(st);
    mm::cp_async_commit();
  }

  const int row0 = q0 + 16 * warp;  // the warp's first row
  const bool active = row0 < G;
  const float c = scale * mm::LOG2E;  // logits (and mx) in log2 units
  const float inv_keep = 1.0f / keep_p;
  const uint32_t s0 = drop ? (uint32_t)seed[0] : 0u;
  uint32_t rk[2];  // the dropout keys of the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) rk[r] = row_key(s0, bh, row0 + 8 * r + (lane >> 2));
  uint32_t qa[1][DH / 16][4];
  float mx[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}}, sum[1][2] = {{0.0f, 0.0f}}, o[1][DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    mm::cp_async_wait<TC_STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and tile t - 1 is consumed
    if (t + TC_STAGES - 1 < nt) load(t + TC_STAGES - 1);
    mm::cp_async_commit();
    if (!active) continue;
    if (t == 0) mm::warp_a_frags<DH, 1>(qa, qs, TC_LD, 16 * warp, lane);
    const int slot = t % TC_STAGES;
    float s[1][NT][4];
    mm::warp_scores<DH, 1>(s, qa, ks + slot * KT * TC_LD, TC_LD, lane);
    mm::scale_and_mask(s[0], c, t * KT, M, lane);
    mm::online_softmax_tile<1, DH>(s, mx, sum, o);  // the sum over the undropped p
    if (drop) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][n][e] = keep_bit(rk[e >> 1], t * KT + 8 * n + 2 * (lane & 3) + (e & 1), thresh)
                           ? s[0][n][e] * inv_keep
                           : 0.0f;
    }
    uint32_t pa[1][KT / 16][4];
    mm::p_frags(pa[0], s[0]);
    mm::warp_pv<DH, 1>(o, pa, vs + slot * KT * TC_LD, TC_LD, lane);
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r + (lane >> 2);
    const float l = mm::quad_sum(sum[0][r]);  // all lanes take part: before the row test
    if (row >= G) continue;
    bf16* orow = out + ((size_t)b * G + row) * D + h * DH + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          mm::pack_bf16x2(o[0][n][2 * r] / l, o[0][n][2 * r + 1] / l);
    if ((lane & 3) == 0) lse[(size_t)bh * G + row] = mx[0][r] * mm::LN2 + logf(l);
  }
}

int flash_fwd(const void* q, const void* k, const void* v, const void* seed, void* out,
              void* lse, int B, int G, int M, int H, float scale, float keep_p, uint32_t thresh,
              int drop, cudaStream_t st) {
  if (B < 1 || G < 1 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<<<dim3((G + TC_QT - 1) / TC_QT, B * H), TC_THREADS, TC_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seed, (bf16*)out,
      (float*)lse, G, M, H, scale, keep_p, thresh, drop);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, typename TO>
int flash_bwd(const T* q, const T* k, const T* v, const T* dout, const float* lse,
              const float* delta, const int* seed, T* dq, TO* dk, TO* dv, int B, int G, int M,
              int H, float scale, float keep_p, uint32_t thresh, int drop, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DQ_SMEM);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<T, TO><<<dim3((M + BT - 1) / BT, B * H), THREADS, DKDV_SMEM, st>>>(
      q, k, v, dout, lse, delta, seed, dk, dv, G, M, H, scale, keep_p, thresh, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T><<<dim3((G + BT - 1) / BT, B * H), THREADS, DQ_SMEM, st>>>(
      q, k, v, dout, lse, delta, seed, dq, G, M, H, scale, keep_p, thresh, drop);
  return cudaGetLastError();
}

// ------------------------------------------------------ K7: LN + proj

// Per-row LayerNorm statistics of x [R, Din]: stats[r] = (mean, rstd),
// fast variance max(0, E[x^2] - E[x]^2), eps 1e-5. One warp per row.
template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, int R, int Din,
                                float2* __restrict__ stats) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < Din; c += 32) {
    const float xv = to_f32(x[(size_t)r * Din + c]);
    s += xv;
    ss += xv * xv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mu = s / Din, var = fmaxf(0.f, ss / Din - mu * mu);
  if (lane == 0) stats[r] = make_float2(mu, rsqrtf(var + vpt::LN_EPS));
}

// xhat = (x - mean) * rstd and the normalised token xhat * w + b (f32).
template <typename T> struct LnRow {
  const T* x;
  const float2* stats;
  const float* w;
  const float* bias;
  int din;
  __device__ float xhat(int r, int c) const {
    const float2 st = stats[r];
    return (to_f32(x[(size_t)r * din + c]) - st.x) * st.y;
  }
  __device__ float xn(int r, int c) const { return xhat(r, c) * w[c] + bias[c]; }
};

// A(m, k) = the normalised token rounded to the compute dtype.
template <typename T> struct LnRounded {
  LnRow<T> ln;
  __device__ float operator()(int m, int k) const { return round_to<T>(ln.xn(m, k)); }
};
// A(m = channel, k = token) = the f32 normalised token (weight gradients).
template <typename T> struct LnTransposed {
  LnRow<T> ln;
  __device__ float operator()(int m, int k) const { return ln.xn(k, m); }
};
// B(k, n) = [wk | wv][k][n]: the two [Din, D] weights side by side.
template <typename T> struct WkWv {
  const T* wk;
  const T* wv;
  int D;
  __device__ float operator()(int k, int n) const {
    return to_f32(n < D ? wk[(size_t)k * D + n] : wv[(size_t)k * D + n - D]);
  }
};
// Emit k (n < D) or v (n >= D) rounded to T.
template <typename T> struct StoreKV {
  T* kout;
  T* vout;
  int D;
  __device__ void operator()(int m, int n, int, float acc) const {
    if (n < D) kout[(size_t)m * D + n] = from_f32<T>(acc);
    else vout[(size_t)m * D + n - D] = from_f32<T>(acc);
  }
};
// A(m, k) = [dk | dv][m][k] (f32); B(k, n) = [wk | wv]^T: W[n][k].
struct DkDv {
  const float* dk;
  const float* dv;
  int D;
  __device__ float operator()(int m, int k) const {
    return k < D ? dk[(size_t)m * D + k] : dv[(size_t)m * D + k - D];
  }
};
struct DkDvB {
  const float* dk;
  const float* dv;
  int D;
  __device__ float operator()(int k, int n) const {
    return n < D ? dk[(size_t)k * D + n] : dv[(size_t)k * D + n - D];
  }
};
template <typename T> struct WkWvT {
  const T* wk;
  const T* wv;
  int D;
  __device__ float operator()(int k, int n) const {
    return to_f32(k < D ? wk[(size_t)n * D + k] : wv[(size_t)n * D + k - D]);
  }
};
// (dxn * xhat, dxn) for the LN scale and bias gradients.
template <typename T> struct LnGradCols {
  LnRow<T> ln;
  const float* dxn;
  __device__ float2 operator()(int r, int c) const {
    const float g = dxn[(size_t)r * ln.din + c];
    return make_float2(g * ln.xhat(r, c), g);
  }
};

// LayerNorm backward per row (one warp):
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dxn * w.
template <typename T>
__global__ void ln_bwd_kernel(LnRow<T> ln, const float* __restrict__ dxn, int R,
                              T* __restrict__ dx) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const int din = ln.din;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < din; c += 32) {
    const float dxh = dxn[(size_t)r * din + c] * ln.w[c];
    s1 += dxh;
    s2 += dxh * ln.xhat(r, c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float m1 = s1 / din, m2 = s2 / din, rstd = ln.stats[r].y;
  for (int c = lane; c < din; c += 32) {
    const float dxh = dxn[(size_t)r * din + c] * ln.w[c];
    dx[(size_t)r * din + c] = from_f32<T>(rstd * ((dxh - m1) - ln.xhat(r, c) * m2));
  }
}

template <typename T>
int kv_project(LnRow<T> ln, const T* wk, const T* wv, T* kbuf, T* vbuf, int rows, int din,
               int D, cudaStream_t st) {
  ln_stats_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(ln.x, rows, din,
                                                    const_cast<float2*>(ln.stats));
  gemm<true, true>(rows, 2 * D, din, 1, LnRounded<T>{ln}, WkWv<T>{wk, wv, D},
                   StoreKV<T>{kbuf, vbuf, D}, st);
  return cudaGetLastError();
}

template <typename T>
int attn_train_kv_fwd(const void* q, const void* x, const void* ln_w, const void* ln_b,
                      const void* wk, const void* wv, const void* seed, void* out, void* lse,
                      void* kbuf, void* vbuf, void* rowstats, int B, int G, int M, int din, int H,
                      float scale, float keep_p, unsigned thresh, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * DH;
  LnRow<T> ln{static_cast<const T*>(x), static_cast<const float2*>(rowstats),
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), din};
  int e = kv_project<T>(ln, static_cast<const T*>(wk), static_cast<const T*>(wv),
                        static_cast<T*>(kbuf), static_cast<T*>(vbuf), B * M, din, D, st);
  if (e != cudaSuccess) return e;
  return flash_fwd<T>(static_cast<const T*>(q), static_cast<const T*>(kbuf),
                      static_cast<const T*>(vbuf), static_cast<const int*>(seed),
                      static_cast<T*>(out), static_cast<float*>(lse), B, G, M, H, scale, keep_p,
                      thresh, drop, st);
}

template <typename T>
int attn_train_kv_bwd(const void* q, const void* x, const void* ln_w, const void* ln_b,
                      const void* wk, const void* wv, const void* seed, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dx, void* dw,
                      void* dlnw, void* dlnb, void* kbuf, void* vbuf, void* rowstats, void* dk32, void* dv32,
                      void* dxn, void* part, void* wpart, int B, int G, int M, int din, int H,
                      int splits, int nblk, float scale, float keep_p, unsigned thresh, int drop,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * DH, rows = B * M;
  const T* wk_ = static_cast<const T*>(wk);
  const T* wv_ = static_cast<const T*>(wv);
  LnRow<T> ln{static_cast<const T*>(x), static_cast<const float2*>(rowstats),
              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), din};
  int e = kv_project<T>(ln, wk_, wv_, static_cast<T*>(kbuf), static_cast<T*>(vbuf), rows, din, D,
                        st);
  if (e != cudaSuccess) return e;
  float* dk_ = static_cast<float*>(dk32);
  float* dv_ = static_cast<float*>(dv32);
  e = flash_bwd<T, float>(static_cast<const T*>(q), static_cast<const T*>(kbuf),
                          static_cast<const T*>(vbuf), static_cast<const T*>(dout),
                          static_cast<const float*>(lse), static_cast<const float*>(delta),
                          static_cast<const int*>(seed), static_cast<T*>(dq), dk_, dv_, B, G, M, H,
                          scale, keep_p, thresh, drop, st);
  if (e != cudaSuccess) return e;
  // dxn = dk Wk^T + dv Wv^T  [rows, Din] f32
  float* dxn_ = static_cast<float*>(dxn);
  gemm<true, false>(rows, din, 2 * D, 1, DkDv{dk_, dv_, D}, WkWvT<T>{wk_, wv_, D},
                    StoreF32{dxn_, din}, st);
  ln_bwd_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(ln, dxn_, rows, static_cast<T*>(dx));
  // dLN scale / bias: column sums of (dxn * xhat, dxn)
  float* part_ = static_cast<float*>(part);
  colsum2(rows, din, nblk, LnGradCols<T>{ln, dxn_}, part_, st);
  sum_parts(nblk, din, part_, static_cast<float*>(dlnw), static_cast<float*>(dlnb), st);
  // [dWk | dWv] = xn^T [dk | dv]  ([Din, 2D], f32), split over tokens
  float* wpart_ = static_cast<float*>(wpart);
  gemm<false, true>(din, 2 * D, rows, splits, LnTransposed<T>{ln}, DkDvB{dk_, dv_, D},
                    StoreSplit{wpart_, din, 2 * D}, st);
  sum_splits(splits, din * 2 * D, wpart_, static_cast<float*>(dw), st);
  return cudaGetLastError();
}

}  // namespace vpt_flash

using namespace vpt_flash;

#define SEED_ARGS float scale, float keep_p, unsigned thresh, int drop, void* stream

extern "C" int attn_train_fwd_f32(const void* q, const void* k, const void* v, const void* seed,
                                  void* out, void* lse, int b, int g, int m, int h, SEED_ARGS) {
  return flash_fwd<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const int*>(seed),
                          static_cast<float*>(out), static_cast<float*>(lse), b, g, m, h, scale,
                          keep_p, thresh, drop, static_cast<cudaStream_t>(stream));
}
// bf16 on the tensor cores (pointers 16-byte aligned)
extern "C" int attn_train_fwd_tc_bf16(const void* q, const void* k, const void* v,
                                      const void* seed, void* out, void* lse, int b, int g, int m,
                                      int h, SEED_ARGS) {
  return tc::flash_fwd(q, k, v, seed, out, lse, b, g, m, h, scale, keep_p, thresh, drop,
                       static_cast<cudaStream_t>(stream));
}

template <typename T>
static int attn_train_bwd_t(const void* q, const void* k, const void* v, const void* seed,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, int b, int g, int m, int h, float scale,
                            float keep_p, unsigned thresh, int drop, void* stream) {
  return flash_bwd<T, T>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(dout),
                         static_cast<const float*>(lse), static_cast<const float*>(delta),
                         static_cast<const int*>(seed), static_cast<T*>(dq), static_cast<T*>(dk),
                         static_cast<T*>(dv), b, g, m, h, scale, keep_p, thresh, drop,
                         static_cast<cudaStream_t>(stream));
}
extern "C" int attn_train_bwd_f32(const void* q, const void* k, const void* v, const void* seed,
                                  const void* dout, const void* lse, const void* delta, void* dq,
                                  void* dk, void* dv, int b, int g, int m, int h, SEED_ARGS) {
  return attn_train_bwd_t<float>(q, k, v, seed, dout, lse, delta, dq, dk, dv, b, g, m, h, scale,
                                 keep_p, thresh, drop, stream);
}
extern "C" int attn_train_bwd_bf16(const void* q, const void* k, const void* v, const void* seed,
                                   const void* dout, const void* lse, const void* delta, void* dq,
                                   void* dk, void* dv, int b, int g, int m, int h, SEED_ARGS) {
  return attn_train_bwd_t<__nv_bfloat16>(q, k, v, seed, dout, lse, delta, dq, dk, dv, b, g, m, h,
                                         scale, keep_p, thresh, drop, stream);
}

#define KV_FWD_ARGS                                                                         \
  const void *q, const void *x, const void *ln_w, const void *ln_b, const void *wk,         \
      const void *wv, const void *seed, void *out, void *lse, void *kbuf, void *vbuf,       \
      void *rowstats, int b, int g, int m, int din, int h, SEED_ARGS
#define KV_FWD_PASS                                                                          \
  q, x, ln_w, ln_b, wk, wv, seed, out, lse, kbuf, vbuf, rowstats, b, g, m, din, h, scale,   \
      keep_p, thresh, drop, stream

extern "C" int attn_train_kv_fwd_f32(KV_FWD_ARGS) { return attn_train_kv_fwd<float>(KV_FWD_PASS); }
extern "C" int attn_train_kv_fwd_bf16(KV_FWD_ARGS) {
  return attn_train_kv_fwd<__nv_bfloat16>(KV_FWD_PASS);
}

#define KV_BWD_ARGS                                                                         \
  const void *q, const void *x, const void *ln_w, const void *ln_b, const void *wk,         \
      const void *wv, const void *seed, const void *dout, const void *lse,                  \
      const void *delta, void *dq, void *dx, void *dw, void *dlnw, void *dlnb, void *kbuf, void *vbuf,   \
      void *rowstats, void *dk32, void *dv32, void *dxn, void *part, void *wpart, int b,    \
      int g, int m, int din, int h, int splits, int nblk, SEED_ARGS
#define KV_BWD_PASS                                                                          \
  q, x, ln_w, ln_b, wk, wv, seed, dout, lse, delta, dq, dx, dw, dlnw, dlnb, kbuf, vbuf, rowstats,  \
      dk32, dv32, dxn, part, wpart, b, g, m, din, h, splits, nblk, scale, keep_p, thresh,   \
      drop, stream

extern "C" int attn_train_kv_bwd_f32(KV_BWD_ARGS) { return attn_train_kv_bwd<float>(KV_BWD_PASS); }
extern "C" int attn_train_kv_bwd_bf16(KV_BWD_ARGS) {
  return attn_train_kv_bwd<__nv_bfloat16>(KV_BWD_PASS);
}

extern "C" int dropout_mask_u8(const void* seed, int bh, int g, int m, unsigned thresh, void* out,
                               void* stream) {
  const size_t n = (size_t)bh * g * m;
  dropout_mask_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), bh, g, m, thresh, static_cast<unsigned char*>(out));
  return cudaGetLastError();
}
