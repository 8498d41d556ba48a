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
// with mix the 32-bit integer hash of kv_tile.cuh. The backward regenerates the
// same bits; no mask is stored. The plain PyTorch twin computes the same
// bits with int64 tensor ops (ops/cuda/flash_train.py), so the kernel and
// the twin agree mask for mask.
//
// Bound on the H100: operations. Per (cloud, head) the attention does
// 2 x G x M x dh MACs forward and 5 x G x M x dh backward (two recomputes
// of the scores, dV, dPd, dK in one kernel and scores, dPd, dQ in the
// other); K7 adds the k/v projection of every kv token (M x Din x 2D MACs,
// twice: forward and the backward's recompute) and its backward products.
// The f32 kernels run on CUDA cores in f32 (67 TFLOP/s peak), so the
// bound that matters there is that rate, not the 989 TFLOP/s of the
// tensor cores. K8's bf16 forward
// (tc::flash_fwd_tc_kernel), K7's bf16 forward (tc::ln_xn_kernel, then
// kv_tile.cuh's attn_kv_ln_tile_kernel with K7's dropout and
// log-sum-exp: each 64-token tile of xn projected onto the head's k|v on
// chip and attended there, K4's kernel body; 132.9 GFLOP at ft_cls's q
// [330, 128, 256] x [330, 1,024, 256], H = 4, 0.134 ms at 989 TFLOP/s,
// against 0.065 ms for its 217 MB of x, q, out and lse), the bf16 backward
// of K8 and of K7's attention
// (tc::flash_bwd_kv_tc_kernel, tc::flash_bwd_dq_tc_kernel) and K7's bf16
// projections (tc::kv_proj_tc_kernel, tc::dxn_tc_kernel,
// tc::dw_tc_kernel) run their products on the tensor cores; at the pretrain point branch's [96, 128,
// 256], H = 4, the forward's are 1.6 GFLOP (0.002 ms at 989 TFLOP/s)
// against 25.4 MB of q, k, v, out and lse (0.0076 ms at 3.35 TB/s), the
// backward's 4.0 GFLOP (5 products in one launch, 0.004 ms) against 44 MB of q, k, v, dO,
// dq, dk and dv (0.0133 ms), and the dropout hash and the exp of each score
// run beside them on the CUDA cores. The dtype picks the kernels
// (ops/cuda/__init__.py `tc_route`): f32 stays on the CUDA-core kernels,
// since a tensor-core f32 product is TF32.
//
// Design: one block per (cloud*head, 64 query rows) in the forward and in
// the dQ pass, one block per (cloud*head, 64 kv rows) in the dK/dV pass,
// so nothing is carried between blocks: the TPU kernel accumulated dQ
// across its sequential kv grid axis, here the dQ pass walks the kv tiles
// itself (at the cost of recomputing the scores once more) and the result
// is deterministic without atomics. The CUDA-core kernels hold tiles of
// 64 x 64 in shared memory as f32 with rows padded to 68 floats; 256
// threads, each owning a 4 x 4 register tile, so a row's max and sum
// reduce over 16 lanes by shuffles. The tensor-core kernels (namespace tc)
// keep the same grids with 4 warps of 16 rows a block.
// In f32, K7's projections, LN backward and weight gradients run through
// the SIMT product of train_common.cuh; its weight gradients are split
// over the token axis into partials summed in a fixed order. In bf16 its
// products run on the tensor cores (namespace tc, the end of this file).
#include "kv_tile.cuh"
#include "mma.cuh"
#include "train_common.cuh"

namespace vpt_flash {

using namespace vpt;
using vpt_kvln::keep_bit;  // the dropout hash (kv_tile.cuh), shared with K7's tile kernel
using vpt_kvln::mix32;
using vpt_kvln::row_key;

constexpr int DH = 64;       // head width of these kernels
constexpr int BT = 64;       // rows per tile (queries or kv tokens)
constexpr int LD = BT + 4;   // padded shared-memory row stride (floats)
constexpr int THREADS = 256;
constexpr int TILE = DH * LD;  // floats per [64][68] tile

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

// ----------------------------------------- K8 backward, bf16, on the tensor cores
// The CUDA-core backward's math (header :11-16) with every product on
// mma.sync, bf16 in and f32 out, the operands bf16 in
// shared memory (rows padded to TC_LD) and the accumulators f32 in
// registers. p = 2^(s * scale * log2 e - lse * log2 e) from the forward's
// natural-unit f32 lse, Pd = p * keep / (1 - rate) from the same hash
// (row_key of the query row, keep_bit of the key column), dS = (Pd * dPd -
// p * delta) * scale; Pd and dS are rounded to bf16 in registers as the A
// fragments of the next products, as the forward rounds p for P.V.
//
// Kv-row side (flash_bwd_kv_tc_kernel): a warp owns 16 kv rows and
// computes the transposed tiles S^T = K.Q^T and dPd^T = V.dO^T against each
// 64-row query tile (its k and v rows as A fragments, the q and dO tiles as
// B), so that Pd^T and dS^T land in the accumulator layout that is the A
// fragment of dV += Pd^T.dO and dK += dS^T.Q (dO and q read through
// ldmatrix.trans). The q and dO tiles, with their rows' lse * log2 e (+inf
// past G, so p = 0 there), delta and dropout key, stream through a
// TC_STAGES-deep cp.async ring, one barrier a tile. At M <= 128 (every
// 128-latent self-attention) one block of 8 warps holds all the kv rows of
// its cloud and head and also forms dQ = dS.K from dS^T in shared memory:
// one launch, and S, dPd and the dropout hash computed once. At M > 128 a
// block of 4 warps takes 64 kv rows, and a second pass
// (flash_bwd_dq_tc_kernel) gives dQ: one block per (64 query rows, cloud *
// head), a warp's 16 query rows with q and dO as A fragments in registers,
// the k and v tiles streaming through the same ring: S, dPd, then dQ +=
// dS.K (k through ldmatrix.trans); keys past M get p = 0. No block carries
// anything to another, and every sum runs in a fixed order: no atomics,
// the same bits on every launch. dk / dv are written in bf16, for K8 and
// for K7's backward, whose tensor-core projections take them on.

// Shared memory of the kv-row kernel: its k and v rows (and, fused, dS^T
// of a query tile), a ring of q and dO tiles, and each query row's lse *
// log2 e, delta (f32) and dropout key (u32).
template <int WARPS, bool FUSED>
constexpr size_t bwd_kv_smem() {
  return sizeof(bf16) * (size_t)((FUSED ? 3 : 2) * 16 * WARPS + 2 * TC_STAGES * TC_QT) * TC_LD +
         sizeof(float) * 3 * TC_STAGES * TC_QT;
}
constexpr int TC_SMALL_WARPS = 8;                  // the fused kernel: all of M <= 128 a block
constexpr int TC_SMALL_M = 16 * TC_SMALL_WARPS;
constexpr size_t TC_BWD_KV_SMEM = bwd_kv_smem<TC_WARPS, false>();
constexpr size_t TC_BWD_SMALL_SMEM = bwd_kv_smem<TC_SMALL_WARPS, true>();
constexpr size_t TC_BWD_Q_SMEM = sizeof(bf16) * (size_t)(2 * TC_QT + 2 * TC_STAGES * KT) * TC_LD;

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = vpt::mma::pack_bf16x2(a, b);
}

// The kv-row side: one block of WARPS warps per (16 WARPS kv rows, cloud
// * head), 16 kv rows a warp. Unfused (WARPS = 4) it gives dK and dV, and
// the dQ pass below gives dQ. FUSED (WARPS = 8, M <= 128: the block holds
// every kv row of its cloud and head) it also gives dQ: after each query
// tile the warps put dS^T in shared memory (kv rows past M as 0), and dQ
// of the tile = dS.K on mma.sync (warp_atb: dS^T and k both down the kv
// rows), a warp's 16 query rows by 32 columns, written out whole; no
// second launch, no recompute of S and dPd.
template <int WARPS, bool FUSED>
__global__ void __launch_bounds__(32 * WARPS, 2)
flash_bwd_kv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ seed, bf16* __restrict__ dq, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int G, int M, int H, float scale, float keep_p,
                       uint32_t thresh, int drop) {
  namespace mm = vpt::mma;
  constexpr int ROWS = 16 * WARPS, THREADS = 32 * WARPS;
  // fused, a query tile goes in four parts of 16 rows: a quarter of the
  // score registers, so that two blocks of 8 warps fit an SM's registers
  // (128 a thread) without spilling
  constexpr int PARTS = FUSED ? 4 : 1, N8 = NT / PARTS, QP = TC_QT / PARTS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][TC_LD]
  bf16* vs = ks + ROWS * TC_LD;                  // [ROWS][TC_LD]
  bf16* qs = vs + ROWS * TC_LD;                  // [TC_STAGES][TC_QT][TC_LD]
  bf16* dos = qs + TC_STAGES * TC_QT * TC_LD;    // [TC_STAGES][TC_QT][TC_LD]
  bf16* dst = dos + TC_STAGES * TC_QT * TC_LD;   // FUSED: [ROWS][TC_LD], dS^T of a tile
  // [TC_STAGES][2][TC_QT]: the query rows' lse * log2 e and delta; then
  // [TC_STAGES][TC_QT]: their dropout keys
  float* rowv = reinterpret_cast<float*>(dos + (TC_STAGES * TC_QT + (FUSED ? ROWS : 0)) * TC_LD);
  uint32_t* rowk = reinterpret_cast<uint32_t*>(rowv + TC_STAGES * 2 * TC_QT);
  const int bh = blockIdx.y, b = bh / H, h = bh % H, m0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = H * DH, nt = (G + TC_QT - 1) / TC_QT;
  const bf16* qb = q + (size_t)b * G * D + h * DH;
  const bf16* dob = dout + (size_t)b * G * D + h * DH;
  const uint32_t bkey = mix32(bh + mix32(drop ? (uint32_t)seed[0] : 0u));  // row_key's inner part
  auto load = [&](int t) {
    const int slot = t % TC_STAGES;
    mm::cp_rows<DH, TC_QT, THREADS>(qs + slot * TC_QT * TC_LD, TC_LD, qb, D, t * TC_QT, G, tid);
    mm::cp_rows<DH, TC_QT, THREADS>(dos + slot * TC_QT * TC_LD, TC_LD, dob, D, t * TC_QT, G, tid);
    if (tid < TC_QT) {  // plain stores: read after the barrier of a later tile
      float* rv = rowv + slot * 2 * TC_QT;
      const int g = t * TC_QT + tid;
      rv[tid] = g < G ? lse[(size_t)bh * G + g] * mm::LOG2E : CUDART_INF_F;
      rv[TC_QT + tid] = g < G ? delta[(size_t)bh * G + g] : 0.0f;
      rowk[slot * TC_QT + tid] = mix32((uint32_t)g + bkey);  // row_key(seed, bh, g)
    }
  };
  // group 0: the block's k and v rows and the first query tile; then one a tile
  mm::cp_rows<DH, ROWS, THREADS>(ks, TC_LD, k + (size_t)b * M * D + h * DH, D, m0, M, tid);
  mm::cp_rows<DH, ROWS, THREADS>(vs, TC_LD, v + (size_t)b * M * D + h * DH, D, m0, M, tid);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nt) load(st);
    mm::cp_async_commit();
  }

  const int row0 = 16 * warp;  // the warp's kv rows in the block's tile
  const bool active = m0 + row0 < M;
  const float c = scale * mm::LOG2E, inv_keep = 1.0f / keep_p;
  uint32_t mrow[2];  // the kv index of the thread's two accumulator rows
#pragma unroll
  for (int r = 0; r < 2; ++r) mrow[r] = m0 + row0 + 8 * r + (lane >> 2);
  float dka[1][DH / 8][4], dva[1][DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[0][n][e] = dva[0][n][e] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    mm::cp_async_wait<TC_STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and tile t - 1 is consumed
    if (t + TC_STAGES - 1 < nt) load(t + TC_STAGES - 1);
    mm::cp_async_commit();
    const int slot = t % TC_STAGES;
    const bf16* qt = qs + slot * TC_QT * TC_LD;
    const bf16* dot = dos + slot * TC_QT * TC_LD;
    if (active) {
      const float* rv = rowv + slot * 2 * TC_QT;
      const uint32_t* rk = rowk + slot * TC_QT;
#pragma unroll 1
      for (int hf = 0; hf < PARTS; ++hf) {  // the tile's query rows in PARTS parts
        const bf16* qh = qt + hf * QP * TC_LD;
        const bf16* doh = dot + hf * QP * TC_LD;
        uint32_t fa[1][DH / 16][4];
        float st[1][N8][4], dpt[1][N8][4];  // [kv row][query column]
        mm::warp_a_frags<DH, 1>(fa, ks, TC_LD, row0, lane);
        mm::warp_scores<DH, 1, N8>(st, fa, qh, TC_LD, lane);  // S^T = K.Q^T
        mm::warp_a_frags<DH, 1>(fa, vs, TC_LD, row0, lane);
        mm::warp_scores<DH, 1, N8>(dpt, fa, doh, TC_LD, lane);  // dPd^T = V.dO^T
#pragma unroll
        for (int n = 0; n < N8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = hf * QP + 8 * n + 2 * (lane & 3) + (e & 1);  // the query in the tile
            const float p = mm::exp2_approx(st[0][n][e] * c - rv[col]);
            float pd = p;
            if (drop) pd = keep_bit(rk[col], mrow[e >> 1], thresh) ? p * inv_keep : 0.0f;
            st[0][n][e] = pd;
            dpt[0][n][e] = (pd * dpt[0][n][e] - p * rv[TC_QT + col]) * scale;  // dS^T
          }
        uint32_t pa[1][N8 / 2][4];
        mm::p_frags(pa[0], st[0]);
        mm::warp_pv<DH, 1>(dva, pa, doh, TC_LD, lane);  // dV += Pd^T.dO
        mm::p_frags(pa[0], dpt[0]);
        mm::warp_pv<DH, 1>(dka, pa, qh, TC_LD, lane);  // dK += dS^T.Q
        if (FUSED) {  // dS^T, rounded as dK's product took it, rows past M as 0
#pragma unroll
          for (int n = 0; n < N8; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(dst + (row0 + 8 * r + (lane >> 2)) * TC_LD + hf * QP +
                                           8 * n + 2 * (lane & 3)) =
                  (int)mrow[r] < M ? mm::pack_bf16x2(dpt[0][n][2 * r], dpt[0][n][2 * r + 1])
                                   : 0u;
        }
      }
    }
    if (FUSED) {
      __syncthreads();  // dS^T of the tile is complete
      // dQ rows 16 (warp % 4).. of the tile, columns 32 (warp / 4)..: dS.K
      // over the kv rows (M rounded up to 16: the rows past M are 0 in both)
      const int qr = 16 * (warp % 4), c0 = 32 * (warp / 4);
      float dqa[1][4][4], unused[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) dqa[0][n][0] = dqa[0][n][1] = dqa[0][n][2] = dqa[0][n][3] = 0.0f;
      mm::warp_atb<1, 4, false>(dqa, unused, dst + qr, TC_LD, ks + c0, TC_LD, (M + 15) & ~15,
                                lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int g = t * TC_QT + qr + 8 * r + (lane >> 2);
        if (g >= G) continue;
        bf16* row = dq + ((size_t)b * G + g) * D + h * DH + c0 + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < 4; ++n) store2(row + 8 * n, dqa[0][n][2 * r], dqa[0][n][2 * r + 1]);
      }
    }
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if ((int)mrow[r] >= M) continue;
    const size_t off = ((size_t)b * M + mrow[r]) * D + h * DH + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      store2(dk + off + 8 * n, dka[0][n][2 * r], dka[0][n][2 * r + 1]);
      store2(dv + off + 8 * n, dva[0][n][2 * r], dva[0][n][2 * r + 1]);
    }
  }
}

// The query-row side, for M > 128: one block per (64 query rows, cloud *
// head) walks the kv tiles.
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ seed, bf16* __restrict__ dq, int G, int M, int H,
                       float scale, float keep_p, uint32_t thresh, int drop) {
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_QT][TC_LD]
  bf16* dos = qs + TC_QT * TC_LD;                // [TC_QT][TC_LD]
  bf16* ks = dos + TC_QT * TC_LD;                // [TC_STAGES][KT][TC_LD]
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
  // group 0: the block's q and dO rows and the first kv tile; then one a tile
  mm::cp_rows<DH, TC_QT, TC_THREADS>(qs, TC_LD, q + (size_t)b * G * D + h * DH, D, q0, G, tid);
  mm::cp_rows<DH, TC_QT, TC_THREADS>(dos, TC_LD, dout + (size_t)b * G * D + h * DH, D, q0, G,
                                     tid);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nt) load(st);
    mm::cp_async_commit();
  }

  const int row0 = q0 + 16 * warp;  // the warp's first query row
  const bool active = row0 < G;
  const float c = scale * mm::LOG2E, inv_keep = 1.0f / keep_p;
  const uint32_t s0 = drop ? (uint32_t)seed[0] : 0u;
  float l2[2], dl[2];
  uint32_t rk[2];  // the thread's two rows: lse * log2 e, delta, dropout key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = row0 + 8 * r + (lane >> 2);
    l2[r] = g < G ? lse[(size_t)bh * G + g] * mm::LOG2E : 0.0f;
    dl[r] = g < G ? delta[(size_t)bh * G + g] : 0.0f;
    rk[r] = row_key(s0, bh, g);
  }
  uint32_t qa[1][DH / 16][4], doa[1][DH / 16][4];
  float dqa[1][DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) dqa[0][n][0] = dqa[0][n][1] = dqa[0][n][2] = dqa[0][n][3] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    mm::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (t + TC_STAGES - 1 < nt) load(t + TC_STAGES - 1);
    mm::cp_async_commit();
    if (!active) continue;
    if (t == 0) {
      mm::warp_a_frags<DH, 1>(qa, qs, TC_LD, 16 * warp, lane);
      mm::warp_a_frags<DH, 1>(doa, dos, TC_LD, 16 * warp, lane);
    }
    const int slot = t % TC_STAGES;
    const bf16* kt = ks + slot * KT * TC_LD;
    float s[1][NT][4], dp[1][NT][4];
    mm::warp_scores<DH, 1>(s, qa, kt, TC_LD, lane);                          // S = Q.K^T
    mm::warp_scores<DH, 1>(dp, doa, vs + slot * KT * TC_LD, TC_LD, lane);  // dPd = dO.V^T
    const bool ragged = t * KT + KT > M;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * KT + 8 * n + 2 * (lane & 3) + (e & 1);  // the key
        const int r = e >> 1;
        const float p = ragged && col >= M ? 0.0f : mm::exp2_approx(s[0][n][e] * c - l2[r]);
        float pd = p;
        if (drop) pd = keep_bit(rk[r], col, thresh) ? p * inv_keep : 0.0f;
        s[0][n][e] = (pd * dp[0][n][e] - p * dl[r]) * scale;  // dS
      }
    uint32_t pa[1][KT / 16][4];
    mm::p_frags(pa[0], s[0]);
    mm::warp_pv<DH, 1>(dqa, pa, kt, TC_LD, lane);  // dQ += dS.K
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = row0 + 8 * r + (lane >> 2);
    if (g >= G) continue;
    bf16* row = dq + ((size_t)b * G + g) * D + h * DH + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) store2(row + 8 * n, dqa[0][n][2 * r], dqa[0][n][2 * r + 1]);
  }
}

int flash_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seed, void* dq, void* dk, void* dv, int B, int G,
              int M, int H, float scale, float keep_p, uint32_t thresh, int drop,
              cudaStream_t st) {
  if (B < 1 || G < 1 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const bf16 *q_ = (const bf16*)q, *k_ = (const bf16*)k, *v_ = (const bf16*)v;
  const bf16* do_ = (const bf16*)dout;
  const float *lse_ = (const float*)lse, *delta_ = (const float*)delta;
  const int* seed_ = (const int*)seed;
  bf16 *dq_ = (bf16*)dq, *dk_ = (bf16*)dk, *dv_ = (bf16*)dv;
  cudaError_t e;
  if (M <= TC_SMALL_M) {  // one launch: every kv row of a cloud and head in one block
    auto kern = flash_bwd_kv_tc_kernel<TC_SMALL_WARPS, true>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TC_BWD_SMALL_SMEM);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(1, B * H), 32 * TC_SMALL_WARPS, TC_BWD_SMALL_SMEM, st>>>(
        q_, k_, v_, do_, lse_, delta_, seed_, dq_, dk_, dv_, G, M, H, scale, keep_p, thresh,
        drop);
    return (int)cudaGetLastError();
  }
  auto kern = flash_bwd_kv_tc_kernel<TC_WARPS, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TC_BWD_KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TC_BWD_Q_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((M + KT - 1) / KT, B * H), TC_THREADS, TC_BWD_KV_SMEM, st>>>(
      q_, k_, v_, do_, lse_, delta_, seed_, dq_, dk_, dv_, G, M, H, scale, keep_p, thresh, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tc_kernel<<<dim3((G + TC_QT - 1) / TC_QT, B * H), TC_THREADS, TC_BWD_Q_SMEM,
                           st>>>(q_, k_, v_, do_, lse_, delta_, seed_, dq_, G, M, H, scale,
                                 keep_p, thresh, drop);
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
                          static_cast<const int*>(seed), static_cast<T*>(dq), dk_, dv_, B, G, M,
                          H, scale, keep_p, thresh, drop, st);
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

// ------------------------------------------- K7, bf16, on the tensor cores
// The three projection-sized products of K7, which the JAX kernel runs at
// precision DEFAULT (flash_train.py:478-492 _proj, :623-650): one bf16
// pass with f32 accumulation, so bf16 operands on mma.sync with f32
// accumulators are the reference's own arithmetic.
//  (a) ln_xn_kernel: the kv LayerNorm, one warp a row: f32 statistics with
//      the fast variance (as ln_stats_kernel), then xn = (x - mu) * rstd *
//      w + b, each step rounded as the plain twin's, written in bf16 once;
//  (b) kv_proj_tc_kernel: [k | v] = xn . [wk | wv], rounded to bf16;
//  (c) dxn_tc_kernel: dxn = [dk | dv] . [wk | wv]^T in f32, from the bf16
//      dk and dv of the tensor-core attention backward; the weights are
//      read as they lie ([Din, D] rows, ldmatrix without .trans gives the
//      B fragments of the transpose);
//  (d) dw_tc_kernel: [dWk | dWv] = xn^T . [dk | dv] (both down the token
//      rows, warp_atb), the rows cut into splits whose f32 partials a
//      second pass sums in split order, as K11 (dense.cu).
// K7's forward runs (a), then kv_tile.cuh's tile kernel, which projects
// xn on chip in (b)'s k16 steps (the same bits) and attends (up to 128
// query rows; past them (a), (b) and K8's forward). Its backward runs (a)
// and (b) (the same kernels on the same inputs: the same bits, so the
// forward's log-sum-exp fits them), the attention backward, (c), the
// LayerNorm backward and its column sums on the CUDA cores (ln_bwd_kernel,
// colsum2), then (d).
// Bound on the H100: operations. At the pretrain point branch (96 x 2,048
// tokens, Din = 256, 2D = 512) each product is 51.5 GFLOP, 0.052 ms at
// 989 TFLOP/s, against 100 MB of x and of xn.
// Design of (b)-(d): K11's. A block of 8 warps owns a 128 x 128 tile of
// the output, a warp 64 x 32 of f32 accumulators in registers; the
// contraction streams through a 4-stage cp.async ring in shared memory (32
// columns a stage in (b) and (c), 32 token rows in (d)), rows padded by 8
// bf16 so that ldmatrix meets no bank conflict, one barrier a stage. Every
// product runs its k steps in a fixed order and no block sums into
// another's output: the same bits every run. Rows past B*M and columns
// past Din are zero-filled or masked; Din must be a multiple of 32 and D
// of 64 (the gate admits Din a multiple of 128, and D = 64 H).
namespace tc {

constexpr int PJ_BM = 128, PJ_BN = 128;  // a block's output tile
constexpr int PJ_WM = 64, PJ_WN = 32;    // a warp's
constexpr int PJ_MI = PJ_WM / 16, PJ_NI = PJ_WN / 8;
constexpr int PJ_WARPS_N = PJ_BN / PJ_WN;
constexpr int PJ_THREADS = 32 * (PJ_BM / PJ_WM) * PJ_WARPS_N;  // 256
constexpr int PJ_KC = 32;      // contraction columns a stage in (b) and (c)
constexpr int PJ_KR = 32;      // token rows a stage in (d)
constexpr int PJ_STAGES = 4;   // stages in flight
constexpr int PJ_LDK = PJ_KC + 8;  // padded row of a [rows][PJ_KC] tile (bf16)
constexpr int PJ_LDN = PJ_BN + 8;  // padded row of a [k][128] tile (bf16)
constexpr size_t PJ_KV_SMEM = sizeof(bf16) * PJ_STAGES * (PJ_BM * PJ_LDK + PJ_KC * PJ_LDN);
constexpr size_t PJ_DX_SMEM = sizeof(bf16) * PJ_STAGES * (PJ_BM + PJ_BN) * PJ_LDK;
constexpr size_t PJ_DW_SMEM = sizeof(bf16) * PJ_STAGES * PJ_KR * 2 * PJ_LDN;
constexpr int LN_ROWS = 8;  // rows (warps) a block of ln_xn_kernel
constexpr int KV_MAX_DIN = 1024;  // the widest Din K7's gate admits (flash_train_kv_enabled)

// (a) xn [R, Din] bf16 and stats[r] = (mean, rstd), 8 columns a lane at a
// time (Din a multiple of 8); the row is read twice (the second time from
// L1 / L2), as K17's forward does.
__global__ void __launch_bounds__(32 * LN_ROWS)
ln_xn_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, int R, int din, bf16* __restrict__ xn,
             float2* __restrict__ stats) {
  const int r = blockIdx.x * LN_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const bf16* xr = x + (size_t)r * din;
  float s = 0.f, ss = 0.f;
  for (int c = 8 * lane; c < din; c += 256) {
    float v[8];
    load_vec<bf16, 8>(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mu = s / din, rs = rsqrtf(fmaxf(0.f, ss / din - mu * mu) + vpt::LN_EPS);
  if (lane == 0) stats[r] = make_float2(mu, rs);
  bf16* out = xn + (size_t)r * din;
  for (int c = 8 * lane; c < din; c += 256) {
    float v[8];
    load_vec<bf16, 8>(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)  // ((x - mu) * rstd) * w + b, each step rounded
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mu, rs), w[c + i]), b[c + i]);
    store_vec<bf16, 8>(out + c, v);
  }
}

// Rows [r0, r0 + R) by columns [n0, n0 + W) of [a | b], two row-major [.,
// D] arrays side by side as one [., 2D] -> shared rows of `ld` elements,
// 16-byte cp.async chunks (D a multiple of 8, so no chunk straddles a and
// b); rows at or past `rows` zero-filled, never read.
template <int W, int R>
__device__ __forceinline__ void cp_rows_pair(bf16* dst, int ld, const bf16* a, const bf16* b,
                                             int D, int n0, int r0, int rows, int tid) {
  constexpr int CPR = W / 8, N = R * CPR;
  static_assert(N % PJ_THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < N / PJ_THREADS; ++i) {
    const int c = tid + i * PJ_THREADS;
    const int r = c / CPR, cc = c - r * CPR, n = n0 + cc * 8;
    const bool valid = r0 + r < rows;
    const bf16* src = n < D ? a + n : b + (n - D);
    vpt::mma::cp_async16(dst + r * ld + cc * 8, src + (valid ? (size_t)(r0 + r) * D : 0), valid);
  }
}

__device__ __forceinline__ void zero_acc(float (&c)[PJ_MI][PJ_NI][4]) {
#pragma unroll
  for (int i = 0; i < PJ_MI; ++i)
#pragma unroll
    for (int j = 0; j < PJ_NI; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
}

// (b) one block per (128 columns of [k | v], 128 token rows); xn's columns
// and wk|wv's rows stream in 32-column stages.
__global__ void __launch_bounds__(PJ_THREADS, 2)
kv_proj_tc_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, bf16* __restrict__ k, bf16* __restrict__ v,
                  int rows, int din, int D) {
  namespace mm = vpt::mma;
  constexpr int SLOT = PJ_BM * PJ_LDK + PJ_KC * PJ_LDN;  // [BM][LDK] of xn, [KC][LDN] of w
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * PJ_BN, m0 = blockIdx.y * PJ_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nc = din / PJ_KC;
  auto load = [&](int c) {
    bf16* xs = ring + (c % PJ_STAGES) * SLOT;
    mm::cp_rows<PJ_KC, PJ_BM, PJ_THREADS>(xs, PJ_LDK, xn + (size_t)c * PJ_KC, din, m0, rows,
                                          tid);
    cp_rows_pair<PJ_BN, PJ_KC>(xs + PJ_BM * PJ_LDK, PJ_LDN, wk, wv, D, n0, c * PJ_KC, din, tid);
  };
#pragma unroll
  for (int st = 0; st < PJ_STAGES - 1; ++st) {
    if (st < nc) load(st);
    mm::cp_async_commit();
  }
  const int wm = warp / PJ_WARPS_N, wn = warp % PJ_WARPS_N;
  float acc[PJ_MI][PJ_NI][4];
  zero_acc(acc);
  for (int c = 0; c < nc; ++c) {
    mm::cp_async_wait<PJ_STAGES - 2>();  // stage c has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and stage c - 1 is consumed
    if (c + PJ_STAGES - 1 < nc) load(c + PJ_STAGES - 1);
    mm::cp_async_commit();
    const bf16* xs = ring + (c % PJ_STAGES) * SLOT;
    mm::warp_ab<PJ_MI, PJ_NI>(acc, xs + wm * PJ_WM * PJ_LDK, PJ_LDK,
                              xs + PJ_BM * PJ_LDK + wn * PJ_WN, PJ_LDN, PJ_KC, lane);
  }
  mm::cp_async_wait<0>();
  const int grp = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PJ_MI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * PJ_WM + 16 * i + 8 * hh + grp;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < PJ_NI; ++j) {
        const int n = n0 + wn * PJ_WN + 8 * j + c0;
        bf16* dst = n < D ? k + (size_t)m * D + n : v + (size_t)m * D + (n - D);
        *reinterpret_cast<uint32_t*>(dst) =
            mm::pack_bf16x2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
}

// (c) one block per (128 columns of Din, 128 token rows); the 2D columns
// of [dk | dv] and of [wk | wv] stream in 32-column stages, dk / wk first.
__global__ void __launch_bounds__(PJ_THREADS, 2)
dxn_tc_kernel(const bf16* __restrict__ dk, const bf16* __restrict__ dv,
              const bf16* __restrict__ wk, const bf16* __restrict__ wv, float* __restrict__ dxn,
              int rows, int din, int D) {
  namespace mm = vpt::mma;
  constexpr int SLOT = (PJ_BM + PJ_BN) * PJ_LDK;  // [BM][LDK] of dk|dv, [BN][LDK] of w
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int c0 = blockIdx.x * PJ_BN, m0 = blockIdx.y * PJ_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nc = 2 * D / PJ_KC;
  auto load = [&](int c) {
    bf16* as = ring + (c % PJ_STAGES) * SLOT;
    const bool second = c * PJ_KC >= D;  // dv / wv
    const int j0 = c * PJ_KC - (second ? D : 0);
    mm::cp_rows<PJ_KC, PJ_BM, PJ_THREADS>(as, PJ_LDK, (second ? dv : dk) + j0, D, m0, rows, tid);
    mm::cp_rows<PJ_KC, PJ_BN, PJ_THREADS>(as + PJ_BM * PJ_LDK, PJ_LDK, (second ? wv : wk) + j0,
                                          D, c0, din, tid);
  };
#pragma unroll
  for (int st = 0; st < PJ_STAGES - 1; ++st) {
    if (st < nc) load(st);
    mm::cp_async_commit();
  }
  const int wm = warp / PJ_WARPS_N, wn = warp % PJ_WARPS_N;
  float acc[PJ_MI][PJ_NI][4];
  zero_acc(acc);
  for (int c = 0; c < nc; ++c) {
    mm::cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (c + PJ_STAGES - 1 < nc) load(c + PJ_STAGES - 1);
    mm::cp_async_commit();
    const bf16* as = ring + (c % PJ_STAGES) * SLOT;
    mm::warp_abt<PJ_MI, PJ_NI>(acc, as + wm * PJ_WM * PJ_LDK, PJ_LDK,
                               as + (PJ_BM + wn * PJ_WN) * PJ_LDK, PJ_LDK, PJ_KC, lane);
  }
  mm::cp_async_wait<0>();
  const int grp = lane >> 2, cl = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PJ_MI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * PJ_WM + 16 * i + 8 * hh + grp;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < PJ_NI; ++j) {
        const int c = c0 + wn * PJ_WN + 8 * j + cl;
        if (c < din)  // din even: the pair is in the row
          *reinterpret_cast<float2*>(dxn + (size_t)m * din + c) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
}

// (d) one block per (128 x 128 tile of [dWk | dWv] ([Din, 2D]), split of
// the token rows); 32-row stages of xn's and [dk | dv]'s tile columns.
__global__ void __launch_bounds__(PJ_THREADS, 2)
dw_tc_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ dk,
             const bf16* __restrict__ dv, int rows, int din, int D, int splits,
             float* __restrict__ wpart) {
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][KR][LDN]
  bf16* ys = xs + PJ_STAGES * PJ_KR * PJ_LDN;     // [STAGES][KR][LDN]
  const int tiles_n = 2 * D / PJ_BN;
  const int c0 = (blockIdx.x / tiles_n) * PJ_BM, n0 = (blockIdx.x % tiles_n) * PJ_BN;
  const int split = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int2 range = vpt::split_range(rows, PJ_KR, split, splits);
  const int t_begin = range.x / PJ_KR, t_end = (range.y + PJ_KR - 1) / PJ_KR, r_end = range.y;
  auto load = [&](int t) {
    const int slot = (t - t_begin) % PJ_STAGES;
    mm::cp_rows<PJ_BM, PJ_KR, PJ_THREADS>(xs + slot * PJ_KR * PJ_LDN, PJ_LDN, xn + c0, din,
                                          t * PJ_KR, r_end, tid, din - c0);
    cp_rows_pair<PJ_BN, PJ_KR>(ys + slot * PJ_KR * PJ_LDN, PJ_LDN, dk, dv, D, n0, t * PJ_KR,
                               r_end, tid);
  };
#pragma unroll
  for (int st = 0; st < PJ_STAGES - 1; ++st) {
    if (t_begin + st < t_end) load(t_begin + st);
    mm::cp_async_commit();
  }
  const int wm = warp / PJ_WARPS_N, wn = warp % PJ_WARPS_N;
  float acc[PJ_MI][PJ_NI][4], unused[PJ_NI][4];
  zero_acc(acc);
  for (int t = t_begin; t < t_end; ++t) {
    mm::cp_async_wait<PJ_STAGES - 2>();
    __syncthreads();
    if (t + PJ_STAGES - 1 < t_end) load(t + PJ_STAGES - 1);
    mm::cp_async_commit();
    const int slot = (t - t_begin) % PJ_STAGES;
    mm::warp_atb<PJ_MI, PJ_NI, false>(acc, unused, xs + slot * PJ_KR * PJ_LDN + wm * PJ_WM,
                                      PJ_LDN, ys + slot * PJ_KR * PJ_LDN + wn * PJ_WN, PJ_LDN,
                                      PJ_KR, lane);
  }
  mm::cp_async_wait<0>();
  float* wp = wpart + (size_t)split * din * 2 * D;
  const int grp = lane >> 2, cl = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < PJ_MI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = c0 + wm * PJ_WM + 16 * i + 8 * hh + grp;
      if (m >= din) continue;
#pragma unroll
      for (int j = 0; j < PJ_NI; ++j)
        *reinterpret_cast<float2*>(wp + (size_t)m * 2 * D + n0 + wn * PJ_WN + 8 * j + cl) =
            make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    }
}

// (a) then (b): stats, xn and k, v of rows tokens.
int kv_project(const void* x, const void* ln_w, const void* ln_b, const void* wk, const void* wv,
               void* k, void* v, void* xn, void* stats, int rows, int din, int D,
               cudaStream_t st) {
  if (rows < 1 || din < PJ_KC || din % PJ_KC || D < DH || D % DH)
    return (int)cudaErrorInvalidValue;
  ln_xn_kernel<<<(rows + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(
      (const bf16*)x, (const float*)ln_w, (const float*)ln_b, rows, din, (bf16*)xn,
      (float2*)stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kv_proj_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)PJ_KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  kv_proj_tc_kernel<<<dim3(2 * D / PJ_BN, (rows + PJ_BM - 1) / PJ_BM), PJ_THREADS, PJ_KV_SMEM,
                      st>>>((const bf16*)xn, (const bf16*)wk, (const bf16*)wv, (bf16*)k,
                            (bf16*)v, rows, din, D);
  return (int)cudaGetLastError();
}

// K7's bf16 forward. Up to 128 query rows (every driven path's G): (a)
// into xn and rowstats, then one pass of kv_tile.cuh's tile kernel (the
// stream kernel past Din = 384) in nsplit kv splits with K7's dropout and
// log-sum-exp (TRAIN), which projects each 64-token tile of xn onto this
// head's k|v on chip and attends over it; with nsplit > 1 the merge pass
// also writes lse. No k or v reaches device memory (kbuf and vbuf unused).
// Past 128 query rows (no driven training path has them): (a) and (b)
// into kbuf and vbuf, then K8's bf16 forward (flash_fwd_tc_kernel) over
// them. Din a multiple of 32 up to 1,024: the backward's kv_project takes
// Din in 32-column stages, and its k|v must be the tile kernel's.
int attn_train_kv_fwd(const void* q, const void* x, const void* ln_w, const void* ln_b,
                      const void* wk, const void* wv, const void* seed, void* out, void* lse,
                      void* kbuf, void* vbuf, void* rowstats, void* xn, void* part_acc,
                      void* part_ml, int B, int G, int M, int din, int H, int nsplit, float scale,
                      float keep_p, unsigned thresh, int drop, cudaStream_t st) {
  const int rows = B * M, nt = (M + KT - 1) / KT;
  if (B < 1 || G < 1 || M < 1 || H < 1 || din < PJ_KC || din % PJ_KC || din > KV_MAX_DIN)
    return (int)cudaErrorInvalidValue;
  if (G > vpt_kvln::QT) {
    const int e = kv_project(x, ln_w, ln_b, wk, wv, kbuf, vbuf, xn, rowstats, rows, din, H * DH,
                             st);
    if (e != cudaSuccess) return e;
    return flash_fwd(q, kbuf, vbuf, seed, out, lse, B, G, M, H, scale, keep_p, thresh, drop, st);
  }
  if (!vpt_kvln::kvln_split_ok(nt, nsplit)) return (int)cudaErrorInvalidValue;
  ln_xn_kernel<<<(rows + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(
      (const bf16*)x, (const float*)ln_w, (const float*)ln_b, rows, din, (bf16*)xn,
      (float2*)rowstats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const vpt_kvln::TrainArgs tr{(const int*)seed, (float*)lse, keep_p, thresh, drop};
  e = vpt_kvln::kvln_pass<true, true>(q, (const bf16*)xn, wk, wv, out, part_acc, part_ml, B, G, M,
                                      din, H, nsplit, scale, st, tr);
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  vpt_kvln::attn_combine_kernel<bf16, true><<<B * G, 256, 0, st>>>(
      (const float*)part_acc, (const float*)part_ml, (bf16*)out, G, H, nsplit, (float*)lse);
  return (int)cudaGetLastError();
}

int attn_train_kv_bwd(const void* q, const void* x, const void* ln_w, const void* ln_b,
                      const void* wk, const void* wv, const void* seed, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dx, void* dw,
                      void* dlnw, void* dlnb, void* kbuf, void* vbuf, void* rowstats, void* xn,
                      void* dk, void* dv, void* dxn, void* part, void* wpart, int B, int G, int M,
                      int din, int H, int splits, int nblk, float scale, float keep_p,
                      unsigned thresh, int drop, cudaStream_t st) {
  const int D = H * DH, rows = B * M;
  if (splits < 1 || splits > (rows + PJ_KR - 1) / PJ_KR) return (int)cudaErrorInvalidValue;
  int e = kv_project(x, ln_w, ln_b, wk, wv, kbuf, vbuf, xn, rowstats, rows, din, D, st);
  if (e != cudaSuccess) return e;
  e = flash_bwd(q, kbuf, vbuf, dout, lse, delta, seed, dq, dk, dv, B, G, M, H, scale, keep_p,
                thresh, drop, st);
  if (e != cudaSuccess) return e;
  const bf16 *dk_ = (const bf16*)dk, *dv_ = (const bf16*)dv;
  // dxn = [dk | dv] [wk | wv]^T  [rows, Din] f32
  cudaError_t err = cudaFuncSetAttribute(dxn_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PJ_DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  float* dxn_ = static_cast<float*>(dxn);
  dxn_tc_kernel<<<dim3((din + PJ_BN - 1) / PJ_BN, (rows + PJ_BM - 1) / PJ_BM), PJ_THREADS,
                  PJ_DX_SMEM, st>>>(dk_, dv_, (const bf16*)wk, (const bf16*)wv, dxn_, rows, din,
                                    D);
  // dx and the dLN scale / bias column sums, on the CUDA cores
  LnRow<bf16> ln{static_cast<const bf16*>(x), static_cast<const float2*>(rowstats),
                 static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), din};
  ln_bwd_kernel<bf16><<<(rows + 7) / 8, 256, 0, st>>>(ln, dxn_, rows, static_cast<bf16*>(dx));
  float* part_ = static_cast<float*>(part);
  colsum2(rows, din, nblk, LnGradCols<bf16>{ln, dxn_}, part_, st);
  sum_parts(nblk, din, part_, static_cast<float*>(dlnw), static_cast<float*>(dlnb), st);
  // [dWk | dWv] = xn^T [dk | dv]  ([Din, 2D], f32), split over the tokens
  err = cudaFuncSetAttribute(dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PJ_DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  float* wpart_ = static_cast<float*>(wpart);
  dw_tc_kernel<<<dim3((din + PJ_BM - 1) / PJ_BM * (2 * D / PJ_BN), splits), PJ_THREADS,
                 PJ_DW_SMEM, st>>>((const bf16*)xn, dk_, dv_, rows, din, D, splits, wpart_);
  sum_splits(splits, din * 2 * D, wpart_, static_cast<float*>(dw), st);
  return cudaGetLastError();
}

}  // namespace tc

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

extern "C" int attn_train_bwd_f32(const void* q, const void* k, const void* v, const void* seed,
                                  const void* dout, const void* lse, const void* delta, void* dq,
                                  void* dk, void* dv, int b, int g, int m, int h, SEED_ARGS) {
  return flash_bwd<float, float>(static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), static_cast<const float*>(dout),
                                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                                 static_cast<const int*>(seed), static_cast<float*>(dq),
                                 static_cast<float*>(dk), static_cast<float*>(dv), b, g, m, h,
                                 scale, keep_p, thresh, drop, static_cast<cudaStream_t>(stream));
}
// bf16 on the tensor cores (pointers 16-byte aligned)
extern "C" int attn_train_bwd_tc_bf16(const void* q, const void* k, const void* v,
                                      const void* seed, const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk, void* dv, int b,
                                      int g, int m, int h, SEED_ARGS) {
  return tc::flash_bwd(q, k, v, dout, lse, delta, seed, dq, dk, dv, b, g, m, h, scale, keep_p,
                       thresh, drop, static_cast<cudaStream_t>(stream));
}

#define KV_FWD_ARGS                                                                         \
  const void *q, const void *x, const void *ln_w, const void *ln_b, const void *wk,         \
      const void *wv, const void *seed, void *out, void *lse, void *kbuf, void *vbuf,       \
      void *rowstats, int b, int g, int m, int din, int h, SEED_ARGS
#define KV_FWD_PASS                                                                          \
  q, x, ln_w, ln_b, wk, wv, seed, out, lse, kbuf, vbuf, rowstats, b, g, m, din, h, scale,   \
      keep_p, thresh, drop, stream

extern "C" int attn_train_kv_fwd_f32(KV_FWD_ARGS) { return attn_train_kv_fwd<float>(KV_FWD_PASS); }
// bf16 on the tensor cores (pointers 16-byte aligned): xn [B*M, Din] bf16
// and rowstats f32 [B*M, 2] scratch; up to 128 query rows the tile kernel
// in nsplit splits of the 64-token tiles (none empty), its split states in
// part_acc f32 [B, H, nsplit, G, 64] and part_ml f32 [B, H, nsplit, G, 2]
// (stubs at nsplit 1), kbuf and vbuf unused (null); past 128 k and v [B, M,
// H*64] bf16 in kbuf and vbuf, nsplit unused
extern "C" int attn_train_kv_fwd_tc_bf16(const void* q, const void* x, const void* ln_w,
                                         const void* ln_b, const void* wk, const void* wv,
                                         const void* seed, void* out, void* lse, void* kbuf,
                                         void* vbuf, void* rowstats, void* xn, void* part_acc,
                                         void* part_ml, int b, int g, int m, int din, int h,
                                         int nsplit, SEED_ARGS) {
  return tc::attn_train_kv_fwd(q, x, ln_w, ln_b, wk, wv, seed, out, lse, kbuf, vbuf, rowstats, xn,
                               part_acc, part_ml, b, g, m, din, h, nsplit, scale, keep_p, thresh,
                               drop, static_cast<cudaStream_t>(stream));
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

// bf16 on the tensor cores (pointers 16-byte aligned); scratch: k, v [B, M,
// H*64] and xn [B*M, Din] bf16, rowstats f32 [B*M, 2], dk, dv bf16 [B, M,
// H*64], dxn f32 [B*M, Din], part f32 [nblk, 2, Din], wpart f32 [splits,
// Din, 2 H*64]; dw f32 [Din, 2 H*64] is [dWk | dWv]
extern "C" int attn_train_kv_bwd_tc_bf16(
    const void* q, const void* x, const void* ln_w, const void* ln_b, const void* wk,
    const void* wv, const void* seed, const void* dout, const void* lse, const void* delta,
    void* dq, void* dx, void* dw, void* dlnw, void* dlnb, void* kbuf, void* vbuf, void* rowstats,
    void* xn, void* dk, void* dv, void* dxn, void* part, void* wpart, int b, int g, int m,
    int din, int h, int splits, int nblk, SEED_ARGS) {
  return tc::attn_train_kv_bwd(q, x, ln_w, ln_b, wk, wv, seed, dout, lse, delta, dq, dx, dw, dlnw,
                               dlnb, kbuf, vbuf, rowstats, xn, dk, dv, dxn, part, wpart, b, g, m,
                               din, h, splits, nblk, scale, keep_p, thresh, drop,
                               static_cast<cudaStream_t>(stream));
}

// K7's LN-folded k|v projection alone (bf16, tensor cores): x [rows, Din],
// ln_w, ln_b f32 [Din], wk, wv [Din, H*64] -> k, v [rows, H*64]; xn [rows,
// Din] bf16 and stats f32 [rows, 2] are written too
extern "C" int kv_project_tc_bf16(const void* x, const void* ln_w, const void* ln_b,
                                  const void* wk, const void* wv, void* k, void* v, void* xn,
                                  void* stats, int rows, int din, int h, void* stream) {
  return tc::kv_project(x, ln_w, ln_b, wk, wv, k, v, xn, stats, rows, din, h * DH,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int dropout_mask_u8(const void* seed, int bh, int g, int m, unsigned thresh, void* out,
                               void* stream) {
  const size_t n = (size_t)bh * g * m;
  dropout_mask_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), bh, g, m, thresh, static_cast<unsigned char*>(out));
  return cudaGetLastError();
}
