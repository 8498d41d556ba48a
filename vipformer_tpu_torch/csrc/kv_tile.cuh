// The bf16 tile kernels that K4 (attention.cu) and K7's forward
// (flash_train.cu) share: one block of 8 warps per (head, cloud, kv split)
// projects 64-token tiles of xn onto this head's k|v on mma.sync, keeps
// them in shared memory, and runs K13's online softmax over them for its
// 128 query rows (16 a warp); k and v never reach device memory. Past 128
// query rows the same kernels, in their projection mode, write k and v
// once. Design and measurements at K4's section of attention.cu.
//
// K7's forward (TRAIN) adds three things to K4's function, as K8's bf16
// forward (flash_train.cu tc::flash_fwd_tc_kernel) runs them on k and v
// from device memory:
//   * the dropout keep bit of each p before P.V (row_key of (seed, b*H +
//     head, the query row), keep_bit of the key's index in the cloud, so
//     the mask is the twin's whatever the tile or the split), kept p times
//     1 / (1 - rate), dropped p 0, behind the runtime `drop` flag;
//   * l summing the undropped, unrounded p (it already does);
//   * the row's f32 lse = m ln 2 + log l (natural units) into [B, H, G]
//     for the backward, written by the block at one split, else by the
//     merge pass from the split states.
// The backward recomputes k and v with flash_train.cu's kv_proj_tc_kernel
// on the same xn (K7's own LayerNorm pass) and forms p = exp(s - lse), so
// the tile kernel's k|v must be that kernel's bit for bit: both take Din
// in ascending k16 steps of mma.sync into f32 accumulators from zero and
// round once to bf16. At one split the forward is then K8's bf16 forward
// on those k and v, the same steps in the same order: the same bits.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace vpt_kvln {

using vpt::mma::bf16;
using vpt::mma::KT;
using vpt::mma::NT;

constexpr int DH = 64;          // head width
constexpr int QT = 128;         // query rows a block
constexpr int LDQ = DH + 8;     // padded shared row of q's staging (bf16)
constexpr int KVLN_NW = 8, KVLN_THREADS = 32 * KVLN_NW;  // 16 query rows a warp
constexpr int KVLN_LDW = 2 * DH + 8;  // padded row of this head's [wk|wv], and of a k|v tile
constexpr int KVLN_TILE_DIN = 256;     // the widest Din of the two-blocks-an-SM tile kernel
constexpr int KVLN_TILE_DB_DIN = 384;  // the widest Din of the double-buffered tile kernel
// the tile kernel: the weights, one or two tiles of xn (then their k|v)
__host__ __device__ constexpr size_t kvln_tile_smem(int tdin, bool db) {
  return sizeof(bf16) * ((size_t)tdin * KVLN_LDW + (db ? 2 : 1) * KT * (tdin + 8));
}
// the stream kernel: a k|v tile and the ring of chunks
constexpr int KVLN_KC = 64;            // Din columns a chunk
constexpr int KVLN_STAGES = 3;         // chunks in the ring
constexpr int KVLN_LDX = KVLN_KC + 8;  // padded row of a chunk of xn
constexpr int KVLN_SLOT = KT * KVLN_LDX + KVLN_KC * KVLN_LDW;  // bf16 elements
constexpr size_t KVLN_STREAM_SMEM =
    sizeof(bf16) * (KT * KVLN_LDW + (size_t)KVLN_STAGES * KVLN_SLOT);
static_assert(KVLN_NW * 16 == QT, "a warp's 16 query rows");
static_assert(QT * LDQ <= KT * (KVLN_TILE_DIN + 8) &&
                  QT * LDQ <= KT * KVLN_LDW + KVLN_STAGES * KVLN_SLOT,
              "q is staged over a tile of xn, or over the k|v tile and the ring");
static_assert(2 * (kvln_tile_smem(KVLN_TILE_DIN, false) + 1024) <= 233472 &&
                  2 * (KVLN_STREAM_SMEM + 1024) <= 233472,
              "two blocks an SM");
static_assert(kvln_tile_smem(KVLN_TILE_DB_DIN, true) <= 232448, "one block an SM");

// ------------------------------------------------------------ dropout
// The keep bit of element (row g, column m) of (cloud b, head h) is a pure
// function of (seed, b*H + h, g, m):
//   bits = mix(m + mix(g + mix(bh + mix(seed))))  (all mod 2^32),
//   keep = bits >= thresh,  thresh = round(rate * 2^32).
// K7 and K8, forward and backward, draw every mask from these three.
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

// What K7's forward passes besides K4's operands: the int32 seed [1] on
// the card, lse f32 [B, H, G], 1 - rate, the keep threshold and whether
// anything is dropped. K4's instances never read it.
struct TrainArgs {
  const int* seed;
  float* lse;
  float keep_p;
  uint32_t thresh;
  int drop;
};

// A warp's dropout state: its two rows' keys (rows row0 + lane / 4 and 8
// after it), 1 / (1 - rate) as K8's forward computes it, the threshold.
struct RowDrop {
  uint32_t rk[2];
  float inv_keep;
  uint32_t thresh;
  int drop;
};

template <bool TRAIN>
__device__ __forceinline__ RowDrop row_drop(const TrainArgs& tr, int bh, int row0, int lane) {
  RowDrop d{{0u, 0u}, 1.0f, 0u, 0};
  if constexpr (TRAIN) {
    d.drop = tr.drop;
    d.thresh = tr.thresh;
    d.inv_keep = 1.0f / tr.keep_p;
    const uint32_t s0 = d.drop ? (uint32_t)tr.seed[0] : 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) d.rk[r] = row_key(s0, bh, row0 + 8 * r + (lane >> 2));
  }
  return d;
}

// ------------------------------------------------------------ tiles
// The warp's k|v accumulators (tokens 32 rg.., columns 32 cg..) rounded to
// bf16 into the k|v tile (rows KVLN_LDW apart): the Dense emit, no bias.
__device__ __forceinline__ void kvln_store_kv(bf16* kv, const float (&acc)[2][4][4], int rg,
                                              int cg, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(
            kv + (32 * rg + 16 * i + 8 * hh + (lane >> 2)) * KVLN_LDW + 32 * cg + 8 * j +
            2 * (lane & 3)) = vpt::mma::pack_bf16x2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
}

// One 64-token tile of the online softmax of _packed_kv_ln_kernel, as K13
// runs it, for a warp's 16 query rows: m_new, corr = exp(m - m_new), p =
// exp(s - m_new) in f32, l summing the unrounded p, acc = acc * corr +
// bf16(p) . v (exp as 2^ of log2 units, c = scale * log2 e); the tile's k
// in columns 0.. of kv, v in DH.., tokens at or past m_end masked. With
// TRAIN and dr.drop, each p is kept (times 1 / (1 - rate)) or dropped by
// its keep bit after l has summed it, as K8's bf16 forward does.
template <bool TRAIN>
__device__ __forceinline__ void kvln_attend(const uint32_t (&qa)[1][DH / 16][4], const bf16* kv,
                                            float c, int t0, int m_end, float (&mx)[1][2],
                                            float (&sum)[1][2], float (&o)[1][DH / 8][4],
                                            const RowDrop& dr, int lane) {
  namespace mm = vpt::mma;
  float s[1][NT][4];
  mm::warp_scores<DH, 1>(s, qa, kv, KVLN_LDW, lane);
  mm::scale_and_mask(s[0], c, t0, m_end, lane);
  mm::online_softmax_tile<1, DH>(s, mx, sum, o);  // the sum over the undropped p
  if constexpr (TRAIN) {
    if (dr.drop) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][n][e] = keep_bit(dr.rk[e >> 1], t0 + 8 * n + 2 * (lane & 3) + (e & 1), dr.thresh)
                           ? s[0][n][e] * dr.inv_keep
                           : 0.0f;
    }
  }
  uint32_t pa[1][KT / 16][4];
  mm::p_frags(pa[0], s[0]);
  mm::warp_pv<DH, 1>(o, pa, kv + DH, KVLN_LDW, lane);
}

// The warp's 16 query rows from row0: divided by l into out (and, with
// TRAIN, lse = m ln 2 + log l into lse [B, H, G]), or with a split the
// unnormalised state for attn_combine_kernel.
template <bool TRAIN>
__device__ __forceinline__ void kvln_store_out(bf16* out, float* part_acc, float* part_ml,
                                               float* lse, const float (&o)[1][DH / 8][4],
                                               const float (&mx)[1][2], const float (&sum)[1][2],
                                               int b, int g, int h, int head, int nsplit,
                                               int split, int row0, int lane) {
  namespace mm = vpt::mma;
  const int d = h * DH, c0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r + (lane >> 2);
    const float l = mm::quad_sum(sum[0][r]);  // all lanes take part: before the row test
    if (row >= g) continue;
    if (nsplit == 1) {
      bf16* orow = out + ((size_t)b * g + row) * d + head * DH + c0;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            mm::pack_bf16x2(o[0][n][2 * r] / l, o[0][n][2 * r + 1] / l);
      if constexpr (TRAIN) {
        if ((lane & 3) == 0) lse[((size_t)b * h + head) * g + row] = mx[0][r] * mm::LN2 + logf(l);
      }
    } else {
      const size_t prow = (((size_t)b * h + head) * nsplit + split) * g + row;
      float* pacc = part_acc + prow * DH + c0;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(pacc + 8 * n) = make_float2(o[0][n][2 * r], o[0][n][2 * r + 1]);
      if ((lane & 3) == 0) {
        part_ml[2 * prow] = mx[0][r] * mm::LN2;  // the merge pass takes natural units
        part_ml[2 * prow + 1] = l;
      }
    }
  }
}

// In the projection mode, the warp's k|v accumulators (as kvln_store_kv
// takes them) rounded to bf16 into k and v [B * M, H * 64] (v kv_rows
// rows after k): tokens t0.. of the cloud whose first row is row0, those
// at or past m_end left out.
__device__ __forceinline__ void kvln_write_kv(bf16* kv, const float (&acc)[2][4][4], size_t row0,
                                              int t0, int m_end, size_t kv_rows, int d, int head,
                                              int rg, int cg, int lane) {
  bf16* base = kv + (cg >= 2 ? kv_rows * d : 0) + head * DH + 32 * (cg & 1) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + 32 * rg + 16 * i + 8 * hh + (lane >> 2);
      if (t >= m_end) continue;
      bf16* row = base + (row0 + t) * d;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            vpt::mma::pack_bf16x2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    }
}

// The tile kernel (Din <= TDIN): the head's weights resident, a whole
// 64-token tile of xn a step. With DB (one block an SM; the attention
// only) two tile buffers: the next tile's copy is in flight during a
// tile's products; without it (two blocks an SM) one buffer, and the
// other block's products overlap a block's copy. ATTEND: the attention
// over the tiles into out [B, G, H*64] (or the merge pass's states); else
// the projection alone into out = k, then v. TRAIN (K7's forward; ATTEND
// only): the dropout and the log-sum-exp of the header.
template <int TDIN, bool DB, bool ATTEND, bool TRAIN = false>
__global__ void __launch_bounds__(KVLN_THREADS, DB ? 1 : 2)
attn_kv_ln_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ xn,
                       const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                       bf16* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int g, int m, int din, int h, int nsplit,
                       int tps, float scale, TrainArgs tr) {
  static_assert(ATTEND || !DB, "the projection mode is single-buffered");
  static_assert(ATTEND || !TRAIN, "K7's forward attends");
  namespace mm = vpt::mma;
  constexpr int LDT = TDIN + 8;  // padded row of a tile of xn
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wres = reinterpret_cast<bf16*>(smem_raw);  // [TDIN][LDW]: this head's [wk|wv]
  bf16* tiles = wres + TDIN * KVLN_LDW;            // [1 + DB][KT][LDT]: xn, then its k|v
  const int b = blockIdx.y, head = blockIdx.x;
  const int split = blockIdx.z % nsplit, q0 = (blockIdx.z / nsplit) * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (m + KT - 1) / KT;
  const int t_begin = split * tps, t_end = min(nt, t_begin + tps);
  const int m_end = min(m, t_end * KT);  // a tile boundary but for the last split
  const int d = h * DH, dp = (din + 15) & ~15;  // Din rounded up to the k steps
  const int cpr = dp >> 3;                       // 16-byte chunks of a row of a tile
  const bf16* xb = xn + (size_t)b * m * din;
  auto load = [&](int t) {  // tile t's rows of xn, zero-filled past m_end and Din
    bf16* xt = tiles + (DB ? ((t - t_begin) & 1) * KT * LDT : 0);
    for (int e = tid; e < KT * cpr; e += KVLN_THREADS) {
      const int r = e / cpr, c8 = e - r * cpr;
      const bool ok = t * KT + r < m_end && 8 * c8 < din;
      mm::cp_async16(xt + r * LDT + 8 * c8, ok ? xb + (size_t)(t * KT + r) * din + 8 * c8 : xb,
                     ok);
    }
  };
  // q, staged in the (last) tile buffer until each warp holds its A
  // fragments, and the weights (rows past Din zero-filled)
  bf16* qstage = tiles + (DB ? KT * LDT : 0);
  if constexpr (ATTEND)
    mm::cp_rows<DH, QT, KVLN_THREADS>(qstage, LDQ, q + (size_t)b * g * d + head * DH, d, q0, g,
                                      tid);
  for (int r0 = 0; r0 < dp; r0 += 32) {
    mm::cp_rows<DH, 32, KVLN_THREADS>(wres + r0 * KVLN_LDW, KVLN_LDW, wk + head * DH, d, r0,
                                      din, tid);
    mm::cp_rows<DH, 32, KVLN_THREADS>(wres + r0 * KVLN_LDW + DH, KVLN_LDW, wv + head * DH, d,
                                      r0, din, tid);
  }
  if (DB) load(t_begin);  // into the first buffer, beside q
  mm::cp_async_commit();
  mm::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[1][DH / 16][4];
  if constexpr (ATTEND) mm::warp_a_frags<DH, 1>(qa, qstage, LDQ, 16 * warp, lane);
  const int rg = warp >> 2, cg = warp & 3;  // the warp's tokens and k|v columns of a tile
  const bool active = q0 + 16 * warp < g;
  const float c = scale * mm::LOG2E;  // logits (and mx) in log2 units
  const RowDrop dr = row_drop<TRAIN>(tr, b * h + head, q0 + 16 * warp, lane);
  float mx[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}}, sum[1][2] = {{0.0f, 0.0f}};
  float o[1][DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    bf16* xt = tiles + (DB ? ((t - t_begin) & 1) * KT * LDT : 0);
    if (DB) {
      mm::cp_async_wait<0>();  // tile t has landed (this thread's copies)
      __syncthreads();         // ... everyone's; q and tile t - 1's k|v are read
      if (t + 1 < t_end) load(t + 1);  // into the other buffer
      mm::cp_async_commit();
    } else {
      __syncthreads();  // q, or the last tile, is read: tile t takes its place
      load(t);
      mm::cp_async_commit();
      mm::cp_async_wait<0>();
      __syncthreads();
    }
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    mm::warp_ab<2, 4>(acc, xt + 32 * rg * LDT, LDT, wres + 32 * cg, KVLN_LDW, dp, lane);
    if constexpr (!ATTEND) {
      kvln_write_kv(out, acc, (size_t)b * m, t * KT, m_end, (size_t)gridDim.y * m, d, head, rg,
                    cg, lane);
    } else {
      __syncthreads();  // xn is read: the tile's k|v takes its place
      kvln_store_kv(xt, acc, rg, cg, lane);
      __syncthreads();
      if (active) kvln_attend<TRAIN>(qa, xt, c, t * KT, m_end, mx, sum, o, dr, lane);
    }
  }
  if (ATTEND && active)
    kvln_store_out<TRAIN>(out, part_acc, part_ml, tr.lse, o, mx, sum, b, g, h, head, nsplit,
                          split, q0 + 16 * warp, lane);
}

// The stream kernel (any Din, a multiple of 8): chunk c of the split holds
// columns k0.. of tile t's rows of xn (rows past m_end and columns past Din
// zero-filled) and rows k0.. of this head's wk and wv columns (rows past
// Din zero-filled). ATTEND and TRAIN as the tile kernel's.
template <bool ATTEND, bool TRAIN = false>
__global__ void __launch_bounds__(KVLN_THREADS, 2)
attn_kv_ln_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ xn,
                         const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                         bf16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int g, int m, int din, int h, int nsplit,
                         int tps, float scale, TrainArgs tr) {
  static_assert(ATTEND || !TRAIN, "K7's forward attends");
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv = reinterpret_cast<bf16*>(smem_raw);  // [KT][LDW]: k | v of a tile
  bf16* ring = kv + KT * KVLN_LDW;               // [STAGES][KT x LDX | KC x LDW]
  const int b = blockIdx.y, head = blockIdx.x;
  const int split = blockIdx.z % nsplit, q0 = (blockIdx.z / nsplit) * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (m + KT - 1) / KT;
  const int t_begin = split * tps, t_end = min(nt, t_begin + tps);
  const int m_end = min(m, t_end * KT);
  const int d = h * DH, nkc = (din + KVLN_KC - 1) / KVLN_KC;
  const int nchunks = (t_end - t_begin) * nkc;
  const bf16* xb = xn + (size_t)b * m * din;
  auto load = [&](int ch) {
    const int t = t_begin + ch / nkc, k0 = (ch % nkc) * KVLN_KC;
    bf16* xs = ring + (ch % KVLN_STAGES) * KVLN_SLOT;
    bf16* ws = xs + KT * KVLN_LDX;
    mm::cp_rows<KVLN_KC, KT, KVLN_THREADS>(xs, KVLN_LDX, xb + k0, din, t * KT, m_end, tid,
                                           din - k0);
    mm::cp_rows<DH, KVLN_KC, KVLN_THREADS>(ws, KVLN_LDW, wk + (size_t)k0 * d + head * DH, d, 0,
                                           din - k0, tid);
    mm::cp_rows<DH, KVLN_KC, KVLN_THREADS>(ws + DH, KVLN_LDW, wv + (size_t)k0 * d + head * DH,
                                           d, 0, din - k0, tid);
  };
  // q, staged over the k|v tile and the ring until each warp holds its A
  // fragments; then the ring
  uint32_t qa[1][DH / 16][4];
  if constexpr (ATTEND) {
    mm::cp_rows<DH, QT, KVLN_THREADS>(kv, LDQ, q + (size_t)b * g * d + head * DH, d, q0, g, tid);
    mm::cp_async_commit();
    mm::cp_async_wait<0>();
    __syncthreads();
    mm::warp_a_frags<DH, 1>(qa, kv, LDQ, 16 * warp, lane);
    __syncthreads();
  }
#pragma unroll
  for (int st = 0; st < KVLN_STAGES - 1; ++st) {
    if (st < nchunks) load(st);
    mm::cp_async_commit();
  }
  const int rg = warp >> 2, cg = warp & 3;
  const bool active = q0 + 16 * warp < g;
  const float c = scale * mm::LOG2E;
  const RowDrop dr = row_drop<TRAIN>(tr, b * h + head, q0 + 16 * warp, lane);
  float mx[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}}, sum[1][2] = {{0.0f, 0.0f}};
  float o[1][DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.0f;
  float acc[2][4][4];
  for (int ci = 0; ci < nchunks; ++ci) {
    const int kc = ci % nkc;
    if (kc == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    mm::cp_async_wait<KVLN_STAGES - 2>();  // chunk ci has landed (this thread's copies)
    __syncthreads();  // ... everyone's; chunk ci - 1 is consumed, the k|v tile read
    if (ci + KVLN_STAGES - 1 < nchunks) load(ci + KVLN_STAGES - 1);
    mm::cp_async_commit();
    const bf16* xs = ring + (ci % KVLN_STAGES) * KVLN_SLOT;
    mm::warp_ab<2, 4>(acc, xs + 32 * rg * KVLN_LDX, KVLN_LDX, xs + KT * KVLN_LDX + 32 * cg,
                      KVLN_LDW, KVLN_KC, lane);
    if (kc != nkc - 1) continue;
    const int t0 = (t_begin + ci / nkc) * KT;
    if constexpr (!ATTEND) {
      kvln_write_kv(out, acc, (size_t)b * m, t0, m_end, (size_t)gridDim.y * m, d, head, rg, cg,
                    lane);
    } else {
      kvln_store_kv(kv, acc, rg, cg, lane);
      __syncthreads();  // the tile's k and v are complete
      if (active) kvln_attend<TRAIN>(qa, kv, c, t0, m_end, mx, sum, o, dr, lane);
    }
  }
  mm::cp_async_wait<0>();
  if (ATTEND && active)
    kvln_store_out<TRAIN>(out, part_acc, part_ml, tr.lse, o, mx, sum, b, g, h, head, nsplit,
                          split, q0 + 16 * warp, lane);
}

// Merges the per-split online-softmax states of K4, K13 (both routes) and
// K7's bf16 forward when M was split over blocks: out = sum_s acc_s
// e^(m_s - M) / sum_s l_s e^(m_s - M), M = max m_s, and with LSE (K7) the
// row's lse = M + log(sum_s l_s e^(m_s - M)) into lse [B, H, G]. One block
// per (cloud, query row), a thread per output column.
template <typename T, bool LSE = false>
__global__ void attn_combine_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml, T* __restrict__ out,
                                    int g, int h, int nsplit, float* __restrict__ lse) {
  const int b = blockIdx.x / g, r = blockIdx.x % g;
  const int d = h * DH;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const int head = col / DH, c = col - head * DH;
    const size_t row0 = (((size_t)b * h + head) * nsplit) * g + r;
    float mx = -CUDART_INF_F;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, part_ml[2 * (row0 + (size_t)sp * g)]);
    float l = 0.f, a = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const size_t row = row0 + (size_t)sp * g;
      const float w = expf(part_ml[2 * row] - mx);
      l += part_ml[2 * row + 1] * w;
      a += part_acc[row * DH + c] * w;
    }
    out[((size_t)b * g + r) * d + col] = vpt::from_f32<T>(a / l);
    if constexpr (LSE) {
      if (c == 0) lse[((size_t)b * h + head) * g + r] = mx + logf(l);
    }
  }
}

// nsplit splits of nt tiles, ceil(nt / nsplit) each, none empty
inline bool kvln_split_ok(int nt, int nsplit) {
  return nsplit >= 1 && nsplit <= nt && (nsplit - 1) * ((nt + nsplit - 1) / nsplit) < nt;
}

// One pass over xn [B*M, Din] in nsplit kv splits, the attention
// (ATTEND) or the projection alone (out = k, then v): the tile kernel up
// to Din = KVLN_TILE_DIN, the double-buffered one (the attention only) up
// to KVLN_TILE_DB_DIN, else the stream kernel. TRAIN: K7's forward, with
// `tr`.
template <bool ATTEND, bool TRAIN = false>
cudaError_t kvln_pass(const void* q, const bf16* xn, const void* wk, const void* wv, void* out,
                      void* part_acc, void* part_ml, int b, int g, int m, int din, int h,
                      int nsplit, float scale, cudaStream_t stream, TrainArgs tr = {}) {
  const int nt = (m + KT - 1) / KT, tps = (nt + nsplit - 1) / nsplit;
  auto kernel = attn_kv_ln_stream_kernel<ATTEND, TRAIN>;
  size_t smem = KVLN_STREAM_SMEM;
  if (din <= KVLN_TILE_DIN) {
    kernel = attn_kv_ln_tile_kernel<KVLN_TILE_DIN, false, ATTEND, TRAIN>;
    smem = kvln_tile_smem(KVLN_TILE_DIN, false);
  } else if constexpr (ATTEND) {
    if (din <= KVLN_TILE_DB_DIN) {
      kernel = attn_kv_ln_tile_kernel<KVLN_TILE_DB_DIN, true, true, TRAIN>;
      smem = kvln_tile_smem(KVLN_TILE_DB_DIN, true);
    }
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(h, b, (ATTEND ? (g + QT - 1) / QT : 1) * nsplit);
  kernel<<<grid, KVLN_THREADS, smem, stream>>>(
      (const bf16*)q, xn, (const bf16*)wk, (const bf16*)wv, (bf16*)out, (float*)part_acc,
      (float*)part_ml, g, m, din, h, nsplit, tps, scale, tr);
  return cudaGetLastError();
}

}  // namespace vpt_kvln
