// K4 and K5: eval attention on the packed [B, tokens, H*dh] layout.
//
// K4 replaces vipformer_tpu/ops/pallas/attention.py:fused_attention_packed_kv_ln
// (the cross-attention: kv LayerNorm + k/v projections folded in, online
// softmax over M chunks, divided by l after PV, attention.py:383-444).
// K5 replaces attention.py:fused_attention_packed_small (the self-attention
// at small M: whole score block on chip, softmax normalised BEFORE PV,
// attention.py:619-635).
//
// Bound on the H100, K4: arithmetic of the folded projections. Per
// (cloud, head) every kv token is projected onto that head's k and v
// columns (M x Din x 2dh = 33.5 MMAC at M=1024, Din=256, dh=64) plus
// 2 x G x M x dh = 16.8 MMAC for the attention itself: 25.8 GFLOP at
// [64, 128] x [64, 1024, 256], H = 4, 0.026 ms on the bf16 tensor cores,
// 0.39 ms at least on the f32 CUDA cores. In bf16 the tokens are
// normalised once (ln_xn_kernel) and projected once per head. The f32
// kernel reads the raw tokens once per head and per block of 128 query
// rows (from L2 after the first: a cloud's heads run side by side) and
// normalises them each time; their statistics are computed once.
// Bound on the H100, K5 (q/k/v [64, 128, 256], H = 4, bf16): device
// memory. q, k and v are read once and the output written once (16.8 MB,
// 0.005 ms at 3.35 TB/s); the products are 4 x B x G x M x D = 1.07 GFLOP,
// 0.001 ms on the bf16 tensor cores but 0.016 ms at least on the f32 CUDA
// cores. At these sizes a launch's latency, not either bound, sets its time.
// K13 replaces attention.py:fused_attention_packed (:212, kernel
// _packed_kernel :156): flash attention on q/k/v already projected, the
// online softmax streamed over M chunks (the Fourier image cross-attention,
// M = 20,736 tokens at 144x144). K15 replaces
// attention.py:fused_attention_packed_kv (:325, kernel _packed_kv_kernel
// :266): K13 with the bias-free k/v projections folded in (the
// self-attention at 512 latents, where K6's tiles do not fit). In bf16,
// past 128 queries and up to 512 queries and tokens, a thread-block
// cluster a (cloud, head) projects each token once and keeps k and v on
// chip (design at its section below); elsewhere K4's bf16 passes run on
// the tokens as they are.
// K6 replaces attention.py:fused_attention_packed_small_qkv_ln (kernel
// :666-712): K5 with the pre-LN and the q/k/v projections folded in, so
// the raw tokens are read and only the attention output is written. On the
// card its work is arithmetic: 2 x G x Din x 3D + 4 x G x G x D per cloud,
// 22 GFLOP at x [330, 128, 256], H = 4: 0.022 ms on the bf16 tensor cores
// (its bytes, 22 MB in and out, take 0.007 ms at 3.35 TB/s), but 0.33 ms
// at least on the f32 CUDA cores.
//
// The dtype picks K4's kernels (ops/cuda/__init__.py `tc_route`): bf16
// runs `tc::ln_xn_kernel` (the tokens normalised once, xn written), then
// up to 128 query rows `attn_kv_ln_tile_kernel` (Din <= 256; its
// double-buffered instance up to 384) or `attn_kv_ln_stream_kernel`
// (Din > 384): xn's projection and K13's online softmax in one block per
// (head, cloud, kv split); past 128 query rows the single-buffered tile
// kernel (Din <= 256) or the stream kernel in their projection mode write
// k and v once and K13's `tc::attn_packed_tc_kernel` attends over them
// (design at their section below). f32 runs attn_flash_kernel's KV_LN
// mode on the CUDA cores.
// Design, K4 f32 (and K13 f32, K15): the Pallas kernel carried the
// online-softmax state across a sequential grid axis; blocks on Hopper
// carry nothing between them, so one block per (cloud, head, 128 query
// rows) walks the M chunks (32 tokens each) itself. At small batch that is
// fewer blocks than the card has SMs, so the wrapper may split the chunks
// over several blocks (flash-decoding style) and a second kernel merges
// their (max, sum, acc) states. Every phase is register-tiled over shared
// memory: the projection gives a thread 4 tokens x 4 k-or-v columns (one
// float4 of normalised tokens and one vector of weights per k step), the
// logits 4 query rows x 4 tokens, PV 4 rows x 8 columns; a thread keeps
// the same 4 query rows throughout, so its rows' running max and sum stay
// in registers and the row reductions are shuffles within 8 lanes.
// Bound on the H100, K13 (q [48, 128, 256], k/v [48, 20,736, 256], bf16):
// device memory. k and v are 1.02 GB, read once per block of 128 query
// rows (G <= 128 at its site: once): 0.306 ms at 3.35 TB/s. The products
// are 4 x B x G x M x D = 130.5 GFLOP: 0.13 ms on the bf16 tensor cores,
// but at least 1.95 ms on the f32 CUDA cores (67 TFLOP/s). K15: the
// products, K4's arithmetic (at its section below); its f32 kernel redoes
// the projection once per 128-row query tile (4 times at G = 512).
// The dtype picks K13's kernel (ops/cuda/__init__.py `tc_route`): bf16
// runs `tc::attn_packed_tc_kernel` below; f32 runs attn_flash_kernel's
// KV_DIRECT mode, on the CUDA cores, because a tensor-core f32 product is
// TF32 (about 3 decimal digits), which would break the f32 bound of 2e-5
// against the twin and the 1e-4 card-vs-CPU checks.
// Design, K13 bf16: one block of 4 warps per (head, cloud, 128 query
// rows, kv split), each warp two tiles of 16 query rows (MT = 2: each
// B fragment read from shared memory serves both, 4% faster than 8 warps
// of 16 rows, PERF.md), with its q in registers as ldmatrix A fragments.
// The split's k and v tiles of 64 tokens x this head's 64 columns (each
// row 128 contiguous bytes at a stride of H x 128 bytes, 8 cp.async of 16
// bytes) stream through a ring of 3 stages, rows padded to 72 bf16 so
// that ldmatrix meets no bank conflict, with one barrier a tile and the
// loads of the next two tiles in flight during a tile's products.
// s = q.k on mma.sync m16n8k16 (bf16 in, f32 out), then the online
// softmax of _packed_kernel (JAX attention.py:163-206) in registers: the
// tile's row max over the quad of lanes that shares a row, corr =
// exp(m - m_new), p = exp(s - m_new) in f32, l summing the unrounded p,
// p rounded to bf16 in registers as the A fragments of P.V (v through
// ldmatrix.trans), acc rescaled by corr and divided by l at the end. The
// logits are kept in log2 units (s * scale * log2 e), so each exp is one
// ex2.approx (within 2 ulp); the split states store m in natural units.
// The tile is the 64 tokens of the JAX test case whose kv_chunk is 64
// (tests/test_torch_perceiver_kernels.py CASES), the CPU witness of this
// tile order. Tokens past M get -inf logits and zero-filled k/v rows;
// query rows past G are neither computed into the output nor written. The
// kv split (flash decoding) keeps the f32 part_acc / part_ml layout that
// attn_combine_kernel merges; the planner (ops/cuda/attention.py
// `packed_splits`) splits the 64-token tiles so that the card holds at
// least one full wave of blocks, and its last wave is 90% full (4 splits
// at the image shape: the partial states add 52 MB of writes and reads,
// 0.016 ms at the memory rate). Per -Xptxas -v on the card (sm_90a): 235
// registers, no spills, 73,728 bytes of shared memory a block, two
// blocks to an SM.
// Design, K15 and K13 f32: the f32 K4's kernel with the kv source as a
// template mode (LN + projection, projection only, or k/v read directly),
// so they share the tiles, the split over blocks and the merge pass. The
// dtype picks K15's route (`tc_route`): bf16 runs the tensor-core
// kernels, f32 attn_flash_kernel's KV_PROJ mode.
// The dtype picks K5's kernel too (`tc_route`): bf16 runs
// `tc::attn_small_tc_kernel`, f32 attn_small_kernel<float> on the CUDA
// cores, for the same TF32 reason.
// Design, K5 bf16: K14's numerics (p normalised before P.V) on K13's
// packed layout and warp-level tiles. One block of 4 warps per (head,
// cloud, 64 query rows: 16 a warp); the (cloud, head)'s whole k and v
// (M < 512: 9,216 B a 64-token tile each) are staged once in shared
// memory by cp_rows as K13 loads them, one cp.async group a tile (q with
// the first k tile, the other k tiles, then v), so that the scores start
// on a tile as soon as it lands and device memory is read once per block.
// Up to M = 128 a warp keeps its 16 x M logits in registers (64 f32 a
// lane): one warp_scores pass, the exact row max, p = 2^(t - max) and its
// sum, p / sum rounded to bf16 in registers as P.V's A fragments, and
// warp_pv: half the score products and exps of two passes, at the main
// paths' M = 128. Above 128 keys, K14's two passes over shared memory:
// the running max and sum, then the same scores again, p normalised, P.V.
// 64 query rows a block was the fastest shape measured at every main
// path's G = 128 (16 and 32 rows were slower, 128 too); at the main paths'
// batches it gives at least 256 blocks, more than one for each of 132 SMs.
// Keys past M get -inf and zero-filled k/v rows; query rows past G are
// computed from zero rows and not written. Per -Xptxas -v on the card
// (sm_90a): 119-128 registers, no spills.
// The dtype picks K6's kernel too (`tc_route`): bf16 runs
// `tc::attn_small_qkv_ln_tc_kernel`, f32 attn_small_qkv_ln_kernel<float>.
// Design, K6 bf16: one block per (head, cloud), so that the grid has H x B
// blocks (1,320 at the ft_cls eval's B = 330, ten for each of 132 SMs,
// two resident) and each block's q, k and v stay on chip from the
// projection to the attention. The block streams Din in chunks of 32
// columns through a 3-stage cp.async ring (raw x rows and the head's
// [32, 64] slices of wq, wk and wv), normalises each landed chunk in place
// to bf16 with the row statistics it computed while the first chunks
// landed (x is read once for them and once for the products: H + H
// reads of each cloud's x, from L2 after the first), and accumulates the
// head's [G, 192] of q|k|v on mma.sync (8 warps of 32 rows x 96 columns
// at G <= 128). The chunks stream so that no Din needs all of x on chip
// (G = 178 rows at Din = 1024 would be 365 KB); q, k and v, rounded to
// bf16, then take the ring's place, and K5's warp_small_attention runs on
// them: scores in registers up to 128 keys, two passes above (G <= 192,
// 12 warps). Rows past G are zero rows: their keys are masked, their
// queries not written. One block per cloud would compute the statistics
// once, but gives 330 blocks for 132 SMs (2.5 waves of one block an SM,
// 1.25 of two) and loops over the heads anyway, since [G, 3D] of f32
// accumulators do not fit one block's registers: measured on the H100,
// it took 1.7 times as long at B = 330 (PERF.md).
// Design, K5 f32: one block per (cloud, head), two threads per query row,
// each holding half of the row's dh accumulators (columns interleaved to
// spread shared-memory banks; rows padded to dh+1 floats for the same
// reason).
// Numerics follow the Pallas kernels: LN in f32 with the fast variance and
// eps 1e-5, cast to the compute dtype; k/v = f32-accumulated projections
// rounded to the compute dtype; logits in f32; p cast to v's dtype before
// PV; f32 accumulation. The f32 routes of K4, K5, K6, K13 and K15 run
// plain CUDA-core FMAs.
#include "common.cuh"
#include "kv_tile.cuh"
#include "mma.cuh"

namespace {

constexpr int DH = 64;       // head width supported by these kernels
constexpr int LDH = DH + 1;  // padded shared-memory row stride
constexpr int MC = 32;       // kv tokens per chunk (K4)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------- K4, K13, K15 (online softmax over kv chunks)
// Layout of the block's shared memory (f32, row strides padded by 4 to keep
// float4 alignment while spreading banks):
//   xsT [din][MC+4]  normalised chunk, transposed (token fastest)
//   kT  [DH][MC+4]   this head's k columns of the chunk, transposed
//   vs  [MC][DH+4]   this head's v columns of the chunk
//   qT  [DH][QT+4]   this block's query rows, transposed
//   pT  [MC][QT+4]   p of the chunk in v's dtype, transposed
// Thread t owns query rows rq0 = 4*(t/8) .. +3 in every phase, so the
// online-softmax state of its rows stays in registers.
constexpr int QT = 128;       // query rows per block
constexpr int K4_THREADS = 256;
constexpr int LDC = MC + 4, LDV = DH + 4, LDQ = QT + 4;

__device__ __forceinline__ void load4(const float* w, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* w, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(w);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Where a chunk's k and v come from: KV_LN (K4) LayerNorms the raw tokens
// x and projects them with wk / wv; KV_PROJ (K15) projects x as it is;
// KV_DIRECT (K13) reads k and v [B, M, H*64] straight from device memory.
enum KvMode { KV_LN = 0, KV_PROJ = 1, KV_DIRECT = 2 };

template <typename T>
struct KvSource {
  const T* x;                      // [B, M, Din] raw tokens (KV_LN, KV_PROJ)
  const float* ln_w;               // [Din] f32 (KV_LN)
  const float* ln_b;
  const T* wk;                     // [Din, H*64] (KV_LN, KV_PROJ)
  const T* wv;
  const T* k;                      // [B, M, H*64] (KV_DIRECT)
  const T* v;
  int din;                         // 0 for KV_DIRECT
};

// The kv source arrives as separate __restrict__ parameters (not the
// struct), so the weight and token loads keep the read-only data path.
template <typename T, int MODE>
__global__ void __launch_bounds__(K4_THREADS)
attn_flash_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const T* __restrict__ wk, const T* __restrict__ wv,
                  const T* __restrict__ kin, const T* __restrict__ vin, T* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int g, int m,
                  int din, int h, int nsplit, int cps, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;  // absent (din = 0) in KV_DIRECT
  float* kT = xsT + (size_t)din * LDC;
  float* vs = kT + DH * LDC;
  float* qT = vs + MC * LDV;
  float* pT = qT + DH * LDQ;

  const int b = blockIdx.y, head = blockIdx.x;
  const int split = blockIdx.z % nsplit, q0 = (blockIdx.z / nsplit) * QT;
  const int m_begin = split * cps * MC, m_end = min(m, (split + 1) * cps * MC);
  // tokens past m_end (the ragged tail of the last chunk) are masked out
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = K4_THREADS / 32;
  const int d = h * DH;
  const T* xb = MODE == KV_DIRECT ? nullptr : x + (size_t)b * m * din;

  for (int e = tid; e < QT * DH; e += K4_THREADS) {
    const int r = e / DH, c = e - r * DH;
    qT[c * LDQ + r] = (q0 + r < g)
        ? vpt::to_f32(q[((size_t)b * g + q0 + r) * d + head * DH + c]) : 0.f;
  }

  const int rq0 = 4 * (tid >> 3);   // this thread's 4 query rows
  const int sub = tid & 7;          // its place in the 8-lane row group
  float acc[4][8];                  // PV accumulators: rows rq0.., cols 8*sub..
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += MC) {
    if constexpr (MODE == KV_DIRECT) {
      // (a') this head's k and v columns of the chunk, straight from memory;
      // the barrier keeps them from overwriting what (d) of the previous
      // chunk still reads
      __syncthreads();
      for (int e = tid; e < MC * DH; e += K4_THREADS) {
        const int r = e / DH, c = e - r * DH;
        float kv = 0.f, vv = 0.f;
        if (m0 + r < m_end) {
          const size_t off = ((size_t)b * m + m0 + r) * d + head * DH + c;
          kv = vpt::to_f32(kin[off]);
          vv = vpt::to_f32(vin[off]);
        }
        kT[c * LDC + r] = kv;
        vs[r * LDV + c] = vv;
      }
      __syncthreads();
    } else {
      if constexpr (MODE == KV_PROJ) {
        // (a) the raw chunk as it is, transposed
        for (int e = tid; e < MC * din; e += K4_THREADS) {
          const int r = e / din, c = e - r * din;
          xsT[c * LDC + r] =
              (m0 + r < m_end) ? vpt::to_f32(xb[(size_t)(m0 + r) * din + c]) : 0.f;
        }
      } else {
        // (a) LayerNorm of the raw chunk, one warp per token
        for (int r = warp; r < MC; r += nwarps) {
          if (m0 + r >= m_end) {
            for (int c = lane; c < din; c += 32) xsT[c * LDC + r] = 0.f;
            continue;
          }
          const T* xr = xb + (size_t)(m0 + r) * din;
          float s1 = 0.f, s2 = 0.f;
          for (int c = lane; c < din; c += 32) {
            const float v = vpt::to_f32(xr[c]);
            s1 += v;
            s2 += v * v;
          }
          s1 = warp_sum(s1);
          s2 = warp_sum(s2);
          const float mu = s1 / din, mu2 = s2 / din;
          const float var = fmaxf(0.f, mu2 - mu * mu);
          const float rs = rsqrtf(var + vpt::LN_EPS);
          for (int c = lane; c < din; c += 32) {
            const float v = vpt::to_f32(xr[c]);
            xsT[c * LDC + r] = vpt::round_to<T>((v - mu) * (rs * ln_w[c]) + ln_b[c]);
          }
        }
      }
      __syncthreads();
      // (b) k and v of the chunk for this head: [MC rows] x [2*DH cols]; a
      //     thread owns 4 tokens x 4 columns (lanes 0-15 k, 16-31 v), each
      //     rounded to T as the Dense it replaces emits it
      const int cg = tid & 31, r0 = 4 * (tid >> 5);
      const int sel = cg >> 4, c0 = 4 * (cg & 15);
      const T* w = (sel ? wv : wk) + head * DH + c0;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < din; ++kk) {
        float wq[4];
        load4(w + (size_t)kk * d, wq);
        const float4 xv = ld4(xsT + kk * LDC + r0);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xr[i], wq[j], a[i][j]);
      }
      if (sel == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(kT + (c0 + j) * LDC + r0) = make_float4(
              vpt::round_to<T>(a[0][j]), vpt::round_to<T>(a[1][j]),
              vpt::round_to<T>(a[2][j]), vpt::round_to<T>(a[3][j]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(vs + (r0 + i) * LDV + c0) = make_float4(
              vpt::round_to<T>(a[i][0]), vpt::round_to<T>(a[i][1]),
              vpt::round_to<T>(a[i][2]), vpt::round_to<T>(a[i][3]));
      }
      __syncthreads();
    }
    // (c) logits of rows rq0.. x tokens 4*sub.., online softmax update
    float corr[4];
    {
      const int j0 = 4 * sub;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c) {
        const float4 qv = ld4(qT + c * LDQ + rq0);
        const float4 kv = ld4(kT + c * LDC + j0);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
        const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qr[i], kr[j], sc[i][j]);
      }
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cm = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = (m0 + j0 + j < m_end) ? sc[i][j] * scale : -CUDART_INF_F;
          cm = fmaxf(cm, sc[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
        const float m_new = fmaxf(m_run[i], cm);
        corr[i] = expf(m_run[i] - m_new);  // 0 on the first chunk
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(sc[i][j] - m_new);
          ps += p;
          pr[i][j] = vpt::round_to<T>(p);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[i] = l_run[i] * corr[i] + ps;
        m_run[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pT + (j0 + j) * LDQ + rq0) =
            make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
    }
    __syncthreads();
    // (d) acc = acc * corr + p @ v for rows rq0.. x columns 8*sub..
    {
      const int c0 = 8 * sub;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= corr[i];
#pragma unroll 4
      for (int j = 0; j < MC; ++j) {
        const float4 pv = ld4(pT + j * LDQ + rq0);
        const float4 va = ld4(vs + j * LDV + c0), vb = ld4(vs + j * LDV + c0 + 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float vr[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
      }
    }
    // the next chunk's LayerNorm (or copy) writes only xsT, which (d) does
    // not read; its projection writes kT/vs after the barrier that follows
    // it (KV_DIRECT has its own barrier in front of its loads)
  }
  const int c0 = 8 * sub;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rq0 + i;
    if (r >= g) continue;
    if (nsplit == 1) {
      T* o = out + ((size_t)b * g + r) * d + head * DH + c0;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = vpt::from_f32<T>(acc[i][c] / l_run[i]);
    } else {  // this split's unnormalised state, for attn_combine_kernel
      const size_t row = (((size_t)b * h + head) * nsplit + split) * g + r;
      float* pa = part_acc + row * DH + c0;
#pragma unroll
      for (int c = 0; c < 8; ++c) pa[c] = acc[i][c];
      if (sub == 0) {
        part_ml[2 * row] = m_run[i];
        part_ml[2 * row + 1] = l_run[i];
      }
    }
  }
}

// The merge pass of the split states (K4, K13, K15) is kv_tile.cuh's
// attn_combine_kernel.
using vpt_kvln::attn_combine_kernel;

// ------------------------------------------- K13, bf16, on the tensor cores
namespace tc {

using vpt::mma::bf16;
using vpt::mma::KT;
using vpt::mma::NT;
constexpr int MT = 2;         // row tiles of 16 a warp
constexpr int WARPS = 4;
constexpr int QT = WARPS * MT * 16;  // query rows a block: 128
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;     // k/v tiles in flight
constexpr int LD = DH + 8;    // padded shared row (bf16)
constexpr size_t SMEM = sizeof(bf16) * (size_t)(QT + 2 * STAGES * KT) * LD;

// One block per (head, cloud, 128 query rows x kv split): the split's
// 64-token tiles [t_begin, t_end) stream through the ring; with
// nsplit > 1 the block writes its unnormalised state for
// attn_combine_kernel, else the output.
__global__ void __launch_bounds__(THREADS, 2)
attn_packed_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ part_acc, float* __restrict__ part_ml, int g, int m,
                      int h, int nsplit, int tps, float scale) {
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QT][LD]
  bf16* ks = qs + QT * LD;                       // [STAGES][KT][LD]
  bf16* vs = ks + STAGES * KT * LD;              // [STAGES][KT][LD]
  const int b = blockIdx.y, head = blockIdx.x;
  const int split = blockIdx.z % nsplit, q0 = (blockIdx.z / nsplit) * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (m + KT - 1) / KT;
  const int t_begin = split * tps, t_end = min(nt, t_begin + tps);
  const int m_end = min(m, t_end * KT);  // a tile boundary but for the last split
  const int d = h * DH;
  const bf16* kb = k + (size_t)b * m * d + head * DH;
  const bf16* vb = v + (size_t)b * m * d + head * DH;
  auto load = [&](int t) {
    const int slot = (t - t_begin) % STAGES;
    mm::cp_rows<DH, KT, THREADS>(ks + slot * KT * LD, LD, kb, d, t * KT, m_end, tid);
    mm::cp_rows<DH, KT, THREADS>(vs + slot * KT * LD, LD, vb, d, t * KT, m_end, tid);
  };
  // group 0: q and the first tile; then one group a tile
  mm::cp_rows<DH, QT, THREADS>(qs, LD, q + (size_t)b * g * d + head * DH, d, q0, g, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_begin + st < t_end) load(t_begin + st);
    mm::cp_async_commit();
  }

  const int row0 = warp * MT * 16;  // the warp's first row in the block
  const bool active = q0 + row0 < g;
  const float c = scale * mm::LOG2E;  // logits (and mx) in log2 units
  uint32_t qa[MT][DH / 16][4];
  float mx[MT][2], sum[MT][2], o[MT][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mx[mt][0] = mx[mt][1] = -CUDART_INF_F;
    sum[mt][0] = sum[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    mm::cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; and tile t - 1 is consumed
    if (t + STAGES - 1 < t_end) load(t + STAGES - 1);
    mm::cp_async_commit();
    if (!active) continue;
    if (t == t_begin) mm::warp_a_frags<DH, MT>(qa, qs, LD, row0, lane);
    const int slot = (t - t_begin) % STAGES;
    float s[MT][NT][4];
    mm::warp_scores<DH, MT>(s, qa, ks + slot * KT * LD, LD, lane);
    // the online softmax of _packed_kernel: m_new, corr = exp(m - m_new),
    // p = exp(s - m_new) in f32, l = l * corr + sum(p) over the unrounded
    // p, acc = acc * corr + bf16(p) . v (exp as 2^ of the log2 units)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mm::scale_and_mask(s[mt], c, t * KT, m_end, lane);
    mm::online_softmax_tile<MT, DH>(s, mx, sum, o);
    uint32_t pa[MT][KT / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mm::p_frags(pa[mt], s[mt]);
    mm::warp_pv<DH, MT>(o, pa, vs + slot * KT * LD, LD, lane);
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * mt + 8 * r + (lane >> 2);
      const float l = mm::quad_sum(sum[mt][r]);  // all lanes take part: before the row test
      if (row >= g) continue;
      if (nsplit == 1) {
        bf16* orow = out + ((size_t)b * g + row) * d + head * DH + c0;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) =
              mm::pack_bf16x2(o[mt][n][2 * r] / l, o[mt][n][2 * r + 1] / l);
      } else {  // this split's unnormalised state, for attn_combine_kernel
        const size_t prow = (((size_t)b * h + head) * nsplit + split) * g + row;
        float* acc = part_acc + prow * DH + c0;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<float2*>(acc + 8 * n) =
              make_float2(o[mt][n][2 * r], o[mt][n][2 * r + 1]);
        if ((lane & 3) == 0) {
          part_ml[2 * prow] = mx[mt][r] * mm::LN2;  // the merge pass takes natural units
          part_ml[2 * prow + 1] = l;
        }
      }
    }
}

int launch_packed(const void* q, const void* k, const void* v, void* out, void* part_acc,
                  void* part_ml, int b, int g, int m, int h, int nsplit, float scale,
                  cudaStream_t stream) {
  const int nt = (m + KT - 1) / KT;
  if (b < 1 || g < 1 || h < 1 || m < 1 || nsplit < 1 || nsplit > nt)
    return (int)cudaErrorInvalidValue;
  const int tps = (nt + nsplit - 1) / nsplit;  // tiles per split
  if ((nsplit - 1) * tps >= nt) return (int)cudaErrorInvalidValue;  // no empty split
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_packed_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(h, b, ((g + QT - 1) / QT) * nsplit);
  attn_packed_tc_kernel<<<grid, THREADS, SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)part_acc,
      (float*)part_ml, g, m, h, nsplit, tps, scale);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_combine_kernel<bf16><<<b * g, 256, 0, stream>>>(
        (const float*)part_acc, (const float*)part_ml, (bf16*)out, g, h, nsplit, nullptr);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------- K5 and K6's attention phase
// One warp's attention over a (cloud, head)'s whole key axis in shared
// memory, with p normalised before P.V, as _packed_small_kernel does:
// the warp's 16 query rows at qs, nt 64-key tiles of k and v at ks and vs
// (rows LD apart), keys at or past m masked, c = scale * log2(e) (logits
// in log2 units); o gets the 16 output rows in f32. With NTR > 0 (m <=
// 64 NTR) the warp keeps its 16 x m scores in registers: one pass of
// warp_scores, the exact row max, p = 2^(t - max) and its sum, p / sum
// rounded to bf16 as P.V's A fragments. With NTR = 0 (any m) K14's two
// passes: the running max and sum over the k tiles, then the same scores
// again, p normalised, P.V. With STAGED, k and v are still landing in
// K5's cp.async groups (q with k tile 0 in group 0, k tile t in group t,
// v tile t in group nt + t) and each tile is waited for before its first
// use, behind a barrier: then every thread of the block calls this.
template <int NTR, bool STAGED>
__device__ __forceinline__ void warp_small_attention(float (&o)[1][DH / 8][4], const bf16* qs,
                                                     const bf16* ks, const bf16* vs, int nt,
                                                     int m, float c, bool active, int lane) {
  namespace mm = vpt::mma;
  uint32_t qa[1][DH / 16][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.0f;
  if constexpr (NTR > 0) {
    float s[NTR][1][NT][4];  // the warp's 16 x m scores, then p
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int t = 0; t < NTR; ++t) {
      if (STAGED && t < nt) {
        mm::cp_async_wait_n(2 * nt - 1 - t);  // k tile t has landed (this thread's copies)
        __syncthreads();                      // ... everyone's
      }
      if (!active || t >= nt) continue;
      if (t == 0) mm::warp_a_frags<DH, 1>(qa, qs, LD, 0, lane);
      mm::warp_scores<DH, 1>(s[t], qa, ks + t * KT * LD, LD, lane);
      mm::scale_and_mask(s[t][0], c, t * KT, m, lane);
      float tm[2];
      mm::tile_max(s[t][0], tm);
      mx[0] = fmaxf(mx[0], tm[0]);
      mx[1] = fmaxf(mx[1], tm[1]);
    }
    uint32_t pa[NTR][1][KT / 16][4];
    if (active) {
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < NTR; ++t)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // 2^-inf = 0 past m (and in a tile past nt)
            s[t][0][n][e] = t < nt ? mm::exp2_approx(s[t][0][n][e] - mx[e >> 1]) : 0.0f;
            sum[e >> 1] += s[t][0][n][e];
          }
      const float inv[2] = {1.0f / mm::quad_sum(sum[0]), 1.0f / mm::quad_sum(sum[1])};
#pragma unroll
      for (int t = 0; t < NTR; ++t) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][0][n][e] *= inv[e >> 1];  // p
        mm::p_frags(pa[t][0], s[t][0]);
      }
    }
#pragma unroll
    for (int t = 0; t < NTR; ++t) {
      if (t >= nt) break;
      if (STAGED) {
        mm::cp_async_wait_n(nt - 1 - t);  // v tile t has landed (this thread's copies)
        __syncthreads();                  // ... everyone's
      }
      if (active) mm::warp_pv<DH, 1>(o, pa[t], vs + t * KT * LD, LD, lane);
    }
  } else {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.0f, 0.0f};
    for (int t = 0; t < nt; ++t) {  // pass 1: running max, this lane's share of the sum
      if (STAGED) {
        mm::cp_async_wait_n(2 * nt - 1 - t);  // k tile t has landed (this thread's copies)
        __syncthreads();                      // ... everyone's
      }
      if (!active) continue;
      if (t == 0) mm::warp_a_frags<DH, 1>(qa, qs, LD, 0, lane);
      float s[1][NT][4];
      mm::warp_scores<DH, 1>(s, qa, ks + t * KT * LD, LD, lane);
      mm::scale_and_mask(s[0], c, t * KT, m, lane);
      float tm[2];
      mm::tile_max(s[0], tm);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float nm = fmaxf(mx[r], tm[r]);
        float ps = 0.0f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ps += mm::exp2_approx(s[0][n][2 * r] - nm) + mm::exp2_approx(s[0][n][2 * r + 1] - nm);
        sum[r] = sum[r] * mm::exp2_approx(mx[r] - nm) + ps;  // 2^-inf = 0 on the first tile
        mx[r] = nm;
      }
    }
    float inv[2] = {0.0f, 0.0f};
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.0f / mm::quad_sum(sum[r]);
    }
    for (int t = 0; t < nt; ++t) {  // pass 2: the same scores, p normalised, P.V
      if (STAGED) {
        mm::cp_async_wait_n(nt - 1 - t);  // v tile t has landed (this thread's copies)
        __syncthreads();                  // ... everyone's
      }
      if (!active) continue;
      float s[1][NT][4];
      uint32_t pa[1][KT / 16][4];
      mm::warp_scores<DH, 1>(s, qa, ks + t * KT * LD, LD, lane);
      mm::scale_and_mask(s[0], c, t * KT, m, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][n][e] = mm::exp2_approx(s[0][n][e] - mx[e >> 1]) * inv[e >> 1];  // p
      mm::p_frags(pa[0], s[0]);
      mm::warp_pv<DH, 1>(o, pa, vs + t * KT * LD, LD, lane);
    }
  }
}

// The warp's 16 output rows from row0 of a (cloud, head) with g rows: o
// rounded to bf16 into ob (the cloud's first row at its head's columns,
// rows d apart); rows at or past g are not written.
__device__ __forceinline__ void store_rows(bf16* ob, const float (&o)[1][DH / 8][4], int row0,
                                           int g, int d, int lane) {
  ob += 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r + (lane >> 2);
    if (row >= g) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * d + 8 * n) =
          vpt::mma::pack_bf16x2(o[0][n][2 * r], o[0][n][2 * r + 1]);
  }
}

// ------------------------------------------- K5, bf16, on the tensor cores
// One block of SMALL_NW warps per (head, cloud, 64 query rows); a warp
// owns 16 rows. The (cloud, head)'s whole k and v (M < 512 rows of 64) are
// staged once in shared memory, one cp.async group a 64-key tile: q with
// k tile 0, then each k tile, then each v tile, so that the scores start
// on tile 0 while the rest land; warp_small_attention then keeps the
// scores in registers up to 128 keys (NTR = 2), else takes two passes.
constexpr int SMALL_NW = 4;  // warps a block: 64 query rows

constexpr size_t small_smem_bytes(int m) {
  return sizeof(bf16) * (size_t)(16 * SMALL_NW + 2 * ((m + KT - 1) / KT) * KT) * LD;
}

template <int NTR>
__global__ void __launch_bounds__(SMALL_NW * 32, 4)
attn_small_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int g, int m, int h,
                     float scale) {
  namespace mm = vpt::mma;
  constexpr int ROWS = 16 * SMALL_NW, NTHREADS = 32 * SMALL_NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = (m + KT - 1) / KT;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                     // [nt * KT][LD]
  bf16* vs = ks + nt * KT * LD;                  // [nt * KT][LD]
  const int head = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = h * DH;
  const bf16* kb = k + (size_t)b * m * d + head * DH;
  const bf16* vb = v + (size_t)b * m * d + head * DH;
  // groups 0 .. nt - 1: q with k tile 0, then k tiles; nt .. 2 nt - 1: v tiles
  mm::cp_rows<DH, ROWS, NTHREADS>(qs, LD, q + (size_t)b * g * d + head * DH, d, q0, g, tid);
  for (int t = 0; t < nt; ++t) {
    mm::cp_rows<DH, KT, NTHREADS>(ks + t * KT * LD, LD, kb, d, t * KT, m, tid);
    mm::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    mm::cp_rows<DH, KT, NTHREADS>(vs + t * KT * LD, LD, vb, d, t * KT, m, tid);
    mm::cp_async_commit();
  }
  const bool active = q0 + 16 * warp < g;
  float o[1][DH / 8][4];
  warp_small_attention<NTR, true>(o, qs + 16 * warp * LD, ks, vs, nt, m, scale * mm::LOG2E,
                                  active, lane);
  if (active)
    store_rows(out + (size_t)b * g * d + head * DH, o, q0 + 16 * warp, g, d, lane);
}

// scores in registers up to 128 keys (two 64-key tiles), else two passes
int launch_small(const void* q, const void* k, const void* v, void* out, int b, int g, int m,
                 int h, float scale, cudaStream_t stream) {
  if (b < 1 || g < 1 || h < 1 || m < 1 || m > 512) return (int)cudaErrorInvalidValue;
  auto kernel = m <= 2 * KT ? attn_small_tc_kernel<2> : attn_small_tc_kernel<0>;
  const size_t smem = small_smem_bytes(m);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(h, b, (g + 16 * SMALL_NW - 1) / (16 * SMALL_NW));
  kernel<<<grid, SMALL_NW * 32, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (bf16*)out, g, m, h, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------- K6, bf16, on the tensor cores
// One block per (head, cloud), the whole cloud's G rows in one block: 128
// rows (8 warps) with the scores in registers (G <= 128, NTR = 2), 192
// rows (12 warps) with K14's two passes (G <= 192, NTR = 0). Three phases:
//  (a) while the first chunks land, the LayerNorm statistics of the G raw
//      rows, one warp a row, eight rows of a warp at once (16-byte loads,
//      eight in flight a lane): f32, the fast variance
//      max(0, E[x^2] - E[x]^2);
//  (b) the head's q, k and v columns ([G, 3 x 64] of LN(x) . [wq|wk|wv]):
//      Din streams in chunks of QKV_KC columns through a ring of
//      QKV_STAGES, each chunk one cp.async group of the raw x rows (rows
//      past G zero-filled) and of the three weights' [QKV_KC, 64] slices.
//      A landed chunk of x is normalised in place to bf16 (a column pair
//      a thread, so that few registers stay live beside the accumulators),
//      then warp (rg, ch) accumulates rows 32 rg.. by columns 96 ch.. of
//      [q|k|v] in f32 on mma.sync (warp_ab: x through ldmatrix, the
//      weights through ldmatrix.trans), two chunks of loads in flight
//      behind it;
//  (c) q, k and v rounded to bf16 into shared memory over the ring, then
//      warp_small_attention: a warp's 16 query rows against all G keys.
// Shared memory: 2 x 128 f32 statistics and the ring, 70,144 bytes at
// G <= 128 (86,016 at G <= 192), whatever Din: at most three blocks an SM
// (the 128 registers of two blocks of 8 warps set two).
constexpr int QKV_KC = 32;               // Din columns a chunk: two k16 steps
constexpr int QKV_STAGES = 3;            // chunks in flight
constexpr int QKV_LDX = QKV_KC + 8;      // padded row of a chunk of x (bf16)
constexpr int QKV_LDW = 3 * DH + 8;      // padded row of a chunk of [wq|wk|wv] (bf16)
constexpr int QKV_STAT_ROWS = 8;         // rows a warp's statistics take at once

// rows a block of the score mode NTR covers: a warp for each 16
__host__ __device__ constexpr int qkv_rows(int ntr) { return ntr > 0 ? KT * ntr : 3 * KT; }
__host__ __device__ constexpr int qkv_slot(int rows) {  // bf16 elements
  return rows * QKV_LDX + QKV_KC * QKV_LDW;
}
constexpr size_t qkv_smem_bytes(int rows) {
  return sizeof(float) * 2 * rows + sizeof(bf16) * (size_t)QKV_STAGES * qkv_slot(rows);
}
static_assert(3 * qkv_rows(2) * LD <= QKV_STAGES * qkv_slot(qkv_rows(2)) &&
                  3 * qkv_rows(0) * LD <= QKV_STAGES * qkv_slot(qkv_rows(0)),
              "q, k and v fit over the ring");

template <int NTR>
__global__ void __launch_bounds__(2 * qkv_rows(NTR), NTR > 0 ? 2 : 1)
attn_small_qkv_ln_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const bf16* __restrict__ wq,
                            const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                            bf16* __restrict__ out, int g, int din, int h, float scale) {
  namespace mm = vpt::mma;
  constexpr int ROWS = qkv_rows(NTR), NW = ROWS / 16, NTHREADS = 32 * NW;
  constexpr int SLOT = qkv_slot(ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mus = reinterpret_cast<float*>(smem_raw);  // [ROWS] row means
  float* rss = mus + ROWS;                          // [ROWS] row 1/std
  bf16* ring = reinterpret_cast<bf16*>(rss + ROWS);  // [STAGES][ROWS x LDX | KC x LDW]
  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = h * DH, nc = din / QKV_KC;
  const bf16* xb = x + (size_t)b * g * din;
  auto load = [&](int c) {  // chunk c: columns k0.. of x and rows k0.. of the weights
    bf16* xs = ring + (c % QKV_STAGES) * SLOT;
    bf16* ws = xs + ROWS * QKV_LDX;
    const size_t k0 = (size_t)c * QKV_KC;
    mm::cp_rows<QKV_KC, ROWS, NTHREADS>(xs, QKV_LDX, xb + k0, din, 0, g, tid);
    mm::cp_rows<DH, QKV_KC, NTHREADS>(ws, QKV_LDW, wq + k0 * d + head * DH, d, 0, QKV_KC, tid);
    mm::cp_rows<DH, QKV_KC, NTHREADS>(ws + DH, QKV_LDW, wk + k0 * d + head * DH, d, 0, QKV_KC,
                                      tid);
    mm::cp_rows<DH, QKV_KC, NTHREADS>(ws + 2 * DH, QKV_LDW, wv + k0 * d + head * DH, d, 0,
                                      QKV_KC, tid);
  };
#pragma unroll
  for (int st = 0; st < QKV_STAGES - 1; ++st) {
    if (st < nc) load(st);
    mm::cp_async_commit();
  }

  // (a) row statistics, f32: mean and max(0, E[x^2] - E[x]^2); a warp
  // takes QKV_STAT_ROWS of its rows at once, so that as many 16-byte loads
  // a lane are in flight
  for (int r0 = warp; r0 < g; r0 += QKV_STAT_ROWS * NW) {
    float s1[QKV_STAT_ROWS], s2[QKV_STAT_ROWS];
#pragma unroll
    for (int i = 0; i < QKV_STAT_ROWS; ++i) s1[i] = s2[i] = 0.f;
    for (int c8 = lane; c8 < din / 8; c8 += 32) {
      uint4 u[QKV_STAT_ROWS];
#pragma unroll
      for (int i = 0; i < QKV_STAT_ROWS; ++i) {
        const int r = r0 + i * NW;
        u[i] = r < g ? *reinterpret_cast<const uint4*>(xb + (size_t)r * din + 8 * c8)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < QKV_STAT_ROWS; ++i) {
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          s1[i] += f.x + f.y;
          s2[i] += f.x * f.x + f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QKV_STAT_ROWS; ++i) {
      const int r = r0 + i * NW;
      const float t1 = warp_sum(s1[i]), t2 = warp_sum(s2[i]);
      if (lane == 0 && r < g) {
        const float mu = t1 / din, mu2 = t2 / din;
        mus[r] = mu;
        rss[r] = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
      }
    }
  }

  // (b) [q|k|v] = LN(x) . [wq|wk|wv] of this head, f32 accumulators
  const int rg = warp >> 1, ch = warp & 1;  // rows 32 rg.., columns 96 ch..
  const bool busy = 32 * rg < g;
  const int cp = tid % (QKV_KC / 2);  // the column pair of a chunk this thread normalises
  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int c = 0; c < nc; ++c) {
    mm::cp_async_wait<QKV_STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();  // ... everyone's; chunk c - 1's products are done; the statistics are in
    if (c + QKV_STAGES - 1 < nc) load(c + QKV_STAGES - 1);
    mm::cp_async_commit();
    bf16* xs = ring + (c % QKV_STAGES) * SLOT;
    {  // LN(x) of the chunk in place, rounded to bf16 (rows past G stay 0);
       // few registers beside the 96 accumulators: a column pair a thread
      const int col = c * QKV_KC + 2 * cp;
      const float2 w = *reinterpret_cast<const float2*>(ln_w + col);
      const float2 bb = *reinterpret_cast<const float2*>(ln_b + col);
      for (int r = tid / (QKV_KC / 2); r < g; r += NTHREADS / (QKV_KC / 2)) {
        uint32_t* e = reinterpret_cast<uint32_t*>(xs + r * QKV_LDX + 2 * cp);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e));
        const float mu = mus[r], rs = rss[r];
        // (x - mu) * (rs * w) + b, each step rounded as the plain twin's
        *e = mm::pack_bf16x2(__fadd_rn(__fmul_rn(f.x - mu, __fmul_rn(rs, w.x)), bb.x),
                             __fadd_rn(__fmul_rn(f.y - mu, __fmul_rn(rs, w.y)), bb.y));
      }
    }
    __syncthreads();  // the chunk is normalised
    if (busy)
      mm::warp_ab<2, 12>(acc, xs + 32 * rg * QKV_LDX, QKV_LDX, xs + ROWS * QKV_LDX + 96 * ch,
                         QKV_LDW, QKV_KC, lane);
  }
  mm::cp_async_wait<0>();
  __syncthreads();  // every product is done: the ring becomes q, k and v [3][ROWS][LD]

  // (c) q, k, v rounded to bf16 (rows past G from zero rows: finite), then
  // the attention of each warp's 16 query rows
  bf16* qkv = ring;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = 96 * ch + 8 * j;  // an n8 tile never straddles q, k and v
    bf16* dst = qkv + (col / DH) * ROWS * LD + col % DH + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dst + (32 * rg + 16 * i + 8 * r + (lane >> 2)) * LD) =
            mm::pack_bf16x2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
  }
  __syncthreads();
  const bool active = 16 * warp < g;
  float o[1][DH / 8][4];
  warp_small_attention<NTR, false>(o, qkv + 16 * warp * LD, qkv + ROWS * LD,
                                   qkv + 2 * ROWS * LD, (g + KT - 1) / KT, g,
                                   scale * mm::LOG2E, active, lane);
  if (active) store_rows(out + (size_t)b * g * d + head * DH, o, 16 * warp, g, d, lane);
}

// scores in registers up to 128 rows, else two passes; Din a multiple of
// QKV_KC
int launch_small_qkv_ln(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                        const void* wk, const void* wv, void* out, int b, int g, int din, int h,
                        float scale, cudaStream_t stream) {
  if (b < 1 || g < 1 || h < 1 || din < QKV_KC || din % QKV_KC || g > qkv_rows(0))
    return (int)cudaErrorInvalidValue;
  const int ntr = g <= qkv_rows(2) ? 2 : 0;
  auto kernel = ntr ? attn_small_qkv_ln_tc_kernel<2> : attn_small_qkv_ln_tc_kernel<0>;
  const int rows = qkv_rows(ntr);
  const size_t smem = qkv_smem_bytes(rows);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3(h, b), 2 * rows, smem, stream>>>(
      (const bf16*)x, (const float*)ln_w, (const float*)ln_b, (const bf16*)wq, (const bf16*)wk,
      (const bf16*)wv, (bf16*)out, g, din, h, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------- K4, bf16, on the tensor cores
// ln_xn_kernel normalises the kv tokens once: xn = LN(x) in bf16 (f32
// statistics, the fast variance, each step rounded as layer_norm_f32),
// written to device memory. Then, up to 128 query rows (every path's G
// but the Perceiver's 512 latents), one block of 8 warps per (head,
// cloud, kv split) walks the split's 64-token tiles: each tile of xn is
// projected onto this head's k|v [64, 128] on mma.sync (warp (rg, cg):
// tokens 32 rg.., columns 32 cg.., so warps 0-1 and 4-5 project k, the
// others v), rounded to bf16 into shared memory, and each warp runs K13's
// online softmax over them for its 16 query rows (q held in registers as
// A fragments; scores, p rounded in registers, P.V). k and v never reach
// device memory.
// What bounds it: the projection, two thirds of the products, and its
// operands from L2 (xn once per head, the weights once per block). xn is
// written once because normalising inside the blocks, redone by each of
// the H heads' blocks on the CUDA cores, measured half the kernel's time
// (0.106 of 0.209 ms at [64, 128] x [64, 1,024, 256]; PERF.md), more than
// writing xn and reading it back (33.5 MB each way there, 0.02 ms at 3.35
// TB/s). The tile kernel keeps the head's [wk|wv] slice in shared memory
// for the block and copies a whole tile of xn at a time, then runs the
// projection's Din / 16 k steps with no barrier among them and writes the
// tile's k|v over it: up to Din = KVLN_TILE_DIN (the flagship's 256) in
// one tile buffer, two blocks an SM (103,424 B), so that one block's copy
// overlaps the other's products; up to KVLN_TILE_DB_DIN (partseg's and
// semseg's 384) in two, one block an SM (204,800 B), the next tile's copy
// in flight during a tile's products (15% and 8% faster there than the
// stream kernel; PERF.md). Past it (up to 1,024) the stream kernel takes
// each tile in Din chunks of KVLN_KC columns with the weights' rows,
// through a ring of KVLN_STAGES, one barrier a chunk, two blocks an SM.
// Past 128 query rows a block for each 128 of them would project every
// tile again (4 times at 512 latents: 0.7641 ms, against 0.4031 for the
// PyTorch route; PERF.md). There the two kernels run in their projection
// mode (ATTEND false; single-buffered, two blocks an SM): one block per
// (head, cloud, kv split) writes its tiles' k and v in bf16 to device
// memory, once, and K13's attn_packed_tc_kernel attends over them.
// The tile and stream kernels, their helpers and the merge pass are
// kv_tile.cuh's, shared with K7's bf16 forward (flash_train.cu).
using vpt_kvln::KVLN_LDW;
using vpt_kvln::KVLN_NW;
using vpt_kvln::KVLN_THREADS;
using vpt_kvln::kvln_split_ok;
using vpt_kvln::kvln_pass;

// xn = (x - mu) * (rs * w) + b of each of `rows` rows of x [rows, din], in
// bf16, each step rounded as layer_norm_f32, with mu and rs = 1/std from
// f32 sums (the fast variance max(0, E[x^2] - E[x]^2)): one warp a row, 16
// bytes a lane at a time; the row is read twice (the second time from L1).
__global__ void __launch_bounds__(256)
ln_xn_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
             const float* __restrict__ ln_b, bf16* __restrict__ xn, int rows, int din) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * din;
  float s1 = 0.f, s2 = 0.f;
  for (int c8 = lane; c8 < din / 8; c8 += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + 8 * c8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      s1 += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 / din, mu2 = s2 / din;
  const float rs = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
  bf16* out = xn + (size_t)row * din;
  for (int c8 = lane; c8 < din / 8; c8 += 32) {
    const int col = 8 * c8;
    const uint4 u = *reinterpret_cast<const uint4*>(xr + col);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float4 w0 = ld4(ln_w + col), w1 = ld4(ln_w + col + 4);
    const float4 b0 = ld4(ln_b + col), b1 = ld4(ln_b + col + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      r[j] = vpt::mma::pack_bf16x2(
          __fadd_rn(__fmul_rn(__fsub_rn(f.x, mu), __fmul_rn(rs, w[2 * j])), bb[2 * j]),
          __fadd_rn(__fmul_rn(__fsub_rn(f.y, mu), __fmul_rn(rs, w[2 * j + 1])), bb[2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(out + col) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}


// K4 and K15 in bf16. With `ln` (K4) the LayerNorm pass into xn
// [B*M, Din] first, and the passes below read xn; without it (K15) they
// read the tokens x as they are. Then up to QT query rows the attention
// pass in nsplit kv splits (with nsplit > 1 the merge pass), past it the
// projection pass in psplit kv splits into kv (k, then v: [2, B*M,
// H*64]) and K13 over them in nsplit kv splits. Din a multiple of 8.
int launch_kv(bool ln, const void* q, const void* x, const void* ln_w, const void* ln_b,
              const void* wk, const void* wv, void* out, void* part_acc, void* part_ml, void* xn,
              void* kv, int b, int g, int m, int din, int h, int nsplit, int psplit, float scale,
              cudaStream_t stream) {
  const int nt = (m + KT - 1) / KT;
  if (b < 1 || g < 1 || h < 1 || m < 1 || din < 8 || din % 8 || !kvln_split_ok(nt, nsplit) ||
      (g > QT && !kvln_split_ok(nt, psplit)))
    return (int)cudaErrorInvalidValue;
  const int rows = b * m;
  const bf16* src = (const bf16*)x;
  cudaError_t err;
  if (ln) {
    ln_xn_kernel<<<(rows + 7) / 8, 256, 0, stream>>>((const bf16*)x, (const float*)ln_w,
                                                     (const float*)ln_b, (bf16*)xn, rows, din);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = (const bf16*)xn;
  }
  if (g > QT) {
    err = kvln_pass<false>(q, src, wk, wv, kv, nullptr, nullptr, b, g, m, din, h, psplit, scale,
                           stream);
    if (err != cudaSuccess) return (int)err;
    const bf16* k = (const bf16*)kv;
    return launch_packed(q, k, k + (size_t)rows * h * DH, out, part_acc, part_ml, b, g, m, h,
                         nsplit, scale, stream);
  }
  err = kvln_pass<true>(q, src, wk, wv, out, part_acc, part_ml, b, g, m, din, h, nsplit, scale,
                        stream);
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  attn_combine_kernel<bf16><<<b * g, 256, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, (bf16*)out, g, h, nsplit, nullptr);
  return (int)cudaGetLastError();
}

// ------------------------------------------- K15, bf16, on the tensor cores
// The self-attention at the Perceiver's 512 latents: G = M = 512 queries
// and tokens a cloud, Din = 256. Its k|v for a (cloud, head) is 512 x 128
// bf16 (128 KB). K4's kernels would either project every tile once per
// 128-row query tile (4 times here) or write k and v to device memory and
// read them back once per query tile (K13's kernel). Here a thread-block
// cluster takes one (cloud, head): c = ceil(max(G, M) / 256) blocks on
// neighbouring SMs, block r with tokens and query rows [256 r, 256 (r +
// 1)). It keeps k and v on chip, and each token is projected once per
// head:
//   1. block r projects its tokens of the raw x onto the head's k|v on
//      mma.sync: Din streams in 64-column chunks (the slice's rows of x
//      and the weights' 64 rows of this head's [wk|wv]) through a ring of
//      cp.async stages, so any Din up to 1,024 fits; 8 warps of 64 tokens
//      x 64 columns accumulate in f32 over the chunks;
//   2. a cluster barrier (arrive.release / wait.acquire): every block is
//      done with its ring and q's staging, whose place the cloud's k|v
//      rows take;
//   3. block r rounds its slice to bf16 (the Dense emit, the twin's) into
//      its own rows of the cloud's k|v [512, 128] and copies them, 16
//      bytes at a time through st.shared::cluster, into the same rows of
//      every other block of the cluster; a second cluster barrier makes
//      them visible. After it no block touches another's shared memory;
//   4. each warp attends its 32 query rows (q held as A fragments since
//      step 1) over the cloud's 64-token tiles in order, all in its own
//      block's shared memory with no barrier: K13's online softmax (f32
//      logits, p rounded to bf16 before an f32 P.V, divided by l at the
//      end).
// No merge pass runs, and k and v never reach device memory. A block with
// no query rows (G < M) only projects; one with no tokens (M < G) only
// attends. The cloud's k|v takes 139,264 B of shared memory, so one block
// fits an SM: PKV_MT = 2 (K13's two row tiles a warp, each k and v
// fragment serving both; 8 warps x 32 rows, clusters of 2 at 512 latents)
// ran faster at the main path's shape than one row tile a warp (8 warps x
// 16 rows, clusters of 4) and than K4's passes (PERF.md). A first design
// that kept only the block's own slice and copied each remote tile into a
// local buffer before its use (a block barrier a tile) was slower than
// both.
// Bound on the H100 at [64, 512] x [64, 512, 256], H = 4: the products,
// 2 x B x M x Din x 2D + 4 x B x G x M x D = 25.8 GFLOP, 0.026 ms on the
// bf16 tensor cores; x, q and the output move 50 MB (0.015 ms at 3.35
// TB/s).
constexpr int PKV_MT = 2;             // row tiles of 16 a warp
constexpr int PKV_SLICE = KVLN_NW * 16 * PKV_MT;  // tokens and query rows a block: 256
constexpr int PKV_MAX_TOKENS = 512;   // the cloud's k|v rows on chip: G, M at most
constexpr int PKV_KC = 64;            // Din columns a chunk of the projection
constexpr int PKV_LDX = PKV_KC + 8;   // padded row of a chunk of x
constexpr int PKV_MAX_DIN = 1024;     // Din streams: any multiple of 8 up to this
constexpr int PKV_STAGES = 2;         // the projection's ring of Din chunks
// the projection's ring and q's staging share the k|v rows' place
constexpr int PKV_SLOT = PKV_SLICE * PKV_LDX + PKV_KC * KVLN_LDW;
constexpr size_t PKV_SMEM =
    sizeof(bf16) * (size_t)(PKV_MAX_TOKENS * KVLN_LDW > PKV_STAGES * PKV_SLOT + PKV_SLICE * LD
                                ? PKV_MAX_TOKENS * KVLN_LDW
                                : PKV_STAGES * PKV_SLOT + PKV_SLICE * LD);
static_assert(PKV_SMEM <= 232448, "one block an SM");
static_assert(KVLN_THREADS == 256 && PKV_SLICE == 256,
              "8 warps: 32 query rows each, a slice's 16-byte pieces 16 a thread a row");

__global__ void __launch_bounds__(KVLN_THREADS, 1)
attn_packed_kv_cluster_kernel(const bf16* __restrict__ q, const bf16* __restrict__ x,
                              const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                              bf16* __restrict__ out, int g, int m, int din, int h, float scale) {
  namespace mm = vpt::mma;
  constexpr int MT = PKV_MT, SLICE = PKV_SLICE, STAGES = PKV_STAGES, SLOT = PKV_SLOT;
  constexpr int NCG = 4 / MT, NI = 4 * MT;  // the projection's column groups and n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [MAX_TOKENS][LDW]: the cloud's k|v for this head, block r's slice at
  // rows SLICE r..; while the block projects, its ring of x and weight
  // chunks and q's staging
  bf16* kvall = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = kvall;                       // [STAGES][SLICE x LDX | KC x LDW]
  bf16* qstage = kvall + STAGES * SLOT;     // [SLICE][LD]
  const int rank = (int)mm::cluster_rank(), head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = h * DH, nkc = (din + PKV_KC - 1) / PKV_KC;
  const int s0 = rank * SLICE;  // the block's first token and first query row
  const int nt = (m + KT - 1) / KT;  // the cloud's kv tiles
  const bool projects = s0 < m, attends = s0 < g;
  const bf16* xb = x + (size_t)b * m * din;
  auto load = [&](int ch) {  // Din columns k0.. of the slice's rows of x and of the weights' rows
    const int k0 = ch * PKV_KC;
    bf16* xs = ring + (ch % STAGES) * SLOT;
    bf16* ws = xs + SLICE * PKV_LDX;
    mm::cp_rows<PKV_KC, SLICE, KVLN_THREADS>(xs, PKV_LDX, xb + k0, din, s0, m, tid, din - k0);
    mm::cp_rows<DH, PKV_KC, KVLN_THREADS>(ws, KVLN_LDW, wk + (size_t)k0 * d + head * DH, d, 0,
                                          din - k0, tid);
    mm::cp_rows<DH, PKV_KC, KVLN_THREADS>(ws + DH, KVLN_LDW, wv + (size_t)k0 * d + head * DH, d,
                                          0, din - k0, tid);
  };
  // group 0: q and the first chunk; then one group a chunk
  mm::cp_rows<DH, SLICE, KVLN_THREADS>(qstage, LD, q + (size_t)b * g * d + head * DH, d, s0, g,
                                       tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (projects && st < nkc) load(st);
    mm::cp_async_commit();
  }
  const int rg = warp / NCG, cg = warp % NCG;  // tokens 64 rg.., k|v columns 8 NI cg..
  float acc[4][NI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  uint32_t qa[MT][DH / 16][4];
  for (int ch = 0; ch < (projects ? nkc : 1); ++ch) {
    mm::cp_async_wait<STAGES - 2>();  // chunk ch (and q) landed: this thread's copies
    __syncthreads();                  // ... everyone's; chunk ch - 1's stage is consumed
    if (ch == 0)  // q's rows past G are zero rows
      mm::warp_a_frags<DH, MT>(qa, qstage, LD, 16 * MT * warp, lane);
    if (projects && ch + STAGES - 1 < nkc) load(ch + STAGES - 1);
    mm::cp_async_commit();
    if (!projects) break;
    const bf16* xs = ring + (ch % STAGES) * SLOT;
    mm::warp_ab<4, NI>(acc, xs + 64 * rg * PKV_LDX, PKV_LDX, xs + SLICE * PKV_LDX + 8 * NI * cg,
                       KVLN_LDW, PKV_KC, lane);
  }
  mm::cp_async_wait<0>();
  // every block of the cluster is done with its ring and q: the k|v rows
  // take their place. The slice, rounded to bf16 (the Dense emit), into
  // this block's rows, then copied into every other block's same rows.
  mm::cluster_sync();
  if (projects) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(
              kvall + (s0 + 64 * rg + 16 * i + 8 * hh + (lane >> 2)) * KVLN_LDW + 8 * NI * cg +
              8 * j + 2 * (lane & 3)) = mm::pack_bf16x2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    __syncthreads();
    const int nr = (int)gridDim.x;
#pragma unroll
    for (int e = 0; e < SLICE / 16; ++e) {  // 16-byte pieces: 16 a row, a thread each
      const int r = (tid >> 4) + 16 * e, c8 = tid & 15;
      const int off = (s0 + r) * KVLN_LDW + 8 * c8;
      const uint4 v = *reinterpret_cast<const uint4*>(kvall + off);
      const uint32_t addr = mm::smem_addr(kvall + off);
      for (int other = 1; other < nr; ++other)
        mm::st_cluster16(mm::cluster_map(addr, (uint32_t)((rank + other) % nr)), v);
    }
  }
  mm::cluster_sync();  // the cloud's k|v is in every block; no block reads another's after this
  const int row0 = s0 + 16 * MT * warp;
  if (!attends || row0 >= g) return;
  const float c = scale * mm::LOG2E;  // logits (and mx) in log2 units
  float mx[MT][2], sum[MT][2], o[MT][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mx[mt][0] = mx[mt][1] = -CUDART_INF_F;
    sum[mt][0] = sum[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
  }
  // K13's online softmax over the cloud's tiles in order (as kvln_attend)
  for (int t = 0; t < nt; ++t) {
    const bf16* kv = kvall + t * KT * KVLN_LDW;
    float s[MT][NT][4];
    mm::warp_scores<DH, MT>(s, qa, kv, KVLN_LDW, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mm::scale_and_mask(s[mt], c, t * KT, m, lane);
    mm::online_softmax_tile<MT, DH>(s, mx, sum, o);
    uint32_t pa[MT][KT / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mm::p_frags(pa[mt], s[mt]);
    mm::warp_pv<DH, MT>(o, pa, kv + DH, KVLN_LDW, lane);
  }
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * mt + 8 * r + (lane >> 2);
      const float l = mm::quad_sum(sum[mt][r]);  // all lanes take part: before the row test
      if (row >= g) continue;
      bf16* orow = out + ((size_t)b * g + row) * d + head * DH + c0;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            mm::pack_bf16x2(o[mt][n][2 * r] / l, o[mt][n][2 * r + 1] / l);
    }
}

// One cluster per (cloud, head) of `cluster` = ceil(max(G, M) / 256)
// blocks of 8 warps x 32 query rows (G and M at most PKV_MAX_TOKENS), Din
// a multiple of 8 up to PKV_MAX_DIN.
int launch_packed_kv_cluster(const void* q, const void* x, const void* wk, const void* wv,
                             void* out, int b, int g, int m, int din, int h, int cluster,
                             float scale, cudaStream_t stream) {
  const int tokens = g > m ? g : m;
  if (b < 1 || g < 1 || h < 1 || m < 1 || din < 8 || din % 8 || din > PKV_MAX_DIN ||
      tokens > PKV_MAX_TOKENS || cluster != (tokens + PKV_SLICE - 1) / PKV_SLICE || h > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = attn_packed_kv_cluster_kernel;
  const size_t smem = PKV_SMEM;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, h, b);
  cfg.blockDim = dim3(KVLN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = cluster;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, (const bf16*)x,
                                             (const bf16*)wk, (const bf16*)wv, (bf16*)out, g, m,
                                             din, h, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------- K5 (SA)
template <typename T>
__global__ void attn_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, T* __restrict__ out, int g, int m,
                                  int h, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [G, LDH]
  float* ks = qs + (size_t)g * LDH;  // [M, LDH]
  float* vs = ks + (size_t)m * LDH;  // [M, LDH]
  float* ps = vs + (size_t)m * LDH;  // [G, M+1] normalised p in v's dtype

  const int b = blockIdx.y, head = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = h * DH;
  for (int e = tid; e < g * DH; e += nt) {
    const int r = e / DH, c = e - r * DH;
    qs[r * LDH + c] = vpt::to_f32(q[((size_t)b * g + r) * d + head * DH + c]);
  }
  for (int e = tid; e < m * DH; e += nt) {
    const int r = e / DH, c = e - r * DH;
    const size_t src = ((size_t)b * m + r) * d + head * DH + c;
    ks[r * LDH + c] = vpt::to_f32(k[src]);
    vs[r * LDH + c] = vpt::to_f32(v[src]);
  }
  __syncthreads();

  const int row = tid >> 1, half = tid & 1;
  const bool has_row = row < g;
  float* pr = ps + (size_t)row * (m + 1);
  float rmax = -CUDART_INF_F;
  if (has_row) {
    for (int j = half; j < m; j += 2) {
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < DH; ++c) s = fmaf(qs[row * LDH + c], ks[j * LDH + c], s);
      s *= scale;
      pr[j] = s;
      rmax = fmaxf(rmax, s);
    }
  }
  rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
  float rsum = 0.f;
  if (has_row) {
    for (int j = half; j < m; j += 2) {
      const float e = expf(pr[j] - rmax);
      pr[j] = e;
      rsum += e;
    }
  }
  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
  if (has_row) {
    for (int j = half; j < m; j += 2) pr[j] = vpt::round_to<T>(pr[j] / rsum);
  }
  __syncthreads();
  if (has_row) {
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < m; ++j) {
      const float p = pr[j];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = fmaf(p, vs[j * LDH + 2 * i + half], acc[i]);
    }
    T* o = out + ((size_t)b * g + row) * d + head * DH;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[2 * i + half] = vpt::from_f32<T>(acc[i]);
  }
}

// ---------------------------------------------------- K6 (SA, pre-LN + q/k/v)
// The f32 route, on the CUDA cores (bf16: tc::attn_small_qkv_ln_tc_kernel
// above). One block per (cloud, head), 256 threads, three phases:
//  (a) LayerNorm statistics of the cloud's G raw rows (one warp per row);
//  (b) this head's q, k and v columns, [G, 64] each: tiles of 64 rows, Din
//      streamed 16 columns at a time; each step stages the normalised rows
//      (LN applied while loading, rounded to T) once for all three
//      products and one 16 x 64 slice of each weight, and a thread keeps
//      4 rows x 4 columns of each of q, k and v in registers. The products
//      are rounded to T and kept in shared memory (f32);
//  (c) K5's attention on them: two threads per query row, rows in batches
//      of 128, the f32 scores of a batch in the space the staging used.
// Shared memory: q/k/v [G][65] + LN statistics + max(staging, scores of
// min(G, 128) rows), 163 KB at G = 128; G <= 178.
constexpr int K6_THREADS = 256;
constexpr int K6_ROWS = 64;  // rows per projection tile
constexpr int K6_KC = 16;    // Din columns per staging step
constexpr int K6_LDS = 64 + 4;
constexpr int K6_BATCH = K6_THREADS / 2;  // query rows per attention batch

__host__ __device__ inline size_t k6_work_offset(int g) {  // floats, 16-byte aligned
  return ((size_t)g * (3 * LDH + 2) + 3) / 4 * 4;
}
__host__ __device__ inline size_t k6_work_floats(int g) {
  const size_t staging = (size_t)4 * K6_KC * K6_LDS;
  const size_t scores = (size_t)(g < K6_BATCH ? g : K6_BATCH) * (g + 1);
  return staging > scores ? staging : scores;
}

template <typename T>
__global__ void __launch_bounds__(K6_THREADS)
attn_small_qkv_ln_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const T* __restrict__ wq,
                         const T* __restrict__ wk, const T* __restrict__ wv, T* __restrict__ out,
                         int g, int din, int h, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [G, LDH]
  float* ks = qs + (size_t)g * LDH;  // [G, LDH]
  float* vs = ks + (size_t)g * LDH;  // [G, LDH]
  float* mus = vs + (size_t)g * LDH;  // [G] row means
  float* rss = mus + g;              // [G] row 1/std
  float* work = smem + k6_work_offset(g);
  float* As = work;                  // [KC][LDS] normalised rows, transposed
  float* Bs = As + K6_KC * K6_LDS;   // [3][KC][LDS] weight slices of q, k, v

  const int b = blockIdx.y, head = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = h * DH;
  const T* xb = x + (size_t)b * g * din;

  // (a) row statistics: f32 fast variance max(0, E[x^2] - E[x]^2)
  for (int r = warp; r < g; r += K6_THREADS / 32) {
    const T* xr = xb + (size_t)r * din;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < din; c += 32) {
      const float v = vpt::to_f32(xr[c]);
      s1 += v;
      s2 += v * v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mu = s1 / din, mu2 = s2 / din;
      mus[r] = mu;
      rss[r] = rsqrtf(fmaxf(0.f, mu2 - mu * mu) + vpt::LN_EPS);
    }
  }
  __syncthreads();

  // (b) q, k, v = LN(x) @ w[:, head cols], f32-accumulated, rounded to T
  const int tx = tid % 16, ty = tid / 16;
  float* const dsts[3] = {qs, ks, vs};
  for (int r0 = 0; r0 < g; r0 += K6_ROWS) {
    float acc[3][4][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;
    for (int k0 = 0; k0 < din; k0 += K6_KC) {
#pragma unroll
      for (int it = 0; it < K6_ROWS * K6_KC / K6_THREADS; ++it) {
        const int e = tid + it * K6_THREADS;
        const int r = e / K6_KC, kk = e % K6_KC;  // neighbouring threads: neighbouring columns
        const int row = r0 + r, col = k0 + kk;
        float v = 0.f;
        if (row < g && col < din) {
          const float xv = vpt::to_f32(xb[(size_t)row * din + col]);
          v = vpt::round_to<T>((xv - mus[row]) * (rss[row] * ln_w[col]) + ln_b[col]);
        }
        As[kk * K6_LDS + r] = v;
      }
#pragma unroll
      for (int it = 0; it < 3 * K6_KC * DH / K6_THREADS; ++it) {
        const int e = tid + it * K6_THREADS;
        const int p = e / (K6_KC * DH), rem = e % (K6_KC * DH);
        const int kk = rem / DH, c = rem % DH;
        const int col = k0 + kk;
        const T* w = p == 0 ? wq : (p == 1 ? wk : wv);
        Bs[(p * K6_KC + kk) * K6_LDS + c] =
            col < din ? vpt::to_f32(w[(size_t)col * d + head * DH + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < K6_KC; ++kk) {
        const float4 av = ld4(As + kk * K6_LDS + ty * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float4 bv = ld4(Bs + (p * K6_KC + kk) * K6_LDS + tx * 4);
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[p][i][j] = fmaf(ar[i], br[j], acc[p][i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= g) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dsts[p][row * LDH + tx * 4 + j] = vpt::round_to<T>(acc[p][i][j]);
      }
  }
  __syncthreads();  // q/k/v complete; the staging space becomes the scores

  // (c) softmax(q k^T * scale) v, normalised before PV, p rounded to T
  const int half = tid & 1;
  float* pr = work + (size_t)(tid >> 1) * (g + 1);
  for (int base = 0; base < g; base += K6_BATCH) {
    const int row = base + (tid >> 1);
    const bool has_row = row < g;
    float rmax = -CUDART_INF_F;
    if (has_row) {
      for (int j = half; j < g; j += 2) {
        float s = 0.f;
#pragma unroll 16
        for (int c = 0; c < DH; ++c) s = fmaf(qs[row * LDH + c], ks[j * LDH + c], s);
        s *= scale;
        pr[j] = s;
        rmax = fmaxf(rmax, s);
      }
    }
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
    float rsum = 0.f;
    if (has_row) {
      for (int j = half; j < g; j += 2) {
        const float e = expf(pr[j] - rmax);
        pr[j] = e;
        rsum += e;
      }
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    if (has_row) {
      for (int j = half; j < g; j += 2) pr[j] = vpt::round_to<T>(pr[j] / rsum);
    }
    __syncwarp();  // the pair of a row sits in one warp and reads only that row
    if (has_row) {
      float acc[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
      for (int j = 0; j < g; ++j) {
        const float p = pr[j];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] = fmaf(p, vs[j * LDH + 2 * i + half], acc[i]);
      }
      T* o = out + ((size_t)b * g + row) * d + head * DH;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[2 * i + half] = vpt::from_f32<T>(acc[i]);
    }
    __syncwarp();  // the next batch overwrites this row's scores
  }
}

int threads_for(int g) {
  int t = (2 * g + 127) / 128 * 128;  // two threads per query row
  return t < 128 ? 128 : t;
}

// Launches K4 / K13 / K15 (the kv source by MODE) and, when the chunks
// are split over blocks, the merge pass.
template <typename T, int MODE>
int launch_flash(const void* q, const KvSource<T>& src, void* out, void* part_acc,
                 void* part_ml, int b, int g, int m, int h, int nsplit, float scale,
                 cudaStream_t stream) {
  const int nchunks = (m + MC - 1) / MC;
  if (b < 1 || g < 1 || h < 1 || m < 1 || nsplit < 1 || nsplit > nchunks)
    return (int)cudaErrorInvalidValue;
  if ((MODE == KV_DIRECT) != (src.din == 0)) return (int)cudaErrorInvalidValue;
  const int cps = (nchunks + nsplit - 1) / nsplit;  // chunks per split
  if ((nsplit - 1) * cps >= nchunks) return (int)cudaErrorInvalidValue;  // no empty split
  const size_t smem = sizeof(float) * ((size_t)src.din * LDC + DH * LDC + MC * LDV +
                                       DH * LDQ + MC * LDQ);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_flash_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(h, b, ((g + QT - 1) / QT) * nsplit);
  attn_flash_kernel<T, MODE><<<grid, K4_THREADS, smem, stream>>>(
      (const T*)q, src.x, src.ln_w, src.ln_b, src.wk, src.wv, src.k, src.v, (T*)out,
      (float*)part_acc, (float*)part_ml, g, m, src.din, h, nsplit, cps, scale);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_combine_kernel<T><<<b * g, 256, 0, stream>>>(
        (const float*)part_acc, (const float*)part_ml, (T*)out, g, h, nsplit, nullptr);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv_ln(const void* q, const void* x, const void* ln_w, const void* ln_b, const void* wk,
                 const void* wv, void* out, void* part_acc, void* part_ml, int b, int g, int m,
                 int din, int h, int nsplit, float scale, cudaStream_t stream) {
  if (din < 1) return (int)cudaErrorInvalidValue;
  const KvSource<T> src{(const T*)x, (const float*)ln_w, (const float*)ln_b, (const T*)wk,
                        (const T*)wv, nullptr, nullptr, din};
  return launch_flash<T, KV_LN>(q, src, out, part_acc, part_ml, b, g, m, h, nsplit, scale,
                                stream);
}

template <typename T>
int launch_packed_kv(const void* q, const void* x, const void* wk, const void* wv, void* out,
                     void* part_acc, void* part_ml, int b, int g, int m, int din, int h,
                     int nsplit, float scale, cudaStream_t stream) {
  if (din < 1) return (int)cudaErrorInvalidValue;
  const KvSource<T> src{(const T*)x, nullptr, nullptr, (const T*)wk, (const T*)wv, nullptr,
                        nullptr, din};
  return launch_flash<T, KV_PROJ>(q, src, out, part_acc, part_ml, b, g, m, h, nsplit, scale,
                                  stream);
}

template <typename T>
int launch_packed(const void* q, const void* k, const void* v, void* out, void* part_acc,
                  void* part_ml, int b, int g, int m, int h, int nsplit, float scale,
                  cudaStream_t stream) {
  const KvSource<T> src{nullptr, nullptr, nullptr, nullptr, nullptr, (const T*)k, (const T*)v,
                        0};
  return launch_flash<T, KV_DIRECT>(q, src, out, part_acc, part_ml, b, g, m, h, nsplit, scale,
                                    stream);
}

template <typename T>
int launch_small(const void* q, const void* k, const void* v, void* out, int b, int g, int m,
                 int h, float scale, cudaStream_t stream) {
  if (2 * g > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(g + 2 * m) * LDH + (size_t)g * (m + 1));
  cudaFuncSetAttribute(attn_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(h, b);
  attn_small_kernel<T><<<grid, threads_for(g), smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, g, m, h, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_small_qkv_ln(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                        const void* wk, const void* wv, void* out, int b, int g, int din, int h,
                        float scale, cudaStream_t stream) {
  if (b < 1 || g < 1 || din < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (k6_work_offset(g) + k6_work_floats(g));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(attn_small_qkv_ln_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(h, b);
  attn_small_qkv_ln_kernel<T><<<grid, K6_THREADS, smem, stream>>>(
      (const T*)x, (const float*)ln_w, (const float*)ln_b, (const T*)wq, (const T*)wk,
      (const T*)wv, (T*)out, g, din, h, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: x [B, G, Din] raw tokens, ln_w/ln_b f32 [Din], wq/wk/wv [Din, H*64]
// -> out [B, G, H*64] = attention(LN(x) wq, LN(x) wk, LN(x) wv). f32 on
// the CUDA cores: G <= 178 (the shared-memory bound above).
extern "C" int attn_small_qkv_ln_f32(const void* x, const void* ln_w, const void* ln_b,
                                     const void* wq, const void* wk, const void* wv, void* out,
                                     int b, int g, int din, int h, float scale, void* stream) {
  return launch_small_qkv_ln<float>(x, ln_w, ln_b, wq, wk, wv, out, b, g, din, h, scale,
                                    (cudaStream_t)stream);
}

// bf16 on the tensor cores: G <= 192, Din a multiple of 32; pointers
// 16-byte aligned.
extern "C" int attn_small_qkv_ln_tc_bf16(const void* x, const void* ln_w, const void* ln_b,
                                         const void* wq, const void* wk, const void* wv,
                                         void* out, int b, int g, int din, int h, float scale,
                                         void* stream) {
  return tc::launch_small_qkv_ln(x, ln_w, ln_b, wq, wk, wv, out, b, g, din, h, scale,
                                 (cudaStream_t)stream);
}

// K4: q [B, G, H*64], x [B, M, Din] raw tokens, ln_w/ln_b f32 [Din],
// wk/wv [Din, H*64] -> out [B, G, H*64]. f32 on the CUDA cores.
// With nsplit > 1 the M chunks are split over nsplit blocks per (cloud,
// head, query tile), whose states go through part_acc f32
// [B, H, nsplit, G, 64] and part_ml f32 [B, H, nsplit, G, 2] scratch and
// are merged by a second kernel; nsplit must leave no split empty.
extern "C" int attn_kv_ln_f32(const void* q, const void* x, const void* ln_w,
                              const void* ln_b, const void* wk, const void* wv, void* out,
                              void* part_acc, void* part_ml, int b, int g, int m, int din, int h,
                              int nsplit, float scale, void* stream) {
  return launch_kv_ln<float>(q, x, ln_w, ln_b, wk, wv, out, part_acc, part_ml, b, g, m, din, h,
                           nsplit, scale, (cudaStream_t)stream);
}

// bf16 on the tensor cores: Din a multiple of 8 (at most KV_MAX_DIN by
// the wrapper), pointers 16-byte aligned; nsplit counts splits of the
// 64-token tiles, as K13's; xn bf16 [B*M, Din] scratch.
extern "C" int attn_kv_ln_tc_bf16(const void* q, const void* x, const void* ln_w,
                                  const void* ln_b, const void* wk, const void* wv, void* out,
                                  void* part_acc, void* part_ml, void* xn, void* kv, int b, int g,
                                  int m, int din, int h, int nsplit, int psplit, float scale,
                                  void* stream) {
  return tc::launch_kv(true, q, x, ln_w, ln_b, wk, wv, out, part_acc, part_ml, xn, kv, b, g, m,
                       din, h, nsplit, psplit, scale, (cudaStream_t)stream);
}

// K5: q [B, G, H*64], k/v [B, M, H*64] -> out [B, G, H*64]. f32 on the
// CUDA cores: G <= 512, and the f32 q/k/v/p tiles must fit shared memory
// (G = M = 128: 162 KB).
extern "C" int attn_small_f32(const void* q, const void* k, const void* v, void* out, int b, int g,
                              int m, int h, float scale, void* stream) {
  return launch_small<float>(q, k, v, out, b, g, m, h, scale, (cudaStream_t)stream);
}

// bf16 on the tensor cores: M <= 512, any G; pointers 16-byte aligned.
extern "C" int attn_small_tc_bf16(const void* q, const void* k, const void* v, void* out, int b,
                                  int g, int m, int h, float scale, void* stream) {
  return tc::launch_small(q, k, v, out, b, g, m, h, scale, (cudaStream_t)stream);
}

// K13: q [B, G, H*64], k/v [B, M, H*64] -> out [B, G, H*64], any G and M;
// nsplit, part_acc and part_ml as for K4.
extern "C" int attn_packed_f32(const void* q, const void* k, const void* v, void* out,
                               void* part_acc, void* part_ml, int b, int g, int m, int h,
                               int nsplit, float scale, void* stream) {
  return launch_packed<float>(q, k, v, out, part_acc, part_ml, b, g, m, h, nsplit, scale,
                              (cudaStream_t)stream);
}

// bf16 on the tensor cores: nsplit counts splits of the 64-token tiles
// (pointers 16-byte aligned).
extern "C" int attn_packed_tc_bf16(const void* q, const void* k, const void* v, void* out,
                                   void* part_acc, void* part_ml, int b, int g, int m, int h,
                                   int nsplit, float scale, void* stream) {
  return tc::launch_packed(q, k, v, out, part_acc, part_ml, b, g, m, h, nsplit, scale,
                           (cudaStream_t)stream);
}

// K15: q [B, G, H*64], x [B, M, Din] tokens (already normalised by the
// caller), wk/wv [Din, H*64] -> out [B, G, H*64]; Din <= 1024 (the chunk
// [Din, 36] f32 stays in shared memory); nsplit as for K4. f32 on the
// CUDA cores.
extern "C" int attn_packed_kv_f32(const void* q, const void* x, const void* wk, const void* wv,
                                  void* out, void* part_acc, void* part_ml, int b, int g, int m,
                                  int din, int h, int nsplit, float scale, void* stream) {
  return launch_packed_kv<float>(q, x, wk, wv, out, part_acc, part_ml, b, g, m, din, h, nsplit,
                                 scale, (cudaStream_t)stream);
}

// bf16 on the tensor cores (pointers 16-byte aligned, Din a multiple of
// 8): with cluster > 0 the cluster kernel, one cluster a (cloud, head) of
// that many blocks of 256 tokens and query rows (G, M <= 512; part_acc,
// part_ml and kv unused); with cluster 0 K4's passes on the tokens as they are (no
// LayerNorm), with nsplit and psplit as K4's and the k|v scratch kv [2,
// B*M, H*64] past 128 query rows.
extern "C" int attn_packed_kv_tc_bf16(const void* q, const void* x, const void* wk, const void* wv,
                                      void* out, void* part_acc, void* part_ml, void* kv, int b,
                                      int g, int m, int din, int h, int cluster, int nsplit,
                                      int psplit, float scale, void* stream) {
  if (cluster > 0)
    return tc::launch_packed_kv_cluster(q, x, wk, wv, out, b, g, m, din, h, cluster, scale,
                                        (cudaStream_t)stream);
  return tc::launch_kv(false, q, x, nullptr, nullptr, wk, wv, out, part_acc, part_ml, nullptr, kv,
                       b, g, m, din, h, nsplit, psplit, scale, (cudaStream_t)stream);
}
