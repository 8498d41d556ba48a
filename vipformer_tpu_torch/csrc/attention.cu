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
// (cloud, head) the block projects every kv token onto that head's k and v
// columns (M x Din x 2dh = 33.5 MMAC at M=1024, Din=256, dh=64) plus
// 2 x G x M x dh = 16.8 MMAC for the attention itself; the raw tokens are
// read once per head, so the LayerNorm is recomputed H times (a factor of
// H=4 on the LN, not on the projections: each head projects only its own
// columns), and once more per extra block of 128 query rows when G > 128.
// Removing that factor (one block per cloud over all heads, or a separate
// projection pass) is later work.
// Bound on the H100, K5: shared-memory bandwidth of two 128x128x64 f32
// products per (cloud, head); q/k/v are read once, the output written once.
//
// Design, K4: the Pallas kernel carried the online-softmax state across a
// sequential grid axis; blocks on Hopper carry nothing between them, so
// one block per (cloud, head, 128 query rows) walks the M chunks (32
// tokens each) itself. At small batch that is fewer blocks than the card
// has SMs, so the wrapper may split the chunks over several blocks
// (flash-decoding style) and a second kernel merges their (max, sum, acc)
// states. Every phase is register-tiled over shared memory:
// the projection gives a thread 4 tokens x 4 k-or-v columns (one float4 of
// normalised tokens and one vector of weights per k step), the logits 4
// query rows x 4 tokens, PV 4 rows x 8 columns; a thread keeps the same 4
// query rows throughout, so its rows' running max and sum stay in
// registers and the row reductions are shuffles within 8 lanes.
// Design, K5: one block per (cloud, head), two threads per query row, each
// holding half of the row's dh accumulators (columns interleaved to spread
// shared-memory banks; rows padded to dh+1 floats for the same reason).
// Numerics follow the Pallas kernels: LN in f32 with the fast variance and
// eps 1e-5, cast to the compute dtype; k/v = f32-accumulated projections
// rounded to the compute dtype; logits in f32; p cast to v's dtype before
// PV; f32 accumulation. Plain CUDA-core FMAs; tensor cores (wgmma) are
// later work.
#include "common.cuh"

namespace {

constexpr int DH = 64;       // head width supported by these kernels
constexpr int LDH = DH + 1;  // padded shared-memory row stride
constexpr int MC = 32;       // kv tokens per chunk (K4)
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- K4 (CA)
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

template <typename T>
__global__ void __launch_bounds__(K4_THREADS)
attn_kv_ln_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const T* __restrict__ wk, const T* __restrict__ wv, T* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int g, int m,
                  int din, int h, int nsplit, int cps, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;
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
  const T* xb = x + (size_t)b * m * din;

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
      const float rs = rsqrtf(var + LN_EPS);
      for (int c = lane; c < din; c += 32) {
        const float v = vpt::to_f32(xr[c]);
        xsT[c * LDC + r] = vpt::round_to<T>((v - mu) * (rs * ln_w[c]) + ln_b[c]);
      }
    }
    __syncthreads();
    // (b) k and v of the chunk for this head: [MC rows] x [2*DH cols]; a
    //     thread owns 4 tokens x 4 columns (lanes 0-15 k, 16-31 v)
    {
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
    }
    __syncthreads();
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
    // the next chunk's LayerNorm writes only xsT, which (d) does not read;
    // its projection writes kT/vs after the barrier that follows the LN
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

// Merges the per-split online-softmax states of K4 when M was split over
// blocks: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max m_s.
// One block per (cloud, query row), a thread per output column.
template <typename T>
__global__ void attn_combine_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml, T* __restrict__ out,
                                    int g, int h, int nsplit) {
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
  }
}

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

int threads_for(int g) {
  int t = (2 * g + 127) / 128 * 128;  // two threads per query row
  return t < 128 ? 128 : t;
}

template <typename T>
int launch_kv_ln(const void* q, const void* x, const void* ln_w, const void* ln_b, const void* wk,
                 const void* wv, void* out, void* part_acc, void* part_ml, int b, int g, int m,
                 int din, int h, int nsplit, float scale, cudaStream_t stream) {
  const int nchunks = (m + MC - 1) / MC;
  if (m < 1 || nsplit < 1 || nsplit > nchunks) return (int)cudaErrorInvalidValue;
  const int cps = (nchunks + nsplit - 1) / nsplit;  // chunks per split
  if ((nsplit - 1) * cps >= nchunks) return (int)cudaErrorInvalidValue;  // no empty split
  const size_t smem = sizeof(float) * ((size_t)din * LDC + DH * LDC + MC * LDV + DH * LDQ +
                                       MC * LDQ);
  cudaFuncSetAttribute(attn_kv_ln_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(h, b, ((g + QT - 1) / QT) * nsplit);
  attn_kv_ln_kernel<T><<<grid, K4_THREADS, smem, stream>>>(
      (const T*)q, (const T*)x, (const float*)ln_w, (const float*)ln_b, (const T*)wk,
      (const T*)wv, (T*)out, (float*)part_acc, (float*)part_ml, g, m, din, h, nsplit, cps,
      scale);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_combine_kernel<T><<<b * g, 256, 0, stream>>>(
        (const float*)part_acc, (const float*)part_ml, (T*)out, g, h, nsplit);
  }
  return (int)cudaGetLastError();
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

}  // namespace

// q [B, G, H*64], x [B, M, Din] raw tokens, ln_w/ln_b f32 [Din],
// wk/wv [Din, H*64] -> out [B, G, H*64].
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

extern "C" int attn_kv_ln_bf16(const void* q, const void* x, const void* ln_w,
                              const void* ln_b, const void* wk, const void* wv, void* out,
                              void* part_acc, void* part_ml, int b, int g, int m, int din, int h,
                              int nsplit, float scale, void* stream) {
  return launch_kv_ln<__nv_bfloat16>(q, x, ln_w, ln_b, wk, wv, out, part_acc, part_ml, b, g, m, din, h,
                           nsplit, scale, (cudaStream_t)stream);
}

// q [B, G, H*64], k/v [B, M, H*64] -> out [B, G, H*64]. G <= 512, and the
// f32 q/k/v/p tiles must fit shared memory (G = M = 128: 162 KB).
extern "C" int attn_small_f32(const void* q, const void* k, const void* v, void* out, int b, int g,
                              int m, int h, float scale, void* stream) {
  return launch_small<float>(q, k, v, out, b, g, m, h, scale, (cudaStream_t)stream);
}

extern "C" int attn_small_bf16(const void* q, const void* k, const void* v, void* out, int b,
                               int g, int m, int h, float scale, void* stream) {
  return launch_small<__nv_bfloat16>(q, k, v, out, b, g, m, h, scale, (cudaStream_t)stream);
}
