// K3: fused eval patch stem (neighbour gather + Group2Emb mini-PointNet).
//
// Replaces vipformer_tpu/ops/pallas/stem.py:_stem_call (reached through
// group2emb_fused_apply). The BatchNorm folds and the extended first-layer
// table t1ext = [pts @ W1 + b1 | centers @ W1 - b1] stay in the PyTorch
// wrapper, as in stem.py:170-203.
//
// Bound on the H100: arithmetic. Per group of S=32 rows the chain is
// 64x128 + 256x256 + 256xD multiply-adds per row (~5.5 MMAC per group,
// 0.7 GMAC per cloud at the flagship shapes); the inputs are 32 gathered
// 64-wide rows and the weights (~200 K values, L2 resident), the output is
// one D-wide row.
//
// Design: one block per (cloud, group). Hopper gathers rows directly, so
// the 32 neighbour rows of t1ext are read by index and the group's center
// row subtracted (the Pallas signed one-hot MXU trick, stem.py:66-79, is
// not ported). W3 and W4 (256 KB in bf16 together) do not fit a block's
// shared memory, so they stream from global/L2 (L1 serves the block's
// warps after the first): each thread owns a 4-row x 8-column register
// tile of a layer's output, so one k step costs 4 broadcast shared-memory
// reads and one 16-byte weight load for 32 FMAs. The global (max-pooled) half of concat[global, local] @ W3 is
// the same for every row of a group, so its f32 partial sum is computed
// once per group and seeds each row's accumulator.
// Rounding follows nn.layers.Dense: f32 accumulation, round to the compute
// dtype, then add the bias in that dtype. Plain CUDA-core FMAs: a tensor-
// core (wgmma) version is later work.
#include "common.cuh"

namespace {

constexpr int S_MAX = 32;    // rows (group size) per block
constexpr int THREADS = 256;
constexpr int RT = 4;        // rows of a thread's register tile
constexpr int CT = 8;        // columns of a thread's register tile

// Eight consecutive weights w[0..7] as f32 (one 16-byte load for bf16,
// two for f32; the caller keeps w 16-byte aligned).
__device__ __forceinline__ void load8(const float* w, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  const float4 b = *reinterpret_cast<const float4*>(w + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* w, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(w);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
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

// t1ext [B, N+G, C1], idx int32 [B, G*S], w2 [C1, 128], b2 [128],
// w3 [256, 256] (BN folded), b3 [256], w4 [256, D], b4 [D] -> out [B, G, D].
// All floating operands in the compute dtype (f32 or bf16), 16-byte
// aligned. Needs S <= 32, C1 % 4 == 0 and D % 8 == 0.
extern "C" int stem_f32(const void* t1ext, const void* idx, const void* w2, const void* b2,
                        const void* w3, const void* b3, const void* w4, const void* b4, void* out,
                        int b, int n, int g, int s, int c1, int d, void* stream) {
  return launch<float>(t1ext, idx, w2, b2, w3, b3, w4, b4, out, b, n, g, s, c1, d,
                       (cudaStream_t)stream);
}

extern "C" int stem_bf16(const void* t1ext, const void* idx, const void* w2, const void* b2,
                         const void* w3, const void* b3, const void* w4, const void* b4, void* out,
                         int b, int n, int g, int s, int c1, int d, void* stream) {
  return launch<__nv_bfloat16>(t1ext, idx, w2, b2, w3, b3, w4, b4, out, b, n, g, s, c1, d,
                               (cudaStream_t)stream);
}
