// K9: train-mode Group2Emb (mini-PointNet with batch-statistics
// BatchNorm), forward and backward.
//
// Replaces vipformer_tpu/ops/pallas/g2e_train.py:g2e_train_apply (:722;
// the six passes F1-F3 and P1-P3 of g2e_train.py:21-63, run by
// _g2e_fwd_impl :371 and _g2e_bwd_impl :485). The chain, rows R = B*G*S
// grouped S at a time:
//   h1p = x0 W0 + b0 (64), x1 = relu(bn0(h1p)), h2 = x1 W1 + b1 (128),
//   xc = [max_S h2 | h2], h3p = xc W2 + b2 (256, cached),
//   x3 = relu(bn1(h3p)), out = max_S (x3 W3 + b3) (D).
// Numerics as the Pallas kernel: every Dense is an f32-accumulated product
// rounded to the compute dtype BEFORE its bias is added (and rounded
// again); BatchNorm statistics are f32 sums of the rounded activations,
// fast variance clipped at 0, eps 1e-5; the normalised value h*a + c is
// rounded to the compute dtype before the ReLU. Gradients: the final max
// pool routes each group's gradient to the FIRST argmax (stored as int32
// by the forward); the h2 global-feature pool splits it equally among
// ties (g2e_train.py:51-56); BatchNorm backward through the batch
// statistics, dh = gamma*rstd*(dy - mean(dy) - xhat*mean(dy*xhat)).
// Only h3p (and the argmax and statistics) pass from the forward to the
// backward; x1, h2 and x3 are recomputed from x0 and h3p.
//
// Bound on the H100: operations. The forward does 139,456 MAC a row at D
// = 256 (the two 256-wide Dense dominate) and the backward about twice
// that: at R = 393,216 rows (the pretrain step) 0.111 ms forward and 0.222
// ms backward at the bf16 tensor rate of 989 TFLOP/s, against 0.03-0.06
// ms of bytes at 3.35 TB/s.
//
// The dtype picks the kernels (ops/cuda/__init__.py `tc_route`): f32 runs
// the CUDA-core passes below (a tensor-core f32 product is TF32, which
// would break the f32 bounds against the twin); bf16 runs namespace tc.
//
// Design, f32: the TPU grid ran in order and carried the BatchNorm sums and
// the weight gradients in scratch across it. Here each pass is a separate
// launch: the Dense layers are SIMT products over functors that recompute
// their operands (train_common.cuh), the BatchNorm and bias sums are
// per-block column partials, and the weight gradients dW = X^T dY are split
// over the rows into partials; both kinds are summed by a second pass in a
// fixed order, so every result is deterministic. Between launches, within
// one call, activations live in device memory (h2, the group maxima, h4,
// and the backward's gradients).
//
// Design, bf16 (namespace tc): one tensor-core kernel a pass, like the TPU
// kernel's, over row tiles of whole groups (128 rows hold floor(128 / S)
// groups, so S <= 128), 16 warps of mma.sync (mma.cuh), the weights in
// shared memory for the whole launch (persistent blocks, one an SM), the
// activations of a tile in shared memory, and only h3p cached:
//   F1  colsum2 of h1p on the CUDA cores (Cin <= 16), BN0's statistics;
//   F2  fwd_mid_kernel: x1, h2 = x1 W1, the group max, xc, h3p = xc W2
//       (written), the column sums of (h3p, h3p^2); BN1's statistics;
//   F3  fwd_out_kernel<N>: x3, h4 = x3 W3 in D / N column slices, each
//       group's max and first argmax from the tile: no h4 in memory;
//   P1  bwd_dy3_kernel<false>: dh4 formed in the tile from dy and the
//       argmax, dy3 = relu'(x3) (dh4 W3^T), the column sums (dy3, dy3
//       xhat3) in f64; P2 bwd_dy3_kernel<true>: the same dy3, dh3p
//       (written), its column sums (db2) and each group's sums (gsum);
//   P2  bwd_mid_kernel: x1, h2, gmax, xc again (the same code as F2: the
//       same bits), dxc's local half dh3p W2[128:]^T, its gmax half's
//       group sums as gsum W2[:128]^T (1/S of the products, CUDA cores),
//       split among h2's ties, dh2, dy1 = relu'(x1) (dh2 W1^T), the column
//       sums (dy1, dy1 xhat1) and of dh2 (db1); x1, xc, dh2 and dy1
//       written in bf16 for the weight gradients and P3;
//   P3  bwd_in_kernel on the CUDA cores: dh1p, dx0, dW0 and db0;
//   dW  dw3_kernel (K11's split design, x3 and dh4 formed by its loaders;
//       db3 from dy's column sums), K11 itself (dense.cu) for dW2 = xc^T
//       dh3p and dW1 = x1^T dh2.
// No h4, dh4 or f32 array of R rows reaches device memory: dy3, dxc and
// the f32 dy1 live in registers and shared memory. Every cross-block sum
// is per-block partials summed in a fixed order (each block's partial over
// its tiles, a tile's rows first): two runs give the same bits.
// Numerics: the twin's rounding points. Where the twin's f32 steps feed a
// bf16 rounding through a near-cancellation (the BatchNorm backwards), the
// kernels round each step as the twin does, sum the backward's statistics
// in f64, and add every product's k steps in round-to-nearest (block_mma):
// each measure moved the results, and the exactly-zero bias gradients,
// closer to the twin's (PERF.md, section 6).
#include "mma.cuh"
#include "train_common.cuh"

// K11's bf16 weight gradient (dense.cu): dW = x^T dy, db = colsum(dy).
namespace vpt_dense {
namespace tc {
int launch(const void* x, const void* dy, void* dw, void* db, void* wpart, void* bpart, int r,
           int cin, int cout, int splits, cudaStream_t st);
}  // namespace tc
}  // namespace vpt_dense

namespace vpt_g2e {

using namespace vpt;

constexpr int C1 = 64, C2 = 128, C3 = 256;  // Group2Emb's hidden widths
constexpr float BN_EPS = 1e-5f;
constexpr int MAX_CIN = 16;  // the widest x0 row (ops/cuda/g2e_train.py MAX_CIN)
// Rows of the statistics table [10][C3]: BN0 (mean, var, rstd, a, c), then BN1.
enum { MU0, VAR0, RSTD0, A0, SH0, MU1, VAR1, RSTD1, A1, SH1 };

// h1p = x0 W0 + b0 of row xr (cin values), column c: the one FMA order of
// every pass that recomputes it (F1's statistics, the bf16 kernels' x1,
// the backward's masks and xhat1), so all of them agree bit for bit.
template <typename T>
__device__ __forceinline__ float h1p_of(const T* xr, const T* w0, const T* b0, int c, int cin) {
  float acc = 0.f;
  for (int i = 0; i < cin; ++i) acc = fmaf(to_f32(xr[i]), to_f32(w0[i * C1 + c]), acc);
  return round_to<T>(round_to<T>(acc) + to_f32(b0[c]));
}

// relu of the normalised value h*a + sh, rounded to T before the ReLU.
template <typename T>
__device__ __forceinline__ float bn_relu(float h, float a, float sh) {
  return fmaxf(round_to<T>(__fadd_rn(__fmul_rn(h, a), sh)), 0.f);
}

// What the chain recomputes from x0 and h3p.
template <typename T> struct Chain {
  const T* x0;
  const T* w0;
  const T* b0;
  const float* stats;
  const T* h3p;
  int cin;
  __device__ const float* st(int row) const { return stats + row * C3; }
  __device__ float h1p(int r, int c) const { return h1p_of(x0 + (size_t)r * cin, w0, b0, c, cin); }
  __device__ float x1(int r, int c) const { return bn_relu<T>(h1p(r, c), st(A0)[c], st(SH0)[c]); }
  __device__ float xhat1(int r, int c) const {
    return (h1p(r, c) - st(MU0)[c]) * st(RSTD0)[c];
  }
  __device__ float x3(int r, int c) const {
    return bn_relu<T>(to_f32(h3p[(size_t)r * C3 + c]), st(A1)[c], st(SH1)[c]);
  }
  __device__ float xhat3(int r, int c) const {
    return (to_f32(h3p[(size_t)r * C3 + c]) - st(MU1)[c]) * st(RSTD1)[c];
  }
};

template <typename T> struct X1A {  // A(m = row, k = channel)
  Chain<T> ch;
  __device__ float operator()(int m, int k) const { return ch.x1(m, k); }
};
template <typename T> struct X1T {  // A(m = channel, k = row)
  Chain<T> ch;
  __device__ float operator()(int m, int k) const { return ch.x1(k, m); }
};
template <typename T> struct X3A {
  Chain<T> ch;
  __device__ float operator()(int m, int k) const { return ch.x3(m, k); }
};
template <typename T> struct X3T {
  Chain<T> ch;
  __device__ float operator()(int m, int k) const { return ch.x3(k, m); }
};
// xc = [gmax of the row's group | h2 of the row]
template <typename T> struct XC {
  const T* gmax;
  const T* h2;
  int S;
  __device__ float at(int r, int c) const {
    return to_f32(c < C2 ? gmax[(size_t)(r / S) * C2 + c] : h2[(size_t)r * C2 + c - C2]);
  }
};
template <typename T> struct XCA {
  XC<T> xc;
  __device__ float operator()(int m, int k) const { return xc.at(m, k); }
};
template <typename T> struct XCT {
  XC<T> xc;
  __device__ float operator()(int m, int k) const { return xc.at(k, m); }
};

// Column sums of (h, h^2): BatchNorm statistics.
template <typename T> struct L0Sq {
  Chain<T> ch;
  __device__ float2 operator()(int r, int c) const {
    const float h = ch.h1p(r, c);
    return make_float2(h, h * h);
  }
};
template <typename T> struct RowSq {
  const T* p;
  int ld;
  __device__ float2 operator()(int r, int c) const {
    const float h = to_f32(p[(size_t)r * ld + c]);
    return make_float2(h, h * h);
  }
};
// Column sums of (v, 0): bias gradients.
template <typename T> struct Col {
  const T* p;
  int ld;
  __device__ float2 operator()(int r, int c) const {
    return make_float2(to_f32(p[(size_t)r * ld + c]), 0.f);
  }
};
// Column sums of (dy, dy * xhat): BatchNorm backward.
template <typename T> struct Bn1Grad {
  Chain<T> ch;
  const float* dy3;
  __device__ float2 operator()(int r, int c) const {
    const float g = dy3[(size_t)r * C3 + c];
    return make_float2(g, g * ch.xhat3(r, c));
  }
};
template <typename T> struct Bn0Grad {
  Chain<T> ch;
  const float* dy1;
  __device__ float2 operator()(int r, int c) const {
    const float g = dy1[(size_t)r * C1 + c];
    return make_float2(g, g * ch.xhat1(r, c));
  }
};

// dy3 = x3 > 0 ? dx3 : 0 (f32), dy1 likewise.
template <typename T> struct StoreRelu3 {
  Chain<T> ch;
  float* out;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * C3 + n] = ch.x3(m, n) > 0.f ? acc : 0.f;
  }
};
template <typename T> struct StoreRelu1 {
  Chain<T> ch;
  float* out;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * C1 + n] = ch.x1(m, n) > 0.f ? acc : 0.f;
  }
};

// BatchNorm statistics from the column partials: one thread per channel.
__global__ void bn_finish_kernel(const float* __restrict__ part, int nblk, int C, float n,
                                 const float* __restrict__ gamma, const float* __restrict__ beta,
                                 float* __restrict__ stats, int base) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < nblk; ++k) {
    s += part[((size_t)k * 2) * C + c];
    ss += part[((size_t)k * 2 + 1) * C + c];
  }
  const float mu = s / n, var = fmaxf(ss / n - mu * mu, 0.f);
  const float rstd = rsqrtf(var + BN_EPS), a = gamma[c] * rstd;
  stats[(base + 0) * C3 + c] = mu;
  stats[(base + 1) * C3 + c] = var;
  stats[(base + 2) * C3 + c] = rstd;
  stats[(base + 3) * C3 + c] = a;
  stats[(base + 4) * C3 + c] = beta[c] - mu * a;
}

// Max over each group's S rows of a [R, C] array, per column; with
// `amax`, also the first row of the maximum.
template <typename T>
__global__ void group_max_kernel(const T* __restrict__ x, int ngroups, int S, int C,
                                 T* __restrict__ out, int* __restrict__ amax) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)ngroups * C) return;
  const size_t g = i / C;
  const int c = i % C;
  const T* p = x + g * S * C + c;
  float best = to_f32(p[0]);
  int arg = 0;
  for (int s = 1; s < S; ++s) {
    const float v = to_f32(p[(size_t)s * C]);
    if (v > best) {
      best = v;
      arg = s;
    }
  }
  out[i] = from_f32<T>(best);
  if (amax != nullptr) amax[i] = arg;
}

// dh4: each group's gradient at its stored argmax row, zero elsewhere.
template <typename T>
__global__ void scatter_argmax_kernel(const T* __restrict__ dy, const int* __restrict__ amax,
                                      int R, int S, int D, T* __restrict__ dh4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * D) return;
  const size_t r = i / D;
  const int n = i % D;
  const size_t gi = (r / S) * D + n;
  dh4[i] = amax[gi] == (int)(r % S) ? dy[gi] : from_f32<T>(0.f);
}

// BatchNorm backward, elementwise:
// dh = gamma*rstd * ((dy - mean(dy)) - xhat * mean(dy*xhat)), rounded to T.
// sums: (sum dy, sum dy*xhat) per channel; dy of BN0 is read rounded to T.
template <typename T, int C, bool BN1>
__global__ void bn_bwd_kernel(Chain<T> ch, const float* __restrict__ dy,
                              const float* __restrict__ sdy, const float* __restrict__ sdyx,
                              const float* __restrict__ gamma, int R, float n,
                              T* __restrict__ dh) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * C) return;
  const int r = i / C, c = i % C;
  const float gm = gamma[c] * ch.st(BN1 ? RSTD1 : RSTD0)[c];
  const float g = BN1 ? dy[i] : round_to<T>(dy[i]);
  const float xh = BN1 ? ch.xhat3(r, c) : ch.xhat1(r, c);
  dh[i] = from_f32<T>(gm * ((g - sdy[c] / n) - xh * (sdyx[c] / n)));
}

// Max-pool backward of the h2 global feature (equal split among ties)
// plus the local half of dxc: dh2 = dxc[:, 128:] + (sum_S dxc[:, :128]) / cnt * eq.
template <typename T>
__global__ void gmax_bwd_kernel(const float* __restrict__ dxc, const T* __restrict__ h2,
                                const T* __restrict__ gmax, int ngroups, int S,
                                T* __restrict__ dh2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)ngroups * C2) return;
  const size_t g = i / C2;
  const int c = i % C2;
  const float mx = to_f32(gmax[i]);
  float dg = 0.f, cnt = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t r = g * S + s;
    dg += dxc[r * C3 + c];
    cnt += to_f32(h2[r * C2 + c]) == mx ? 1.f : 0.f;
  }
  const float share = dg / cnt;
  for (int s = 0; s < S; ++s) {
    const size_t r = g * S + s;
    const float eq = to_f32(h2[r * C2 + c]) == mx ? 1.f : 0.f;
    dh2[r * C2 + c] = from_f32<T>(dxc[r * C3 + C2 + c] + share * eq);
  }
}

unsigned blocks_for(size_t n) { return (unsigned)((n + 255) / 256); }

// The BatchNorm seams of a pass split over data-parallel ranks. `stage` 0
// runs a pass whole in one call (one rank); stages 1, 2 and 3 run it in
// three calls, ending at each of its two seams, where the wrapper
// all-reduces the raw column sums `sums` [2][C] over the ranks
// (ops/cuda/g2e_train.py) and passes them, with the global row count n, to
// the next stage (JAX g2e_train.py:409-411, :448-450, :536-543, :602-608).
// The forward's seam sums the partials part[nblk][2][C] into sums, in the
// order bn_finish_kernel sums them; a stage after a seam finishes the
// statistics from the reduced sums as one partial.
int seam(int nblk, int C, const float* part, float* sums, cudaStream_t st) {
  sum_parts(nblk, C, part, sums, sums + C, st);
  return (int)cudaGetLastError();
}

void finish_stats(int stage, const float* part, int nblk, const float* sums, int C, float n,
                  const float* gamma, const float* beta, float* stats, int base,
                  cudaStream_t st) {
  if (stage == 0)
    bn_finish_kernel<<<1, C3, 0, st>>>(part, nblk, C, n, gamma, beta, stats, base);
  else
    bn_finish_kernel<<<1, C3, 0, st>>>(sums, 1, C, n, gamma, beta, stats, base);
}

template <typename T>
void recompute_h2(Chain<T> ch, const T* w1, const T* b1, T* h2, T* gmax, int R, int S,
                  cudaStream_t st) {
  gemm<true, true>(R, C2, C1, 1, X1A<T>{ch}, RowMajor<T>{w1, C2}, StoreDense<T>{h2, b1, C2}, st);
  group_max_kernel<T><<<blocks_for((size_t)(R / S) * C2), 256, 0, st>>>(h2, R / S, S, C2, gmax,
                                                                       nullptr);
}

template <typename T>
int g2e_fwd(const void* x0, const void* w0, const void* b0, const void* g0, const void* be0,
            const void* w1, const void* b1, const void* w2, const void* b2, const void* g1,
            const void* be1, const void* w3, const void* b3, void* out, void* amax, void* h3p,
            void* stats, void* h2, void* gmax, void* h4, void* part, int R, int S, int cin, int D,
            int nblk, void* sums, float n, int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats_ = static_cast<float*>(stats);
  float* part_ = static_cast<float*>(part);
  float* sums_ = static_cast<float*>(sums);
  T* h2_ = static_cast<T*>(h2);
  T* gmax_ = static_cast<T*>(gmax);
  T* h3p_ = static_cast<T*>(h3p);
  T* h4_ = static_cast<T*>(h4);
  Chain<T> ch{static_cast<const T*>(x0), static_cast<const T*>(w0), static_cast<const T*>(b0),
              stats_, h3p_, cin};
  // F1: BatchNorm_0 statistics of h1p
  if (stage <= 1) {
    colsum2(R, C1, nblk, L0Sq<T>{ch}, part_, st);
    if (stage == 1) return seam(nblk, C1, part_, sums_, st);
  }
  // F2: BatchNorm_0 statistics; h2, its group maxima, h3p (cached) and
  // BatchNorm_1 statistics
  if (stage <= 2) {
    finish_stats(stage, part_, nblk, sums_, C1, n, static_cast<const float*>(g0),
                 static_cast<const float*>(be0), stats_, MU0, st);
    recompute_h2<T>(ch, static_cast<const T*>(w1), static_cast<const T*>(b1), h2_, gmax_, R, S,
                    st);
    gemm<true, true>(R, C3, C3, 1, XCA<T>{XC<T>{gmax_, h2_, S}},
                     RowMajor<T>{static_cast<const T*>(w2), C3},
                     StoreDense<T>{h3p_, static_cast<const T*>(b2), C3}, st);
    colsum2(R, C3, nblk, RowSq<T>{h3p_, C3}, part_, st);
    if (stage == 2) return seam(nblk, C3, part_, sums_, st);
  }
  finish_stats(stage, part_, nblk, sums_, C3, n, static_cast<const float*>(g1),
               static_cast<const float*>(be1), stats_, MU1, st);
  // F3: h4, its group maxima and first argmax
  gemm<true, true>(R, D, C3, 1, X3A<T>{ch}, RowMajor<T>{static_cast<const T*>(w3), D},
                   StoreDense<T>{h4_, static_cast<const T*>(b3), D}, st);
  group_max_kernel<T><<<blocks_for((size_t)(R / S) * D), 256, 0, st>>>(
      h4_, R / S, S, D, static_cast<T*>(out), static_cast<int*>(amax));
  return cudaGetLastError();
}

template <typename T>
int g2e_bwd(const void* x0, const void* w0, const void* b0, const void* g0, const void* w1,
            const void* b1, const void* w2, const void* b2, const void* g1, const void* w3,
            const void* h3p, const void* amax, const void* stats, const void* dy, void* dx0,
            void* dw0, void* db0, void* dg0, void* dbe0, void* dw1, void* db1, void* dw2,
            void* db2, void* dg1, void* dbe1, void* dw3, void* db3, void* dh4, void* dy3,
            void* h2, void* gmax, void* dh3p, void* dxc, void* dh2, void* dy1, void* dh1p,
            void* part, void* wpart, int R, int S, int cin, int D, int nblk, int splits,
            void* sums, float n, int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sums_ = static_cast<const float*>(sums);
  const float* stats_ = static_cast<const float*>(stats);
  float* part_ = static_cast<float*>(part);
  float* wpart_ = static_cast<float*>(wpart);
  const T* w0_ = static_cast<const T*>(w0);
  const T* w1_ = static_cast<const T*>(w1);
  const T* w2_ = static_cast<const T*>(w2);
  const T* w3_ = static_cast<const T*>(w3);
  T* dh4_ = static_cast<T*>(dh4);
  float* dy3_ = static_cast<float*>(dy3);
  T* h2_ = static_cast<T*>(h2);
  T* gmax_ = static_cast<T*>(gmax);
  T* dh3p_ = static_cast<T*>(dh3p);
  float* dxc_ = static_cast<float*>(dxc);
  T* dh2_ = static_cast<T*>(dh2);
  float* dy1_ = static_cast<float*>(dy1);
  T* dh1p_ = static_cast<T*>(dh1p);
  float* dbe1_ = static_cast<float*>(dbe1);
  float* dg1_ = static_cast<float*>(dg1);
  float* dbe0_ = static_cast<float*>(dbe0);
  float* dg0_ = static_cast<float*>(dg0);
  Chain<T> ch{static_cast<const T*>(x0), w0_, static_cast<const T*>(b0), stats_,
              static_cast<const T*>(h3p), cin};

  // P1: dh4 at the argmax rows; dW3, db3; dy3 = relu'(x3) * dh4 W3^T; BN1 sums
  // (this rank's: dbe1, dg1; the seam's reduced sums feed dh3p)
  if (stage <= 1) {
    scatter_argmax_kernel<T><<<blocks_for((size_t)R * D), 256, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const int*>(amax), R, S, D, dh4_);
    gemm<false, true>(C3, D, R, splits, X3T<T>{ch}, RowMajor<T>{dh4_, D},
                      StoreSplit{wpart_, C3, D}, st);
    sum_splits(splits, C3 * D, wpart_, static_cast<float*>(dw3), st);
    colsum2(R, D, nblk, Col<T>{dh4_, D}, part_, st);
    sum_parts(nblk, D, part_, static_cast<float*>(db3), nullptr, st);
    gemm<true, false>(R, C3, D, 1, RowMajor<T>{dh4_, D}, Transposed<T>{w3_, D},
                      StoreRelu3<T>{ch, dy3_}, st);
    colsum2(R, C3, nblk, Bn1Grad<T>{ch, dy3_}, part_, st);
    sum_parts(nblk, C3, part_, dbe1_, dg1_, st);
    if (stage == 1) return cudaGetLastError();
  }

  // P2: dh3p; dW2, db2; dxc = dh3p W2^T; the pool's tie split; dW1, db1;
  // dy1 = relu'(x1) * dh2 W1^T; BN0 sums
  if (stage == 0 || stage == 2) {
    bn_bwd_kernel<T, C3, true><<<blocks_for((size_t)R * C3), 256, 0, st>>>(
        ch, dy3_, stage == 0 ? dbe1_ : sums_, stage == 0 ? dg1_ : sums_ + C3,
        static_cast<const float*>(g1), R, n, dh3p_);
    recompute_h2<T>(ch, w1_, static_cast<const T*>(b1), h2_, gmax_, R, S, st);
    gemm<false, true>(C3, C3, R, splits, XCT<T>{XC<T>{gmax_, h2_, S}}, RowMajor<T>{dh3p_, C3},
                      StoreSplit{wpart_, C3, C3}, st);
    sum_splits(splits, C3 * C3, wpart_, static_cast<float*>(dw2), st);
    colsum2(R, C3, nblk, Col<T>{dh3p_, C3}, part_, st);
    sum_parts(nblk, C3, part_, static_cast<float*>(db2), nullptr, st);
    gemm<true, false>(R, C3, C3, 1, RowMajor<T>{dh3p_, C3}, Transposed<T>{w2_, C3},
                      StoreF32{dxc_, C3}, st);
    gmax_bwd_kernel<T><<<blocks_for((size_t)(R / S) * C2), 256, 0, st>>>(dxc_, h2_, gmax_, R / S,
                                                                        S, dh2_);
    gemm<false, true>(C1, C2, R, splits, X1T<T>{ch}, RowMajor<T>{dh2_, C2},
                      StoreSplit{wpart_, C1, C2}, st);
    sum_splits(splits, C1 * C2, wpart_, static_cast<float*>(dw1), st);
    colsum2(R, C2, nblk, Col<T>{dh2_, C2}, part_, st);
    sum_parts(nblk, C2, part_, static_cast<float*>(db1), nullptr, st);
    gemm<true, false>(R, C1, C2, 1, RowMajor<T>{dh2_, C2}, Transposed<T>{w1_, C2},
                      StoreRelu1<T>{ch, dy1_}, st);
    colsum2(R, C1, nblk, Bn0Grad<T>{ch, dy1_}, part_, st);
    sum_parts(nblk, C1, part_, dbe0_, dg0_, st);
    if (stage == 2) return cudaGetLastError();
  }

  // P3: dh1p; dW0, db0; dx0 = dh1p W0^T
  bn_bwd_kernel<T, C1, false><<<blocks_for((size_t)R * C1), 256, 0, st>>>(
      ch, dy1_, stage == 0 ? dbe0_ : sums_, stage == 0 ? dg0_ : sums_ + C1,
      static_cast<const float*>(g0), R, n, dh1p_);
  gemm<false, true>(cin, C1, R, splits, Transposed<T>{static_cast<const T*>(x0), cin},
                    RowMajor<T>{dh1p_, C1}, StoreSplit{wpart_, cin, C1}, st);
  sum_splits(splits, cin * C1, wpart_, static_cast<float*>(dw0), st);
  colsum2(R, C1, nblk, Col<T>{dh1p_, C1}, part_, st);
  sum_parts(nblk, C1, part_, static_cast<float*>(db0), nullptr, st);
  gemm<true, false>(R, cin, C1, 1, RowMajor<T>{dh1p_, C1}, Transposed<T>{w0_, C1},
                    StoreDense<T>{static_cast<T*>(dx0), nullptr, cin}, st);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16, on the tensor cores
// Every pass below is one kernel over row tiles of whole groups (TR = 128
// rows hold floor(128 / S) groups; the rest of the tile is masked), 16
// warps of 32 rows x N/4 columns of f32 accumulators, products on
// mma.sync through the warp tiles of mma.cuh. Weights stay in shared
// memory for the whole launch: the blocks are persistent (one an SM) and
// walk their row tiles in a fixed order, so each block's partial sums, and
// the fixed-order sums over blocks after them, give the same bits every
// run. Recomputed operands (x1, xc, x3, dh4) are formed in registers and
// stored to shared rows padded by 8 bf16 (ldmatrix meets no bank
// conflict); no h4, dh4 and no f32 array of R rows reaches device memory.
namespace tc {

namespace mm = vpt::mma;
using bf16 = mm::bf16;

constexpr int TR = 128;  // rows of a tile
constexpr int WARPS = 16, THREADS = 32 * WARPS;
constexpr int LD2 = C2 + 8, LD3 = C3 + 8;  // padded bf16 rows of 128 and 256 columns
constexpr int LDF2 = C2 + 4, LDF1 = C1 + 4;  // f32 staging rows of 128 and 64 columns
constexpr int EQ_WORDS = C2 / 32;            // the bits h2 == gmax of a row
// shared memory, bytes: W2 [256][264], W1 [64][136], a tile [128][264]
constexpr int W2_SMEM = 2 * C3 * LD3, W1_SMEM = 2 * C1 * LD2, T_SMEM = 2 * TR * LD3;
constexpr int MID_FWD_SMEM = W2_SMEM + W1_SMEM + T_SMEM;         // 220,160
constexpr int MID_BWD_SMEM = MID_FWD_SMEM + 4 * TR * EQ_WORDS;   // 222,208
static_assert(4 * TR * LDF2 <= T_SMEM, "f32 staging of 128 columns fits a tile");
// The kernels take D a multiple of 64 (ops/cuda/g2e_train.py pads W3, b3,
// dy and the argmax with zero columns up to one). F3 cuts D into slices of
// the widest N of 256, 192, 128 and 64 that divides it; P1 / P2a take D in
// chunks of at most DY3_COLS columns.
constexpr int DY3_COLS = 384;
constexpr int out_cols(int d) {
  return d % 256 == 0 ? 256 : d % 192 == 0 ? 192 : d % 128 == 0 ? 128 : 64;
}
__host__ __device__ constexpr int dy3_cols(int d) { return d < DY3_COLS ? d : DY3_COLS; }
// F3: W3's column slice [256][N + 8] and a tile; P1 / P2a: W3's row slice
// [128][kc + 8] and the dh4 tile [128][kc + 8] of a chunk of kc = dy3_cols(D)
// columns (at least the f32 staging)
constexpr int out_smem(int n) { return 2 * C3 * (n + 8) + T_SMEM; }
constexpr int dy3_smem(int d) {
  const int ld = dy3_cols(d) + 8;
  return 2 * TR * ld + (2 * TR * ld > 4 * TR * LDF2 ? 2 * TR * ld : 4 * TR * LDF2);
}

struct Tile {
  int row0, valid, groups;
};
// Tile t: rows [row0, row0 + valid), `groups` whole groups.
__device__ __forceinline__ Tile tile_at(int t, int S, int R) {
  const int rows = TR / S * S, row0 = t * rows, valid = min(rows, R - row0);
  return Tile{row0, valid, valid / S};
}
__device__ __forceinline__ int num_tiles(int S, int R) {
  const int rows = TR / S * S;
  return (R + rows - 1) / rows;
}

using mm::block_mma;  // K9's products: round-to-nearest k steps (the default)
using mm::for_pairs;

__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mm::pack_bf16x2(a, b);
}
// Dense's emit: the product rounded to bf16, then the bias added and rounded.
__device__ __forceinline__ float dense_out(float acc, float bias) {
  return round_to<bf16>(round_to<bf16>(acc) + bias);
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(mm::pack_bf16x2(f[0], f[1]), mm::pack_bf16x2(f[2], f[3]),
                    mm::pack_bf16x2(f[4], f[5]), mm::pack_bf16x2(f[6], f[7]));
}

// rows x cols (a multiple of 8) bf16 from device memory (rows `stride`
// apart) into shared rows of `ld`, as 16-byte cp.async; rows at or past
// `valid` zero-filled, never read.
__device__ __forceinline__ void cp_tile(bf16* dst, int ld, const bf16* src, size_t stride,
                                        int rows, int cols, int valid, int tid) {
  const int cpr = cols >> 3;
  for (int e = tid; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, q = e - r * cpr;
    const bool ok = r < valid;
    mm::cp_async16(dst + r * ld + 8 * q, ok ? src + r * stride + 8 * q : src, ok);
  }
}
// rows [0, valid) x cols (a multiple of 8) of a shared tile -> device rows
// `stride` apart, 16 bytes a store.
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, const bf16* src, int ld,
                                           int valid, int cols, int tid) {
  const int cpr = cols >> 3;
  for (int e = tid; e < valid * cpr; e += THREADS) {
    const int r = e / cpr, q = e - r * cpr;
    *reinterpret_cast<uint4*>(dst + r * stride + 8 * q) =
        *reinterpret_cast<const uint4*>(src + r * ld + 8 * q);
  }
}
__device__ __forceinline__ void zero_shared(void* p, int bytes, int tid) {
  uint4* q = static_cast<uint4*>(p);
  for (int e = tid; e < bytes / 16; e += THREADS) q[e] = make_uint4(0u, 0u, 0u, 0u);
}

// x1 of the tile's rows into columns 0-63 of xs (rows LD3 apart), 0 past
// `valid`; with x1g, also into device memory [R, 64]. Thread t takes row
// t / 4, columns 16 (t % 4) .. + 16.
__device__ __forceinline__ void stage_x1(bf16* xs, const bf16* x0, const bf16* w0,
                                         const bf16* b0, const float* stats, const Tile& tl,
                                         int cin, int tid, bf16* x1g) {
  const int r = tid >> 2, c0 = (tid & 3) * 16;
  float v[16];
  if (r < tl.valid) {
    const bf16* xr = x0 + (size_t)(tl.row0 + r) * cin;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int c = c0 + q;
      v[q] = bn_relu<bf16>(h1p_of(xr, w0, b0, c, cin), stats[A0 * C3 + c], stats[SH0 * C3 + c]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = 0.f;
  }
  const uint4 lo = pack8(v), hi = pack8(v + 8);
  uint4* s = reinterpret_cast<uint4*>(xs + r * LD3 + c0);
  s[0] = lo;
  s[1] = hi;
  if (x1g != nullptr && r < tl.valid) {
    uint4* g = reinterpret_cast<uint4*>(x1g + (size_t)(tl.row0 + r) * C1 + c0);
    g[0] = lo;
    g[1] = hi;
  }
}

// From x1 in columns 0-63 of the tile T (rows LD3 apart): h2 = x1 W1 + b1
// on the tensor cores into columns 128-255, then each group's max of h2
// into columns 0-127 of its rows, so T holds xc = [gmax | h2]; with eq
// (zeroed), the bits h2 == gmax of each row. The same code in F2 and P2,
// so both see the same h2 and gmax. Ends with a barrier.
__device__ __forceinline__ void h2_gmax(bf16* T, const bf16* w1s, const bf16* b1, const Tile& tl,
                                        int S, int tid, uint32_t* eq) {
  const int warp = tid >> 5, lane = tid & 31;
  {
    float c[2][C2 / 32][4];
    block_mma<C2, false>(c, T, LD3, w1s, LD2, C1, warp, lane);
    // x1 (columns 0-63) and h2 (128-255) do not overlap: no barrier here
    for_pairs<C2>(c, warp, lane, [&](int r, int col, float v0, float v1) {
      st_pair(T + r * LD3 + C2 + col, dense_out(v0, to_f32(b1[col])),
              dense_out(v1, to_f32(b1[col + 1])));
    });
  }
  __syncthreads();
  for (int p = tid; p < tl.groups * C2; p += THREADS) {
    const int g = p >> 7, col = p & (C2 - 1);
    bf16* rows = T + g * S * LD3;
    float m = to_f32(rows[C2 + col]);
    for (int s = 1; s < S; ++s) m = fmaxf(m, to_f32(rows[s * LD3 + C2 + col]));
    const bf16 mb = from_f32<bf16>(m);
    for (int s = 0; s < S; ++s) {
      if (eq != nullptr && to_f32(rows[s * LD3 + C2 + col]) == m)
        atomicOr(eq + (g * S + s) * EQ_WORDS + (col >> 5), 1u << (col & 31));
      rows[s * LD3 + col] = mb;
    }
  }
  __syncthreads();
}

// F2: per tile, x1 and h2 (h2_gmax), h3p = xc W2 + b2 (written), and the
// column sums of (h3p, h3p^2) over the block's tiles -> part[block][2][256].
// W1 and W2 stay in shared memory; one block an SM (MID_FWD_SMEM).
__global__ void __launch_bounds__(THREADS, 1)
    fwd_mid_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ w0,
                   const bf16* __restrict__ b0, const float* __restrict__ stats,
                   const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                   const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                   bf16* __restrict__ h3p, float* __restrict__ part, int R, int S, int cin) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  bf16* w1s = w2s + C3 * LD3;
  bf16* T = w1s + C1 * LD2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  cp_tile(w2s, LD3, w2, C3, C3, C3, C3, tid);
  cp_tile(w1s, LD2, w1, C2, C1, C2, C1, tid);
  mm::cp_async_commit();
  zero_shared(T, T_SMEM, tid);
  mm::cp_async_wait<0>();
  __syncthreads();
  const int col = tid & (C3 - 1), half = tid >> 8;  // the column sums' share
  float s1 = 0.f, s2 = 0.f;
  const int ntiles = num_tiles(S, R);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_at(t, S, R);
    stage_x1(T, x0, w0, b0, stats, tl, cin, tid, nullptr);
    __syncthreads();
    h2_gmax(T, w1s, b1, tl, S, tid, nullptr);
    float c[2][C3 / 32][4];
    block_mma<C3, false>(c, T, LD3, w2s, LD3, C3, warp, lane);
    __syncthreads();
    for_pairs<C3>(c, warp, lane, [&](int r, int cc, float v0, float v1) {
      st_pair(T + r * LD3 + cc, dense_out(v0, to_f32(b2[cc])), dense_out(v1, to_f32(b2[cc + 1])));
    });
    __syncthreads();
    store_rows(h3p + (size_t)tl.row0 * C3, C3, T, LD3, tl.valid, C3, tid);
    // the tile's sums, then the block's: short chains of f32 additions
    const int r1 = min(tl.valid, 64 * half + 64);
    float t1 = 0.f, t2 = 0.f;
    for (int r = 64 * half; r < r1; ++r) {
      const float h = to_f32(T[r * LD3 + col]);
      t1 += h;
      t2 += h * h;
    }
    s1 += t1;
    s2 += t2;
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(T);
  red[tid] = s1;
  red[THREADS + tid] = s2;
  __syncthreads();
  if (tid < C3) {
    part[(blockIdx.x * 2 + 0) * C3 + tid] = red[tid] + red[C3 + tid];
    part[(blockIdx.x * 2 + 1) * C3 + tid] = red[THREADS + tid] + red[THREADS + C3 + tid];
  }
}

// F3: block b owns columns [n0, n0 + N) of h4, n0 = N (b % (D / N)), and
// walks row tiles; per tile x3 = relu(bn1(h3p)) is staged, h4 = x3 W3 + b3
// on the tensor cores rounded into shared memory, and each group's max and
// FIRST argmax (the smallest row among equal values) written. W3's column
// slice stays in shared memory (out_smem(N)).
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_out_kernel(const bf16* __restrict__ h3p, const float* __restrict__ stats,
                   const bf16* __restrict__ w3, const bf16* __restrict__ b3,
                   bf16* __restrict__ out, int* __restrict__ amax, int R, int S, int D) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w3s = reinterpret_cast<bf16*>(smem);
  bf16* T = w3s + C3 * LDN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nct = D / N, n0 = (blockIdx.x % nct) * N, nb = gridDim.x / nct;
  cp_tile(w3s, LDN, w3 + n0, D, C3, N, C3, tid);
  mm::cp_async_commit();
  zero_shared(T, T_SMEM, tid);
  mm::cp_async_wait<0>();
  __syncthreads();
  const int ntiles = num_tiles(S, R);
  for (int t = blockIdx.x / nct; t < ntiles; t += nb) {
    const Tile tl = tile_at(t, S, R);
    for (int e = tid; e < TR * (C3 / 8); e += THREADS) {
      const int r = e >> 5, q = (e & 31) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < tl.valid) {
        unpack8(*reinterpret_cast<const uint4*>(h3p + (size_t)(tl.row0 + r) * C3 + q), v);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = bn_relu<bf16>(v[k], stats[A1 * C3 + q + k], stats[SH1 * C3 + q + k]);
      }
      *reinterpret_cast<uint4*>(T + r * LD3 + q) = pack8(v);
    }
    __syncthreads();
    float c[2][N / 32][4];
    block_mma<N, false>(c, T, LD3, w3s, LDN, C3, warp, lane);
    __syncthreads();
    for_pairs<N>(c, warp, lane, [&](int r, int cc, float v0, float v1) {
      st_pair(T + r * LDN + cc, dense_out(v0, to_f32(b3[n0 + cc])),
              dense_out(v1, to_f32(b3[n0 + cc + 1])));
    });
    __syncthreads();
    for (int p = tid; p < tl.groups * N; p += THREADS) {
      const int g = p / N, cc = p - g * N;
      const bf16* rows = T + g * S * LDN + cc;
      float best = to_f32(rows[0]);
      int arg = 0;
      for (int s = 1; s < S; ++s) {
        const float v = to_f32(rows[s * LDN]);
        if (v > best) {
          best = v;
          arg = s;
        }
      }
      const size_t o = (size_t)(tl.row0 / S + g) * D + n0 + cc;
      out[o] = from_f32<bf16>(best);
      amax[o] = arg;
    }
    __syncthreads();
  }
}

// P1 (DH3P false) and P2's first half (DH3P true): block b owns columns
// [c0, c0 + 128) of the 256 (c0 = 128 (b % 2)) and walks row tiles; per
// tile dh4 is formed in shared memory (zero, then each group's dy at its
// argmax row), dy3 = relu'(x3) (dh4 W3^T) on the tensor cores, staged in
// f32. Up to D = DY3_COLS, W3's row slice stays in shared memory for the
// launch; a wider D is taken in chunks of DY3_COLS columns, each chunk's
// slice of W3 loaded and its dh4 formed per tile, the chunks' products
// added in registers. P1 sums (dy3, dy3 xhat3)
// per column over its tiles -> part[b / 2][2][256]; P2 writes dh3p = bn1's
// backward of dy3, rounded to bf16, from the sums s1b, s2b, sums it per
// column (db2) -> part[b / 2][0][256] and over each group's rows -> gsum
// [R / S][256] (f32). Both run the same product on the same inputs: the
// same dy3.
// Numerics: dh3p's f32 steps round one by one as the twin's do (no FMA
// contraction), and the sums are f64 (partials too; sum_parts_f64 rounds
// them once). dh3p = gamma rstd ((dy3 - s1b / R) - xhat3 s2b / R) nearly
// cancels where relu' is 0, so the last bits of s1b and s2b (which an f32
// sum of R terms in another order moves) decide some of its bf16
// roundings, and through dxc each of those moves a share of its row of
// dh2, whose column sums are the exactly-zero db1. The bias gradient db2
// is summed here, on the CUDA cores, not by K11's all-ones tensor-core
// product, for the same reason.
template <bool DH3P>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dy3_kernel(const bf16* __restrict__ h3p, const int* __restrict__ amax,
                   const bf16* __restrict__ dy, const float* __restrict__ stats,
                   const bf16* __restrict__ w3, const float* __restrict__ g1,
                   const float* __restrict__ s1b, const float* __restrict__ s2b, float n,
                   bf16* __restrict__ dh3p, float* __restrict__ gsum, double* __restrict__ part,
                   int R, int S, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = dy3_cols(D), ldw = kc + 8;
  const bool resident = kc == D;  // W3's row slice loaded once
  bf16* w3s = reinterpret_cast<bf16*>(smem);
  bf16* T = w3s + C2 * ldw;
  float* st = reinterpret_cast<float*>(T);  // dy3 [128][LDF2] after the product
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = (blockIdx.x & 1) * C2, nb = gridDim.x >> 1;
  if (resident) {
    cp_tile(w3s, ldw, w3 + (size_t)c0 * D, D, C2, D, C2, tid);
    mm::cp_async_commit();
  }
  // the column pass: thread t takes column c0 + t % 128, rows 32 (t / 128) .. + 32
  const int col = tid & (C2 - 1), quarter = tid >> 7, c = c0 + col;
  const float mu = stats[MU1 * C3 + c], rstd = stats[RSTD1 * C3 + c];
  const float a = stats[A1 * C3 + c], sh = stats[SH1 * C3 + c];
  float gm = 0.f, m1 = 0.f, m2 = 0.f;
  if (DH3P) {
    gm = __fmul_rn(g1[c], rstd);
    m1 = __fdiv_rn(s1b[c], n);
    m2 = __fdiv_rn(s2b[c], n);
  }
  double sd = 0.0, sdx = 0.0;
  mm::cp_async_wait<0>();
  __syncthreads();
  const int ntiles = num_tiles(S, R);
  for (int t = blockIdx.x >> 1; t < ntiles; t += nb) {
    const Tile tl = tile_at(t, S, R);
    const int g0 = tl.row0 / S;
    float acc[2][C2 / 32][4];
    for (int k0 = 0; k0 < D; k0 += kc) {
      const int kw = min(kc, D - k0);
      if (!resident) {
        cp_tile(w3s, ldw, w3 + (size_t)c0 * D + k0, D, C2, kw, C2, tid);
        mm::cp_async_commit();
      }
      zero_shared(T, 2 * TR * ldw, tid);
      __syncthreads();
      for (int p = tid; p < tl.groups * kw; p += THREADS) {
        const int g = p / kw, nn = p - g * kw;
        const size_t o = (size_t)(g0 + g) * D + k0 + nn;
        T[(g * S + amax[o]) * ldw + nn] = dy[o];
      }
      mm::cp_async_wait<0>();
      __syncthreads();
      block_mma<C2, true>(acc, T, ldw, w3s, ldw, kw, warp, lane, k0 > 0);
      __syncthreads();
    }
    for_pairs<C2>(acc, warp, lane, [&](int r, int cc, float v0, float v1) {
      *reinterpret_cast<float2*>(st + r * LDF2 + cc) = make_float2(v0, v1);
    });
    __syncthreads();
    const int r1 = min(tl.valid, 32 * quarter + 32);
#pragma unroll 4
    for (int r = 32 * quarter; r < r1; ++r) {
      const size_t o = (size_t)(tl.row0 + r) * C3 + c;
      const float h = to_f32(h3p[o]);
      const float d = bn_relu<bf16>(h, a, sh) > 0.f ? st[r * LDF2 + col] : 0.f;
      const float xh = __fmul_rn(__fsub_rn(h, mu), rstd);
      if (DH3P) {
        const bf16 v =
            from_f32<bf16>(__fmul_rn(gm, __fsub_rn(__fsub_rn(d, m1), __fmul_rn(xh, m2))));
        dh3p[o] = v;
        sd += to_f32(v);  // db2: the column sums of the rounded dh3p
      } else {
        sd += d;
        sdx += __fmul_rn(d, xh);
      }
    }
    __syncthreads();
    if (DH3P) {  // each group's sum of dh3p over its rows (this block's rows, read back)
      for (int p = tid; p < tl.groups * C2; p += THREADS) {
        const int g = p >> 7, cc = p & (C2 - 1);
        const bf16* src = dh3p + (size_t)(tl.row0 + g * S) * C3 + c0 + cc;
        float sum = 0.f;
        for (int s2 = 0; s2 < S; ++s2) sum += to_f32(src[(size_t)s2 * C3]);
        gsum[(size_t)(g0 + g) * C3 + c0 + cc] = sum;
      }
    }
  }
  double* sst = reinterpret_cast<double*>(T);
  sst[tid] = sd;
  sst[THREADS + tid] = sdx;
  __syncthreads();
  if (tid < C2) {
    double u = 0.0, v = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u += sst[k * C2 + tid];
      v += sst[THREADS + k * C2 + tid];
    }
    part[((blockIdx.x >> 1) * 2 + 0) * C3 + c0 + tid] = u;
    if (!DH3P) part[((blockIdx.x >> 1) * 2 + 1) * C3 + c0 + tid] = v;
  }
}

// P2's second half: per tile, x1 (written) and h2, gmax, xc (written; the
// same code as F2), dxc's local half dh3p W2[128:]^T on the tensor cores
// (dh3p copied in); of its gmax half only each group's sum over its rows
// is needed, which is (the group's sum of dh3p, gsum [R / S][256] from
// P2's first half) W2[:128]^T, 1/S of the products, f32 on the CUDA cores;
// split among h2's ties: dh2 = dxc[:, 128:] + (sum dxc[:, :128]) / cnt at
// the ties, rounded to bf16 (written); dy1 = relu'(x1) (dh2 W1^T) on the
// tensor cores, written in bf16, and the column sums of (dy1, dy1 xhat1)
// over the block's tiles in f64 -> part[block][2][64], of dh2 (db1) ->
// bpart[block][128]. W1 and W2 stay in shared memory; one block an SM
// (MID_BWD_SMEM).
__global__ void __launch_bounds__(THREADS, 1)
    bwd_mid_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ w0,
                   const bf16* __restrict__ b0, const float* __restrict__ stats,
                   const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                   const bf16* __restrict__ w2, const bf16* __restrict__ dh3p,
                   const float* __restrict__ gsum, bf16* __restrict__ x1,
                   bf16* __restrict__ xc, bf16* __restrict__ dh2,
                   bf16* __restrict__ dy1, double* __restrict__ part, float* __restrict__ bpart,
                   int R, int S, int cin) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  bf16* w1s = w2s + C3 * LD3;
  bf16* T = w1s + C1 * LD2;
  uint32_t* eq = reinterpret_cast<uint32_t*>(T + TR * LD3);
  float* st = reinterpret_cast<float*>(T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  cp_tile(w2s, LD3, w2, C3, C3, C3, C3, tid);
  cp_tile(w1s, LD2, w1, C2, C1, C2, C1, tid);
  mm::cp_async_commit();
  zero_shared(T, T_SMEM, tid);
  // the column pass of dy1: thread t takes column t % 64, rows 16 (t / 64) .. + 16
  const int col = tid & (C1 - 1), part8 = tid >> 6;
  double sd = 0.0, sdx = 0.0;  // f64, as P1's: they decide dh1p's roundings
  float sb = 0.f;
  mm::cp_async_wait<0>();
  __syncthreads();
  const int ntiles = num_tiles(S, R);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_at(t, S, R);
    const size_t row0 = tl.row0;
    eq[tid] = 0u;  // TR * EQ_WORDS == THREADS words
    stage_x1(T, x0, w0, b0, stats, tl, cin, tid, x1);
    __syncthreads();
    h2_gmax(T, w1s, b1, tl, S, tid, eq);
    store_rows(xc + row0 * C3, C3, T, LD3, tl.valid, C3, tid);
    __syncthreads();
    cp_tile(T, LD3, dh3p + row0 * C3, C3, TR, C3, tl.valid, tid);
    mm::cp_async_commit();
    mm::cp_async_wait<0>();
    __syncthreads();
    // dxc's local half, dxc[:, 128:] = dh3p W2[128:]^T, on the tensor cores
    float acc[2][C2 / 32][4];
    block_mma<C2, true>(acc, T, LD3, w2s + C2 * LD3, LD3, C3, warp, lane);
    __syncthreads();
    // its gmax half only as each group's sum over its rows: (the group's
    // sum of dh3p, from P2's first half) W2[:128]^T, f32 on the CUDA cores,
    // split among h2's ties -> share [groups][128] in the tile
    for (int p = tid; p < tl.groups * C2; p += THREADS) {
      const int g = p >> 7, j = p & (C2 - 1);
      const float* gs = gsum + (size_t)(row0 / S + g) * C3;
      const bf16* w = w2s + j * LD3;
      float sum = 0.f, cnt = 0.f;
      for (int c = 0; c < C3; ++c) sum = fmaf(gs[c], to_f32(w[c]), sum);
      for (int s = 0; s < S; ++s)
        cnt += (eq[(g * S + s) * EQ_WORDS + (j >> 5)] >> (j & 31)) & 1u ? 1.f : 0.f;
      st[g * C2 + j] = sum / cnt;
    }
    __syncthreads();
    for_pairs<C2>(acc, warp, lane, [&](int r, int j, float& v0, float& v1) {
      const float* share = st + (r / S) * C2 + j;
      const uint32_t bits = eq[r * EQ_WORDS + (j >> 5)] >> (j & 31);
      v0 = round_to<bf16>(bits & 1u ? v0 + share[0] : v0);
      v1 = round_to<bf16>(bits & 2u ? v1 + share[1] : v1);
    });
    __syncthreads();
    for_pairs<C2>(acc, warp, lane, [&](int r, int j, float v0, float v1) {
      st_pair(T + r * LD2 + j, v0, v1);
    });
    __syncthreads();
    store_rows(dh2 + row0 * C2, C2, T, LD2, tl.valid, C2, tid);
    {  // db1: the column sums of the rounded dh2, thread t column t % 128
      const int r1 = min(tl.valid, 32 * (tid >> 7) + 32);
      float tb = 0.f;
      for (int r = 32 * (tid >> 7); r < r1; ++r) tb += to_f32(T[r * LD2 + (tid & (C2 - 1))]);
      sb += tb;
    }
    {
      float d1[2][C1 / 32][4];
      block_mma<C1, true>(d1, T, LD2, w1s, LD2, C2, warp, lane);
      __syncthreads();
      for_pairs<C1>(d1, warp, lane, [&](int r, int cc, float v0, float v1) {
        *reinterpret_cast<float2*>(st + r * LDF1 + cc) = make_float2(v0, v1);
      });
    }
    __syncthreads();
    const int r1 = min(tl.valid, 16 * part8 + 16);
    const float mu = stats[MU0 * C3 + col], rstd = stats[RSTD0 * C3 + col];
    const float a = stats[A0 * C3 + col], sh = stats[SH0 * C3 + col];
    for (int r = 16 * part8; r < r1; ++r) {
      const float h = h1p_of(x0 + (row0 + r) * cin, w0, b0, col, cin);
      const float d = bn_relu<bf16>(h, a, sh) > 0.f ? st[r * LDF1 + col] : 0.f;
      sd += d;
      sdx += __fmul_rn(d, __fmul_rn(__fsub_rn(h, mu), rstd));  // the twin's roundings
      dy1[(row0 + r) * C1 + col] = from_f32<bf16>(d);
    }
    __syncthreads();
  }
  double* sst = reinterpret_cast<double*>(T);
  sst[tid] = sd;
  sst[THREADS + tid] = sdx;
  st[4 * THREADS + tid] = sb;
  __syncthreads();
  if (tid < C1) {
    double u = 0.0, v = 0.0;
#pragma unroll
    for (int k = 0; k < THREADS / C1; ++k) {
      u += sst[k * C1 + tid];
      v += sst[THREADS + k * C1 + tid];
    }
    part[(blockIdx.x * 2 + 0) * C1 + tid] = u;
    part[(blockIdx.x * 2 + 1) * C1 + tid] = v;
  }
  if (tid < C2) {
    float u = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) u += st[4 * THREADS + k * C2 + tid];
    bpart[(size_t)blockIdx.x * C2 + tid] = u;
  }
}

// P3 on the CUDA cores (Cin <= 16: under 1% of the operations): a warp a
// row, lane l columns 2l and 2l + 1: dh1p = bn0's backward of dy1 (bf16),
// rounded; dx0 = dh1p W0^T (the warp's sum), rounded; dW0 and db0 summed
// over the block's rows -> wpart[block][cin][64], bpart[block][64].
constexpr int IN_WARPS = 8;
__global__ void __launch_bounds__(32 * IN_WARPS)
    bwd_in_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ w0,
                  const bf16* __restrict__ b0, const float* __restrict__ stats,
                  const float* __restrict__ g0, const float* __restrict__ s1a,
                  const float* __restrict__ s2a, float n, const bf16* __restrict__ dy1, int R,
                  int cin, int per, bf16* __restrict__ dx0, float* __restrict__ wpart,
                  float* __restrict__ bpart) {
  __shared__ float red[IN_WARPS][MAX_CIN + 1][C1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mu[2], rstd[2], gm[2], m1[2], m2[2], db[2], w[MAX_CIN][2], dw[MAX_CIN][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = 2 * lane + e;
    mu[e] = stats[MU0 * C3 + c];
    rstd[e] = stats[RSTD0 * C3 + c];
    gm[e] = __fmul_rn(g0[c], rstd[e]);
    m1[e] = __fdiv_rn(s1a[c], n);
    m2[e] = __fdiv_rn(s2a[c], n);
    db[e] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_CIN; ++i) {
      w[i][e] = i < cin ? to_f32(w0[i * C1 + c]) : 0.f;
      dw[i][e] = 0.f;
    }
  }
  const int r0 = blockIdx.x * per, r1 = min(R, r0 + per);
  for (int r = r0 + warp; r < r1; r += IN_WARPS) {
    const bf16* xr = x0 + (size_t)r * cin;
    const uint32_t d2 = *reinterpret_cast<const uint32_t*>(dy1 + (size_t)r * C1 + 2 * lane);
    const float dyv[2] = {__uint_as_float(d2 << 16), __uint_as_float(d2 & 0xffff0000u)};
    float dh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float h = h1p_of(xr, w0, b0, 2 * lane + e, cin);
      const float xh = __fmul_rn(__fsub_rn(h, mu[e]), rstd[e]);  // the twin's roundings
      dh[e] = round_to<bf16>(
          __fmul_rn(gm[e], __fsub_rn(__fsub_rn(dyv[e], m1[e]), __fmul_rn(xh, m2[e]))));
      db[e] += dh[e];
    }
#pragma unroll
    for (int i = 0; i < MAX_CIN; ++i) {
      if (i >= cin) break;
      const float xi = to_f32(xr[i]);
      dw[i][0] = fmaf(xi, dh[0], dw[i][0]);
      dw[i][1] = fmaf(xi, dh[1], dw[i][1]);
      float px = dh[0] * w[i][0] + dh[1] * w[i][1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) px += __shfl_xor_sync(0xffffffffu, px, off);
      if (lane == i) dx0[(size_t)r * cin + i] = from_f32<bf16>(px);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int i = 0; i < MAX_CIN; ++i) red[warp][i][2 * lane + e] = dw[i][e];
    red[warp][MAX_CIN][2 * lane + e] = db[e];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < (cin + 1) * C1; k += blockDim.x) {
    const int i = k / C1, c = k - i * C1, slot = i < cin ? i : MAX_CIN;
    float s = 0.f;
    for (int u = 0; u < IN_WARPS; ++u) s += red[u][slot][c];
    if (i < cin)
      wpart[((size_t)blockIdx.x * cin + i) * C1 + c] = s;
    else
      bpart[(size_t)blockIdx.x * C1 + c] = s;
  }
}

// dW3 = x3^T dh4 [256, D], K11's split design (dense.cu): one block per
// (128 x 128 tile of dW3, split of the rows), 8 warps of 64 x 32 f32
// accumulators (mma.cuh warp_atb), 32-row steps. Each step's x3 (from h3p
// and BN1) and dh4 (dy at each group's argmax, 0 elsewhere) are formed in
// registers and stored to one of two shared stages, the next step's loads
// in flight during this step's products. Two blocks an SM. (db3, the
// column sums of dh4, is the column sums of dy: colsum2 over the groups.)
constexpr int WB = 128, WSTEP = 32, WTHREADS = 256, LDW = WB + 8;
constexpr int DB3_BLOCKS = 32;  // row blocks of db3's column sums over the groups
__global__ void __launch_bounds__(WTHREADS, 2)
    dw3_kernel(const bf16* __restrict__ h3p, const float* __restrict__ stats,
               const bf16* __restrict__ dy, const int* __restrict__ amax, int R, int S, int D,
               int splits, float* __restrict__ wpart) {
  __shared__ __align__(16) bf16 xs[2][WSTEP][LDW];
  __shared__ __align__(16) bf16 ys[2][WSTEP][LDW];
  __shared__ float aff[2][WB];  // BN1's scale and shift of the block's x3 columns
  const int tiles_n = (D + WB - 1) / WB;
  const int m0 = blockIdx.x / tiles_n * WB, n0 = blockIdx.x % tiles_n * WB, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int2 rows = vpt::split_range(R, WSTEP, split, splits);
  // this thread's 8-column chunk q of rows rr and rr + 16 of each step
  const int q = tid & 15, rr = tid >> 4, cx = m0 + 8 * q, cy = n0 + 8 * q;
  uint4 xr[2], yr[2];
  bool ok[2];
  auto load = [&](int t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = t * WSTEP + rr + 16 * u;
      ok[u] = r < rows.y;
      xr[u] = yr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (!ok[u]) continue;
      xr[u] = *reinterpret_cast<const uint4*>(h3p + (size_t)r * C3 + cx);
      if (cy < D) {
        const int g = r / S, s = r - g * S;
        const size_t o = (size_t)g * D + cy;
        const int4 i0 = *reinterpret_cast<const int4*>(amax + o);
        const int4 i1 = *reinterpret_cast<const int4*>(amax + o + 4);
        const uint4 v = *reinterpret_cast<const uint4*>(dy + o);
        const int idx[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
        uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = (idx[2 * k] == s ? wv[k] & 0xffffu : 0u) |
                  (idx[2 * k + 1] == s ? wv[k] & 0xffff0000u : 0u);
        yr[u] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
  };
  auto store = [&](int slot) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v[8];
      unpack8(xr[u], v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = ok[u] ? bn_relu<bf16>(v[k], aff[0][8 * q + k], aff[1][8 * q + k]) : 0.f;
      *reinterpret_cast<uint4*>(&xs[slot][rr + 16 * u][8 * q]) = pack8(v);
      *reinterpret_cast<uint4*>(&ys[slot][rr + 16 * u][8 * q]) = yr[u];
    }
  };
  constexpr int MI = 4, NI = 4;
  const int wm = warp >> 2, wn = warp & 3;
  const bool active = n0 + wn * 32 < D;
  float c[MI][NI][4], cs[NI][4];  // cs: warp_atb's column sums, not taken here
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int i = 0; i < MI; ++i) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
  const int t0 = rows.x / WSTEP, t1 = (rows.y + WSTEP - 1) / WSTEP;
  aff[tid >> 7][tid & (WB - 1)] = stats[(tid < WB ? A1 : SH1) * C3 + m0 + (tid & (WB - 1))];
  load(t0);
  __syncthreads();
  store(0);
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) & 1;
    if (t + 1 < t1) load(t + 1);
    if (active)
      mm::warp_atb<MI, NI, false>(c, cs, &xs[slot][0][wm * 64], LDW, &ys[slot][0][wn * 32], LDW,
                                  WSTEP, lane);
    if (t + 1 < t1) store(slot ^ 1);
    __syncthreads();
  }
  if (!active) return;
  float* wp = wpart + (size_t)split * C3 * D;
  const int grp = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 64 + 16 * i + 8 * hh + grp, nn = n0 + wn * 32 + 8 * j + c0;
        if (nn < D)
          *reinterpret_cast<float2*>(wp + (size_t)m * D + nn) =
              make_float2(c[i][j][2 * hh], c[i][j][2 * hh + 1]);
      }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int N>
cudaError_t launch_out(int grid, const bf16* h3p, const float* stats, const bf16* w3,
                       const bf16* b3, bf16* out, int* amax, int R, int S, int D,
                       cudaStream_t st) {
  const cudaError_t e = allow_smem(fwd_out_kernel<N>, out_smem(N));
  if (e != cudaSuccess) return e;
  fwd_out_kernel<N><<<grid, THREADS, out_smem(N), st>>>(h3p, stats, w3, b3, out, amax, R, S, D);
  return cudaGetLastError();
}

template <bool DH3P>
cudaError_t launch_dy3(int grid, const bf16* h3p, const int* amax, const bf16* dy,
                       const float* stats, const bf16* w3, const float* g1, const float* s1b,
                       const float* s2b, float n, bf16* dh3p, float* gsum, double* part, int R,
                       int S, int D, cudaStream_t st) {
  const cudaError_t e = allow_smem(bwd_dy3_kernel<DH3P>, dy3_smem(D));
  if (e != cudaSuccess) return e;
  bwd_dy3_kernel<DH3P><<<grid, THREADS, dy3_smem(D), st>>>(h3p, amax, dy, stats, w3, g1, s1b,
                                                           s2b, n, dh3p, gsum, part, R, S, D);
  return cudaGetLastError();
}

// The forward: F1 on the CUDA cores (h1p's column sums, BN0's statistics),
// F2 (fwd_mid_kernel) and BN1's statistics, F3 (fwd_out_kernel). gmid and
// gout are the persistent grids (ops/cuda/g2e_train.py `grids`).
int fwd(const bf16* x0, const bf16* w0, const bf16* b0, const float* g0, const float* be0,
        const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2, const float* g1,
        const float* be1, const bf16* w3, const bf16* b3, bf16* out, int* amax, bf16* h3p,
        float* stats, float* part, int R, int S, int cin, int D, int nblk, int gmid, int gout,
        float* sums, float n, int stage, cudaStream_t st) {
  if (D % 64 != 0) return (int)cudaErrorInvalidValue;
  Chain<bf16> ch{x0, w0, b0, stats, h3p, cin};
  cudaError_t e;
  if (stage <= 1) {
    colsum2(R, C1, nblk, L0Sq<bf16>{ch}, part, st);
    if (stage == 1) return seam(nblk, C1, part, sums, st);
  }
  if (stage <= 2) {
    finish_stats(stage, part, nblk, sums, C1, n, g0, be0, stats, MU0, st);
    e = allow_smem(fwd_mid_kernel, MID_FWD_SMEM);
    if (e != cudaSuccess) return e;
    fwd_mid_kernel<<<gmid, THREADS, MID_FWD_SMEM, st>>>(x0, w0, b0, stats, w1, b1, w2, b2, h3p,
                                                        part, R, S, cin);
    if (stage == 2) return seam(gmid, C3, part, sums, st);
  }
  finish_stats(stage, part, gmid, sums, C3, n, g1, be1, stats, MU1, st);
  switch (out_cols(D)) {
    case 64: e = launch_out<64>(gout, h3p, stats, w3, b3, out, amax, R, S, D, st); break;
    case 128: e = launch_out<128>(gout, h3p, stats, w3, b3, out, amax, R, S, D, st); break;
    case 192: e = launch_out<192>(gout, h3p, stats, w3, b3, out, amax, R, S, D, st); break;
    case 256: e = launch_out<256>(gout, h3p, stats, w3, b3, out, amax, R, S, D, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The backward: P1 (bwd_dy3_kernel<false>) and s1b, s2b; P2
// (bwd_dy3_kernel<true>: dh3p; bwd_mid_kernel: x1, xc, dh2, dy1) and s1a,
// s2a, db2 and db1; P3 (bwd_in_kernel) and its split sums; the weight
// gradients dW3 (dw3_kernel; db3 from dy's column sums), dW2 = xc^T dh3p
// and dW1 = x1^T dh2 (K11, dense.cu).
int bwd(const bf16* x0, const bf16* w0, const bf16* b0, const float* g0, const bf16* w1,
        const bf16* b1, const bf16* w2, const float* g1, const bf16* w3, const bf16* h3p,
        const int* amax, const float* stats, const bf16* dy, bf16* dx0, float* dw0, float* db0,
        float* dg0, float* dbe0, float* dw1, float* db1, float* dw2, float* db2, float* dg1,
        float* dbe1, float* dw3, float* db3, bf16* x1, bf16* xc, bf16* dh3p, bf16* dh2,
        bf16* dy1, float* gsum, float* part, float* wpart, int R, int S, int cin, int D, int nblk,
        int gmid, int gdy3, int splits3, int splits2, int splits1, const float* sums, float n,
        int stage, cudaStream_t st) {
  if (D % 64 != 0) return (int)cudaErrorInvalidValue;
  double* partd = reinterpret_cast<double*>(part);
  cudaError_t e;
  if (stage <= 1) {  // P1: this rank's BN1 sums (dbe1, dg1)
    e = launch_dy3<false>(gdy3, h3p, amax, dy, stats, w3, g1, dbe1, dg1, n, dh3p, gsum, partd, R,
                          S, D, st);
    if (e != cudaSuccess) return (int)e;
    sum_parts(gdy3 / 2, C3, partd, dbe1, dg1, st);
    if (stage == 1) return (int)cudaGetLastError();
  }
  if (stage == 0 || stage == 2) {  // P2, from the reduced BN1 sums; this rank's BN0 sums
    e = launch_dy3<true>(gdy3, h3p, amax, dy, stats, w3, g1, stage == 0 ? dbe1 : sums,
                         stage == 0 ? dg1 : sums + C3, n, dh3p, gsum, partd, R, S, D, st);
    if (e != cudaSuccess) return (int)e;
    sum_parts(gdy3 / 2, C3, partd, db2, nullptr, st);
    e = allow_smem(bwd_mid_kernel, MID_BWD_SMEM);
    if (e != cudaSuccess) return (int)e;
    float* bpart = reinterpret_cast<float*>(partd + (size_t)gmid * 2 * C1);
    bwd_mid_kernel<<<gmid, THREADS, MID_BWD_SMEM, st>>>(x0, w0, b0, stats, w1, b1, w2, dh3p,
                                                        gsum, x1, xc, dh2, dy1, partd, bpart, R,
                                                        S, cin);
    sum_parts(gmid, C1, partd, dbe0, dg0, st);
    sum_splits(gmid, C2, bpart, db1, st);
    if (stage == 2) return (int)cudaGetLastError();
  }
  const int per = (R + nblk - 1) / nblk;  // P3, from the reduced BN0 sums
  bwd_in_kernel<<<nblk, 32 * IN_WARPS, 0, st>>>(x0, w0, b0, stats, g0, stage == 0 ? dbe0 : sums,
                                                stage == 0 ? dg0 : sums + C1, n, dy1, R, cin,
                                                per, dx0, wpart, wpart + (size_t)nblk * cin * C1);
  sum_splits(nblk, cin * C1, wpart, dw0, st);
  sum_splits(nblk, C1, wpart + (size_t)nblk * cin * C1, db0, st);
  const dim3 g3(2 * ((D + WB - 1) / WB), splits3);
  dw3_kernel<<<g3, WTHREADS, 0, st>>>(h3p, stats, dy, amax, R, S, D, splits3, wpart);
  sum_splits(splits3, C3 * D, wpart, dw3, st);
  colsum2(R / S, D, DB3_BLOCKS, Col<bf16>{dy, D}, part, st);
  sum_parts(DB3_BLOCKS, D, (const float*)part, db3, nullptr, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // K11's own column sums of dh3p and dh2 go to scratch (part): db2 and
  // db1 came from P2 above
  int err = vpt_dense::tc::launch(xc, dh3p, dw2, part, wpart, wpart + (size_t)splits2 * C3 * C3,
                                  R, C3, C3, splits2, st);
  if (err != 0) return err;
  return vpt_dense::tc::launch(x1, dh2, dw1, part, wpart, wpart + (size_t)splits1 * C1 * C2, R, C1,
                               C2, splits1, st);
}

}  // namespace tc

}  // namespace vpt_g2e

using namespace vpt_g2e;

#define G2E_FWD_ARGS                                                                        \
  const void *x0, const void *w0, const void *b0, const void *g0, const void *be0,          \
      const void *w1, const void *b1, const void *w2, const void *b2, const void *g1,       \
      const void *be1, const void *w3, const void *b3, void *out, void *amax, void *h3p,    \
      void *stats, void *h2, void *gmax, void *h4, void *part, int r, int s, int cin, int d, \
      int nblk, void *sums, float n, int stage, void *stream
#define G2E_FWD_PASS                                                                          \
  x0, w0, b0, g0, be0, w1, b1, w2, b2, g1, be1, w3, b3, out, amax, h3p, stats, h2, gmax, h4, \
      part, r, s, cin, d, nblk, sums, n, stage, stream

extern "C" int g2e_fwd_f32(G2E_FWD_ARGS) { return g2e_fwd<float>(G2E_FWD_PASS); }

// bf16 on the tensor cores: no h2, gmax or h4 scratch; part f32 [max(nblk,
// gmid), 2, 256]; gmid, gout the persistent grids of F2 and F3
extern "C" int g2e_fwd_tc_bf16(const void* x0, const void* w0, const void* b0, const void* g0,
                               const void* be0, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* g1, const void* be1, const void* w3,
                               const void* b3, void* out, void* amax, void* h3p, void* stats,
                               void* part, int r, int s, int cin, int d, int nblk, int gmid,
                               int gout, void* sums, float n, int stage, void* stream) {
  using tc::bf16;
  return tc::fwd((const bf16*)x0, (const bf16*)w0, (const bf16*)b0, (const float*)g0,
                 (const float*)be0, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
                 (const bf16*)b2, (const float*)g1, (const float*)be1, (const bf16*)w3,
                 (const bf16*)b3, (bf16*)out, (int*)amax, (bf16*)h3p, (float*)stats,
                 (float*)part, r, s, cin, d, nblk, gmid, gout, (float*)sums, n, stage,
                 (cudaStream_t)stream);
}

#define G2E_BWD_ARGS                                                                         \
  const void *x0, const void *w0, const void *b0, const void *g0, const void *w1,            \
      const void *b1, const void *w2, const void *b2, const void *g1, const void *w3,        \
      const void *h3p, const void *amax, const void *stats, const void *dy, void *dx0,       \
      void *dw0, void *db0, void *dg0, void *dbe0, void *dw1, void *db1, void *dw2,          \
      void *db2, void *dg1, void *dbe1, void *dw3, void *db3, void *dh4, void *dy3,          \
      void *h2, void *gmax, void *dh3p, void *dxc, void *dh2, void *dy1, void *dh1p,         \
      void *part, void *wpart, int r, int s, int cin, int d, int nblk, int splits,           \
      void *sums, float n, int stage, void *stream
#define G2E_BWD_PASS                                                                          \
  x0, w0, b0, g0, w1, b1, w2, b2, g1, w3, h3p, amax, stats, dy, dx0, dw0, db0, dg0, dbe0,    \
      dw1, db1, dw2, db2, dg1, dbe1, dw3, db3, dh4, dy3, h2, gmax, dh3p, dxc, dh2, dy1, dh1p, \
      part, wpart, r, s, cin, d, nblk, splits, sums, n, stage, stream

extern "C" int g2e_bwd_f32(G2E_BWD_ARGS) { return g2e_bwd<float>(G2E_BWD_PASS); }

// bf16 on the tensor cores: scratch x1 [R, 64], xc [R, 256], dh3p [R, 256],
// dh2 [R, 128], dy1 [R, 64] (bf16), gsum f32 [R / S, 256] (each group's
// sum of dh3p), part [max(gdy3 / 2, gmid, 32), 2,
// max(256, D)] f64 (P1's and P2's sums; the others use it as f32),
// wpart f32 (the largest of P3's and the three weight gradients' split
// partials); gmid, gdy3 the persistent grids of P2 and P1, splits3,
// splits2, splits1 the row splits of dW3, dW2 and dW1
extern "C" int g2e_bwd_tc_bf16(const void* x0, const void* w0, const void* b0, const void* g0,
                               const void* w1, const void* b1, const void* w2, const void* g1,
                               const void* w3, const void* h3p, const void* amax,
                               const void* stats, const void* dy, void* dx0, void* dw0, void* db0,
                               void* dg0, void* dbe0, void* dw1, void* db1, void* dw2, void* db2,
                               void* dg1, void* dbe1, void* dw3, void* db3, void* x1, void* xc,
                               void* dh3p, void* dh2, void* dy1, void* gsum, void* part,
                               void* wpart, int r,
                               int s, int cin, int d, int nblk, int gmid, int gdy3, int splits3,
                               int splits2, int splits1, const void* sums, float n, int stage,
                               void* stream) {
  using tc::bf16;
  return tc::bwd((const bf16*)x0, (const bf16*)w0, (const bf16*)b0, (const float*)g0,
                 (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const float*)g1,
                 (const bf16*)w3, (const bf16*)h3p, (const int*)amax, (const float*)stats,
                 (const bf16*)dy, (bf16*)dx0, (float*)dw0, (float*)db0, (float*)dg0,
                 (float*)dbe0, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2, (float*)dg1,
                 (float*)dbe1, (float*)dw3, (float*)db3, (bf16*)x1, (bf16*)xc, (bf16*)dh3p,
                 (bf16*)dh2, (bf16*)dy1, (float*)gsum, (float*)part, (float*)wpart, r, s, cin, d,
                 nblk, gmid, gdy3, splits3, splits2, splits1, (const float*)sums, n, stage,
                 (cudaStream_t)stream);
}
