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
// Bound on the H100: operations. The forward does about 140 kMAC per row
// (the two 256-wide Dense dominate) and the backward about 3x that, all on
// CUDA cores in f32, so at R = 393,216 rows the products, not the bytes,
// set the time.
//
// Design: the TPU grid ran in order and carried the BatchNorm sums and the
// weight gradients in scratch across it. Here each pass is a separate
// launch: the Dense layers are SIMT products over functors that recompute
// their operands (train_common.cuh), the BatchNorm and bias sums are
// per-block column partials, and the weight gradients dW = X^T dY are split
// over the rows into partials; both kinds are summed by a second pass in a
// fixed order, so every result is deterministic. Between launches, within
// one call, activations live in device memory (h2, the group maxima, h4,
// and the backward's gradients); the TPU kernel kept them in VMEM.
#include "train_common.cuh"

namespace vpt_g2e {

using namespace vpt;

constexpr int C1 = 64, C2 = 128, C3 = 256;  // Group2Emb's hidden widths
constexpr float BN_EPS = 1e-5f;
// Rows of the statistics table [10][C3]: BN0 (mean, var, rstd, a, c), then BN1.
enum { MU0, VAR0, RSTD0, A0, SH0, MU1, VAR1, RSTD1, A1, SH1 };

// What the chain recomputes from x0 and h3p.
template <typename T> struct Chain {
  const T* x0;
  const T* w0;
  const T* b0;
  const float* stats;
  const T* h3p;
  int cin;
  __device__ const float* st(int row) const { return stats + row * C3; }
  __device__ float h1p(int r, int c) const {
    float acc = 0.f;
    for (int i = 0; i < cin; ++i)
      acc = fmaf(to_f32(x0[(size_t)r * cin + i]), to_f32(w0[i * C1 + c]), acc);
    return round_to<T>(round_to<T>(acc) + to_f32(b0[c]));
  }
  __device__ float x1(int r, int c) const {
    const float y = round_to<T>(__fadd_rn(__fmul_rn(h1p(r, c), st(A0)[c]), st(SH0)[c]));
    return fmaxf(y, 0.f);
  }
  __device__ float xhat1(int r, int c) const {
    return (h1p(r, c) - st(MU0)[c]) * st(RSTD0)[c];
  }
  __device__ float x3(int r, int c) const {
    const float h = to_f32(h3p[(size_t)r * C3 + c]);
    return fmaxf(round_to<T>(__fadd_rn(__fmul_rn(h, st(A1)[c]), st(SH1)[c])), 0.f);
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
            int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats_ = static_cast<float*>(stats);
  float* part_ = static_cast<float*>(part);
  T* h2_ = static_cast<T*>(h2);
  T* gmax_ = static_cast<T*>(gmax);
  T* h3p_ = static_cast<T*>(h3p);
  T* h4_ = static_cast<T*>(h4);
  const float n = (float)R;
  Chain<T> ch{static_cast<const T*>(x0), static_cast<const T*>(w0), static_cast<const T*>(b0),
              stats_, h3p_, cin};
  // F1: BatchNorm_0 statistics of h1p
  colsum2(R, C1, nblk, L0Sq<T>{ch}, part_, st);
  bn_finish_kernel<<<1, C3, 0, st>>>(part_, nblk, C1, n, static_cast<const float*>(g0),
                                     static_cast<const float*>(be0), stats_, MU0);
  // F2: h2, its group maxima, h3p (cached) and BatchNorm_1 statistics
  recompute_h2<T>(ch, static_cast<const T*>(w1), static_cast<const T*>(b1), h2_, gmax_, R, S, st);
  gemm<true, true>(R, C3, C3, 1, XCA<T>{XC<T>{gmax_, h2_, S}},
                   RowMajor<T>{static_cast<const T*>(w2), C3},
                   StoreDense<T>{h3p_, static_cast<const T*>(b2), C3}, st);
  colsum2(R, C3, nblk, RowSq<T>{h3p_, C3}, part_, st);
  bn_finish_kernel<<<1, C3, 0, st>>>(part_, nblk, C3, n, static_cast<const float*>(g1),
                                     static_cast<const float*>(be1), stats_, MU1);
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
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float n = (float)R;
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

  // P2: dh3p; dW2, db2; dxc = dh3p W2^T; the pool's tie split; dW1, db1;
  // dy1 = relu'(x1) * dh2 W1^T; BN0 sums
  bn_bwd_kernel<T, C3, true><<<blocks_for((size_t)R * C3), 256, 0, st>>>(
      ch, dy3_, dbe1_, dg1_, static_cast<const float*>(g1), R, n, dh3p_);
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

  // P3: dh1p; dW0, db0; dx0 = dh1p W0^T
  bn_bwd_kernel<T, C1, false><<<blocks_for((size_t)R * C1), 256, 0, st>>>(
      ch, dy1_, dbe0_, dg0_, static_cast<const float*>(g0), R, n, dh1p_);
  gemm<false, true>(cin, C1, R, splits, Transposed<T>{static_cast<const T*>(x0), cin},
                    RowMajor<T>{dh1p_, C1}, StoreSplit{wpart_, cin, C1}, st);
  sum_splits(splits, cin * C1, wpart_, static_cast<float*>(dw0), st);
  colsum2(R, C1, nblk, Col<T>{dh1p_, C1}, part_, st);
  sum_parts(nblk, C1, part_, static_cast<float*>(db0), nullptr, st);
  gemm<true, false>(R, cin, C1, 1, RowMajor<T>{dh1p_, C1}, Transposed<T>{w0_, C1},
                    StoreDense<T>{static_cast<T*>(dx0), nullptr, cin}, st);
  return cudaGetLastError();
}

}  // namespace vpt_g2e

using namespace vpt_g2e;

#define G2E_FWD_ARGS                                                                        \
  const void *x0, const void *w0, const void *b0, const void *g0, const void *be0,          \
      const void *w1, const void *b1, const void *w2, const void *b2, const void *g1,       \
      const void *be1, const void *w3, const void *b3, void *out, void *amax, void *h3p,    \
      void *stats, void *h2, void *gmax, void *h4, void *part, int r, int s, int cin, int d, \
      int nblk, void *stream
#define G2E_FWD_PASS                                                                          \
  x0, w0, b0, g0, be0, w1, b1, w2, b2, g1, be1, w3, b3, out, amax, h3p, stats, h2, gmax, h4, \
      part, r, s, cin, d, nblk, stream

extern "C" int g2e_fwd_f32(G2E_FWD_ARGS) { return g2e_fwd<float>(G2E_FWD_PASS); }
extern "C" int g2e_fwd_bf16(G2E_FWD_ARGS) { return g2e_fwd<__nv_bfloat16>(G2E_FWD_PASS); }

#define G2E_BWD_ARGS                                                                         \
  const void *x0, const void *w0, const void *b0, const void *g0, const void *w1,            \
      const void *b1, const void *w2, const void *b2, const void *g1, const void *w3,        \
      const void *h3p, const void *amax, const void *stats, const void *dy, void *dx0,       \
      void *dw0, void *db0, void *dg0, void *dbe0, void *dw1, void *db1, void *dw2,          \
      void *db2, void *dg1, void *dbe1, void *dw3, void *db3, void *dh4, void *dy3,          \
      void *h2, void *gmax, void *dh3p, void *dxc, void *dh2, void *dy1, void *dh1p,         \
      void *part, void *wpart, int r, int s, int cin, int d, int nblk, int splits,           \
      void *stream
#define G2E_BWD_PASS                                                                          \
  x0, w0, b0, g0, w1, b1, w2, b2, g1, w3, h3p, amax, stats, dy, dx0, dw0, db0, dg0, dbe0,    \
      dw1, db1, dw2, db2, dg1, dbe1, dw3, db3, dh4, dy3, h2, gmax, dh3p, dxc, dh2, dy1, dh1p, \
      part, wpart, r, s, cin, d, nblk, splits, stream

extern "C" int g2e_bwd_f32(G2E_BWD_ARGS) { return g2e_bwd<float>(G2E_BWD_PASS); }
extern "C" int g2e_bwd_bf16(G2E_BWD_ARGS) { return g2e_bwd<__nv_bfloat16>(G2E_BWD_PASS); }
