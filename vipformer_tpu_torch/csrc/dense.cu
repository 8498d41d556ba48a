// K11: the Dense backward's weight and bias gradients, dW = x^T . dy and
// db = colsum(dy), f32-accumulated in one pass over the rows.
//
// Replaces vipformer_tpu/ops/pallas/dense.py:dense_grads_pallas (kernel
// :44-63): the TPU kernel streams row blocks through VMEM along a
// sequential grid and accumulates the MXU product and the bias column sum
// in resident f32 output blocks, so x and dy are read once.
//
// Bound on the H100: at the latent sites (R = 42,240 rows of Cin, Cout <=
// 512) the bytes: x and dy are read once (43 MB at Cin = Cout = 256 in
// bf16, 13 us at 3.35 TB/s) against 5.5 GFLOP (6 us at the bf16 tensor
// rate, but at least 83 us on the f32 CUDA cores at 67 TFLOP/s).
//
// Both routes: Hopper blocks carry nothing between them, so the
// sequential row grid becomes split-K over R. Block (dW tile, split) owns
// one tile of dW and a contiguous run of whole row steps (split s of S
// takes steps [s n / S, (s + 1) n / S) of the n steps, so no split is
// empty when S <= n); the blocks of m-tile 0 also sum dy's columns, so dy
// is read once for both gradients. Each split writes f32 partials; a
// second pass sums them in split order (train_common.cuh), so the result
// is deterministic, with no float atomics. Rows past R and columns past
// Cin / Cout are zero-filled or masked, so any R and any width work.
//
// The dtype picks the kernel (ops/cuda/__init__.py `tc_route`):
// bf16 runs `tc::dense_grads_tc_kernel` on the tensor cores; f32 runs
// dense_grads_kernel<float> on the CUDA cores, because a tensor-core f32
// product is TF32 (about 3 decimal digits), which would break the 1e-4
// f32 gradient bound against the twin and the card-vs-CPU step checks.
//
// Design, bf16: a block of 8 warps owns a 128 x 128 tile of dW (Cin x
// Cout), each warp a 64 x 32 sub-tile of f32 accumulators in registers.
// Row steps of 32 rows of the block's x columns and dy columns stream
// through a 4-stage ring in shared memory (each row's slice contiguous
// bytes at a stride of Cin or Cout elements, 16-byte cp.async, rows
// padded to 136 bf16 so that ldmatrix meets no bank conflict), one barrier
// a step, the next three steps' loads in flight during a step's products.
// The products are mma.sync m16n8k16 (bf16 in, f32 accumulate) through
// the warp tile of mma.cuh (`warp_atb`): both operands via ldmatrix.trans,
// since the contraction runs down the rows of x and dy. The bias comes
// from the same dy fragments: the warps of m-tile 0's first warp row run
// one more mma per n8 tile with an all-ones A fragment. A width that is
// not a multiple of 8 (Cin = 3, 6; Cout = 50, 13) cannot use 16-byte
// copies: that operand is staged by plain loads, whose latency the ring
// does not hide, as a template mode of the same kernel (4 instances: x
// and dy each copied or loaded). Products of bf16 values are exact in
// f32, so the result differs from the twin only in the order of its f32
// sums. Per -Xptxas -v on the card (sm_90a): 127-128 registers (the cap
// of two blocks an SM), no spills.
//
// Design, f32: one block of 256 threads per 64 x 64 tile and split; it
// streams its rows 16 at a time through shared memory (x transposed into
// As, dy into Bs; neighbouring threads read neighbouring columns of a row)
// and keeps 4 x 4 f32 accumulators per thread.
#include "mma.cuh"
#include "train_common.cuh"

namespace vpt_dense {

constexpr int TM = 64, TN = 64, TK = 16, THREADS = 256;
constexpr int LDA = TM + 4, LDB = TN + 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_grads_kernel(const T* __restrict__ x, const T* __restrict__ dy, int r, int cin, int cout,
                   int splits, float* __restrict__ wpart, float* __restrict__ bpart) {
  __shared__ __align__(16) float As[TK][LDA];  // x rows, transposed: As[row][cin]
  __shared__ __align__(16) float Bs[TK][LDB];  // dy rows: Bs[row][cout]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, split = blockIdx.z;
  const int2 rows = vpt::split_range(r, TK, split, splits);
  const int r0 = rows.x, r1 = rows.y;
  const bool with_bias = blockIdx.y == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;  // db partial of column n0 + tid (threads 0-63)

  for (int k0 = r0; k0 < r1; k0 += TK) {
#pragma unroll
    for (int it = 0; it < TM * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e % TM, kk = e / TM;
      const int row = k0 + kk, col = m0 + c;
      As[kk][c] = (row < r1 && col < cin) ? vpt::to_f32(x[(size_t)row * cin + col]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < TN * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int c = e % TN, kk = e / TN;
      const int row = k0 + kk, col = n0 + c;
      Bs[kk][c] = (row < r1 && col < cout) ? vpt::to_f32(dy[(size_t)row * cout + col]) : 0.f;
    }
    __syncthreads();
    if (with_bias && tid < TN) {
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) bsum += Bs[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* wp = wpart + (size_t)split * cin * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < cin && n < cout) wp[(size_t)m * cout + n] = acc[i][j];
    }
  if (with_bias && tid < TN && n0 + tid < cout) bpart[(size_t)split * cout + n0 + tid] = bsum;
}

// the two split-order sums of the partials into dw and db
int sum_partials(const void* wpart, const void* bpart, void* dw, void* db, int splits, int cin,
                 int cout, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_splits(splits, cin * cout, (const float*)wpart, (float*)dw, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vpt::sum_splits(splits, cout, (const float*)bpart, (float*)db, st);
  return (int)cudaGetLastError();
}

int launch_dense_grads_f32(const void* x, const void* dy, void* dw, void* db, void* wpart,
                           void* bpart, int r, int cin, int cout, int splits, cudaStream_t st) {
  if (r < 1 || cin < 1 || cout < 1 || splits < 1 || splits > (r + TK - 1) / TK)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cout + TN - 1) / TN, (cin + TM - 1) / TM, splits);
  dense_grads_kernel<float><<<grid, THREADS, 0, st>>>((const float*)x, (const float*)dy, r, cin,
                                                      cout, splits, (float*)wpart,
                                                      (float*)bpart);
  return sum_partials(wpart, bpart, dw, db, splits, cin, cout, st);
}

// ------------------------------------------- K11, bf16, on the tensor cores
namespace tc {

using vpt::mma::bf16;
constexpr int BM = 128, BN = 128;  // the block's dW tile: Cin x Cout
constexpr int WM = 64, WN = 32;    // a warp's sub-tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = 32 * (BM / WM) * WARPS_N;  // 256
constexpr int KR = 32;      // rows a step
constexpr int STAGES = 4;   // steps in flight
constexpr int LDX = BM + 8, LDY = BN + 8;  // padded shared rows (bf16)
constexpr size_t SMEM = sizeof(bf16) * (size_t)STAGES * KR * (LDX + LDY);

// An operand whose width is a multiple of 8 is staged by 16-byte cp.async
// (its base 16-byte aligned), any other by plain loads.
constexpr bool copied(int width) { return width % 8 == 0; }

// One step's KR rows [r0, r0 + KR) of an operand's W-column slice (rows
// `stride` elements apart, `cols` of its columns real) into a stage:
// cp.async (CP; columns past `cols` zero-filled), or plain loads of the
// real columns, whose columns past `cols` were zeroed once. Rows at or
// past `rows` are zero-filled.
template <bool CP, int W>
__device__ __forceinline__ void load_step(bf16* dst, int ld, const bf16* src, int stride,
                                          int r0, int rows, int cols, int tid) {
  if constexpr (CP) {
    vpt::mma::cp_rows<W, KR, THREADS>(dst, ld, src, stride, r0, rows, tid, cols);
  } else {
    const int w = min(W, cols);
    for (int e = tid; e < KR * w; e += THREADS) {
      const int rr = e / w, c = e - rr * w;
      dst[rr * ld + c] = r0 + rr < rows ? src[(size_t)(r0 + rr) * stride + c]
                                        : __ushort_as_bfloat16((unsigned short)0);
    }
  }
}

// zero columns [min(W, cols), W) of every stage's KR rows (plain-load mode)
template <int W>
__device__ __forceinline__ void zero_tail(bf16* base, int ld, int cols, int tid) {
  const int w = min(W, cols), tail = W - w;
  for (int e = tid; e < STAGES * KR * tail; e += THREADS) {
    const int rr = e / tail;
    base[rr * ld + w + (e - rr * tail)] = __ushort_as_bfloat16((unsigned short)0);
  }
}

// One block per (128 x 128 tile of dW, split of the rows); XCP / DCP:
// whether x and dy are copied by cp.async (else loaded).
template <bool XCP, bool DCP>
__global__ void __launch_bounds__(THREADS, 2)
dense_grads_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy, int r, int cin,
                      int cout, int splits, float* __restrict__ wpart, float* __restrict__ bpart) {
  namespace mm = vpt::mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][KR][LDX]
  bf16* ys = xs + STAGES * KR * LDX;             // [STAGES][KR][LDY]
  const int tiles_n = (cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int2 rows = vpt::split_range(r, KR, split, splits);
  const int t_begin = rows.x / KR, t_end = (rows.y + KR - 1) / KR, r_end = rows.y;
  const bf16* xb = x + m0;
  const bf16* yb = dy + n0;
  const int xcols = cin - m0, ycols = cout - n0;
  if (!XCP) zero_tail<BM>(xs, LDX, xcols, tid);
  if (!DCP) zero_tail<BN>(ys, LDY, ycols, tid);
  auto load = [&](int t) {
    const int slot = (t - t_begin) % STAGES;
    load_step<XCP, BM>(xs + slot * KR * LDX, LDX, xb, cin, t * KR, r_end, xcols, tid);
    load_step<DCP, BN>(ys + slot * KR * LDY, LDY, yb, cout, t * KR, r_end, ycols, tid);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_begin + st < t_end) load(t_begin + st);
    mm::cp_async_commit();
  }

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bool active = m0 + wm * WM < cin && n0 + wn * WN < cout;
  const bool bias = m0 == 0 && wm == 0;  // these warps also sum dy's columns
  float c[MI][NI][4], cs[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
#pragma unroll
    for (int i = 0; i < MI; ++i) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.0f;
    cs[j][0] = cs[j][1] = cs[j][2] = cs[j][3] = 0.0f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    mm::cp_async_wait<STAGES - 2>();  // step t has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; and step t - 1 is consumed
    if (t + STAGES - 1 < t_end) load(t + STAGES - 1);
    mm::cp_async_commit();
    if (!active) continue;
    const int slot = (t - t_begin) % STAGES;
    const bf16* a = xs + slot * KR * LDX + wm * WM;
    const bf16* b = ys + slot * KR * LDY + wn * WN;
    if (bias)
      mm::warp_atb<MI, NI, true>(c, cs, a, LDX, b, LDY, KR, lane);
    else
      mm::warp_atb<MI, NI, false>(c, cs, a, LDX, b, LDY, KR, lane);
  }
  mm::cp_async_wait<0>();
  if (!active) return;
  float* wp = wpart + (size_t)split * cin * cout;
  const int grp = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * WM + 16 * i + 8 * hh + grp, n = n0 + wn * WN + 8 * j + c0;
        if (m >= cin || n >= cout) continue;
        float* dst = wp + (size_t)m * cout + n;
        if (cout % 2 == 0) {  // n even: the pair is in the row, 8-byte aligned
          *reinterpret_cast<float2*>(dst) = make_float2(c[i][j][2 * hh], c[i][j][2 * hh + 1]);
        } else {
          dst[0] = c[i][j][2 * hh];
          if (n + 1 < cout) dst[1] = c[i][j][2 * hh + 1];
        }
      }
  if (bias && grp == 0) {  // every row of cs holds the column sums: take row 0
    float* bp = bpart + (size_t)split * cout;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int n = n0 + wn * WN + 8 * j + c0;
      if (n < cout) bp[n] = cs[j][0];
      if (n + 1 < cout) bp[n + 1] = cs[j][1];
    }
  }
}

template <bool XCP, bool DCP>
cudaError_t launch_mode(const void* x, const void* dy, void* wpart, void* bpart, int r, int cin,
                        int cout, int splits, cudaStream_t st) {
  auto kernel = dense_grads_tc_kernel<XCP, DCP>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(((cin + BM - 1) / BM) * ((cout + BN - 1) / BN), splits);
  kernel<<<grid, THREADS, SMEM, st>>>((const bf16*)x, (const bf16*)dy, r, cin, cout, splits,
                                      (float*)wpart, (float*)bpart);
  return cudaSuccess;
}

int launch(const void* x, const void* dy, void* dw, void* db, void* wpart, void* bpart, int r,
           int cin, int cout, int splits, cudaStream_t st) {
  if (r < 1 || cin < 1 || cout < 1 || splits < 1 || splits > (r + KR - 1) / KR)
    return (int)cudaErrorInvalidValue;
  const bool xcp = copied(cin), dcp = copied(cout);
  const cudaError_t err =
      xcp ? (dcp ? launch_mode<true, true>(x, dy, wpart, bpart, r, cin, cout, splits, st)
                 : launch_mode<true, false>(x, dy, wpart, bpart, r, cin, cout, splits, st))
          : (dcp ? launch_mode<false, true>(x, dy, wpart, bpart, r, cin, cout, splits, st)
                 : launch_mode<false, false>(x, dy, wpart, bpart, r, cin, cout, splits, st));
  if (err != cudaSuccess) return (int)err;
  return sum_partials(wpart, bpart, dw, db, splits, cin, cout, st);
}

}  // namespace tc
}  // namespace vpt_dense

using namespace vpt_dense;

// x [R, Cin], dy [R, Cout] (both f32, or both bf16) -> dw f32 [Cin, Cout],
// db f32 [Cout]. wpart f32 [splits, Cin, Cout] and bpart f32 [splits, Cout]
// are scratch; `splits` is at most the row steps (16 rows in f32, 32 in
// bf16), so that none is empty (the wrapper plans it). The bf16 kernel
// copies an operand whose width is a multiple of 8 in 16-byte chunks (its
// pointer 16-byte aligned) and loads any other plainly.
extern "C" int dense_grads_f32(const void* x, const void* dy, void* dw, void* db, void* wpart,
                               void* bpart, int r, int cin, int cout, int splits, void* stream) {
  return launch_dense_grads_f32(x, dy, dw, db, wpart, bpart, r, cin, cout, splits,
                                (cudaStream_t)stream);
}

extern "C" int dense_grads_tc_bf16(const void* x, const void* dy, void* dw, void* db,
                                   void* wpart, void* bpart, int r, int cin, int cout, int splits,
                                   void* stream) {
  return tc::launch(x, dy, dw, db, wpart, bpart, r, cin, cout, splits, (cudaStream_t)stream);
}
