// K10: the patch gather with centering, forward and backward.
//
// Replaces vipformer_tpu/ops/pallas/gather.py:gather_rows_centered_pallas
// (:358; forward _gather_centered_kernel :218, VJP _centered_bwd :390 with
// _scatter_centered_kernel :244): out[b, r] = points[b, idx[b, r]] minus
// the xyz of the center of r's group (r / S) on channels 0..2, the center
// rounded to the points' dtype first and the difference taken in f32 and
// rounded once (the Pallas kernel's correctly rounded subtract). Extra
// channels ride along uncentered.
//
// Bound on the H100: bytes. Each output row reads one point row, one
// center and one index and writes C values; there is no arithmetic to
// speak of: at points [96, 2,048, 3], idx [96, 4,096] in bf16, 5.1 MB of
// idx, points, centers and output, 0.0016 ms at 3.35 TB/s. The TPU had no
// hardware gather and built one-hot matrices for its matrix unit; Hopper
// gathers with plain loads, and what takes the time is their latency: the
// idx -> point -> store chain of each row, at the launch floor.
// Design: one warp per run of consecutive output rows (`run` rows, at
// most 64: 2 a lane, lane = row; ops/cuda/gather.py `centered_run_rows`),
// 8 warps a block, in 32-bit arithmetic (the wrapper bounds B N C and B K C
// below 2^31). The warp reads its rows' idx coalesced, all in flight, and
// each group's center once (3 floats a group, rounded to the points' dtype,
// into shared memory); each lane then issues the point loads of its rows,
// 4 or 8 channels at a time, before any store, subtracts the centers in f32,
// rounds once and stages the rows in shared memory. A run's rows x C
// output is contiguous and starts on a 16-byte boundary (run is a multiple
// of 8), so it goes out as 16-byte stores, a piece a lane.
//
// Backward: several groups can pick the same point, so d_points is a
// scatter-add, done with f32 atomicAdd into a zeroed f32 buffer (the sum's
// order, and so its last bits, vary run to run: at most one f32 rounding
// per added term, far below the bf16 rounding of the result; the wrapper
// rounds to the points' dtype). d_centers is a plain sum over each
// group's S rows, negated, one thread per (group, channel): deterministic.
//
// K12: the plain row gather and its scatter-add backward.
//
// Replaces vipformer_tpu/ops/pallas/gather.py:gather_rows_pallas (:180;
// forward _gather_kernel :56 via _gather_impl :119, VJP _gather_bwd :196
// with _scatter_kernel :87 via _scatter_impl :142): out[b, k] =
// points[b, idx[b, k]] for any K (the Pallas wrapper pads K to 128), the
// table [B, N, C <= 128] in f32 or bf16. The TPU built a one-hot matrix
// for its matrix unit and contracted it at HIGHEST precision to copy rows
// bit for bit; here a row is copied with plain loads, so the output IS the
// table's values.
//
// Bound on the H100: bytes (B*K*(C*2 + 1) elements moved, no arithmetic);
// as in K10, what takes the time is the idx -> point -> store chain of
// each row. Design: K10's forward kernel with the centering compiled out
// (gather_centered_kernel<T, CHUNK, false>: no centers, no shared memory
// for them, the staged rows a plain copy of the points' elements): a warp
// a run of up to 64 output rows (lane = row), idx read coalesced, every
// point load in flight before any store, the run written as 16-byte
// stores; runs cross cloud boundaries (row = b K + k) at any K.
//
// Backward: d_points[b, idx[b, k]] += g[b, k], with f32 atomicAdd into a
// zeroed f32 buffer, one thread per element of g; the wrapper rounds the
// f32 sums once to the table's dtype (the Pallas kernel rounded the bf16
// table's sums per grid block, gather.py:98). The sum's order, and so its
// last f32 bits, vary from run to run.
#include <type_traits>

#include "common.cuh"

namespace vpt_gather {

using namespace vpt;

constexpr int GC_WARPS = 8;  // warps a block of gather_centered_kernel
constexpr int GC_ROWS = 2;  // output rows a lane gathers together: a run holds 64 at most

// A warp's shared memory: its run's output (rows x C of T, padded to 16
// bytes), then, where it centers, its groups' centers (3 floats each, at
// most run / S + 2).
__host__ __device__ inline int gc_stage_bytes(int run, int C, int size) {
  return (run * C * size + 15) & ~15;
}
__host__ __device__ inline int gc_slot_bytes(int run, int C, int S, int size, bool center) {
  return gc_stage_bytes(run, C, size) + (center ? (12 * (run / S + 2) + 15) & ~15 : 0);
}

// A gathered element as the kernel holds it: f32 where it is centered,
// else the point's own bits.
template <typename V, typename T>
__device__ __forceinline__ V held(T v) {
  if constexpr (std::is_same<V, T>::value) return v;
  else return to_f32(v);
}

// Rows [row0, row0 + rows) of the output [B K, C] (row = b K + r) are a
// warp's run; a lane gathers CHUNK channels of its rows at a time (4 up
// to C = 4, so that xyz needs no more registers than it uses, else 8).
// CENTER subtracts the centers (K10); without it the rows are a copy
// (K12, S unused).
template <typename T, int CHUNK, bool CENTER>
__global__ void __launch_bounds__(32 * GC_WARPS)
    gather_centered_kernel(const T* __restrict__ points, const float* __restrict__ centers,
                           const int* __restrict__ idx, T* __restrict__ out, int N, int C, int K,
                           int S, int total_rows, int run) {
  constexpr int U = 16 / sizeof(T);  // elements of a 16-byte store
  using V = typename std::conditional<CENTER, float, T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * GC_WARPS + warp) * run;
  if (row0 >= total_rows) return;
  const int rows = min(run, total_rows - row0);
  unsigned char* slot = smem_raw + warp * gc_slot_bytes(run, C, S, sizeof(T), CENTER);
  T* stage = reinterpret_cast<T*>(slot);
  float* cen = reinterpret_cast<float*>(slot + gc_stage_bytes(run, C, sizeof(T)));
  // the lane's rows' idx (lane = row, 32 rows apart), coalesced, all in
  // flight; the run's groups' centers, each read once, rounded to T
  int pofs[GC_ROWS], cj[GC_ROWS];
#pragma unroll
  for (int i = 0; i < GC_ROWS; ++i) {
    const int r = lane + 32 * i;
    pofs[i] = r < rows ? idx[row0 + r] : 0;
  }
  const int g_lo = CENTER ? row0 / S : 0;
  if constexpr (CENTER) {
    const int ng = (row0 + rows - 1) / S - g_lo + 1;
    for (int e = lane; e < 3 * ng; e += 32) cen[e] = round_to<T>(centers[3 * g_lo + e]);
  }
#pragma unroll
  for (int i = 0; i < GC_ROWS; ++i) {
    const int row = row0 + lane + 32 * i;
    pofs[i] = (row / K * N + pofs[i]) * C;   // the point's first element (32-bit)
    cj[i] = CENTER ? 3 * (row / S - g_lo) : 0;  // its group's center in cen
  }
  __syncwarp();
  // CHUNK channels of the lane's GC_ROWS rows a step, their loads in
  // flight before any store: centered, the difference in f32, rounded
  // once to T, into the staged output; else the elements as they are
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    V v[GC_ROWS][CHUNK];
#pragma unroll
    for (int i = 0; i < GC_ROWS; ++i)
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (lane + 32 * i < rows && c0 + k < C) v[i][k] = held<V>(points[pofs[i] + c0 + k]);
#pragma unroll
    for (int i = 0; i < GC_ROWS; ++i)
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int r = lane + 32 * i, c = c0 + k;
        if (r >= rows || c >= C) continue;
        if constexpr (CENTER)
          stage[r * C + c] = from_f32<T>(c < 3 ? v[i][k] - cen[cj[i] + c] : v[i][k]);
        else
          stage[r * C + c] = v[i][k];
      }
  }
  __syncwarp();
  // the run's rows x C elements are contiguous in out from row0 C, which is
  // 16-byte aligned (the run's bytes are a multiple of 16): 16 bytes a
  // lane, then the last run's ragged end element by element
  const int n = rows * C, pieces = n / U;
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row0 * C);
  for (int q = lane; q < pieces; q += 32) dst[q] = src[q];
  for (int e = pieces * U + lane; e < n; e += 32) out[(size_t)row0 * C + e] = stage[e];
}

template <typename T>
__global__ void scatter_points_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                                      float* __restrict__ dpoints, int N, int C, int K,
                                      size_t rows) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const size_t b = i / K;
  float* dp = dpoints + (b * N + idx[i]) * C;
  for (int c = 0; c < C; ++c) atomicAdd(dp + c, to_f32(g[i * C + c]));
}

// d_centers[b, grp, c] = -(sum over the group's S rows of g[., c]), c < 3,
// rounded to T.
template <typename T>
__global__ void center_grad_kernel(const T* __restrict__ g, float* __restrict__ dcenters, int C,
                                   int G, int K, int S, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = i % 3;
  const size_t bg = i / 3, b = bg / G;
  const int grp = bg % G;
  float s = 0.f;
  for (int t = 0; t < S; ++t) s += to_f32(g[(b * K + (size_t)grp * S + t) * C + c]);
  dcenters[i] = round_to<T>(-s);
}

// `run` rows a warp (ops/cuda/gather.py `centered_run_rows`): a multiple
// of 8 (so a run's bytes are a multiple of 16) up to 32 GC_ROWS, whose
// staged output takes at most 4 KB; the wrapper bounds B N C and B K C
// below 2^31.
template <typename T, bool CENTER>
int launch_runs(const void* points, const void* centers, const void* idx, void* out, int B, int N,
                int C, int K, int S, int run, void* stream) {
  if (B < 0 || K < 0 || N < 1 || S < 1 || C < 1 || run < 8 || run % 8 || run > 32 * GC_ROWS ||
      run * C * (int)sizeof(T) > 4096)
    return (int)cudaErrorInvalidValue;
  const int total = B * K, warps = (total + run - 1) / run;
  if (total == 0) return cudaSuccess;
  auto kernel =
      C <= 4 ? gather_centered_kernel<T, 4, CENTER> : gather_centered_kernel<T, 8, CENTER>;
  kernel<<<(warps + GC_WARPS - 1) / GC_WARPS, 32 * GC_WARPS,
           GC_WARPS * gc_slot_bytes(run, C, S, sizeof(T), CENTER),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const float*>(centers),
      static_cast<const int*>(idx), static_cast<T*>(out), N, C, K, S, total, run);
  return cudaGetLastError();
}

// K10: K = G S.
template <typename T>
int gather_centered(const void* points, const void* centers, const void* idx, void* out, int B,
                    int N, int C, int G, int K, int S, int run, void* stream) {
  if (B < 1 || G < 1 || K != G * S) return (int)cudaErrorInvalidValue;
  return launch_runs<T, true>(points, centers, idx, out, B, N, C, K, S, run, stream);
}

template <typename T>
int scatter_centered(const void* g, const void* idx, void* dpoints, void* dcenters, int B, int N,
                     int C, int G, int K, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)B * K, nc = (size_t)B * G * 3;
  scatter_points_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const int*>(idx), static_cast<float*>(dpoints), N, C,
      K, rows);
  center_grad_kernel<T><<<(unsigned)((nc + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<float*>(dcenters), C, G, K, S, nc);
  return cudaGetLastError();
}

// 32-bit index arithmetic (the wrapper bounds B*K*C below 2^31): 64-bit
// division by C and K would cost more than the atomic add.
template <typename T>
__global__ void scatter_rows_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                                    float* __restrict__ dpoints, int N, int C, int K,
                                    int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = i / C;
  atomicAdd(dpoints + ((size_t)(row / K) * N + idx[row]) * C + (i - row * C), to_f32(g[i]));
}

template <typename T>
int scatter_rows(const void* g, const void* idx, void* dpoints, int B, int N, int C, int K,
                 void* stream) {
  const int total = B * K * C;
  if (total == 0) return cudaSuccess;
  scatter_rows_kernel<T><<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const int*>(idx), static_cast<float*>(dpoints), N,
      C, K, total);
  return cudaGetLastError();
}

}  // namespace vpt_gather

using namespace vpt_gather;

extern "C" int gather_centered_f32(const void* points, const void* centers, const void* idx,
                                   void* out, int b, int n, int c, int g, int k, int s, int run,
                                   void* stream) {
  return gather_centered<float>(points, centers, idx, out, b, n, c, g, k, s, run, stream);
}
extern "C" int gather_centered_bf16(const void* points, const void* centers, const void* idx,
                                    void* out, int b, int n, int c, int g, int k, int s, int run,
                                    void* stream) {
  return gather_centered<__nv_bfloat16>(points, centers, idx, out, b, n, c, g, k, s, run,
                                        stream);
}
extern "C" int scatter_centered_f32(const void* grad, const void* idx, void* dpoints,
                                    void* dcenters, int b, int n, int c, int g, int k, int s,
                                    void* stream) {
  return scatter_centered<float>(grad, idx, dpoints, dcenters, b, n, c, g, k, s, stream);
}
extern "C" int scatter_centered_bf16(const void* grad, const void* idx, void* dpoints,
                                     void* dcenters, int b, int n, int c, int g, int k, int s,
                                     void* stream) {
  return scatter_centered<__nv_bfloat16>(grad, idx, dpoints, dcenters, b, n, c, g, k, s,
                                         stream);
}
extern "C" int gather_rows_f32(const void* points, const void* idx, void* out, int b, int n,
                               int c, int k, int run, void* stream) {
  return launch_runs<float, false>(points, nullptr, idx, out, b, n, c, k, 1, run, stream);
}
extern "C" int gather_rows_bf16(const void* points, const void* idx, void* out, int b, int n,
                                int c, int k, int run, void* stream) {
  return launch_runs<__nv_bfloat16, false>(points, nullptr, idx, out, b, n, c, k, 1, run,
                                           stream);
}
extern "C" int scatter_rows_f32(const void* grad, const void* idx, void* dpoints, int b, int n,
                                int c, int k, void* stream) {
  return scatter_rows<float>(grad, idx, dpoints, b, n, c, k, stream);
}
extern "C" int scatter_rows_bf16(const void* grad, const void* idx, void* dpoints, int b,
                                 int n, int c, int k, void* stream) {
  return scatter_rows<__nv_bfloat16>(grad, idx, dpoints, b, n, c, k, stream);
}
