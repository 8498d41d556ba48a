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
// speak of. The TPU had no hardware gather and built one-hot matrices for
// its matrix unit; Hopper gathers with plain loads, so the design is one
// thread per output row.
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
// table's values. One thread per output element: neighbouring threads
// write neighbouring addresses, and the reads of one row (C values) are
// contiguous.
//
// Bound on the H100: bytes (B*K*(C*2 + 1) elements moved, no arithmetic).
//
// Backward: d_points[b, idx[b, k]] += g[b, k], with f32 atomicAdd into a
// zeroed f32 buffer, one thread per element of g; the wrapper rounds the
// f32 sums once to the table's dtype (the Pallas kernel rounded the bf16
// table's sums per grid block, gather.py:98). The sum's order, and so its
// last f32 bits, vary from run to run.
#include "common.cuh"

namespace vpt_gather {

using namespace vpt;

template <typename T>
__global__ void gather_centered_kernel(const T* __restrict__ points,
                                       const float* __restrict__ centers,
                                       const int* __restrict__ idx, T* __restrict__ out, int N,
                                       int C, int G, int K, int S, size_t rows) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const size_t b = i / K;
  const int r = i % K;
  const T* p = points + (b * N + idx[i]) * C;
  const float* cz = centers + (b * G + r / S) * 3;
  for (int c = 0; c < C; ++c) {
    const float v = to_f32(p[c]);
    out[i * C + c] = from_f32<T>(c < 3 ? v - round_to<T>(cz[c]) : v);
  }
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

template <typename T>
int gather_centered(const void* points, const void* centers, const void* idx, void* out, int B,
                    int N, int C, int G, int K, int S, void* stream) {
  const size_t rows = (size_t)B * K;
  gather_centered_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const float*>(centers),
      static_cast<const int*>(idx), static_cast<T*>(out), N, C, G, K, S, rows);
  return cudaGetLastError();
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
// division by C and K would cost more than the copy.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ points, const int* __restrict__ idx,
                                   T* __restrict__ out, int N, int C, int K, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = i / C;  // b * K + k
  out[i] = points[((size_t)(row / K) * N + idx[row]) * C + (i - row * C)];
}

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
int gather_rows(const void* points, const void* idx, void* out, int B, int N, int C, int K,
                void* stream) {
  const int total = B * K * C;
  if (total == 0) return cudaSuccess;
  gather_rows_kernel<T><<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const int*>(idx), static_cast<T*>(out), N, C,
      K, total);
  return cudaGetLastError();
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
                                   void* out, int b, int n, int c, int g, int k, int s,
                                   void* stream) {
  return gather_centered<float>(points, centers, idx, out, b, n, c, g, k, s, stream);
}
extern "C" int gather_centered_bf16(const void* points, const void* centers, const void* idx,
                                    void* out, int b, int n, int c, int g, int k, int s,
                                    void* stream) {
  return gather_centered<__nv_bfloat16>(points, centers, idx, out, b, n, c, g, k, s, stream);
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
                               int c, int k, void* stream) {
  return gather_rows<float>(points, idx, out, b, n, c, k, stream);
}
extern "C" int gather_rows_bf16(const void* points, const void* idx, void* out, int b, int n,
                                int c, int k, void* stream) {
  return gather_rows<__nv_bfloat16>(points, idx, out, b, n, c, k, stream);
}
extern "C" int scatter_rows_f32(const void* grad, const void* idx, void* dpoints, int b, int n,
                                int c, int k, void* stream) {
  return scatter_rows<float>(grad, idx, dpoints, b, n, c, k, stream);
}
extern "C" int scatter_rows_bf16(const void* grad, const void* idx, void* dpoints, int b,
                                 int n, int c, int k, void* stream) {
  return scatter_rows<__nv_bfloat16>(grad, idx, dpoints, b, n, c, k, stream);
}
