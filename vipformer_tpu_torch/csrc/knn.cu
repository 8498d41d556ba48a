// K2: exact k nearest neighbours with packed (distance | index) keys.
//
// Replaces vipformer_tpu/ops/pallas/knn.py:knn_pallas.
//
// What it computes: for each query the k smallest keys (bits(d) & ~mask) |
// i, nearest first, with idx_bits = bit_length(N - 1) and d the f32
// difference of squares summed over c = 0, 1, 2 without FMA contraction
// (vpt::sq_dist3, knn.py:43-46). Every key is unique, so the order needs no
// tie handling and the output equals knn_plain's bit for bit.
//
// Bound on the H100: instruction throughput. The work that must be done is N
// distances a query (3 subtract-multiply-adds, 8 FLOP each: the bound
// chip_smoke.py counts); the selection is integer work on top of it. k
// rounds of a threshold min over all N keys would cost about 3 k N / 32
// warp instructions a query (3,400 at N = 1,024, k = 32) beside about 400
// for the keys; the design below does one pass to a threshold, one to
// compact, and k rounds over a few candidates.
//
// Design (vpt::knn_query, geometry.cuh, shared with K16): a block of QPB
// warps serves QPB queries of one cloud, staged in shared memory once as
// float4 rows padded with points at infinity; one warp owns one query and
// lane l the points l, l+32, ... A pass over the keys keeps each lane's
// smallest (its 4 smallest for 32 < k <= 128) and takes tau, the k-th
// smallest of those kept (their maximum at k = 32: one redux.sync); the
// keys <= tau are compacted into the warp's 512 slots (each lane counts
// its own, a warp prefix sum places them); each lane sorts its 4-16
// candidates in registers and k rounds of one redux.sync over the lanes'
// heads pop them nearest first. At N = 1,024, k = 32 a query costs about
// 1,000 warp instructions (the SASS of knn_kernel<32, 1>): 32 keys x 13
// (an LDS.128, 8 FP, the key, the lane min), 32 x 7 to count and write
// the candidates, and 32 pops x 6 over about 116 candidates (4 a lane) on
// a uniform cloud, against about 3,900 for the k-round scan. A warp with
// more than 512 candidates (a cloud whose nearest points avoid one lane:
// that lane's smallest key sets tau) runs the exact k-round scan instead,
// and counts itself in *overflow where the caller asks; so does every k
// above 128. Up to N = 2,048 the keys stay in registers (64 a lane); past
// it they are recomputed from shared memory in both passes (the second
// compacting with __ballot_sync), so no lane holds 128 keys at N = 4,096.
// There the exact scan recomputes every key in each of its k rounds, a
// load and the distance where a register scan compares, several times
// slower a round than the register scan it replaced (PERF.md §6). It
// serves k > 128, which no path of the port asks for, and warps that
// overflow (chip_smoke.py prints their count). Past N = 1,024 a block's shared memory passes 48 KB; the cap
// is raised once a device (vpt::raise_smem_cap_once). At N = 4,096 a
// block takes 81 KB and 37 registers a thread: two blocks an SM.
#include "geometry.cuh"

namespace {

constexpr int QPB = 8;  // queries (warps) a block

template <int KPL, int M>
__global__ void __launch_bounds__(QPB * 32)
knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
           int* __restrict__ out, int n, int s, int k, int idx_bits, int* overflow) {
  extern __shared__ float4 s_pts[];  // knn_rows(n, KPL) rows, then QPB x KNN_BUF slots
  const int rows = vpt::knn_rows(n, KPL);
  int* bufs = reinterpret_cast<int*>(s_pts + rows);
  const int b = blockIdx.y;
  vpt::knn_stage(s_pts, points + (size_t)b * n * 3, n, rows);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * QPB + warp;
  if (q >= s) return;
  const float* qp = queries + ((size_t)b * s + q) * 3;
  vpt::knn_query<KPL, M>(s_pts, n, make_float4(qp[0], qp[1], qp[2], 0.f), k, (1 << idx_bits) - 1,
                         bufs + warp * vpt::KNN_BUF, out + ((size_t)b * s + q) * k, overflow);
}

// Shared memory of a block: the cloud's rows and, with kept keys, every
// warp's candidate slots.
constexpr size_t smem_bytes(int rows, int m) {
  return sizeof(float4) * (size_t)rows + (m > 0 ? sizeof(int) * QPB * vpt::KNN_BUF : 0);
}

template <int KPL, int M>
int launch(const float* p, const float* q, int* out, int b, int n, int s, int k, int* overflow,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(vpt::knn_rows(n, KPL), M);
  // the cap for the instance's largest cloud (32 KPL points), raised once a
  // device where it passes the default 48 KB
  constexpr size_t most = smem_bytes(32 * KPL, M);
  if (most > 48 * 1024) {
    static std::atomic<unsigned> capped{0};
    const cudaError_t e = vpt::raise_smem_cap_once(knn_kernel<KPL, M>, most, capped);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((s + QPB - 1) / QPB, b);
  knn_kernel<KPL, M><<<grid, QPB * 32, smem, stream>>>(p, q, out, n, s, k, vpt::knn_idx_bits(n),
                                                       overflow);
  return (int)cudaGetLastError();
}

template <int KPL>
int launch_kept(const float* p, const float* q, int* out, int b, int n, int s, int k,
                int* overflow, cudaStream_t stream) {
  switch (vpt::knn_kept(k)) {
    case 1: return launch<KPL, 1>(p, q, out, b, n, s, k, overflow, stream);
    case 4: return launch<KPL, 4>(p, q, out, b, n, s, k, overflow, stream);
    default: return launch<KPL, 0>(p, q, out, b, n, s, k, overflow, stream);
  }
}

}  // namespace

// points f32 [B, N, 3], queries f32 [B, S, 3] -> out int32 [B, S, k];
// overflow: null, or an int32 the kernel adds the count of queries that
// took the exact scan for want of candidate slots to. Needs
// 1 <= k <= N <= 4096.
extern "C" int knn_f32(const void* points, const void* queries, void* out, int b, int n, int s,
                       int k, void* overflow, void* stream) {
  if (k < 1 || k > n) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)points;
  const float* q = (const float*)queries;
  int* o = (int*)out;
  int* ov = (int*)overflow;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 256) return launch_kept<8>(p, q, o, b, n, s, k, ov, st);
  if (n <= 512) return launch_kept<16>(p, q, o, b, n, s, k, ov, st);
  if (n <= 1024) return launch_kept<32>(p, q, o, b, n, s, k, ov, st);
  if (n <= 2048) return launch_kept<64>(p, q, o, b, n, s, k, ov, st);
  if (n <= 4096) return launch_kept<128>(p, q, o, b, n, s, k, ov, st);  // recomputed keys
  return (int)cudaErrorInvalidValue;
}
