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
// Backward (the VJP, both outputs in one launch, deterministic): see
// "The VJPs" below.
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
// Backward: d_points[b, idx[b, k]] += g[b, k] on K10's VJP kernel without
// the centers (see "The VJPs" below).
//
// The VJPs (K10's scatter_centered and K12's scatter_rows, one kernel,
// scatter_sorted_kernel<T, VEC, CENTER, STAGE>): d_points[b, idx[b, r]]
// += g[b, r] over [B, N, C], several rows picking one point, and, with
// CENTER, d_centers[b, grp, :3] = -(the sum of g over the group's S rows).
// Bound on the H100: bytes (g, idx and d_points in the points' dtype,
// d_centers once; at [96, 2,048, 3] bf16 5.2 MB, 0.0016 ms). The TPU
// kernels contracted one-hot matrices on the matrix unit, carrying the
// sums across a sequential grid; on Hopper blocks run in no order, and
// f32 atomicAdd into a zeroed table gave sums whose order, and so whose
// last bits, changed from run to run, beside a zeroing and a cast launch.
// Here one launch writes both outputs, every point row of d_points (zeros
// where no row picks it), already in the points' dtype, with the same bits
// in every run: no floating-point atomics. A block of 512 threads
// (registers held to 40, three blocks an SM) owns a slice of `np` points
// of one cloud (ops/cuda/gather.py `scatter_plan`: as many slices as one
// wave holds, at least 32 points each) and sorts the cloud's rows by
// point: a histogram of its points by shared-memory integer atomics
// (exact counts), an exclusive scan into segment starts, the rows' ids
// placed into their segments by integer atomic cursors (the order inside
// a segment is the arrival order), then each segment sorted by row id by
// insertion, a thread a point (a point has a few rows, at most G for kNN
// indices, and they arrive nearly in order). A group of `lanes` lanes (a
// power of two, 4 channels a lane; C = 128: a warp a point row) sums each
// point's rows in row order in f32 and rounds once to the points' dtype
// (JAX's bf16 Pallas scatter rounds its partial sums at each grid block,
// gather.py:98; the port rounds once, as it did before). STAGE (the
// cloud's g in at most 64 KB: every bf16 path shape): g is first copied
// into shared memory in 16-byte pieces, with the idx loads in flight, and
// every later read of g, the sums' and the centers', is from there; else
// the sums gather g's rows from device memory, 4 rows' loads in flight,
// VEC (C a multiple of 4, g on 16 bytes) 4 channels a load. With CENTER
// the same block then sums its slice of the groups, each group's S rows in
// row order, negated and rounded to the points' dtype, into f32
// d_centers. Every phase is one round of loads or a pass over shared
// memory between barriers: what bounds the kernel is those phases'
// latency and the launch, not the bytes. Shared memory: the scan's warp
// totals, the segment ends, the row ids and, where staged, g: 4 (16 + np
// + K) bytes + K C elements (K <= 16,384).
#include <type_traits>

#include "common.cuh"
#include "train_common.cuh"

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

// ------------------------------------------------------------- the VJPs
constexpr int SC_THREADS = 512;  // threads a block of scatter_sorted_kernel
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_MIN_BLOCKS = 3;  // blocks an SM: registers held to 40 a thread
constexpr int SC_LOADS = 8;  // idx loads a thread keeps in flight: K <= 4,096 in one round
constexpr int SC_VLOADS = 4;  // 16-byte pieces of g a thread stages at once
constexpr int SC_CEN_LOADS = 8;  // a group's rows a center sum loads at once (unstaged)
constexpr int SC_MAX_ROWS = 16384;  // K
constexpr int SC_MAX_SMEM = 232448;

// Shared memory of a block: wsum[SC_WARPS], end[np], seg[K] (ints), then,
// from a 16-byte boundary, STAGE: the cloud's g, K rows of C elements of T.
__host__ __device__ inline size_t sc_rows_offset(int np, int K) {
  return (sizeof(int) * ((size_t)SC_WARPS + np + K) + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t sc_smem_bytes(int np, int K, int C, int size, bool stage) {
  return sc_rows_offset(np, K) + (stage ? (size_t)K * C * size : 0);
}

// The 4 channels [c0, c0 + 4) of a row (f32), those past C as 0: one
// 16-byte (f32) or 8-byte (bf16) load where VEC, else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int n, float (&v)[4]) {
  if constexpr (VEC) {
    load_vec<T, 4>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? to_f32(p[q]) : 0.f;
  }
}
template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ p, int n, const float (&v)[4]) {
  if constexpr (VEC) {
    store_vec<T, 4>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) p[q] = from_f32<T>(v[q]);
  }
}

// The idx of rows r0 + u * SC_THREADS + tid (u < SC_LOADS), -1 past K.
__device__ __forceinline__ void load_idx(const int* __restrict__ ib, int r0, int K,
                                         int (&v)[SC_LOADS]) {
#pragma unroll
  for (int u = 0; u < SC_LOADS; ++u) {
    const int r = r0 + u * SC_THREADS + threadIdx.x;
    v[u] = r < K ? ib[r] : -1;
  }
}

// `n` elements of T from src to shared dst, coalesced: 16-byte pieces
// (SC_VLOADS in flight a thread) where src starts on 16 bytes, then the
// ragged end element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, T* __restrict__ dst,
                                           int n) {
  constexpr int U = 16 / sizeof(T);
  const int pieces = (reinterpret_cast<uintptr_t>(src) & 15) ? 0 : n / U;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int q0 = 0; q0 < pieces; q0 += SC_THREADS * SC_VLOADS) {
    uint4 w[SC_VLOADS];
#pragma unroll
    for (int u = 0; u < SC_VLOADS; ++u) {
      const int q = q0 + u * SC_THREADS + threadIdx.x;
      if (q < pieces) w[u] = s4[q];
    }
#pragma unroll
    for (int u = 0; u < SC_VLOADS; ++u) {
      const int q = q0 + u * SC_THREADS + threadIdx.x;
      if (q < pieces) d4[q] = w[u];
    }
  }
  for (int e = pieces * U + threadIdx.x; e < n; e += SC_THREADS) dst[e] = src[e];
}

// Sorts the row ids of point p's segment, seg[end[p - 1], end[p]), in place
// (insertion sort).
__device__ __forceinline__ void sort_segment(int* seg, const int* end, int p) {
  const int lo = p ? end[p - 1] : 0, hi = end[p];
  for (int i = lo + 1; i < hi; ++i) {
    const int x = seg[i];
    int j = i - 1;
    while (j >= lo && seg[j] > x) {
      seg[j + 1] = seg[j];
      --j;
    }
    seg[j + 1] = x;
  }
}

// Block (b, part) owns points [p0, p0 + npart) of cloud b (part = blockIdx.x
// % parts) and, with CENTER, groups [g_lo, g_hi) (ceil(G / parts) a part).
// STAGE: the cloud's g is copied into shared memory first (coalesced, with
// the idx loads in flight), and every later read of g is from there.
template <typename T, bool VEC, bool CENTER, bool STAGE>
__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
    scatter_sorted_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                          T* __restrict__ dpoints, float* __restrict__ dcenters, int N, int C,
                          int K, int G, int S, int np, int parts, int lanes) {
  extern __shared__ __align__(16) int sc_smem[];
  int* wsum = sc_smem;
  int* end = wsum + SC_WARPS;
  int* seg = end + np;
  T* vals = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc_smem) +
                                 sc_rows_offset(np, K));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / parts, part = blockIdx.x % parts;
  const int p0 = part * np, npart = min(np, N - p0);
  const int* __restrict__ ib = idx + (size_t)b * K;
  const T* __restrict__ gb = g + (size_t)b * K * C;
  constexpr int CH = SC_THREADS * SC_LOADS;

  for (int p = tid; p < npart; p += SC_THREADS) end[p] = 0;
  int v0[SC_LOADS];  // the first SC_LOADS idx of the thread, kept for the placement
  load_idx(ib, 0, K, v0);
  if constexpr (STAGE) stage_rows<T>(gb, vals, K * C);
  __syncthreads();
  // the histogram of the block's points over the cloud's rows (integer
  // atomics in shared memory: exact counts)
  for (int r0 = 0; r0 < K; r0 += CH) {
    int v[SC_LOADS];
    if (r0 == 0) {
#pragma unroll
      for (int u = 0; u < SC_LOADS; ++u) v[u] = v0[u];
    } else {
      load_idx(ib, r0, K, v);
    }
#pragma unroll
    for (int u = 0; u < SC_LOADS; ++u) {
      const int p = v[u] - p0;
      if ((unsigned)p < (unsigned)npart) atomicAdd(&end[p], 1);
    }
  }
  __syncthreads();
  // exclusive scan of the counts into segment starts: a run of `per`
  // points a thread, a warp scan of the runs' sums, a scan of the warps'
  // totals
  {
    const int per = (npart + SC_THREADS - 1) / SC_THREADS;
    const int lo = min(npart, tid * per), hi = min(npart, lo + per);
    int local = 0;
    for (int i = lo; i < hi; ++i) local += end[i];
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < SC_WARPS ? wsum[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += x;
      }
      if (lane < SC_WARPS) wsum[lane] = wi - w;
    }
    __syncthreads();
    int run = wsum[warp] + incl - local;
    for (int i = lo; i < hi; ++i) {
      const int n = end[i];
      end[i] = run;  // the segment's start, then its cursor
      run += n;
    }
  }
  __syncthreads();
  // each row id into its point's segment (an integer atomic cursor, which
  // ends at the segment's end)
  for (int r0 = 0; r0 < K; r0 += CH) {
    int v[SC_LOADS];
    if (r0 == 0) {
#pragma unroll
      for (int u = 0; u < SC_LOADS; ++u) v[u] = v0[u];
    } else {
      load_idx(ib, r0, K, v);
    }
#pragma unroll
    for (int u = 0; u < SC_LOADS; ++u) {
      const int p = v[u] - p0;
      if ((unsigned)p < (unsigned)npart)
        seg[atomicAdd(&end[p], 1)] = r0 + u * SC_THREADS + tid;
    }
  }
  __syncthreads();
  // each segment sorted by row id (insertion sort, a thread a point: a
  // point has a few rows, at most G for kNN indices, and they arrive
  // nearly in order): its sum's order then depends on idx alone, not on
  // the order the atomics placed the rows in. Where a lane sums a point
  // alone (lanes == 1) it sorts that point itself, with no barrier between
  for (int p = tid; lanes > 1 && p < npart; p += SC_THREADS) sort_segment(seg, end, p);
  if (lanes > 1) __syncthreads();
  // a group of `lanes` lanes a point, 4 channels a lane: the point's rows
  // summed in row order in f32 (from shared memory where staged, else 4
  // rows' loads in flight), rounded once; every point row written, zeros
  // where no row picks it
  const int c0 = (tid % lanes) * 4, nc = min(4, C - c0);
  T* __restrict__ dp = dpoints + ((size_t)b * N + p0) * C + c0;
  for (int p = tid / lanes; nc > 0 && p < npart; p += SC_THREADS / lanes) {
    if (lanes == 1) sort_segment(seg, end, p);
    const int lo = p ? end[p - 1] : 0, hi = end[p];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (STAGE) {
      for (int i = lo; i < hi; ++i) {
        const T* __restrict__ x = vals + seg[i] * C + c0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nc) acc[k] += to_f32(x[k]);
      }
    } else {
      int i = lo;
      for (; i + 4 <= hi; i += 4) {
        float x[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) load4<T, VEC>(gb + (size_t)seg[i + u] * C + c0, nc, x[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] += x[u][k];
      }
      for (; i < hi; ++i) {
        float x[4];
        load4<T, VEC>(gb + (size_t)seg[i] * C + c0, nc, x);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += x[k];
      }
    }
    store4<T, VEC>(dp + (size_t)p * C, nc, acc);
  }
  if constexpr (CENTER) {
    // d_centers of the block's groups, with no barrier before (they read
    // only g): each (group, channel) a thread, its S rows summed in row
    // order in f32 (from shared memory where staged, else SC_CEN_LOADS
    // loads in flight), negated, rounded to T
    const int gpp = (G + parts - 1) / parts, g_lo = part * gpp, g_hi = min(G, g_lo + gpp);
    float* __restrict__ dc = dcenters + (size_t)b * G * 3;
    for (int e = tid; e < 3 * (g_hi - g_lo); e += SC_THREADS) {
      const int grp = g_lo + e / 3, c = e % 3;
      const T* __restrict__ gr = (STAGE ? vals : gb) + (size_t)grp * S * C + c;
      float s = 0.f;
      if constexpr (STAGE) {
#pragma unroll 8
        for (int t = 0; t < S; ++t) s += to_f32(gr[t * C]);
      } else {
        for (int t0 = 0; t0 < S; t0 += SC_CEN_LOADS) {
          float x[SC_CEN_LOADS];
#pragma unroll
          for (int u = 0; u < SC_CEN_LOADS; ++u)
            x[u] = t0 + u < S ? to_f32(gr[(size_t)(t0 + u) * C]) : 0.f;
#pragma unroll
          for (int u = 0; u < SC_CEN_LOADS; ++u)
            if (t0 + u < S) s += x[u];
        }
      }
      dc[(size_t)grp * 3 + c] = round_to<T>(-s);
    }
  }
}

// One launch of B * parts blocks, parts = ceil(N / np). The wrapper plans
// np, lanes and stage (ops/cuda/gather.py `scatter_plan`) and sets vec
// only where C is a multiple of 4 and g starts on 16 bytes.
template <typename T, bool CENTER, bool STAGE>
int launch_scatter_as(const void* g, const void* idx, void* dpoints, void* dcenters, int B, int N,
                      int C, int K, int G, int S, int np, int lanes, int vec, void* stream) {
  const size_t smem = sc_smem_bytes(np, K, C, sizeof(T), STAGE);
  if (smem > SC_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int parts = (N + np - 1) / np;
  if (B == 0) return cudaSuccess;
  auto kernel = vec ? scatter_sorted_kernel<T, true, CENTER, STAGE>
                    : scatter_sorted_kernel<T, false, CENTER, STAGE>;
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<B * parts, SC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const int*>(idx), static_cast<T*>(dpoints),
      static_cast<float*>(dcenters), N, C, K, G, S, np, parts, lanes);
  return cudaGetLastError();
}

template <typename T, bool CENTER>
int launch_scatter(const void* g, const void* idx, void* dpoints, void* dcenters, int B, int N,
                   int C, int K, int G, int S, int np, int lanes, int vec, int stage,
                   void* stream) {
  if (B < 0 || N < 1 || C < 1 || C > 128 || K < 0 || K > SC_MAX_ROWS || np < 1 || np > N ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || 4 * lanes < C || (vec && C % 4) ||
      (CENTER && (G < 1 || S < 1 || K != G * S)))
    return (int)cudaErrorInvalidValue;
  return stage ? launch_scatter_as<T, CENTER, true>(g, idx, dpoints, dcenters, B, N, C, K, G, S,
                                                    np, lanes, vec, stream)
               : launch_scatter_as<T, CENTER, false>(g, idx, dpoints, dcenters, B, N, C, K, G, S,
                                                     np, lanes, vec, stream);
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
                                    int np, int lanes, int vec, int stage, void* stream) {
  return launch_scatter<float, true>(grad, idx, dpoints, dcenters, b, n, c, k, g, s, np, lanes,
                                     vec, stage, stream);
}
extern "C" int scatter_centered_bf16(const void* grad, const void* idx, void* dpoints,
                                     void* dcenters, int b, int n, int c, int g, int k, int s,
                                     int np, int lanes, int vec, int stage, void* stream) {
  return launch_scatter<__nv_bfloat16, true>(grad, idx, dpoints, dcenters, b, n, c, k, g, s, np,
                                             lanes, vec, stage, stream);
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
                                int c, int k, int np, int lanes, int vec, int stage,
                                void* stream) {
  return launch_scatter<float, false>(grad, idx, dpoints, nullptr, b, n, c, k, 1, k, np, lanes,
                                      vec, stage, stream);
}
extern "C" int scatter_rows_bf16(const void* grad, const void* idx, void* dpoints, int b,
                                 int n, int c, int k, int np, int lanes, int vec, int stage,
                                 void* stream) {
  return launch_scatter<__nv_bfloat16, false>(grad, idx, dpoints, nullptr, b, n, c, k, 1, k, np,
                                              lanes, vec, stage, stream);
}
