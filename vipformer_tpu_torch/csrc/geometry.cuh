// Device functions shared by the point-selection kernels: K1 (fps.cu), K2
// (knn.cu) and K16 (patchify.cu). K16 runs K1's FPS step and K2's kNN
// selection from here, so its indices equal K1 followed by K2 bit for bit
// by construction.
#pragma once

#include <atomic>

#include "common.cuh"

namespace vpt {

constexpr unsigned FULL_MASK = 0xffffffffu;

// ---------------------------------------------------------------- FPS
// K1's step, K16's phase 1. W FPS warps hold the cloud PPL points
// a lane: point j of lane l of warp w is (w PPL + j) 32 + l, increasing in
// j. A step folds the last center into each point's running min-distance
// (vpt::sq_dist3, no FMA contraction, in the Pallas order), takes each
// lane's best point by a tree over its points (the larger value wins, the
// smaller index on a tie), and the warp's in two redux.sync: the distances
// are >= 0, so their f32 bits order as unsigned integers, __reduce_max_sync
// gives the maximum and __reduce_min_sync over the indices of the lanes
// that hold it its first index (ties to the first index, fps.py:63-68).
// Past one warp each warp's winner goes to a shared slot indexed by the
// step's parity as one 64-bit key (the value's bits high, the index's
// complement low: the largest key is the largest value at its first
// index), ONE barrier over the FPS warps (the block's, or named barrier 1
// where other warps of the block take no part), and every warp reduces
// the W keys itself: up to FPS_SEQ_WARPS each lane reads all W in turn,
// past it lane w reads key w and two more redux.sync reduce them (the
// parity keeps the next step's writes off the slots a slow warp still
// reads).

constexpr int FPS_PPL = 8;          // points a lane: ops/cuda/fps.py PPL
constexpr int FPS_MAX_WARPS = 32;   // 8,192 points: ops/cuda/fps.py MAX_POINTS
constexpr int FPS_SEQ_WARPS = 4;    // up to this many warps each lane reads every key
constexpr unsigned FPS_NONE = 0xffffffffu;  // no candidate: above every index

// The warps a cloud of n points takes (ops/cuda/fps.py fps_warps).
__host__ __device__ constexpr int fps_warps(int n) {
  return (n + 32 * FPS_PPL - 1) / (32 * FPS_PPL);
}

// A lane's points and their running min-distances; a slot past the cloud
// holds distance -1, below every distance, which fminf keeps.
struct FpsLane {
  float x[FPS_PPL], y[FPS_PPL], z[FPS_PPL], d[FPS_PPL];
};

// Load lane `lane` of FPS warp `warp` from the cloud in shared memory,
// point i's xyz at s_xyz[stride i] (K1: [N, 3]; K16: float4 rows).
__device__ __forceinline__ void fps_load(FpsLane& p, const float* s_xyz, int stride, int warp,
                                         int lane, int n) {
#pragma unroll
  for (int j = 0; j < FPS_PPL; ++j) {
    const int i = (warp * FPS_PPL + j) * 32 + lane;
    const bool ok = i < n;
    p.x[j] = ok ? s_xyz[stride * i + 0] : 0.f;
    p.y[j] = ok ? s_xyz[stride * i + 1] : 0.f;
    p.z[j] = ok ? s_xyz[stride * i + 2] : 0.f;
    p.d[j] = ok ? 1e10f : -1.0f;
  }
}

__device__ __forceinline__ unsigned long long fps_key(unsigned v, unsigned i) {
  return ((unsigned long long)v << 32) | (unsigned)~i;
}

// One step of `nw` FPS warps (the block's first nw; ONE_WARP: nw == 1, no
// barrier, no shared slots; WHOLE_BLOCK: they are the block, and
// __syncthreads is their barrier) for step `it` with center (cx, cy, cz):
// returns the next center, the farthest point from every center so far.
template <bool ONE_WARP, bool WHOLE_BLOCK>
__device__ __forceinline__ int fps_step(FpsLane& p, float cx, float cy, float cz, int it,
                                        int warp, int lane, int nw,
                                        unsigned long long (*s_key)[FPS_MAX_WARPS]) {
  float bv[FPS_PPL];
  int bk[FPS_PPL];
#pragma unroll
  for (int j = 0; j < FPS_PPL; ++j) {
    p.d[j] = fminf(p.d[j], sq_dist3(p.x[j] - cx, p.y[j] - cy, p.z[j] - cz));
    bv[j] = p.d[j];
    bk[j] = j;
  }
  // the lane's best: a tree in which the later (larger-index) half wins
  // only on a strictly larger value
#pragma unroll
  for (int s = 1; s < FPS_PPL; s <<= 1)
#pragma unroll
    for (int j = 0; j + s < FPS_PPL; j += 2 * s)
      if (bv[j + s] > bv[j]) {
        bv[j] = bv[j + s];
        bk[j] = bk[j + s];
      }
  const bool has = bv[0] >= 0.f;
  const unsigned v = has ? __float_as_uint(bv[0]) : 0u;
  const unsigned i = has ? (unsigned)((warp * FPS_PPL + bk[0]) * 32 + lane) : FPS_NONE;
  unsigned best = __reduce_max_sync(FULL_MASK, v);
  unsigned first = __reduce_min_sync(FULL_MASK, v == best ? i : FPS_NONE);
  if constexpr (!ONE_WARP) {
    const int slot = it & 1;
    if (lane == 0) s_key[slot][warp] = fps_key(best, first);
    if constexpr (WHOLE_BLOCK) {
      __syncthreads();
    } else {
      asm volatile("bar.sync 1, %0;" ::"r"(32 * nw) : "memory");
    }
    if (nw <= FPS_SEQ_WARPS) {
      unsigned long long key = s_key[slot][0];
      for (int w = 1; w < nw; ++w) {
        const unsigned long long o = s_key[slot][w];
        key = o > key ? o : key;
      }
      first = ~(unsigned)key;
    } else {
      const unsigned long long key = lane < nw ? s_key[slot][lane] : 0ull;
      const unsigned kv = (unsigned)(key >> 32), ki = ~(unsigned)key;
      best = __reduce_max_sync(FULL_MASK, kv);
      first = __reduce_min_sync(FULL_MASK, kv == best ? ki : FPS_NONE);
    }
  }
  return (int)first;
}

// ---------------------------------------------------------------- kNN
// K2's selection, K16's phase 2: one warp finds the k smallest packed keys
// of one query, nearest first. Lane l owns the key slots of points l,
// l+32, ... of the cloud, float4 rows in shared memory padded with points
// at infinity to the slots the lanes walk (their keys lie above every
// real key, so no slot needs a bounds check).
//   1. One pass over the keys: each lane keeps the M smallest of its own
//      (M = 1 for k <= 32, 4 up to KNN_KMAX). tau is the k-th smallest of
//      the 32 M kept keys (their maximum when k = 32 M: one redux.sync;
//      else k rounds of a warp min over the lanes' sorted kept keys). At
//      least k keys are <= tau, so every one of the k smallest is.
//   2. The keys <= tau are compacted into the warp's slots of shared
//      memory: with the keys in registers, each lane counts its own, a
//      warp prefix sum places them and each lane writes its run; with
//      recomputed keys, slot by slot with __ballot_sync and __popc.
//   3. Up to KNN_CAP candidates, candidate c is lane c % 32's, each lane
//      sorts its CPL = 4, 8 or 16 (by the count) in registers and writes
//      them back in its column, and k rounds of one redux.sync over the
//      lanes' heads pop them nearest first (the lane that held the least
//      reads its next). A warp with more candidates runs the exact scan
//      (k rounds of a threshold min over every key) and counts itself in
//      *overflow; so does every k above KNN_KMAX.
// Up to KNN_REG_KPL keys a lane (N <= 2,048) the keys stay in registers
// between the passes; past it they are recomputed from shared memory,
// KNN_CHUNK a lane at a time.

constexpr int KNN_NONE = 0x7fffffff;  // no key: above every key
constexpr int KNN_KMAX = 128;         // the largest k the threshold select takes
constexpr int KNN_CAP = 512;          // candidate slots a warp
constexpr int KNN_BUF = KNN_CAP + 32; // with a row of sentinels below the deepest column
constexpr int KNN_REG_KPL = 64;       // the most keys a lane holds in registers
constexpr int KNN_CHUNK = 32;         // keys a lane a recompute step (KPL > KNN_REG_KPL)

// bit_length(n - 1), at least 1: the low bits of a packed kNN key that hold
// the point index (ops/pallas/knn.py).
__host__ __device__ __forceinline__ int knn_idx_bits(int n) {
  int bits = 1;
  while ((1 << bits) < n) ++bits;
  return bits;
}

// Keys kept a lane for k (M above): 0 means the exact scan.
__host__ __device__ __forceinline__ int knn_kept(int k) {
  return k <= 32 ? 1 : k <= KNN_KMAX ? 4 : 0;
}

// The float4 rows a cloud of n points takes in shared memory for KPL key
// slots a lane: every slot the lanes walk, padded with points at infinity.
__host__ __device__ __forceinline__ int knn_rows(int n, int kpl) {
  const int walk = 32 * (kpl <= KNN_REG_KPL ? kpl : KNN_CHUNK);
  return (n + walk - 1) / walk * walk;
}

// Stage a [N, 3] cloud as `rows` float4 rows, the rows past N at infinity.
__device__ __forceinline__ void knn_stage(float4* s_pts, const float* __restrict__ cloud, int n,
                                          int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_pts[i] = i < n ? make_float4(cloud[3 * i], cloud[3 * i + 1], cloud[3 * i + 2], 0.f)
                     : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
}

// Packed kNN key of a squared distance d >= 0 and point index i: the
// distance's bits above the index bits, the index below. Keys of distinct
// points differ, so ordering keys orders (distance, index). A padded row
// (d = inf) gives 0x7f800000 | i, above every finite key.
__device__ __forceinline__ int knn_key(float d, int i, int mask) {
  return (__float_as_int(d) & ~mask) | i;
}

// The keys of one query: point i's is the f32 squared difference summed
// over c = 0, 1, 2 in order (knn.py:43-49).
struct KnnQuery {
  const float4* pts;
  float qx, qy, qz;
  int mask;
  __device__ __forceinline__ int key(int i) const {
    const float4 p = pts[i];
    return knn_key(sq_dist3(qx - p.x, qy - p.y, qz - p.z), i, mask);
  }
};

// Insert a key into a lane's ascending list of its M smallest.
template <int M>
__device__ __forceinline__ void knn_keep(int (&a)[M], int key) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int lo = min(a[j], key);
    key = max(a[j], key);
    a[j] = lo;
  }
}

// The warp's least head of the lanes' ascending lists a[0..M): the lane
// that holds it (keys are unique) drops it. Keys are >= 0, so unsigned
// order is theirs.
template <int M>
__device__ __forceinline__ int knn_pop(int (&a)[M]) {
  const int m = (int)__reduce_min_sync(FULL_MASK, (unsigned)a[0]);
  const bool mine = a[0] == m;
#pragma unroll
  for (int j = 0; j + 1 < M; ++j) a[j] = mine ? a[j + 1] : a[j];
  a[M - 1] = mine ? KNN_NONE : a[M - 1];
  return m;
}

// Ascending bitonic sort of C (a power of two) keys in registers.
template <int C>
__device__ __forceinline__ void knn_sort(int (&a)[C]) {
#pragma unroll
  for (int size = 2; size <= C; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const int lo = min(a[i], a[j]), hi = max(a[i], a[j]);
          const bool up = (i & size) == 0;
          a[i] = up ? lo : hi;
          a[j] = up ? hi : lo;
        }
      }
}

// The exact scan, round r taking the least key above round r-1's: the
// next key of the query, from registers (KPL <= KNN_REG_KPL) or recomputed
// over nk slots a lane.
template <int KPL>
struct KnnScan {
  const int (&keys)[KPL <= KNN_REG_KPL ? KPL : 1];
  KnnQuery kq;
  int nk;
  int thr;
  __device__ __forceinline__ int operator()() {
    const int lane = threadIdx.x & 31;
    int m = KNN_NONE;
    if constexpr (KPL <= KNN_REG_KPL) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) m = min(m, keys[j] > thr ? keys[j] : KNN_NONE);
    } else {
      for (int j0 = 0; j0 < nk; j0 += KNN_CHUNK) {
#pragma unroll
        for (int jj = 0; jj < KNN_CHUNK; ++jj) {
          const int key = kq.key(lane + 32 * (j0 + jj));
          m = min(m, key > thr ? key : KNN_NONE);
        }
      }
    }
    thr = (int)__reduce_min_sync(FULL_MASK, (unsigned)m);
    return thr;
  }
};

// The candidates' heads: each lane's sorted column of the warp's slots,
// its head in a register and the next read on a pop.
struct KnnHeads {
  const int* col;
  int head;
  __device__ __forceinline__ int operator()() {
    const int m = (int)__reduce_min_sync(FULL_MASK, (unsigned)head);
    col += head == m ? 32 : 0;
    head = *col;
    return m;
  }
};

// k rounds of next() (the warp's next key, nearest first): lane r % 32
// keeps round r's index, and the warp writes out[] 32 indices at a time.
template <bool UNROLL, class Next>
__device__ __forceinline__ void knn_emit(Next& next, int k, int mask, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int rn = min(32, k - r0);
    int o = 0;
    if (UNROLL && rn == 32) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int m = next();
        o = lane == r ? m : o;
      }
    } else {
      for (int r = 0; r < rn; ++r) {
        const int m = next();
        o = lane == r ? m : o;
      }
    }
    if (lane < rn) out[r0 + lane] = o & mask;
  }
}

// Pop k of the count candidates in buf nearest first, CPL a lane: lane l
// holds candidates l, l+32, ..., sorts them and writes them back in its
// column above a sentinel.
template <int CPL>
__device__ __forceinline__ void knn_select(int* buf, int count, int k, int mask,
                                           int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  int c[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int s = lane + 32 * j;
    c[j] = s < count ? buf[s] : KNN_NONE;
  }
  knn_sort<CPL>(c);
#pragma unroll
  for (int j = 0; j < CPL; ++j) buf[lane + 32 * j] = c[j];
  buf[lane + 32 * CPL] = KNN_NONE;
  KnnHeads heads{buf + lane, c[0]};
  knn_emit<true>(heads, k, mask, out);
}

// The k nearest of the n points of the cloud s_pts (knn_rows(n, KPL) rows)
// to q, for the calling warp: out[0..k) nearest first. buf: the warp's
// KNN_BUF slots (unused with M = 0). A warp that takes the exact scan for
// want of slots adds one to *overflow where it is not null. KPL >=
// ceil(n / 32).
template <int KPL, int M>
__device__ __forceinline__ void knn_query(const float4* s_pts, int n, float4 q, int k, int mask,
                                          int* buf, int* __restrict__ out, int* overflow) {
  constexpr bool REG = KPL <= KNN_REG_KPL;
  const int lane = threadIdx.x & 31;
  const KnnQuery kq{s_pts, q.x, q.y, q.z, mask};
  const int nk = knn_rows(n, KPL) / 32;  // key slots a lane
  int keys[REG ? KPL : 1];
  int kept[M > 0 ? M : 1];
#pragma unroll
  for (int j = 0; j < (M > 0 ? M : 1); ++j) kept[j] = KNN_NONE;
  if constexpr (REG) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      keys[j] = kq.key(lane + 32 * j);
      if constexpr (M > 0) knn_keep<M>(kept, keys[j]);
    }
  } else if constexpr (M > 0) {
    for (int j0 = 0; j0 < nk; j0 += KNN_CHUNK) {
#pragma unroll
      for (int jj = 0; jj < KNN_CHUNK; ++jj) knn_keep<M>(kept, kq.key(lane + 32 * (j0 + jj)));
    }
  }
  KnnScan<KPL> scan{keys, kq, nk, -1};
  if constexpr (M == 0) {
    knn_emit<false>(scan, k, mask, out);
  } else {
    int tau = KNN_NONE;
    if (k == 32 * M) {
      tau = (int)__reduce_max_sync(FULL_MASK, (unsigned)kept[M - 1]);
    } else {
      for (int r = 0; r < k; ++r) tau = knn_pop<M>(kept);
    }
    int count;
    if constexpr (REG) {
      int own = 0;
#pragma unroll
      for (int j = 0; j < KPL; ++j) own += keys[j] <= tau;
      int incl = own;  // the warp's inclusive prefix sum of the lanes' counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += t;
      }
      count = __shfl_sync(FULL_MASK, incl, 31);
      if (count <= KNN_CAP) {
        int* w = buf + (incl - own);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          if (keys[j] <= tau) *w++ = keys[j];
        }
      }
    } else {
      const unsigned below = (1u << lane) - 1u;
      count = 0;
      for (int j0 = 0; j0 < nk; j0 += KNN_CHUNK) {
#pragma unroll
        for (int jj = 0; jj < KNN_CHUNK; ++jj) {
          const int key = kq.key(lane + 32 * (j0 + jj));
          const bool take = key <= tau;
          const unsigned ballot = __ballot_sync(FULL_MASK, take);
          const int pos = count + __popc(ballot & below);
          if (take && pos < KNN_CAP) buf[pos] = key;
          count += __popc(ballot);
        }
      }
    }
    __syncwarp();
    if (count <= 128) {
      knn_select<4>(buf, count, k, mask, out);
    } else if (count <= 256) {
      knn_select<8>(buf, count, k, mask, out);
    } else if (count <= KNN_CAP) {
      knn_select<16>(buf, count, k, mask, out);
    } else {
      if (overflow != nullptr && lane == 0) atomicAdd(overflow, 1);
      knn_emit<false>(scan, k, mask, out);
    }
    __syncwarp();  // the next query's compaction overwrites buf
  }
}

// ---------------------------------------------------------------- host
// Raises a kernel's cap on dynamic shared memory to `bytes` (the most any
// launch of it takes) once a device, so that a launch past 48 KB does not
// pay a driver call every time. `done` is the caller's, one for each kernel
// instance: a bit a device. A race sets the same cap twice.
template <class Kernel>
inline cudaError_t raise_smem_cap_once(Kernel kernel, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace vpt
