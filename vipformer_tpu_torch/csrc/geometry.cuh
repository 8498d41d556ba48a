// Device functions shared by the point-selection kernels: K1 (fps.cu), K2
// (knn.cu) and K16 (patchify.cu), so the fused kernel does the same
// arithmetic as the two it fuses and its indices equal theirs bit for bit.
#pragma once

#include "common.cuh"

namespace vpt {

// (value, index) argmax step: the larger value wins, the smaller index on
// a tie (the first index of the maximum, ops/pallas/fps.py:63-68).
__device__ __forceinline__ void argmax_first(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax of each thread's (best, best_i), the first index on
// ties: warp shuffles, then warp 0 over the warps' winners. Every thread
// gets the winning index. s_val / s_idx hold one entry per warp; the two
// barriers also fence the caller's reads of shared memory before the next
// step writes it. Indices >= n mark threads with no candidate.
__device__ __forceinline__ int block_argmax_first(float best, int best_i, int n, float* s_val,
                                                  int* s_idx, int* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    argmax_first(best, best_i, ov, oi);
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? s_val[lane] : -1.0f;
    int i = lane < nwarps ? s_idx[lane] : n;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      argmax_first(v, i, ov, oi);
    }
    if (lane == 0) *s_out = i;
  }
  __syncthreads();
  return *s_out;
}

// bit_length(n - 1), at least 1: the low bits of a packed kNN key that hold
// the point index (ops/pallas/knn.py).
__host__ __device__ __forceinline__ int knn_idx_bits(int n) {
  int bits = 1;
  while ((1 << bits) < n) ++bits;
  return bits;
}

// Packed kNN key of a squared distance d >= 0 and point index i: the
// distance's bits above the index bits, the index below. Keys of distinct
// points differ, so ordering keys orders (distance, index).
__device__ __forceinline__ int knn_key(float d, int i, int mask) {
  return (__float_as_int(d) & ~mask) | i;
}

// k rounds of a warp-wide min over the lanes' keys (KPL a lane, unused
// slots 0x7fffffff): round r takes the least key above round r-1's, so the
// output is nearest first. Lane 0 writes the indices to out[0..k).
template <int KPL>
__device__ __forceinline__ void knn_warp_select(const int (&keys)[KPL], int k, int mask,
                                                int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  int thr = -1;  // below every non-negative key
  for (int r = 0; r < k; ++r) {
    int m = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if (keys[j] > thr && keys[j] < m) m = keys[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    thr = m;
    if (lane == 0) out[r] = m & mask;
  }
}

}  // namespace vpt
