// K1: farthest point sampling.
//
// Replaces vipformer_tpu/ops/pallas/fps.py:fps_pallas (return_centers=True).
//
// Bound on the H100: latency, not bytes or FLOPs. npoint (128) dependent
// steps, each a block-wide argmax over the cloud's running min-distance,
// so the time is npoint x (one distance pass + two levels of reduction +
// two block barriers). The cloud (1024 x 3 f32 = 12 KB) moves once.
//
// Design: one block per cloud. The Pallas kernel kept a tile of clouds in
// VMEM and walked the batch in grid order; here each cloud's xyz and its
// min-distance live in registers (up to MAX_PPT points per thread), so a
// step touches no memory except the centroid's 12 bytes (an L1 hit after
// the first pass). The argmax is (value, index) with the FIRST index on
// ties (fps.py:63-68): warp shuffles, then one shared-memory pass by warp
// 0 (vpt::block_argmax_first, geometry.cuh, shared with K16). Distances use
// vpt::sq_dist3 (no FMA contraction), in the Pallas order.
// One block per cloud leaves SMs idle when B < 132 (32 of 132 busy at
// B=32); splitting a cloud over a cluster is later work.
#include "geometry.cuh"

namespace {

constexpr int MAX_PPT = 8;  // points per thread held in registers

__global__ void fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                           int* __restrict__ idx_out, float* __restrict__ centers_out,
                           int n, int npoint) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* cloud = xyz + (size_t)b * n * 3;

  float px[MAX_PPT], py[MAX_PPT], pz[MAX_PPT], dist[MAX_PPT];
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int i = tid + k * nt;
    if (i < n) {
      px[k] = cloud[3 * i + 0];
      py[k] = cloud[3 * i + 1];
      pz[k] = cloud[3 * i + 2];
    }
    dist[k] = 1e10f;
  }

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_far;

  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    const float cx = __ldg(cloud + 3 * far + 0);
    const float cy = __ldg(cloud + 3 * far + 1);
    const float cz = __ldg(cloud + 3 * far + 2);
    if (tid == 0) {
      idx_out[(size_t)b * npoint + it] = far;
      float* c = centers_out + ((size_t)b * npoint + it) * 3;
      c[0] = cx;
      c[1] = cy;
      c[2] = cz;
    }
    float best = -1.0f;  // every distance is >= 0
    int best_i = n;
#pragma unroll
    for (int k = 0; k < MAX_PPT; ++k) {
      const int i = tid + k * nt;
      if (i < n) {
        const float d = vpt::sq_dist3(px[k] - cx, py[k] - cy, pz[k] - cz);
        dist[k] = fminf(dist[k], d);
        if (dist[k] > best) {  // strict: the smaller index wins a tie
          best = dist[k];
          best_i = i;
        }
      }
    }
    far = vpt::block_argmax_first(best, best_i, n, s_val, s_idx, &s_far);
  }
}

}  // namespace

// xyz f32 [B, N, 3] contiguous, start int32 [B] -> idx int32 [B, npoint],
// centers f32 [B, npoint, 3]. Needs N <= 8 * 1024.
extern "C" int fps_f32(const void* xyz, const void* start, void* idx, void* centers,
                       int b, int n, int npoint, void* stream) {
  int threads = ((n + MAX_PPT - 1) / MAX_PPT + 31) / 32 * 32;
  threads = threads < 256 ? 256 : threads;
  fps_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int*)start, (int*)idx, (float*)centers, n, npoint);
  return (int)cudaGetLastError();
}
