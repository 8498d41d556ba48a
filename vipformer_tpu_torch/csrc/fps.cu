// K1: farthest point sampling.
//
// Replaces vipformer_tpu/ops/pallas/fps.py:fps_pallas (return_centers=True).
//
// Bound on the H100: latency, not bytes or FLOPs. npoint (128) dependent
// steps, each a pass over the cloud's running min-distance and an argmax
// over the cloud, so the time is npoint x one step's latency. The cloud
// (1024 x 3 f32 = 12 KB) moves once.
//
// Design: one block per cloud. The Pallas kernel kept a tile of clouds in
// VMEM and walked the batch in grid order; here the cloud's xyz and its
// running min-distance live in registers, PPL points a lane, in W =
// ceil(N / (32 PPL)) warps. A step (vpt::fps_step, geometry.cuh, which K16
// runs too):
//   * the centroid's xyz from a shared-memory copy of the cloud (a
//     broadcast read; at most 96 KB at 8,192 points);
//   * each lane's distances (vpt::sq_dist3, no FMA contraction, in the
//     Pallas order) and fminf into its running min, then its best point by
//     a tree over its points, which it holds in increasing index, the
//     larger value winning and the smaller index on a tie;
//   * the warp's argmax in two redux.sync: the distances are >= 0, so
//     their f32 bits order as unsigned integers, and __reduce_max_sync
//     over them gives the maximum; __reduce_min_sync over the indices of
//     the lanes that hold it gives its first index (ties to the first
//     index, fps.py:63-68);
//   * with W > 1, each warp's winner goes to a shared slot indexed by the
//     step's parity as one 64-bit key (the value's bits high, the index's
//     complement low: the largest key is the largest value at its first
//     index), ONE barrier, and every warp reduces the W keys itself: up to
//     4 warps each lane reads all W in turn, past it lane w reads key w and
//     two more redux.sync reduce them (the parity keeps the next step's
//     writes off the slots a slow warp still reads). W = 1 has no barrier.
// The work of a step is about a dozen instructions a point, so a lane's
// points set its time: PPL is 8 (4 warps at N = 1,024), since one warp of
// 32 points a lane (no barrier) and 2 warps of 16 measured slower at 1,024
// and at 4,096 points (PERF.md). Up to 256 points a cloud is one warp.
// The indices and centers equal fps_plain's, and K16's by construction,
// bit for bit.
#include "geometry.cuh"

namespace {

constexpr int MAX_POINTS = 8 * 1024;  // ops/cuda/fps.py MAX_POINTS

// PPL points a lane, W = blockDim.x / 32 warps; ONE_WARP (W == 1) has no
// barrier and no shared slots in its step loop.
template <bool ONE_WARP>
__global__ void __launch_bounds__(MAX_POINTS / vpt::FPS_PPL)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ idx_out, float* __restrict__ centers_out, int n, int npoint) {
  extern __shared__ float s_xyz[];  // the cloud [N, 3]
  __shared__ unsigned long long s_key[2][vpt::FPS_MAX_WARPS];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const float* cloud = xyz + (size_t)b * n * 3;
  for (int e = tid; e < 3 * n; e += blockDim.x) s_xyz[e] = cloud[e];
  __syncthreads();

  vpt::FpsLane p;
  vpt::fps_load(p, s_xyz, 3, warp, lane, n);
  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    const float cx = s_xyz[3 * far + 0], cy = s_xyz[3 * far + 1], cz = s_xyz[3 * far + 2];
    if (tid == 0) {
      idx_out[(size_t)b * npoint + it] = far;
      float* c = centers_out + ((size_t)b * npoint + it) * 3;
      c[0] = cx;
      c[1] = cy;
      c[2] = cz;
    }
    far = vpt::fps_step<ONE_WARP, true>(p, cx, cy, cz, it, warp, lane, nw, s_key);
  }
}

}  // namespace

// xyz f32 [B, N, 3] contiguous, start int32 [B] -> idx int32 [B, npoint],
// centers f32 [B, npoint, 3]. N <= 8,192, in ceil(N / (32 PPL)) warps.
extern "C" int fps_f32(const void* xyz, const void* start, void* idx, void* centers, int b, int n,
                       int npoint, void* stream) {
  if (b < 1 || n < 1 || n > MAX_POINTS || npoint < 1) return (int)cudaErrorInvalidValue;
  const int warps = vpt::fps_warps(n);
  const size_t smem = sizeof(float) * 3 * (size_t)n;
  auto kernel = warps == 1 ? fps_kernel<true> : fps_kernel<false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<b, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int*)start, (int*)idx, (float*)centers, n, npoint);
  return (int)cudaGetLastError();
}
