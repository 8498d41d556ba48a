// K16: farthest point sampling, then the kNN of the sampled centers, in one
// launch.
//
// Replaces vipformer_tpu/ops/pallas/patchify.py:fps_knn_pallas.
//
// Bound on the H100: latency, not bytes or FLOPs. The FPS chain is G
// dependent steps (K1's bound); the kNN of a center is about 1,000 warp
// instructions at N = 1,024, K = 32 (K2's, knn.cu) and depends only on
// that center. The cloud moves once (12 KB at N = 1,024); the outputs are
// G x (K + 1) indices.
//
// Design: one block a cloud, whose FPS chain and the kNN of the centers
// it has chosen run at the same time:
//   * W1 = ceil(N / 256) FPS warps run K1's step (vpt::fps_step: 8 points
//     a lane in registers, two redux.sync a warp, one named barrier over
//     the FPS warps only). As each center is chosen, thread 0 writes it
//     into the block's slot for it with one relaxed store (no fence on
//     the chain: the cloud the kNN reads it against was staged before the
//     first barrier).
//   * 8 kNN warps take the next slot from a shared counter, poll it
//     (relaxed loads, nanosleep) until its center is there, and run K2's
//     selection on it (vpt::knn_query); the FPS warps join them when the
//     chain ends.
// At N <= 1,024 (12 warps) two blocks fit an SM, so the eval CLIs' 160
// clouds run in one wave on 132 SMs. The kNN warps' instructions slow the
// latency-bound chain that shares their SM: K16 takes longer than K1 + K2
// at every batch measured (PERF.md §6). The cloud is staged in shared
// memory once, float4 rows padded as K2 pads them. The FPS step and the
// kNN selection are K1's and K2's own code (geometry.cuh), so the indices
// equal K1 followed by K2 on K1's centers bit for bit.
#include "geometry.cuh"

namespace {

constexpr int KNN_WARPS = 8;      // kNN warps a block
constexpr int MAX_POINTS = 4096;  // ops/cuda/patchify.py MAX_POINTS

// The most warps a block of KPL key slots a lane takes, and the blocks an
// SM that instance is built for (two up to 1,024 points).
constexpr int max_warps(int kpl) { return vpt::fps_warps(32 * kpl) + KNN_WARPS; }
constexpr int min_blocks(int kpl) { return kpl <= 32 ? 2 : 1; }

// Shared memory of an instance's block: the cloud's rows, a slot a center
// and, with kept keys, every warp's candidate slots.
constexpr size_t smem_bytes(int rows, int g, int warps, int m) {
  return sizeof(float4) * (size_t)rows + sizeof(int) * (size_t)g +
         (m > 0 ? sizeof(int) * (size_t)warps * vpt::KNN_BUF : 0);
}

// The block's centers: slot i holds its i-th center once the FPS chain has
// chosen it, -1 before. One relaxed 32-bit store publishes it and the kNN
// warps poll the slot with relaxed loads: the cloud they read it against
// was staged before the block's first barrier, so no fence sits on the
// chain.
__device__ __forceinline__ void publish(int* slot, int center) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(slot);
  asm volatile("st.relaxed.cta.shared.b32 [%0], %1;" ::"r"(a), "r"(center) : "memory");
}

__device__ __forceinline__ int published(const int* slot) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(slot);
  int v;
  asm volatile("ld.relaxed.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// One cloud a block. Its first W1 warps run the FPS chain; every warp
// takes the kNN of the centers as they appear.
template <bool ONE_WARP, int KPL, int M>
__global__ void __launch_bounds__(32 * max_warps(KPL), min_blocks(KPL))
fps_knn_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ cidx_out, int* __restrict__ nidx_out, int n, int g, int k,
               int idx_bits, int* overflow) {
  const int b = blockIdx.x;
  extern __shared__ float4 s_pts[];           // the cloud: knn_rows(n, KPL) rows
  const int rows = vpt::knn_rows(n, KPL);
  int* s_cidx = reinterpret_cast<int*>(s_pts + rows);  // the centers, as published
  int* bufs = s_cidx + g;                              // a warp's KNN_BUF candidate slots
  __shared__ unsigned long long s_key[2][vpt::FPS_MAX_WARPS];
  __shared__ int s_next;  // the next center a warp takes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw1 = ONE_WARP ? 1 : vpt::fps_warps(n);
  vpt::knn_stage(s_pts, xyz + (size_t)b * n * 3, n, rows);
  for (int i = tid; i < g; i += blockDim.x) s_cidx[i] = -1;
  if (tid == 0) s_next = 0;
  __syncthreads();

  // ---- the FPS chain (K1's step), publishing each center as it is chosen
  if (warp < nw1) {
    vpt::FpsLane p;
    vpt::fps_load(p, reinterpret_cast<const float*>(s_pts), 4, warp, lane, n);
    int* cidx = cidx_out + (size_t)b * g;
    int far = start[b];
    for (int it = 0; it < g; ++it) {
      if (tid == 0) {
        publish(s_cidx + it, far);
        cidx[it] = far;
      }
      const float4 c = s_pts[far];
      far = vpt::fps_step<ONE_WARP, false>(p, c.x, c.y, c.z, it, warp, lane, nw1, s_key);
    }
  }

  // ---- the kNN of the centers (K2's selection), as they appear
  const int mask = (1 << idx_bits) - 1;
  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(&s_next, 1);
    c = __shfl_sync(vpt::FULL_MASK, c, 0);
    if (c >= g) break;
    int ci;
    while ((ci = published(s_cidx + c)) < 0) __nanosleep(64);
    __syncwarp();
    vpt::knn_query<KPL, M>(s_pts, n, s_pts[ci], k, mask, bufs + warp * vpt::KNN_BUF,
                           nidx_out + ((size_t)b * g + c) * k, overflow);
  }
}

template <bool ONE_WARP, int KPL, int M>
int launch(const float* xyz, const int* start, int* cidx, int* nidx, int b, int n, int g, int k,
           int* overflow, cudaStream_t stream) {
  auto kernel = fps_knn_kernel<ONE_WARP, KPL, M>;
  const int warps = vpt::fps_warps(n) + KNN_WARPS;
  const size_t smem = smem_bytes(vpt::knn_rows(n, KPL), g, warps, M);
  // the cap for the instance's largest cloud, raised once a device
  static std::atomic<unsigned> capped{0};
  const cudaError_t attr = vpt::raise_smem_cap_once(
      kernel, smem_bytes(vpt::knn_rows(32 * KPL, KPL), 32 * KPL, max_warps(KPL), M), capped);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<b, 32 * warps, smem, stream>>>(xyz, start, cidx, nidx, n, g, k, vpt::knn_idx_bits(n),
                                          overflow);
  return (int)cudaGetLastError();
}

template <bool ONE_WARP, int KPL>
int launch_kept(const float* xyz, const int* start, int* cidx, int* nidx, int b, int n, int g,
                int k, int* overflow, cudaStream_t stream) {
  switch (vpt::knn_kept(k)) {
    case 1: return launch<ONE_WARP, KPL, 1>(xyz, start, cidx, nidx, b, n, g, k, overflow, stream);
    case 4: return launch<ONE_WARP, KPL, 4>(xyz, start, cidx, nidx, b, n, g, k, overflow, stream);
    default: return launch<ONE_WARP, KPL, 0>(xyz, start, cidx, nidx, b, n, g, k, overflow, stream);
  }
}

}  // namespace

// xyz f32 [B, N, 3] contiguous, start int32 [B] -> centers_idx int32
// [B, G], neighbor_idx int32 [B, G, K] (nearest first); overflow as K2's
// (knn.cu). Needs 1 <= K <= N <= 4096 and 1 <= G <= N.
extern "C" int fps_knn_f32(const void* xyz, const void* start, void* cidx, void* nidx, int b,
                           int n, int g, int k, void* overflow, void* stream) {
  if (b < 1 || g < 1 || g > n || k < 1 || k > n) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)xyz;
  const int* s = (const int*)start;
  int* c = (int*)cidx;
  int* o = (int*)nidx;
  int* ov = (int*)overflow;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 256) return launch_kept<true, 8>(p, s, c, o, b, n, g, k, ov, st);
  if (n <= 1024) return launch_kept<false, 32>(p, s, c, o, b, n, g, k, ov, st);
  if (n <= 2048) return launch_kept<false, 64>(p, s, c, o, b, n, g, k, ov, st);
  if (n <= MAX_POINTS) return launch_kept<false, 128>(p, s, c, o, b, n, g, k, ov, st);
  return (int)cudaErrorInvalidValue;
}
