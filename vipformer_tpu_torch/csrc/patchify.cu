// K16: farthest point sampling, then the kNN of the sampled centers, in one
// launch.
//
// Replaces vipformer_tpu/ops/pallas/patchify.py:fps_knn_pallas.
//
// Bound on the H100: latency and issue rate, not bytes or FLOPs. Phase 1
// is G dependent steps, each a pass over the cloud's running min-distance
// and a block-wide argmax with two barriers (K1's bound); phase 2 is G x K
// rounds of a threshold min over N keys (K2's: 32 x 1024 integer compares
// per center at the flagship shapes). The cloud moves once (12 KB at
// N = 1024); the outputs are G x (K + 1) indices.
//
// Design: one block per cloud, as the Pallas kernel takes a tile of clouds
// per grid step. The coordinate planes x[N], y[N], z[N] are loaded once
// into shared memory (48 KB at N = 4,096) and both phases read them there.
// Phase 1 is FPS exactly as K1 (fps.cu): each thread keeps the running
// min-distance of its points in registers, distances are vpt::sq_dist3
// (separately rounded, in the Pallas order) and the argmax takes the first
// index on ties (vpt::block_argmax_first). The center coordinates are
// banked in shared memory as phase 1 selects them, so no gather sits
// between the phases. Phase 2 gives each warp a center at a time: lane l
// builds the packed keys (bits(d) & ~mask) | i of points l, l+32, ... (up
// to 128 keys a lane at N = 4,096) as K2 (knn.cu) does, and K warp-min
// extractions emit the neighbours nearest first (vpt::knn_warp_select).
// The arithmetic is K1's and K2's through the shared geometry.cuh, so the
// indices equal K1 followed by K2 on K1's centers bit for bit.
//
// One block per cloud leaves most SMs idle at small B and puts only 8-16
// warps on the selection rounds of each cloud, where K2 spreads a cloud's
// centers over G / 8 blocks: the fusion saves a launch and the centers'
// round trip, not device time (PERF.md).
#include "geometry.cuh"

namespace {

template <int THREADS, int PPT, int KPL>
__global__ void __launch_bounds__(THREADS)
fps_knn_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ cidx_out, int* __restrict__ nidx_out, int n, int g, int k,
               int idx_bits) {
  extern __shared__ float smem[];
  float* sx = smem;  // the coordinate planes [N] each
  float* sy = sx + n;
  float* sz = sy + n;
  float* cx_s = sz + n;  // the centers' coordinates [G] each
  float* cy_s = cx_s + g;
  float* cz_s = cy_s + g;
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cloud = xyz + (size_t)b * n * 3;
  for (int i = tid; i < 3 * n; i += THREADS) {
    const int p = i / 3;
    smem[(i - 3 * p) * n + p] = cloud[i];
  }
  __syncthreads();

  // ---- phase 1: FPS (K1's arithmetic), banking the centers
  float dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) dist[j] = 1e10f;
  int* cidx = cidx_out + (size_t)b * g;
  int far = start[b];
  for (int it = 0; it < g; ++it) {
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    if (tid == 0) {
      cidx[it] = far;
      cx_s[it] = cx;
      cy_s[it] = cy;
      cz_s[it] = cz;
    }
    float best = -1.0f;  // every distance is >= 0
    int best_i = n;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * THREADS;
      if (i < n) {
        const float d = vpt::sq_dist3(sx[i] - cx, sy[i] - cy, sz[i] - cz);
        dist[j] = fminf(dist[j], d);
        if (dist[j] > best) {  // strict: the smaller index wins a tie
          best = dist[j];
          best_i = i;
        }
      }
    }
    // its barriers also publish tid 0's center writes to every warp
    far = vpt::block_argmax_first(best, best_i, n, s_val, s_idx, &s_far);
  }

  // ---- phase 2: packed-key kNN of each center (K2's arithmetic)
  const int lane = tid & 31;
  const int mask = (1 << idx_bits) - 1;
  for (int c = tid >> 5; c < g; c += THREADS / 32) {
    const float qx = cx_s[c], qy = cy_s[c], qz = cz_s[c];
    int keys[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int i = lane + 32 * j;
      if (i < n) {
        const float d = vpt::sq_dist3(qx - sx[i], qy - sy[i], qz - sz[i]);
        keys[j] = vpt::knn_key(d, i, mask);
      } else {
        keys[j] = 0x7fffffff;
      }
    }
    vpt::knn_warp_select<KPL>(keys, k, mask, nidx_out + ((size_t)b * g + c) * k);
  }
}

template <int THREADS, int KPL>
int launch(const float* xyz, const int* start, int* cidx, int* nidx, int b, int n, int g, int k,
           cudaStream_t stream) {
  constexpr int PPT = 32 * KPL / THREADS;  // FPS points a thread, N <= 32 * KPL
  auto kernel = fps_knn_kernel<THREADS, PPT, KPL>;
  const size_t smem = (size_t)3 * (n + g) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<b, THREADS, smem, stream>>>(xyz, start, cidx, nidx, n, g, k, vpt::knn_idx_bits(n));
  return (int)cudaGetLastError();
}

}  // namespace

// xyz f32 [B, N, 3] contiguous, start int32 [B] -> centers_idx int32
// [B, G], neighbor_idx int32 [B, G, K] (nearest first). Needs
// 1 <= K <= N <= 4096 and 1 <= G <= N (K2's limit on N).
extern "C" int fps_knn_f32(const void* xyz, const void* start, void* cidx, void* nidx, int b,
                           int n, int g, int k, void* stream) {
  if (g < 1 || g > n || k < 1 || k > n) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)xyz;
  const int* s = (const int*)start;
  int* c = (int*)cidx;
  int* o = (int*)nidx;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 256) return launch<256, 8>(p, s, c, o, b, n, g, k, st);
  if (n <= 512) return launch<512, 16>(p, s, c, o, b, n, g, k, st);
  if (n <= 1024) return launch<512, 32>(p, s, c, o, b, n, g, k, st);
  if (n <= 2048) return launch<256, 64>(p, s, c, o, b, n, g, k, st);
  if (n <= 4096) return launch<256, 128>(p, s, c, o, b, n, g, k, st);  // semseg's blocks
  return (int)cudaErrorInvalidValue;
}
