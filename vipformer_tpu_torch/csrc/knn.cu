// K2: exact k nearest neighbours with packed (distance | index) keys.
//
// Replaces vipformer_tpu/ops/pallas/knn.py:knn_pallas.
//
// Bound on the H100: issue rate of the selection loop. Per query, N
// distances (3 subtract-multiply-adds each) and then k rounds of a
// threshold min over N keys: about k x N integer compares, 32 x 1024 per
// query at the flagship shapes; memory traffic is the 12 KB cloud per
// block and 128 B of output per query.
//
// Design: a block of QPB warps serves QPB queries of one cloud; the cloud
// is staged in shared memory once per block. One warp owns one query:
// lane l holds the keys of points l, l+32, ... in registers (KPL per lane,
// 32 at N=1024). Keys are (bits(d) & ~mask) | index with
// idx_bits = bit_length(N-1), d the f32 difference of squares summed over
// c = 0, 1, 2 without FMA contraction (vpt::sq_dist3, knn.py:43-46); every
// key is unique, so round r takes min(key > last) with a warp-min and
// needs no tie handling. Output is nearest first, like the Pallas kernel.
#include "common.cuh"

namespace {

constexpr int QPB = 8;  // queries (warps) per block

template <int KPL>
__global__ void knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
                           int* __restrict__ out, int n, int s, int k, int idx_bits) {
  extern __shared__ float sp[];  // [N, 3]
  const int b = blockIdx.y;
  const float* cloud = points + (size_t)b * n * 3;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) sp[i] = cloud[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * QPB + (threadIdx.x >> 5);
  if (q >= s) return;
  const float* qp = queries + ((size_t)b * s + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const int mask = (1 << idx_bits) - 1;

  int keys[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int i = lane + 32 * j;
    if (i < n) {
      const float d = vpt::sq_dist3(qx - sp[3 * i], qy - sp[3 * i + 1], qz - sp[3 * i + 2]);
      keys[j] = (__float_as_int(d) & ~mask) | i;
    } else {
      keys[j] = 0x7fffffff;
    }
  }

  int* o = out + ((size_t)b * s + q) * k;
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
    if (lane == 0) o[r] = m & mask;
  }
}

template <int KPL>
int launch(const float* p, const float* q, int* out, int b, int n, int s, int k, int idx_bits,
           cudaStream_t stream) {
  const size_t smem = (size_t)n * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(knn_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((s + QPB - 1) / QPB, b);
  knn_kernel<KPL><<<grid, QPB * 32, smem, stream>>>(p, q, out, n, s, k, idx_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// points f32 [B, N, 3], queries f32 [B, S, 3] -> out int32 [B, S, k].
// Needs k <= N <= 4096 (keys per lane held in registers: 128 at N = 4096).
extern "C" int knn_f32(const void* points, const void* queries, void* out, int b, int n, int s,
                       int k, void* stream) {
  int idx_bits = 1;
  while ((1 << idx_bits) < n) ++idx_bits;  // bit_length(n - 1), at least 1
  const float* p = (const float*)points;
  const float* q = (const float*)queries;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 256) return launch<8>(p, q, o, b, n, s, k, idx_bits, st);
  if (n <= 512) return launch<16>(p, q, o, b, n, s, k, idx_bits, st);
  if (n <= 1024) return launch<32>(p, q, o, b, n, s, k, idx_bits, st);
  if (n <= 2048) return launch<64>(p, q, o, b, n, s, k, idx_bits, st);
  if (n <= 4096) return launch<128>(p, q, o, b, n, s, k, idx_bits, st);  // semseg's blocks
  return (int)cudaErrorInvalidValue;
}
