// Shared helpers for the hand-written Hopper kernels of vipformer_tpu_torch.
//
// Every entry point has a plain C interface (raw device pointers, sizes,
// the launch stream) so the library loads with ctypes without PyTorch's
// headers, and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vpt {

// Load one element of the storage type as f32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Store an f32 value in the storage type (round to nearest even).
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to the compute dtype T and back: the "emit in the
// compute dtype" step of every f32-accumulated product (nn.layers.Dense).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Squared distance (x-cx)^2 + (y-cy)^2 + (z-cz)^2, summed left to right
// with explicitly rounded operations: nvcc would otherwise contract the
// products and sums into FMAs, which moves the last bit and can flip an
// FPS argmax or a kNN selection relative to the plain PyTorch twin.
__device__ __forceinline__ float sq_dist3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

}  // namespace vpt
