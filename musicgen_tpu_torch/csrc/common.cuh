// Shared helpers for the port's hand-written Hopper kernels.
//
// Every exported entry point has a plain C signature (raw device pointers,
// ints, the CUDA stream as void*) so that Python binds it with ctypes, and
// returns the cudaError_t of the launch (cudaGetLastError right after it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MG_EXPORT extern "C" __attribute__((visibility("default")))

// Round an f32 activation to bf16 (round-to-nearest-even, as jnp.astype)
// and back: the decode products take bf16 operands with f32 accumulation.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two bf16 values packed in one 32-bit word (little-endian: low half first).
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// jax.nn.gelu(v, approximate=True), torch's gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanhf_(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
}

// jax.nn.softplus(v) == logaddexp(v, 0), in its overflow-safe form.
__device__ __forceinline__ float softplusf_(float v) { return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); }

// Streaming multiprocessors of the current device, read once per process.
inline int mg_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}
