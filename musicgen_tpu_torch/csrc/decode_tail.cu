// Kernel B, sampler tail: grammar filter, repetition penalty and exact top-3
// over one row of logits per batch element.
//
// Replaces `_tail_math` inside musicgen_tpu/ops/pallas_decode.py
// `_decode_kernel` (the `tail_inputs` variant reached from
// `fused_sample_step`). Per row, over the real vocabulary ids < V:
//   lse  = logsumexp(logits)
//   w    = (lse - logits) * grammar[bucket]      (0 where the grammar is 0)
//   w   /= min(exp(hist * ln base), 1.2)         (base 1.01 pitch, 1.02 dyn)
//   top-3 of w by three argmax passes, ties to the lowest index
// Pad ids in [V, Vp) get weight 0.
//
// What bounds it on an H100: latency, not bytes. A row is 17,920 floats of
// logits plus 17,914 ints of counts (~143 KB per row); the work is five
// block-wide reductions in sequence.
//
// Design: one block of 1024 threads per row; the weights of the row live in
// dynamic shared memory (Vp x 4 bytes, 70 KB at the main path) between the
// argmax passes, so only the three (value, index) pairs leave the block.
// CUDA C++ rather than Triton keeps the whole decode step on one build route.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr float kLn101 = 0.00995033085316808f;   // ln 1.01
constexpr float kLn102 = 0.019802627296179712f;  // ln 1.02

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < NW ? red[threadIdx.x] : -INFINITY;
  if (threadIdx.x < 32) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < NW ? red[threadIdx.x] : 0.f;
  if (threadIdx.x < 32) v = warp_sum(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// (v, i) beats (bv, bi) when larger, or equal with a lower index.
__device__ __forceinline__ void arg_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ void block_argmax(const float* w, int n, float* red_v, int* red_i, float& out_v,
                             int& out_i) {
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += NT) arg_better(bv, bi, w[i], i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    arg_better(bv, bi, ov, oi);
  }
  if (threadIdx.x % 32 == 0) {
    red_v[threadIdx.x / 32] = bv;
    red_i[threadIdx.x / 32] = bi;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    bv = threadIdx.x < NW ? red_v[threadIdx.x] : -INFINITY;
    bi = threadIdx.x < NW ? red_i[threadIdx.x] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      arg_better(bv, bi, ov, oi);
    }
    if (threadIdx.x == 0) {
      red_v[0] = bv;
      red_i[0] = bi;
    }
  }
  __syncthreads();
  out_v = red_v[0];
  out_i = red_i[0];
  __syncthreads();
}

__global__ void __launch_bounds__(NT) sample_tail_kernel(
    const float* __restrict__ logits, int Vp, int V, const float* __restrict__ gram,
    const int* __restrict__ hist, const int64_t* __restrict__ bucket, int dyn_start,
    int length_start, float* __restrict__ vals, int64_t* __restrict__ idx) {
  extern __shared__ float w[];
  __shared__ float red_v[NW];
  __shared__ int red_i[NW];
  const int r = blockIdx.x;
  const float* x = logits + (size_t)r * Vp;

  float m = -INFINITY;
  for (int i = threadIdx.x; i < V; i += NT) m = fmaxf(m, x[i]);
  m = block_max(m, red_v);
  float s = 0.f;
  for (int i = threadIdx.x; i < V; i += NT) s += expf(x[i] - m);
  const float lse = logf(block_sum(s, red_v)) + m;

  const float* grow = gram + (size_t)bucket[r] * Vp;
  const int* hrow = hist + (size_t)r * V;
  for (int i = threadIdx.x; i < Vp; i += NT) {
    float wv = 0.f;
    if (i < V) {
      const float mk = grow[i];
      if (mk > 0.f) {
        const float lb = i < dyn_start ? kLn101 : (i < length_start ? kLn102 : 0.f);
        const float pen = fminf(expf((float)hrow[i] * lb), 1.2f);
        wv = (lse - x[i]) * mk / pen;
      }
    }
    w[i] = wv;
  }
  __syncthreads();

  for (int k = 0; k < 3; ++k) {
    float bv;
    int bi;
    block_argmax(w, Vp, red_v, red_i, bv, bi);
    if (threadIdx.x == 0) {
      vals[r * 3 + k] = bv;
      idx[r * 3 + k] = bi;
      w[bi] = -1e30f;
    }
    __syncthreads();
  }
}

}  // namespace

MG_EXPORT int mg_sample_tail(const float* logits, int R, int Vp, int V, const float* gram,
                             const int* hist, const int64_t* bucket, int dyn_start,
                             int length_start, float* vals, int64_t* idx, void* stream) {
  if (R < 1 || V < 3 || V > Vp) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Vp * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sample_tail_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sample_tail_kernel<<<R, NT, smem, (cudaStream_t)stream>>>(logits, Vp, V, gram, hist, bucket,
                                                            dyn_start, length_start, vals, idx);
  return (int)cudaGetLastError();
}
