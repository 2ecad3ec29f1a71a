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
// Design: one block of 1024 threads per row (decode_ops.cuh tail_row); the
// weights of the row live in dynamic shared memory (Vp x 4 bytes, 70 KB at
// the main path) between the argmax passes, so only the three (value, index)
// pairs leave the block.
#include "decode_ops.cuh"

using namespace mg;

namespace {

__global__ void __launch_bounds__(TAIL_NT) sample_tail_kernel(
    const float* logits, int Vp, int V, const float* gram, const int* hist,
    const int64_t* bucket, int dyn_start, int length_start, float* vals, int64_t* idx) {
  extern __shared__ float w[];
  __shared__ float red_v[TAIL_NW];
  __shared__ int red_i[TAIL_NW];
  const int r = blockIdx.x;
  tail_row(logits + (size_t)r * Vp, Vp, V, gram + (size_t)bucket[r] * Vp, hist + (size_t)r * V,
           dyn_start, length_start, vals + r * 3, idx + r * 3, w, red_v, red_i);
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
  sample_tail_kernel<<<R, TAIL_NT, smem, (cudaStream_t)stream>>>(logits, Vp, V, gram, hist, bucket,
                                                                 dyn_start, length_start, vals, idx);
  return (int)cudaGetLastError();
}
