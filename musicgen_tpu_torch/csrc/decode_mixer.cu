// Kernel B, state update: the per-token Mamba-2 selective-state step.
//
// Replaces the elementwise middle of `_mixer_math` inside
// musicgen_tpu/ops/pallas_decode.py `_decode_kernel`: with zx from the
// in_proj kernel (conv + silu + softplus already applied),
//   h     = exp(dt * A) * h + (dt * x) B^T        (per head, (P, N))
//   y     = h C + D * x
//   g     = y * silu(z)                           (the RMSNorm runs in out_proj)
//
// What bounds it on an H100: the f32 SSM state, read and written once per
// token: d_inner x B x N x 4 bytes = 1 MB per layer at batch 2.
//
// Design: the TPU kernel kept the state as S[h*P+p, b*N+n] and expanded
// heads and batches with one-hot matmuls, because Mosaic cannot reshape
// lanes into sublanes. Here the same layout is kept (so the packs and
// states are interchangeable with the plain version) but read directly: one
// block owns one (batch, head) pair (decode_ops.cuh mixer_item), each warp 8
// rows p of the head, each lane the state columns n and n + 32, so every row
// is one coalesced 256-byte read and write. The state is updated IN PLACE;
// no two blocks touch the same entries. y = h C is a warp reduction per row.
#include "decode_ops.cuh"

using namespace mg;

namespace {

__global__ void __launch_bounds__(TEAM) mixer_state_kernel(const float* zx, int nz, int di, int nh,
                                                           const float* a_h, const float* d_h,
                                                           float* ssm, float* g, int R) {
  mixer_item(zx, nz, di, a_h, d_h, ssm, g, R, blockIdx.x / nh, blockIdx.x % nh, threadIdx.x);
}

}  // namespace

MG_EXPORT int mg_mixer_state(const float* zx, int nz, int di, int nh, int headdim, int d_state,
                             const float* a_h, const float* d_h, float* ssm, float* g, int R,
                             void* stream) {
  if (headdim != MIX_P || d_state != MIX_N || nh * MIX_P != di || nz < 2 * di + 2 * MIX_N + nh ||
      R < 1)
    return (int)cudaErrorInvalidValue;
  mixer_state_kernel<<<R * nh, TEAM, 0, (cudaStream_t)stream>>>(zx, nz, di, nh, a_h, d_h, ssm, g, R);
  return (int)cudaGetLastError();
}
