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
// token: d_inner x B x N x 4 bytes = 1 MB per layer at batch 2. A launch
// moves 2 MB in 0.6 us at 3.35 TB/s, so what costs is latency: the launch,
// the wait for in_proj's zx, a state row's load.
//
// Design: the TPU kernel kept the state as S[h*P+p, b*N+n] and expanded
// heads and batches with one-hot matmuls, because Mosaic cannot reshape
// lanes into sublanes. Here the same layout is kept (so the packs and
// states are interchangeable with the plain version) but read directly. A
// block is one item (decode_ops.cuh mixer_load and mixer_step): a batch
// row, a head and a quarter of its 64 state rows, each warp 2 rows, each
// lane the state columns n and n + 32, so every row is one coalesced
// 256-byte read and write. R x nheads x 4 blocks (256 at batch 2, so every SM pulls state);
// one block a (row, head) filled 64 of the 132 SMs. The state is updated IN
// PLACE; no two blocks touch the same entries, and nothing is added by an
// atomic. y = h C is a warp reduction per row, as before the split, so the
// bits are those of the whole-head item.
//
// Kernel B's chain launches this kernel as a programmatic dependent of
// in_proj (`dependent`): a block loads its state rows and its head's A and D,
// which in_proj does not write, then waits for in_proj (grid_dep_wait) and
// reads zx. It triggers out_proj's launch at once, which fetches its first
// weights and waits for this one in turn. Two mixers launched back to back
// with the attribute would race on the state, so every other caller
// launches it plainly, where the wait returns at once.
#include "decode_ops.cuh"

using namespace mg;

namespace {

__global__ void __launch_bounds__(TEAM) mixer_state_kernel(const float* zx, int nz, int di, int nh,
                                                           const float* a_h, const float* d_h,
                                                           float* ssm, float* g, int R) {
  MixerLoad m;
  mixer_load(m, a_h, d_h, ssm, R, nh, blockIdx.x, threadIdx.x);
  grid_dep_wait();
  grid_dep_trigger();
  mixer_step(m, zx, nz, di, nh, ssm, g, R, blockIdx.x, threadIdx.x);
}

}  // namespace

// g = the mixer of zx (R rows); ssm advances in place. dependent != 0
// launches it as a programmatic dependent of the launch ahead on the stream,
// which must be the in_proj that writes zx.
MG_EXPORT int mg_mixer_state(const float* zx, int nz, int di, int nh, int headdim, int d_state,
                             const float* a_h, const float* d_h, float* ssm, float* g, int R,
                             int dependent, void* stream) {
  if (headdim != MIX_P || d_state != MIX_N || nh * MIX_P != di || nz < 2 * di + 2 * MIX_N + nh ||
      R < 1)
    return (int)cudaErrorInvalidValue;
  return (int)mg_launch(mixer_state_kernel, dim3(R * nh * MIX_Q), dim3(TEAM), 0, stream, dependent != 0, zx, nz, di,
                        nh, a_h, d_h, ssm, g, R);
}
