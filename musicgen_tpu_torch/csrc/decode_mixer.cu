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
// block owns one (batch, head) pair, each warp 8 rows p of the head, each
// lane the state columns n and n + 32, so every row is one coalesced 256-byte
// read and write. The state is updated IN PLACE; no two blocks touch the same
// entries. y = h C is a warp reduction per row.
#include "common.cuh"

namespace {

constexpr int P = 64;   // headdim
constexpr int N = 64;   // d_state
constexpr int NT = 256;
constexpr int ROWS_PER_WARP = P / (NT / 32);

__global__ void __launch_bounds__(NT) mixer_state_kernel(
    const float* __restrict__ zx, int nz, int di, int nh, const float* __restrict__ a_h,
    const float* __restrict__ d_h, float* __restrict__ ssm, float* __restrict__ g, int R) {
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* row = zx + (size_t)b * nz;
  const int dc = di + 2 * N;
  const float dtv = row[di + dc + h];
  const float decay = expf(dtv * a_h[h]);
  const float dd = d_h[h];
  const float b0 = row[2 * di + lane], b1 = row[2 * di + lane + 32];
  const float c0 = row[2 * di + N + lane], c1 = row[2 * di + N + lane + 32];

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int ch = h * P + warp * ROWS_PER_WARP + i;
    const float xv = row[di + ch];
    const float dtx = xv * dtv;
    float* srow = ssm + (size_t)ch * R * N + (size_t)b * N;
    const float s0 = srow[lane] * decay + dtx * b0;
    const float s1 = srow[lane + 32] * decay + dtx * b1;
    srow[lane] = s0;
    srow[lane + 32] = s1;
    const float yv = warp_sum(s0 * c0 + s1 * c1);
    if (lane == 0) {
      const float z = row[ch];
      g[(size_t)b * di + ch] = (yv + xv * dd) * (z * sigmoidf_(z));
    }
  }
}

}  // namespace

MG_EXPORT int mg_mixer_state(const float* zx, int nz, int di, int nh, int headdim, int d_state,
                             const float* a_h, const float* d_h, float* ssm, float* g, int R,
                             void* stream) {
  if (headdim != P || d_state != N || nh * P != di || nz < 2 * di + 2 * N + nh || R < 1)
    return (int)cudaErrorInvalidValue;
  mixer_state_kernel<<<R * nh, NT, 0, (cudaStream_t)stream>>>(zx, nz, di, nh, a_h, d_h, ssm, g, R);
  return (int)cudaGetLastError();
}
