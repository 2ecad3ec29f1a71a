// Kernel H: the sLSTM recurrence of the prefill, over the whole sequence.
//
// Replaces musicgen_tpu/ops/pallas_slstm.py `_slstm_kernel` (via
// `slstm_pallas`). Per step t, for each (batch row b, head h):
//
//   pre[g, e] = wx[b, t, g, h, e] + sum_d h_{t-1}[d] R[g, h, d, e] + bias[g, h, e]
//   m_t = max(f + m, i);  i' = exp(i - m_t);  f' = exp(f + m - m_t)
//   c_t = f' c + i' tanh(z);  n_t = f' n + i';  h_t = sigmoid(o) c_t / n_t
//
// in f32 throughout, R in f32 as in the TPU kernel. The state starts at
// h = c = n = 0 and m = -inf, as ops/slstm.slstm_init_state; at the first
// step f' is set to 0 directly, so -inf - (-inf) never reaches an exp.
//
// What bounds it on an H100: the T steps are strictly sequential, and each
// (b, h) step reads its head's R_h, 4 x DH x DH f32 (1 MB at DH = 256), for
// DH x 4 DH FMAs: latency and L2 bandwidth, not HBM (the four heads' R, 4 MB,
// stay in the 50 MB L2). Because R is block-diagonal, (b, h) pairs are
// independent: one block per pair needs no grid-wide barrier. The block has
// one thread per gate column (g, e), 4 DH threads; h_{t-1} sits in shared
// memory, the four gates are exchanged through shared memory, DH threads
// update the cell (c, n, m in registers for the whole sequence), and two
// __syncthreads separate the steps. R_h does not fit an SM's 227 KB, so it
// streams from L2 every step; splitting it over a thread-block cluster's
// shared memory is later work. The TPU kernel's T chunks, padding and pad
// masking were artefacts of its grid: this loops over the real T.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxDh = 256;

__global__ void __launch_bounds__(4 * kMaxDh) slstm_scan_kernel(
    const float* __restrict__ wx,  // (B, T, 4, H, DH)
    const float* __restrict__ r,   // (4, H, DH, DH)
    const float* __restrict__ bias,  // (4, H, DH)
    float* __restrict__ h_out,     // (B, T, H, DH)
    float* __restrict__ state,     // (4, B, H, DH): final h, c, n, m
    int B, int T, int H, int DH) {
  __shared__ float hs[kMaxDh];
  __shared__ float pre[4 * kMaxDh];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int j = threadIdx.x, g = j / DH, e = j % DH;
  const int G = 4 * DH;
  const bool col = j < G;
  const float* rcol = r + ((size_t)(g * H + h) * DH) * DH + e;  // R[g, h, :, e], stride DH
  const float bj = col ? __ldg(bias + (size_t)(g * H + h) * DH + e) : 0.f;
  float c = 0.f, n = 0.f, m = -INFINITY;
  if (j < DH) hs[j] = 0.f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    if (col) {
      float acc = __ldg(wx + (((size_t)b * T + t) * 4 + g) * H * DH + (size_t)h * DH + e);
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int d = 0;
      for (; d + 8 <= DH; d += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) part[u] = fmaf(hs[d + u], __ldg(rcol + (size_t)(d + u) * DH), part[u]);
      }
      for (; d < DH; ++d) part[0] = fmaf(hs[d], __ldg(rcol + (size_t)d * DH), part[0]);
      const float rec = ((part[0] + part[1]) + (part[2] + part[3])) + ((part[4] + part[5]) + (part[6] + part[7]));
      pre[j] = (acc + rec) + bj;
    }
    __syncthreads();
    if (j < DH) {
      const float ip = pre[j], fp = pre[DH + j], zp = pre[2 * DH + j], op = pre[3 * DH + j];
      const float m_new = fmaxf(fp + m, ip);
      const float i_act = expf(ip - m_new);
      const float f_act = m == -INFINITY ? 0.f : expf(fp + m - m_new);
      c = f_act * c + i_act * tanhf(zp);
      n = f_act * n + i_act;
      m = m_new;
      const float hv = sigmoidf_(op) * c / n;
      hs[j] = hv;
      h_out[(((size_t)b * T + t) * H + h) * DH + j] = hv;
    }
    __syncthreads();
  }
  if (j < DH) {
    const size_t o = ((size_t)b * H + h) * DH + j, plane = (size_t)B * H * DH;
    state[o] = hs[j];
    state[plane + o] = c;
    state[2 * plane + o] = n;
    state[3 * plane + o] = m;
  }
}

}  // namespace

// h_out (B, T, H, DH) and the final (h, c, n, m) as state (4, B, H, DH), from
// the zero state. DH <= 256 and 4 DH a multiple of 32.
MG_EXPORT int mg_slstm_scan(const float* wx, const float* r, const float* bias, float* h_out, float* state,
                            int B, int T, int H, int DH, void* stream) {
  if (B < 1 || T < 1 || H < 1 || DH < 1 || DH > kMaxDh || (4 * DH) % 32 != 0) return (int)cudaErrorInvalidValue;
  slstm_scan_kernel<<<B * H, 4 * DH, 0, (cudaStream_t)stream>>>(wx, r, bias, h_out, state, B, T, H, DH);
  return (int)cudaGetLastError();
}
