// Kernels B and B', products: the weight-streaming GEMVs of the one-token
// decode step, with the normalisations and the conv step fused around them.
//
// Replaces the three matrix products inside musicgen_tpu/ops/pallas_decode.py
// `_decode_kernel` (reached through `fused_decode_step`): the in_proj and
// out_proj of `_mixer_math` and the lm_head of `_head_math`, in the three
// weight formats of that kernel: bf16 (`_dot`), W8A16 (`_w8dot` :163) and
// W8A8 (`_qdot` :138).
//
//   out[r, n] = sum_k pro(x)[r, k] * W[n, k]    (f32 accumulation)
//
// What bounds it on an H100: the weight bytes. At batch 2 a token streams
// 10 x (4256 x 1024 + 1024 x 2048) + 17920 x 1024 weights: about 166 MB in
// bf16; in int8 about 65 MB of mixer weights, 18 MB of lm_head and 1.3 MB of
// group scales. Two FMAs per weight is far below the card's 295 operations
// per byte, so the products are a read of the weights at HBM bandwidth
// (3.35 TB/s); int8 halves the bytes.
//
// Design: weights are packed K-contiguous, W[n, k] (torch's Linear layout),
// and all rows r < R <= 8 ride the same weight read. A block is one
// 256-thread team (decode_ops.cuh gemv_team), the same in every format: it
// takes its prologue statistics exactly, stages pro(x) once in dynamic
// shared memory, rounded to bf16 (bf16, W8A16) or quantised to int8 (W8A8),
// then walks tiles of 16 columns on the tensor cores (mma.sync m16n8k16
// bf16, the bf16 weights fed to it as loaded and int8 ones converted in
// registers; m16n8k32 s8 in W8A8). Its 8 warps split K, and their sums meet
// in shared memory in warp order; in int8 each group's sum is scaled whole
// and the groups are added in order (`_w8dot`, `_qdot`). A block per tile,
// at most 4 an SM; a bf16 N or K that is not in whole tiles or steps reads
// zeros past its end.
// Three variants share the body:
//   * in_proj:  plain prologue; epilogue = the 4-tap causal conv step + silu
//               on the conv channels (conv state shifted IN PLACE), softplus(dt
//               + dt_bias) on the dt columns, z stored raw.
//   * out_proj: gated-RMSNorm prologue, x * rsqrt(mean(x^2) + 1e-5) * w.
//   * lm_head:  LayerNorm prologue (var = E[x^2] - mean^2, eps 1e-6) and the
//               bias in the epilogue.
// Each block recomputes the per-row statistics of its prologue (and, in
// W8A8, the per-(row, group) activation scales) instead of a separate launch.
//
// Programmatic dependent launch (common.cuh): every block of these kernels
// lets the next launch start at once (grid_dep_trigger), and waits before
// its prologue reads x (grid_dep_wait, after its first weights are in
// flight). Kernel B's chain launches out_proj as a dependent of the mixer,
// and the mixer as a dependent of in_proj; every other launch is plain, and
// its wait returns at once. The arithmetic and its bits are the same either
// way.
#include "decode_ops.cuh"

using namespace mg;

namespace {

template <int PRO, int EPI, int FMT>
__global__ void __launch_bounds__(TEAM, 4) gemv_kernel(GemvArgs a) {
  extern __shared__ uint4 gemv_dyn[];
  __shared__ GemvSmem sm;
  grid_dep_trigger();
  gemv_team<PRO, EPI, FMT, true>(a, sm, blockIdx.x, gridDim.x, threadIdx.x, 1, reinterpret_cast<char*>(gemv_dyn));
}

template <int PRO, int EPI>
int launch(const GemvArgs& a, int fmt, void* stream, bool dependent = false) {
  if (!gemv_shape_ok(a.R, a.K, a.N, fmt)) return (int)cudaErrorInvalidValue;
  if (fmt != kBf16 && a.w_s == nullptr) return (int)cudaErrorInvalidValue;
  switch (fmt) {
    case kBf16: return gemv_launch(gemv_kernel<PRO, EPI, kBf16>, a, fmt, stream, dependent);
    case kW8A16: return gemv_launch(gemv_kernel<PRO, EPI, kW8A16>, a, fmt, stream, dependent);
    case kW8A8: return gemv_launch(gemv_kernel<PRO, EPI, kW8A8>, a, fmt, stream, dependent);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// zx = in_proj(x) with the conv step, silu and softplus applied in place of
// the raw conv / dt columns; conv_state (R, 3, dc) advances in place.
// fmt: 0 bf16, 1 W8A16, 2 W8A8 (w_s: (K / 256, N) group scales, else null).
MG_EXPORT int mg_in_proj_conv(const float* x, const void* w, const float* w_s, float* zx, int R,
                              int K, int N, int di, int dc, int nh, const float* conv_w,
                              const float* conv_b, const float* dt_bias, float* conv_state,
                              int fmt, void* stream) {
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = zx;
  a.R = R; a.K = K; a.N = N;
  a.di = di; a.dc = dc; a.nh = nh;
  a.conv_w = conv_w; a.conv_b = conv_b; a.dt_bias = dt_bias; a.conv_state = conv_state;
  if (di + dc + nh > N) return (int)cudaErrorInvalidValue;
  return launch<kPlain, kInProj>(a, fmt, stream);
}

// out = out_proj(RMSNorm(g) * norm_w), g = y * silu(z) from the mixer kernel;
// dependent != 0 launches it as a programmatic dependent of the launch ahead
// on the stream, which must be the mixer that writes g.
MG_EXPORT int mg_out_proj_rms(const float* g, const float* norm_w, const void* w, const float* w_s,
                              float* out, int R, int K, int N, float eps, int fmt, int dependent, void* stream) {
  GemvArgs a = {};
  a.x = g; a.w = w; a.w_s = w_s; a.out = out;
  a.R = R; a.K = K; a.N = N; a.pw = norm_w; a.eps = eps;
  return launch<kRms, kStore>(a, fmt, stream, dependent != 0);
}

// logits = lm_head(LayerNorm(x)) + bias.
MG_EXPORT int mg_lm_head_ln(const float* x, const float* ln_w, const float* ln_b, const void* w,
                            const float* w_s, const float* bias, float* logits, int R, int K,
                            int N, float eps, int fmt, void* stream) {
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = logits;
  a.R = R; a.K = K; a.N = N; a.pw = ln_w; a.pb = ln_b; a.eps = eps; a.bias = bias;
  return launch<kLayerNorm, kBias>(a, fmt, stream);
}

// ---------------------------------------------------------------------------
// Kernel F's products (the Transformer decode step; ops/tdecode_kernel.py),
// replacing the matrix products of `_attn_math` and `_ffn_math` in
// musicgen_tpu/ops/pallas_transformer_decode.py `_tdecode_kernel`, in bf16
// and W8A16 (fmt 0 or 1). The lm_head and the tail reuse mg_lm_head_ln and
// mg_sample_tail.
// ---------------------------------------------------------------------------

// zx = LN1(x) . W_qkv^T (N = 3 K); the K and V columns are also written as
// bf16 into slot c of this layer's (R, S, K) rings.
MG_EXPORT int mg_t_qkv_ln(const float* x, const float* ln_w, const float* ln_b, const void* w,
                          const float* w_s, float* zx, int R, int K, int N, float eps, void* k_ring,
                          void* v_ring, int S, int c, int fmt, void* stream) {
  if (N != 3 * K || c < 0 || c >= S || fmt == kW8A8) return (int)cudaErrorInvalidValue;
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = zx;
  a.R = R; a.K = K; a.N = N; a.pw = ln_w; a.pb = ln_b; a.eps = eps;
  a.k_ring = static_cast<__nv_bfloat16*>(k_ring); a.v_ring = static_cast<__nv_bfloat16*>(v_ring);
  a.ring_S = S; a.ring_c = c;
  return launch<kLayerNorm, kKvRing>(a, fmt, stream);
}

// h = relu(LN2(x) . W_fc^T + b_fc).
MG_EXPORT int mg_t_fc_relu(const float* x, const float* ln_w, const float* ln_b, const void* w,
                           const float* w_s, const float* bias, float* h, int R, int K, int N, float eps,
                           int fmt, void* stream) {
  if (fmt == kW8A8) return (int)cudaErrorInvalidValue;
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = h;
  a.R = R; a.K = K; a.N = N; a.pw = ln_w; a.pb = ln_b; a.eps = eps; a.bias = bias;
  return launch<kLayerNorm, kBiasRelu>(a, fmt, stream);
}

// resid += x . W^T + b (the out-projection of the attention and of the FFN).
MG_EXPORT int mg_t_res(const float* x, const void* w, const float* w_s, const float* bias, float* resid,
                       int R, int K, int N, int fmt, void* stream) {
  if (fmt == kW8A8) return (int)cudaErrorInvalidValue;
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = resid;
  a.R = R; a.K = K; a.N = N; a.bias = bias;
  return launch<kPlain, kBiasResidual>(a, fmt, stream);
}
