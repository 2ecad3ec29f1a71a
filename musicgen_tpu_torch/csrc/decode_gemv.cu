// Kernel B, products: bf16 weight-streaming GEMV for the one-token decode
// step, with the normalisations and the conv step fused around it.
//
// Replaces the three matrix products inside musicgen_tpu/ops/pallas_decode.py
// `_decode_kernel` (reached through `fused_decode_step`): the in_proj and
// out_proj of `_mixer_math` and the lm_head of `_head_math`.
//
//   out[r, n] = sum_k bf16(pro(x)[r, k]) * W[n, k]    (f32 accumulation)
//
// What bounds it on an H100: the weight bytes. At batch 2 a token streams
// 10 x (4256 x 1024 + 1024 x 2048) + 17920 x 1024 bf16 weights, about 166 MB,
// and does two FMAs per weight: far below the card's 295 operations per byte,
// so the products are a read of the weights at HBM bandwidth (3.35 TB/s).
//
// Design: weights are packed K-contiguous, W[n, k] (torch's Linear layout),
// so one warp streams one output column with 16-byte loads (8 bf16 a lane)
// and all rows r < R <= 8 ride the same weight read. Columns are spread over
// warps grid-stride. The activations (at most 8 x 2048 f32) are read from L1
// and rounded to bf16 in registers, where the TPU kernel rounded them before
// its MXU products. Three variants share the body:
//   * in_proj:  plain prologue; epilogue = the 4-tap causal conv step + silu
//               on the conv channels (conv state shifted IN PLACE; each
//               (row, channel) is owned by exactly one lane), softplus(dt +
//               dt_bias) on the dt columns, z stored raw.
//   * out_proj: gated-RMSNorm prologue, x * rsqrt(mean(x^2) + 1e-5) * w.
//   * lm_head:  LayerNorm prologue (var = E[x^2] - mean^2, eps 1e-6) and the
//               bias in the epilogue.
// Each block recomputes the per-row statistics of its prologue (R x K floats
// from L2) instead of a separate launch.
#include "common.cuh"

namespace {

constexpr int MAXR = 8;    // rows (batch) per launch
constexpr int WARPS = 8;   // warps per block
constexpr int NT = WARPS * 32;

enum { kPlain = 0, kRms = 1, kLayerNorm = 2 };
enum { kStore = 0, kInProj = 1, kBias = 2 };

struct GemvArgs {
  const float* x;                 // (R, K) f32 activations
  const __nv_bfloat16* w;         // (N, K) bf16, K-contiguous
  float* out;                     // (R, N) f32
  int R, K, N;
  const float* pw;                // prologue scale (K,)  [kRms, kLayerNorm]
  const float* pb;                // prologue shift (K,)  [kLayerNorm]
  float eps;
  const float* bias;              // (N,)                 [kBias]
  // kInProj epilogue: columns [0, di) z | [di, di+dc) conv | [di+dc, di+dc+nh) dt
  int di, dc, nh;
  const float* conv_w;            // (4, dc)
  const float* conv_b;            // (dc,)
  const float* dt_bias;           // (nh,)
  float* conv_state;              // (R, 3, dc), updated in place
};

template <int PRO>
__device__ void row_stats(const GemvArgs& a, float* s_mul, float* s_sub) {
  __shared__ float red[2][MAXR][WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = 0; r < a.R; ++r) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = threadIdx.x; k < a.K; k += NT) {
      const float v = a.x[(size_t)r * a.K + k];
      s1 += v;
      s2 += v * v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][r][warp] = s1;
      red[1][r][warp] = s2;
    }
  }
  __syncthreads();
  if (threadIdx.x < a.R) {
    const int r = threadIdx.x;
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      s1 += red[0][r][w];
      s2 += red[1][r][w];
    }
    const float mean = s1 / a.K, msq = s2 / a.K;
    if (PRO == kRms) {
      s_mul[r] = 1.f / sqrtf(msq + a.eps);
      s_sub[r] = 0.f;
    } else {
      s_mul[r] = 1.f / sqrtf(msq - mean * mean + a.eps);
      s_sub[r] = mean;
    }
  }
  __syncthreads();
}

template <int PRO, int EPI>
__global__ void __launch_bounds__(NT) gemv_kernel(GemvArgs a) {
  __shared__ float s_mul[MAXR], s_sub[MAXR];
  if (PRO != kPlain) row_stats<PRO>(a, s_mul, s_sub);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int n = blockIdx.x * WARPS + warp; n < a.N; n += gridDim.x * WARPS) {
    const __nv_bfloat16* wcol = a.w + (size_t)n * a.K;
    float acc[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

    for (int k0 = lane * 8; k0 < a.K; k0 += 32 * 8) {
      const uint4 wv = *reinterpret_cast<const uint4*>(wcol + k0);
      const float wf[8] = {bf16_lo(wv.x), bf16_hi(wv.x), bf16_lo(wv.y), bf16_hi(wv.y),
                           bf16_lo(wv.z), bf16_hi(wv.z), bf16_lo(wv.w), bf16_hi(wv.w)};
      float pw[8], pb[8];
      if (PRO != kPlain) {
        const float4 p0 = *reinterpret_cast<const float4*>(a.pw + k0);
        const float4 p1 = *reinterpret_cast<const float4*>(a.pw + k0 + 4);
        pw[0] = p0.x; pw[1] = p0.y; pw[2] = p0.z; pw[3] = p0.w;
        pw[4] = p1.x; pw[5] = p1.y; pw[6] = p1.z; pw[7] = p1.w;
      }
      if (PRO == kLayerNorm) {
        const float4 q0 = *reinterpret_cast<const float4*>(a.pb + k0);
        const float4 q1 = *reinterpret_cast<const float4*>(a.pb + k0 + 4);
        pb[0] = q0.x; pb[1] = q0.y; pb[2] = q0.z; pb[3] = q0.w;
        pb[4] = q1.x; pb[5] = q1.y; pb[6] = q1.z; pb[7] = q1.w;
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < a.R) {
          const float4 x0 = *reinterpret_cast<const float4*>(a.x + (size_t)r * a.K + k0);
          const float4 x1 = *reinterpret_cast<const float4*>(a.x + (size_t)r * a.K + k0 + 4);
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = xv[j];
            if (PRO == kRms) v = v * s_mul[r] * pw[j];
            if (PRO == kLayerNorm) v = (v - s_sub[r]) * s_mul[r] * pw[j] + pb[j];
            acc[r] = fmaf(bf16_round(v), wf[j], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = warp_sum(acc[r]);

    for (int r = 0; r < a.R && lane == 0; ++r) {
      float v = acc[r];
      if (EPI == kBias) v += a.bias[n];
      if (EPI == kInProj && n >= a.di && n < a.di + a.dc) {
        // Depthwise causal conv step (ops/ssm.causal_conv1d_step semantics:
        // state rows oldest -> newest, tap 3 multiplies the new input).
        const int c = n - a.di;
        float* cs = a.conv_state + (size_t)r * 3 * a.dc;
        const float s0 = cs[c], s1 = cs[a.dc + c], s2 = cs[2 * a.dc + c];
        const float yc = s0 * a.conv_w[c] + s1 * a.conv_w[a.dc + c] +
                         s2 * a.conv_w[2 * a.dc + c] + v * a.conv_w[3 * a.dc + c] + a.conv_b[c];
        cs[c] = s1;
        cs[a.dc + c] = s2;
        cs[2 * a.dc + c] = v;
        v = yc * sigmoidf_(yc);
      } else if (EPI == kInProj && n >= a.di + a.dc && n < a.di + a.dc + a.nh) {
        v = softplusf_(v + a.dt_bias[n - a.di - a.dc]);
      }
      a.out[(size_t)r * a.N + n] = v;
    }
  }
}

template <int PRO, int EPI>
int launch(const GemvArgs& a, void* stream) {
  if (a.R < 1 || a.R > MAXR || a.K <= 0 || a.K % 8 != 0 || a.N <= 0)
    return (int)cudaErrorInvalidValue;
  const int want = (a.N + WARPS - 1) / WARPS, cap = 4 * mg_sm_count();
  const int blocks = want < cap ? want : cap;
  gemv_kernel<PRO, EPI><<<blocks, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// zx = in_proj(x) with the conv step, silu and softplus applied in place of
// the raw conv / dt columns; conv_state (R, 3, dc) advances in place.
MG_EXPORT int mg_in_proj_conv(const float* x, const void* w, float* zx, int R, int K, int N,
                              int di, int dc, int nh, const float* conv_w, const float* conv_b,
                              const float* dt_bias, float* conv_state, void* stream) {
  GemvArgs a = {};
  a.x = x; a.w = static_cast<const __nv_bfloat16*>(w); a.out = zx;
  a.R = R; a.K = K; a.N = N;
  a.di = di; a.dc = dc; a.nh = nh;
  a.conv_w = conv_w; a.conv_b = conv_b; a.dt_bias = dt_bias; a.conv_state = conv_state;
  if (di + dc + nh > N) return (int)cudaErrorInvalidValue;
  return launch<kPlain, kInProj>(a, stream);
}

// out = out_proj(RMSNorm(g) * norm_w), g = y * silu(z) from the mixer kernel.
MG_EXPORT int mg_out_proj_rms(const float* g, const float* norm_w, const void* w, float* out,
                              int R, int K, int N, float eps, void* stream) {
  GemvArgs a = {};
  a.x = g; a.w = static_cast<const __nv_bfloat16*>(w); a.out = out;
  a.R = R; a.K = K; a.N = N; a.pw = norm_w; a.eps = eps;
  return launch<kRms, kStore>(a, stream);
}

// logits = lm_head(LayerNorm(x)) + bias.
MG_EXPORT int mg_lm_head_ln(const float* x, const float* ln_w, const float* ln_b, const void* w,
                            const float* bias, float* logits, int R, int K, int N, float eps,
                            void* stream) {
  GemvArgs a = {};
  a.x = x; a.w = static_cast<const __nv_bfloat16*>(w); a.out = logits;
  a.R = R; a.K = K; a.N = N; a.pw = ln_w; a.pb = ln_b; a.eps = eps; a.bias = bias;
  return launch<kLayerNorm, kBias>(a, stream);
}
