// Device code of the one-token decode math, shared by the per-token kernels
// (kernel B and its int8 variants B': decode_gemv.cu, decode_mixer.cu,
// decode_tail.cu) and the resident whole-generation kernel (C:
// generate_resident.cu).
//
// Each function handles one work item:
//   gemv_team    the output columns of one GEMV that a 256-thread team owns
//                (a warp per column), after the team's prologue statistics;
//   mixer_item   one (batch row, head) of the SSM state update (256 threads);
//   tail_row     the grammar/penalty/top-3 tail of one row (a 1024-thread
//                block).
// A per-token kernel is a grid of such items; the resident kernel walks the
// same items over its persistent blocks between grid barriers. A column's
// reduction order (lane split over K, shuffle order) and a row's statistics
// depend only on the item, never on which block computes it, so both paths
// compute the same bits. The build passes -fmad=false for the same reason:
// no multiply-add is contracted differently where a function is inlined.
//
// Weight formats (template FMT), all K-contiguous, W[n, k]:
//   kBf16   bf16 weights, activations rounded to bf16, f32 accumulation
//           (`_dot` in musicgen_tpu/ops/pallas_decode.py);
//   kW8A16  int8 weights with (K/256, N) f32 group scales, promoted to bf16
//           exactly; products summed in f32 and multiplied by their group's
//           scale (`_w8dot` :163);
//   kW8A8   the same pack; activations quantised per (row, 256-group) to
//           int8 with scale max|x|/127 (floor 1e-20), rounded half to even;
//           products summed exactly in int32 (__dp4a), then scaled by
//           s_x * s_w (`_qdot` :138).
// An int8 lane loads 16 weights (16 bytes), so one warp pass covers two
// groups: lanes 0-15 the first, 16-31 the second. Each lane scales its own
// partial sum; the TPU kernel scaled whole group sums, so the two differ in
// f32 rounding only. A matrix whose K is not a multiple of 256 has one group
// over all of K (`_quantize_cols`), GemvArgs::qgroup = K (the xLSTM FFN's
// down-projection, K = 1408, kernel G); lanes past K then load nothing.
//
// Activations, states, logits and the penalty counts may have been written
// by another block of the same launch (in the resident kernel), so they are
// read with plain loads, which the grid barrier orders after those writes;
// only weights and other constants take the read-only path (__ldg), which
// is not kept coherent with writes made during a launch.
#pragma once

#include <math.h>

#include "common.cuh"

namespace mg {

constexpr int MAXR = 8;             // batch rows one GEMV carries
constexpr int WARPS = 8;            // warps of a GEMV or mixer team
constexpr int TEAM = WARPS * 32;    // 256 threads
constexpr int QGROUP = 256;         // int8 K-group
constexpr int GMAX = 16;            // int8 K-groups a row may have (K <= 4096)
constexpr int TAIL_NT = 1024;       // threads of a tail row
constexpr int TAIL_NW = TAIL_NT / 32;
constexpr int MIX_P = 64;           // headdim the mixer is written for
constexpr int MIX_N = 64;           // d_state
constexpr float kLn101 = 0.00995033085316808f;   // ln 1.01
constexpr float kLn102 = 0.019802627296179712f;  // ln 1.02

enum { kPlain = 0, kRms = 1, kLayerNorm = 2 };  // GEMV prologue
// GEMV epilogue. The Transformer step (kernel F) adds: kKvRing (store, and
// the K and V thirds of the columns also as bf16 into ring slot c),
// kBiasRelu (relu(v + b)) and kBiasResidual (out += v + b); the xLSTM step
// (kernel G): kResidual (out += v) and kBiasGelu (tanh-GELU of v + b).
enum { kStore = 0, kInProj = 1, kBias = 2, kKvRing = 3, kBiasRelu = 4, kBiasResidual = 5, kResidual = 6,
       kBiasGelu = 7 };
enum { kBf16 = 0, kW8A16 = 1, kW8A8 = 2 };      // weight format

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Barrier of one 256-thread team (named barrier `bar`, 1..15; 0 is
// __syncthreads).
__device__ __forceinline__ void team_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(TEAM) : "memory");
}

// ---------------------------------------------------------------------------
// GEMV: out[r, n] = sum_k pro(x)[r, k] * W[n, k], then the epilogue.
// ---------------------------------------------------------------------------

struct GemvArgs {
  const float* x;                 // (R, K) f32 activations
  const void* w;                  // (N, K) bf16 or int8, K-contiguous
  const float* w_s;               // (K / 256, N) f32 group scales [int8]
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
  // kKvRing: columns [N/3, 2N/3) are K, [2N/3, N) V; (R, S, N/3) bf16 rings
  __nv_bfloat16* k_ring;
  __nv_bfloat16* v_ring;
  int ring_S, ring_c;
  int qgroup;                     // int8 K-group; 0 means QGROUP
};

// Shared memory of one GEMV team.
struct GemvSmem {
  float red[MAXR * GMAX * WARPS];
  float mul[MAXR], sub[MAXR];     // prologue row statistics
  float sx[MAXR * GMAX];          // W8A8 activation scales (row, group)
};

template <int PRO>
__device__ __forceinline__ float pro_apply(float v, const GemvSmem& sm, int r, float pw, float pb) {
  if (PRO == kRms) return v * sm.mul[r] * pw;
  if (PRO == kLayerNorm) return (v - sm.sub[r]) * sm.mul[r] * pw + pb;
  return v;
}

// Per-row statistics of the prologue: RMSNorm 1/sqrt(mean(x^2) + eps), or
// LayerNorm mean and 1/sqrt(E[x^2] - mean^2 + eps). Every team recomputes
// them from the R x K activations instead of a separate launch.
template <int PRO>
__device__ void gemv_row_stats(const GemvArgs& a, GemvSmem& sm, int tid, int bar) {
  const int lane = tid % 32, warp = tid / 32;
  for (int r = 0; r < a.R; ++r) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = tid; k < a.K; k += TEAM) {
      const float v = a.x[(size_t)r * a.K + k];
      s1 += v;
      s2 += v * v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      sm.red[r * WARPS + warp] = s1;
      sm.red[(MAXR + r) * WARPS + warp] = s2;
    }
  }
  team_sync(bar);
  if (tid < a.R) {
    const int r = tid;
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      s1 += sm.red[r * WARPS + w];
      s2 += sm.red[(MAXR + r) * WARPS + w];
    }
    const float mean = s1 / a.K, msq = s2 / a.K;
    if (PRO == kRms) {
      sm.mul[r] = 1.f / sqrtf(msq + a.eps);
      sm.sub[r] = 0.f;
    } else {
      sm.mul[r] = 1.f / sqrtf(msq - mean * mean + a.eps);
      sm.sub[r] = mean;
    }
  }
  team_sync(bar);
}

// W8A8: s_x[r, g] = max(max_k |pro(x)[r, k]|, 1e-20) / 127 over each group.
// A maximum does not depend on the order it is taken in.
template <int PRO>
__device__ void gemv_act_scales(const GemvArgs& a, GemvSmem& sm, int tid, int bar) {
  const int lane = tid % 32, warp = tid / 32, G = a.K / QGROUP;
  for (int r = 0; r < a.R; ++r) {
    for (int g = 0; g < G; ++g) {
      float m = 0.f;
      for (int k = g * QGROUP + tid; k < (g + 1) * QGROUP; k += TEAM) {
        const float pw = PRO != kPlain ? __ldg(a.pw + k) : 1.f;
        const float pb = PRO == kLayerNorm ? __ldg(a.pb + k) : 0.f;
        m = fmaxf(m, fabsf(pro_apply<PRO>(a.x[(size_t)r * a.K + k], sm, r, pw, pb)));
      }
      m = warp_max(m);
      if (lane == 0) sm.red[(r * G + g) * WARPS + warp] = m;
    }
  }
  team_sync(bar);
  for (int i = tid; i < a.R * G; i += TEAM) {
    float m = 0.f;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, sm.red[i * WARPS + w]);
    sm.sx[i] = fmaxf(m, 1e-20f) * (1.0f / 127.0f);
  }
  team_sync(bar);
}

__device__ __forceinline__ float int8_at(uint32_t u, int i) {
  return (float)(int8_t)((u >> (8 * i)) & 0xffu);
}

// One output column n for all R rows, computed by one warp; lane 0 applies
// the epilogue and stores.
template <int PRO, int EPI, int FMT>
__device__ void gemv_column(const GemvArgs& a, const GemvSmem& sm, int n, int lane) {
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  if (FMT == kBf16) {
    const __nv_bfloat16* wcol = static_cast<const __nv_bfloat16*>(a.w) + (size_t)n * a.K;
    for (int k0 = lane * 8; k0 < a.K; k0 += 32 * 8) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wcol + k0));
      const float wf[8] = {bf16_lo(wv.x), bf16_hi(wv.x), bf16_lo(wv.y), bf16_hi(wv.y),
                           bf16_lo(wv.z), bf16_hi(wv.z), bf16_lo(wv.w), bf16_hi(wv.w)};
      float pw[8], pb[8];
      if (PRO != kPlain) {
        const float4 p0 = __ldg(reinterpret_cast<const float4*>(a.pw + k0));
        const float4 p1 = __ldg(reinterpret_cast<const float4*>(a.pw + k0 + 4));
        pw[0] = p0.x; pw[1] = p0.y; pw[2] = p0.z; pw[3] = p0.w;
        pw[4] = p1.x; pw[5] = p1.y; pw[6] = p1.z; pw[7] = p1.w;
      }
      if (PRO == kLayerNorm) {
        const float4 q0 = __ldg(reinterpret_cast<const float4*>(a.pb + k0));
        const float4 q1 = __ldg(reinterpret_cast<const float4*>(a.pb + k0 + 4));
        pb[0] = q0.x; pb[1] = q0.y; pb[2] = q0.z; pb[3] = q0.w;
        pb[4] = q1.x; pb[5] = q1.y; pb[6] = q1.z; pb[7] = q1.w;
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < a.R) {
          const float4 x0 = ld4(a.x + (size_t)r * a.K + k0);
          const float4 x1 = ld4(a.x + (size_t)r * a.K + k0 + 4);
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = pro_apply<PRO>(xv[j], sm, r, PRO != kPlain ? pw[j] : 1.f,
                                           PRO == kLayerNorm ? pb[j] : 0.f);
            acc[r] = fmaf(bf16_round(v), wf[j], acc[r]);
          }
        }
      }
    }
  } else {
    // int8: lanes 0-15 hold K-group 2i of pass i, lanes 16-31 group 2i + 1.
    // Each lane scales its share of its group's sum and the warp adds the
    // lanes at the end.
    const int8_t* wcol = static_cast<const int8_t*>(a.w) + (size_t)n * a.K;
    const int G = a.K / QGROUP;
    const int gsz = a.qgroup > 0 ? a.qgroup : QGROUP;
    for (int base = 0; base < a.K; base += 32 * 16) {
      const int k0 = base + lane * 16;
      if (k0 >= a.K) break;
      const int g = k0 / gsz;
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wcol + k0));
      const float sw = __ldg(a.w_s + (size_t)g * a.N + n);
      const uint32_t wu[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < a.R) {
          float xv[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xq = ld4(a.x + (size_t)r * a.K + k0 + 4 * q);
            xv[4 * q] = xq.x; xv[4 * q + 1] = xq.y; xv[4 * q + 2] = xq.z; xv[4 * q + 3] = xq.w;
          }
          if (PRO != kPlain) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w4 = __ldg(reinterpret_cast<const float4*>(a.pw + k0 + 4 * q));
              const float4 b4 = PRO == kLayerNorm ? __ldg(reinterpret_cast<const float4*>(a.pb + k0 + 4 * q))
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
              xv[4 * q] = pro_apply<PRO>(xv[4 * q], sm, r, w4.x, b4.x);
              xv[4 * q + 1] = pro_apply<PRO>(xv[4 * q + 1], sm, r, w4.y, b4.y);
              xv[4 * q + 2] = pro_apply<PRO>(xv[4 * q + 2], sm, r, w4.z, b4.z);
              xv[4 * q + 3] = pro_apply<PRO>(xv[4 * q + 3], sm, r, w4.w, b4.w);
            }
          }
          if (FMT == kW8A16) {
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) part = fmaf(bf16_round(xv[j]), int8_at(wu[j / 4], j % 4), part);
            acc[r] = acc[r] + part * sw;
          } else {
            const float s = sm.sx[r * G + g];
            int part = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t packed = 0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float qv = fminf(fmaxf(rintf(xv[4 * q + i] / s), -127.f), 127.f);
                packed |= ((uint32_t)(int)qv & 0xffu) << (8 * i);
              }
              part = __dp4a((int)packed, (int)wu[q], part);
            }
            acc[r] = acc[r] + (float)part * s * sw;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = warp_sum(acc[r]);

  for (int r = 0; r < a.R && lane == 0; ++r) {
    float v = acc[r];
    if (EPI == kBias) v += __ldg(a.bias + n);
    if (EPI == kBiasRelu) v = fmaxf(v + __ldg(a.bias + n), 0.f);
    if (EPI == kBiasResidual) v = a.out[(size_t)r * a.N + n] + (v + __ldg(a.bias + n));
    if (EPI == kResidual) v = a.out[(size_t)r * a.N + n] + v;
    if (EPI == kBiasGelu) v = gelu_tanhf_(v + __ldg(a.bias + n));
    if (EPI == kKvRing && n >= a.N / 3) {
      // The new K / V row goes into ring slot c of this layer before the
      // layer's attention reads the ring (csrc/tdecode_attn.cu).
      const int dm = a.N / 3, col = (n - dm) % dm;
      __nv_bfloat16* ring = n < 2 * dm ? a.k_ring : a.v_ring;
      ring[((size_t)r * a.ring_S + a.ring_c) * dm + col] = __float2bfloat16_rn(v);
    }
    if (EPI == kInProj && n >= a.di && n < a.di + a.dc) {
      // Depthwise causal conv step (ops/ssm.causal_conv1d_step semantics:
      // state rows oldest -> newest, tap 3 multiplies the new input). Each
      // (row, channel) of the state belongs to this lane alone.
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

// The columns team `team` of `n_teams` owns: n = team * WARPS + warp, then
// strided by n_teams * WARPS. A team without a column returns at once (the
// test is uniform over the team, so its barriers stay matched).
template <int PRO, int EPI, int FMT>
__device__ void gemv_team(const GemvArgs& a, GemvSmem& sm, int team, int n_teams, int tid, int bar) {
  if (team * WARPS >= a.N) return;
  if (PRO != kPlain) gemv_row_stats<PRO>(a, sm, tid, bar);
  if (FMT == kW8A8) gemv_act_scales<PRO>(a, sm, tid, bar);
  const int lane = tid % 32, warp = tid / 32;
  for (int n = team * WARPS + warp; n < a.N; n += n_teams * WARPS)
    gemv_column<PRO, EPI, FMT>(a, sm, n, lane);
}

// Checks of a GEMV's shape against what gemv_column takes.
inline bool gemv_shape_ok(int R, int K, int N, int fmt) {
  if (R < 1 || R > MAXR || K <= 0 || N <= 0 || K % 8 != 0) return false;
  if (fmt != kBf16 && (K % (2 * QGROUP) != 0 || K / QGROUP > GMAX)) return false;
  return true;
}

// The same for a GEMV whose int8 pack may have one group over all of K
// (qgroup = K, K a multiple of 16); W8A16 only in that case.
inline bool gemv_shape_ok_grouped(int R, int K, int N, int fmt, int qgroup) {
  if (fmt == kBf16 || qgroup == QGROUP) return gemv_shape_ok(R, K, N, fmt);
  return fmt == kW8A16 && qgroup == K && K % 16 == 0 && gemv_shape_ok(R, K, N, kBf16);
}

// ---------------------------------------------------------------------------
// Mixer: the selective-state step of one (row b, head h), 256 threads.
//   h_state = exp(dt * A) * h_state + (dt * x) B^T;  y = h_state C + D x;
//   g = y * silu(z)
// State layout S[h*P + p, b*N + n]; each warp owns 8 rows p, each lane the
// state columns n and n + 32 (one coalesced 256-byte row), updated in place.
// ---------------------------------------------------------------------------

static __device__ void mixer_item(const float* zx, int nz, int di, const float* a_h, const float* d_h,
                           float* ssm, float* g, int R, int b, int h, int tid) {
  constexpr int ROWS_PER_WARP = MIX_P / WARPS;
  const int lane = tid % 32, warp = tid / 32;
  const float* row = zx + (size_t)b * nz;
  const int dc = di + 2 * MIX_N;
  const float dtv = row[di + dc + h];
  const float decay = expf(dtv * __ldg(a_h + h));
  const float dd = __ldg(d_h + h);
  const float b0 = row[2 * di + lane], b1 = row[2 * di + lane + 32];
  const float c0 = row[2 * di + MIX_N + lane], c1 = row[2 * di + MIX_N + lane + 32];

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int ch = h * MIX_P + warp * ROWS_PER_WARP + i;
    const float xv = row[di + ch];
    const float dtx = xv * dtv;
    float* srow = ssm + (size_t)ch * R * MIX_N + (size_t)b * MIX_N;
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

// ---------------------------------------------------------------------------
// Sampler tail of one row (a block of TAIL_NT threads). Over the real ids
// i < V:  lse = logsumexp(x);  w = (lse - x) * grammar[bucket];
//         w /= min(exp(hist * ln base), 1.2)  (base 1.01 pitch, 1.02 dyn);
// top-3 of w by three argmax passes, ties to the lowest index; pad ids get 0.
// w lives in shared memory (Vp floats) between the passes.
// ---------------------------------------------------------------------------

static __device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < TAIL_NW ? red[threadIdx.x] : -INFINITY;
  if (threadIdx.x < 32) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

static __device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < TAIL_NW ? red[threadIdx.x] : 0.f;
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

static __device__ void block_argmax(const float* w, int n, float* red_v, int* red_i, float& out_v,
                             int& out_i) {
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += TAIL_NT) arg_better(bv, bi, w[i], i);
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
    bv = threadIdx.x < TAIL_NW ? red_v[threadIdx.x] : -INFINITY;
    bi = threadIdx.x < TAIL_NW ? red_i[threadIdx.x] : 0x7fffffff;
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

// x: the row's Vp logits; grow: its grammar row; hrow: its V window counts.
// Thread 0 writes vals[0..2] and idx[0..2].
static __device__ void tail_row(const float* x, int Vp, int V, const float* grow, const int* hrow,
                         int dyn_start, int length_start, float* vals, int64_t* idx, float* w,
                         float* red_v, int* red_i) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < V; i += TAIL_NT) m = fmaxf(m, x[i]);
  m = block_max(m, red_v);
  float s = 0.f;
  for (int i = threadIdx.x; i < V; i += TAIL_NT) s += expf(x[i] - m);
  const float lse = logf(block_sum(s, red_v)) + m;

  for (int i = threadIdx.x; i < Vp; i += TAIL_NT) {
    float wv = 0.f;
    if (i < V) {
      const float mk = __ldg(grow + i);
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
      vals[k] = bv;
      idx[k] = bi;
      w[bi] = -1e30f;
    }
    __syncthreads();
  }
}

}  // namespace mg
