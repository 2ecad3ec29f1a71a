// Kernel C: the resident whole-generation kernel. ONE launch generates N
// tokens of the Mamba-2 stack with the 'combined' sampler.
//
// Replaces musicgen_tpu/ops/pallas_generate.py `_generate_kernel` (through
// `fused_generate` and `generate_resident`). Per token:
//   pick      the token from the top-3 candidates: greedy, or by CDF
//             inversion of two streamed uniforms (lane 0 the k-choice, lane
//             1 the pick), exactly as pallas_generate.py:159-183; write it
//             out; push it into the penalty window (hist + 1, the tick ring,
//             and the eviction loop while the window holds >= 1024 ticks);
//             gather its f32 embedding row;
//   mixers    for each of the L layers: in_proj + conv step, the SSM state
//             update, gated RMSNorm + out_proj;
//   head      LayerNorm + lm_head + bias;
//   tail      grammar, penalty and exact top-3 -> the next candidates.
//
// What bounds it on an H100: the weights, streamed from HBM once per token
// (166 MB in bf16, 84 MB in int8 with its scales, at batch 2 and full width),
// and the grid barriers. The TPU kernel ran a sequential (token, stage) grid
// with everything else in VMEM; Hopper blocks run in no order, so here the
// grid is a persistent cooperative launch (as many 1024-thread blocks as can
// be co-resident, one per SM at the main path) and each dependent stage ends
// in `grid.sync()`: in_proj -> mixer -> out_proj for each layer, then the
// head, then tail + pick: 3L + 2 = 32 barriers per token at L = 10. The tail
// and the pick of row b run in block b; the pick and the penalty push are
// done by its thread 0, which owns the row's window (a data-dependent loop
// that no other thread waits for until the next barrier).
//
// Each stage walks the same work items as the per-token kernels, through the
// same device functions (decode_ops.cuh): a 1024-thread block holds four
// 256-thread GEMV/mixer teams, or one tail row. So the resident kernel and
// the per-token kernel chain compute the same bits, and with the same
// uniforms emit the same tokens.
//
// Nothing but the weights (and one embedding row per token) comes from
// outside the chip's caches in steady state: the conv and SSM states (1 MB
// and 10.5 MB at batch 2), the window counts, the ring, the candidates and
// the activations stay in device memory, updated in place, and at about 12
// MB fit in the 50 MB L2, which the weight stream shares (whether they stay
// there is not measured). Keeping them in shared memory is later work. The
// launch never falls back: if the grid cannot be co-resident or the device
// refuses a cooperative launch, the error is returned and the wrapper raises.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_ops.cuh"

namespace cgrp = cooperative_groups;
using namespace mg;

namespace {

constexpr int NT = TAIL_NT;          // 1024 threads: 4 GEMV/mixer teams, or one tail row
constexpr int TEAMS = NT / TEAM;
constexpr float kRmsEps = 1e-5f;
constexpr float kLnEps = 1e-6f;

struct ResidentArgs {
  // packed weights (layer-stacked; int8 formats with their group scales)
  const void* w_in;            // (L, d_in_proj, d_model)
  const float* w_in_s;         // (L, d_model / 256, d_in_proj) [int8]
  const void* w_out;           // (L, d_model, d_inner)
  const float* w_out_s;        // (L, d_inner / 256, d_model) [int8]
  const float* conv_w;         // (L, 4, conv_dim)
  const float* conv_b;         // (L, conv_dim)
  const float* dt_bias;        // (L, nheads)
  const float* a_h;            // (L, nheads)
  const float* d_h;            // (L, nheads)
  const float* norm_w;         // (L, d_inner)
  const float* ln_w;           // (d_model,)
  const float* ln_b;           // (d_model,)
  const void* lm_w;            // (Vp, d_model)
  const float* lm_s;           // (d_model / 256, Vp) [int8]
  const float* lm_b;           // (Vp,)
  const float* gram;           // (5, Vp)
  const float* embed;          // (V, d_model) f32
  const float* uniforms;       // (N, B, 2)
  // state, advanced in place
  float* conv;                 // (L, B, 3, conv_dim)
  float* ssm;                  // (L, d_inner, B * d_state)
  int* hist;                   // (B, V) window counts
  int* ring_tok;               // (B, ring)
  int* ring_c;                 // (B, ring)
  int* meta;                   // (B, 3): window start, head, tick sum
  float* cand_v;               // (B, 3) top-3 values
  int64_t* cand_i;             // (B, 3) top-3 ids
  int64_t* last;               // (B,) the token consumed last
  // activations
  float* x;                    // (B, d_model)
  float* zx;                   // (B, d_in_proj)
  float* g;                    // (B, d_inner)
  float* logits;               // (B, Vp)
  int64_t* tokens;             // (B, N) output
  int L, B, d_model, d_inner, nheads, headdim, d_state, conv_dim, d_in_proj, Vp, V;
  int dyn_start, length_start, time_start, tempo_start, ring, window_ticks, n_tokens, greedy;
  int team_bytes;              // dynamic shared memory of one GEMV team (set by the launch)
};
constexpr int kNumPtrs = 32;
constexpr int kNumInts = 19;

__device__ __forceinline__ int bucket_of(const ResidentArgs& a, int64_t tok) {
  return (tok >= a.dyn_start) + (tok >= a.length_start) + (tok >= a.time_start) +
         (tok >= a.tempo_start);
}

// Pick token t of row b, emit it, push it into the window and gather its
// embedding row into x[b]. Block-wide (all NT threads of the block).
__device__ void pick_push_embed(const ResidentArgs& a, int b, int t, int* s_tok) {
  if (threadIdx.x == 0) {
    const int64_t prev = a.last[b];
    const float* cv = a.cand_v + b * 3;
    const int64_t* ci = a.cand_i + b * 3;
    int64_t tok;
    if (a.greedy) {
      tok = ci[0];
    } else {
      // sample/sampler._sample_k tables as P(k=1), P(k=2) per field bucket.
      const int bucket = bucket_of(a, prev);
      const float u_k = __ldg(a.uniforms + ((size_t)t * a.B + b) * 2);
      const float u_p = __ldg(a.uniforms + ((size_t)t * a.B + b) * 2 + 1);
      const float p1 = bucket == 4 ? 0.6f : (bucket <= 1 ? 0.5f : 1.0f);
      const float p2 = bucket == 0 ? 0.5f : (bucket == 4 ? 0.4f : 0.0f);
      const int k = 1 + (u_k >= p1) + (u_k >= p1 + p2);
      const float v0 = cv[0];
      const float v1 = k >= 2 ? cv[1] : 0.f;
      const float v2 = k >= 3 ? cv[2] : 0.f;
      const float r = u_p * (v0 + v1 + v2);
      const int choice = (r >= v0) + (r >= v0 + v1);
      tok = ci[choice];
    }
    a.last[b] = tok;
    a.tokens[(size_t)b * a.n_tokens + t] = tok;

    // Penalty push (sample/sampler.push_token).
    int* hist = a.hist + (size_t)b * a.V;
    int* rt = a.ring_tok + (size_t)b * a.ring;
    int* rc = a.ring_c + (size_t)b * a.ring;
    int* m = a.meta + b * 3;
    const int c_new = (tok >= a.time_start && tok < a.tempo_start) ? (int)(tok - a.time_start) : 0;
    const int head = m[1];
    rt[head % a.ring] = (int)tok;
    rc[head % a.ring] = c_new;
    hist[tok] += 1;
    int start = m[0], wsum = m[2] + c_new;
    // The window never starts past its newest token; the bound only guards
    // against an inconsistent window handed in by the caller.
    while (wsum >= a.window_ticks && start <= head) {
      const int s = start % a.ring;
      hist[rt[s]] -= 1;
      wsum -= rc[s];
      start += 1;
    }
    m[0] = start;
    m[1] = head + 1;
    m[2] = wsum;
    *s_tok = (int)tok;
  }
  __syncthreads();
  const float* erow = a.embed + (size_t)(*s_tok) * a.d_model;
  for (int k = threadIdx.x; k < a.d_model; k += NT) a.x[(size_t)b * a.d_model + k] = __ldg(erow + k);
  __syncthreads();
}

template <int FMT>
__global__ void __launch_bounds__(NT, 1) generate_kernel(ResidentArgs a) {
  // Dynamic shared memory: the tail's Vp weights, or each team's GEMV sums
  // and staged activations. The two are never live at once: a grid barrier
  // separates every GEMV stage from every tail stage.
  extern __shared__ uint4 dyn_smem[];
  float* tail_w = reinterpret_cast<float*>(dyn_smem);
  __shared__ GemvSmem gsm[TEAMS];
  __shared__ float red_v[TAIL_NW];
  __shared__ int red_i[TAIL_NW];
  __shared__ int s_tok;
  cgrp::grid_group grid = cgrp::this_grid();

  const int team_in = threadIdx.x / TEAM, tid = threadIdx.x % TEAM, bar = 1 + team_in;
  const int team = blockIdx.x * TEAMS + team_in, n_teams = gridDim.x * TEAMS;
  GemvSmem& sm = gsm[team_in];
  char* dyn = reinterpret_cast<char*>(dyn_smem) + (size_t)team_in * a.team_bytes;
  const size_t esz = FMT == kBf16 ? 2 : 1;
  const int di = a.d_inner, dc = a.conv_dim, nh = a.nheads, dm = a.d_model, dip = a.d_in_proj;
  const int g_in = dm / QGROUP, g_out = di / QGROUP;

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) pick_push_embed(a, b, 0, &s_tok);
  grid.sync();

  for (int t = 0; t < a.n_tokens; ++t) {
    for (int l = 0; l < a.L; ++l) {
      GemvArgs in = {};
      in.x = a.x;
      in.w = static_cast<const char*>(a.w_in) + (size_t)l * dip * dm * esz;
      in.w_s = FMT == kBf16 ? nullptr : a.w_in_s + (size_t)l * g_in * dip;
      in.out = a.zx;
      in.R = a.B; in.K = dm; in.N = dip;
      in.di = di; in.dc = dc; in.nh = nh;
      in.conv_w = a.conv_w + (size_t)l * 4 * dc;
      in.conv_b = a.conv_b + (size_t)l * dc;
      in.dt_bias = a.dt_bias + (size_t)l * nh;
      in.conv_state = a.conv + (size_t)l * a.B * 3 * dc;
      gemv_team<kPlain, kInProj, FMT>(in, sm, team, n_teams, tid, bar, dyn);
      grid.sync();

      float* ssm = a.ssm + (size_t)l * di * a.B * a.d_state;
      for (int item = team; item < a.B * nh; item += n_teams)
        mixer_item(a.zx, dip, di, a.a_h + (size_t)l * nh, a.d_h + (size_t)l * nh, ssm, a.g, a.B,
                   item / nh, item % nh, tid);
      grid.sync();

      GemvArgs out = {};
      out.x = a.g;
      out.w = static_cast<const char*>(a.w_out) + (size_t)l * dm * di * esz;
      out.w_s = FMT == kBf16 ? nullptr : a.w_out_s + (size_t)l * g_out * dm;
      out.out = a.x;
      out.R = a.B; out.K = di; out.N = dm;
      out.pw = a.norm_w + (size_t)l * di;
      out.eps = kRmsEps;
      gemv_team<kRms, kStore, FMT>(out, sm, team, n_teams, tid, bar, dyn);
      grid.sync();
    }

    GemvArgs head = {};
    head.x = a.x;
    head.w = a.lm_w;
    head.w_s = FMT == kBf16 ? nullptr : a.lm_s;
    head.out = a.logits;
    head.R = a.B; head.K = dm; head.N = a.Vp;
    head.pw = a.ln_w; head.pb = a.ln_b; head.eps = kLnEps; head.bias = a.lm_b;
    gemv_team<kLayerNorm, kBias, FMT>(head, sm, team, n_teams, tid, bar, dyn);
    grid.sync();

    if (t + 1 < a.n_tokens) {
      for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
        const int64_t prev = a.last[b];
        tail_row(a.logits + (size_t)b * a.Vp, a.Vp, a.V, a.gram + (size_t)bucket_of(a, prev) * a.Vp,
                 a.hist + (size_t)b * a.V, a.dyn_start, a.length_start, a.cand_v + b * 3,
                 a.cand_i + b * 3, tail_w, red_v, red_i);
        pick_push_embed(a, b, t + 1, &s_tok);
      }
      grid.sync();
    }
  }
}

bool resident_shape_ok(const ResidentArgs& a, int fmt) {
  if (a.B < 1 || a.B > MAXR || a.L < 1 || a.n_tokens < 1 || a.ring < 1 || a.window_ticks < 1) return false;
  if (a.headdim != MIX_P || a.d_state != MIX_N || a.nheads * MIX_P != a.d_inner) return false;
  if (a.conv_dim != a.d_inner + 2 * a.d_state || a.d_in_proj != 2 * a.d_inner + 2 * a.d_state + a.nheads)
    return false;
  if (a.V < 3 || a.V > a.Vp) return false;
  return gemv_shape_ok(a.B, a.d_model, a.d_in_proj, fmt) && gemv_shape_ok(a.B, a.d_inner, a.d_model, fmt) &&
         gemv_shape_ok(a.B, a.d_model, a.Vp, fmt);
}

template <int FMT>
int launch_resident(const void* const* p, int n_ptrs, const int* v, int n_ints, int* grid_out,
                    void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts) return (int)cudaErrorInvalidValue;
  ResidentArgs a;
  int i = 0;
  a.w_in = p[i++];
  a.w_in_s = static_cast<const float*>(p[i++]);
  a.w_out = p[i++];
  a.w_out_s = static_cast<const float*>(p[i++]);
  a.conv_w = static_cast<const float*>(p[i++]);
  a.conv_b = static_cast<const float*>(p[i++]);
  a.dt_bias = static_cast<const float*>(p[i++]);
  a.a_h = static_cast<const float*>(p[i++]);
  a.d_h = static_cast<const float*>(p[i++]);
  a.norm_w = static_cast<const float*>(p[i++]);
  a.ln_w = static_cast<const float*>(p[i++]);
  a.ln_b = static_cast<const float*>(p[i++]);
  a.lm_w = p[i++];
  a.lm_s = static_cast<const float*>(p[i++]);
  a.lm_b = static_cast<const float*>(p[i++]);
  a.gram = static_cast<const float*>(p[i++]);
  a.embed = static_cast<const float*>(p[i++]);
  a.uniforms = static_cast<const float*>(p[i++]);
  a.conv = static_cast<float*>(const_cast<void*>(p[i++]));
  a.ssm = static_cast<float*>(const_cast<void*>(p[i++]));
  a.hist = static_cast<int*>(const_cast<void*>(p[i++]));
  a.ring_tok = static_cast<int*>(const_cast<void*>(p[i++]));
  a.ring_c = static_cast<int*>(const_cast<void*>(p[i++]));
  a.meta = static_cast<int*>(const_cast<void*>(p[i++]));
  a.cand_v = static_cast<float*>(const_cast<void*>(p[i++]));
  a.cand_i = static_cast<int64_t*>(const_cast<void*>(p[i++]));
  a.last = static_cast<int64_t*>(const_cast<void*>(p[i++]));
  a.x = static_cast<float*>(const_cast<void*>(p[i++]));
  a.zx = static_cast<float*>(const_cast<void*>(p[i++]));
  a.g = static_cast<float*>(const_cast<void*>(p[i++]));
  a.logits = static_cast<float*>(const_cast<void*>(p[i++]));
  a.tokens = static_cast<int64_t*>(const_cast<void*>(p[i++]));
  int j = 0;
  a.L = v[j++]; a.B = v[j++]; a.d_model = v[j++]; a.d_inner = v[j++]; a.nheads = v[j++];
  a.headdim = v[j++]; a.d_state = v[j++]; a.conv_dim = v[j++]; a.d_in_proj = v[j++];
  a.Vp = v[j++]; a.V = v[j++]; a.dyn_start = v[j++]; a.length_start = v[j++];
  a.time_start = v[j++]; a.tempo_start = v[j++]; a.ring = v[j++]; a.window_ticks = v[j++];
  a.n_tokens = v[j++];
  a.greedy = v[j++];
  if (i != kNumPtrs || j != kNumInts || !resident_shape_ok(a, FMT)) return (int)cudaErrorInvalidValue;
  if (FMT != kBf16 && (a.w_in_s == nullptr || a.w_out_s == nullptr || a.lm_s == nullptr))
    return (int)cudaErrorInvalidValue;

  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t team_bytes = std::max(gemv_smem_bytes(a.B, a.d_model, QGROUP, FMT),
                                     gemv_smem_bytes(a.B, a.d_inner, QGROUP, FMT));
  a.team_bytes = (int)team_bytes;
  const size_t smem = std::max((size_t)a.Vp * sizeof(float), TEAMS * team_bytes);
  e = cudaFuncSetAttribute(generate_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, generate_kernel<FMT>, NT, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = per_sm * mg_sm_count();
  if (grid < a.B) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid_out = grid;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)generate_kernel<FMT>, dim3(grid), dim3(NT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per weight format. ptrs: the kNumPtrs device pointers in
// ResidentArgs order (null for the scales of the bf16 pack); ints: the
// kNumInts sizes in ResidentArgs order. *grid_out receives the grid size.
MG_EXPORT int mg_generate_resident_bf16(const void* const* ptrs, int n_ptrs, const int* ints,
                                        int n_ints, int* grid_out, void* stream) {
  return launch_resident<kBf16>(ptrs, n_ptrs, ints, n_ints, grid_out, stream);
}

MG_EXPORT int mg_generate_resident_w8a16(const void* const* ptrs, int n_ptrs, const int* ints,
                                         int n_ints, int* grid_out, void* stream) {
  return launch_resident<kW8A16>(ptrs, n_ptrs, ints, n_ints, grid_out, stream);
}

MG_EXPORT int mg_generate_resident_w8a8(const void* const* ptrs, int n_ptrs, const int* ints,
                                        int n_ints, int* grid_out, void* stream) {
  return launch_resident<kW8A8>(ptrs, n_ptrs, ints, n_ints, grid_out, stream);
}
