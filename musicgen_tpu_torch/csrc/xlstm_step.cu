// Kernel G as one launch a token: the whole xLSTM decode step (the embedding
// row, the mLSTM and sLSTM blocks and the head's LayerNorm + lm_head) in one
// persistent cooperative launch. The sampler tail stays kernel B's
// mg_sample_tail launch (decode_tail.cu), so a token is two launches.
//
// Replaces musicgen_tpu/ops/pallas_xlstm_decode.py `_xlstm_kernel` (through
// `fused_xlstm_logits_step` and `fused_xlstm_sample_step`), the TPU kernel
// that ran the step as one pallas_call whose grid walked the blocks with
// their weights double-buffered into VMEM. In every format of the port:
// bf16 or W8A16 weights, the matrix memory stored in f32 or bf16 (-sb16).
//
// What bounds it on an H100: bytes, 192.7 MB of bf16 weights (103.3 MB in
// W8A16) and 118.8 MB of recurrent state read and written a token at batch
// 2 (60.1 MB under -sb16), 93 us at 3.35 TB/s in bf16; and the chain of 54
// dependent stages, each a few round trips to L2. The first form of the
// chain (68 launches) took 0.75 ms in a CUDA graph on an H100 80GB HBM3 at
// 700 W; its ablation (PERF.md, section 6) put 0.22 ms in the matrix memory
// (each thread walking its rows one load at a time), 0.13 in the sLSTM cell
// (one block a (b, h), a 256-long chain of strided loads a thread), 0.10 in
// the gate products (8 blocks) and 0.07 in the launch gaps.
//
// Design (after kernel C, generate_resident.cu):
//  * One 512-thread block an SM (two 256-thread teams), co-resident
//    (cudaLaunchCooperativeKernel), 128 registers a thread.
//  * Every stage is cut into items and a host plan
//    (ops/xdecode_kernel.xlstm_plan) deals them over the teams, interleaved
//    across the blocks, so that no stage sits on fewer SMs than it has
//    items: the up-projection's 256 tiles (its x_m tiles also run the conv
//    step, the blocksize-4 q, k, v and the gate partials of their 16
//    channels in their epilogue), the matrix memory's 256 items of 16 rows
//    (32 KB of S each, 8 16-byte loads a thread in flight), 8 head items
//    (gates, normalizer, readout, head norm, output gate), the
//    down-projection's 64 tiles; the sLSTM's LayerNorm and conv in 16
//    items, its 256 input-gate tiles, 64 recurrence items (16 units, all
//    four gates, both rows on one read of their R tile), 8 group-norm
//    items, the FFN's 88 + 64 tiles; the head's 1,120 tiles.
//  * Stages are separated by counters, not launches (grid_sync.cuh): a
//    team with items in a stage waits for the previous stage's count, runs
//    its items and adds their number to the stage's counter. The last block
//    to finish resets the counters, so the next launch and a CUDA-graph
//    replay start clean.
//  * A team entering a stage first asks L2 for that stage's weights and
//    matrix-memory rows (cp.async.bulk.prefetch.L2): they do not depend on
//    the activations, so they stream while the team waits.
//  * Every item is a function of xlstm_ops.cuh or decode_ops.cuh that the
//    chain runs too, in the same order, so the step equals the chain bit
//    for bit (chip_smoke.py [9 xstep]).
//  * Fewer, wider heads (1 or 2 at width 1,024: DK 2,048 or 1,024, DH 1,024
//    or 512) run the same stages: matrix-memory items of 8 rows (two column
//    quads a thread at DK 2,048), the head item xm_head_out_wide (its row
//    blocks' partials read in a loop), cell items that read R from L2
//    instead of staging it, the group norm in a loop over the units.
//
// The states (conv, the matrix memory S, n, m, the sLSTM h, c, n, m) advance
// in place. The launch never falls back: if the grid cannot be co-resident
// or the plan does not fit, the error is returned and the wrapper raises.
#include <algorithm>
#include <cstddef>

#include "grid_sync.cuh"
#include "xlstm_ops.cuh"

using namespace mg;

namespace {

constexpr int NT = 512;  // threads of a block: two teams
constexpr int TEAMS = NT / TEAM;
constexpr int MAX_TEAM_ITEMS = 48;  // items of all kinds a team may have (the plan checks it)
constexpr int kCounterStride = 32;  // ints between two stages' counters (a 128-byte line each)
constexpr float kLnEps = 1e-6f;
constexpr float kGroupEps = 1e-5f;
// The plan's work kinds (ops/xdecode_kernel.STEP_KINDS, in this order).
enum {
  kEmbed = 0, kMUp, kMMem, kMOut, kMDown, kSPrep, kSIf, kSZo, kSCell, kSGn, kSUp, kSDown, kHead, kKinds
};

struct StepArgs {
  // the pack (block-stacked; int8 formats with their group scales)
  const float* m_ln;       // (M, 2, d)
  const void* m_w_up;      // (M, 2 di, d)
  const float* m_w_up_s;   // (M, d / 256, 2 di) [int8]
  const float* m_conv_w;   // (M, 4, di)
  const float* m_conv_b;   // (M, di)
  const float* m_qkv_w;    // (M, 3, di / 4, 4, 4)
  const float* m_w_gate;   // (M, 2H, 3 di)
  const float* m_gate_b;   // (M, 2H)
  const float* m_outnorm;  // (M, di)
  const float* m_skip;     // (M, di)
  const void* m_w_down;    // (M, d, di)
  const float* m_w_down_s; // (M, di / 256, d) [int8]
  const float* s_ln;       // (S, 2, d)
  const float* s_conv_w;   // (S, 4, d)
  const float* s_conv_b;   // (S, d)
  const void* s_w_if;      // (S, 2d, d)
  const float* s_w_if_s;   // (S, d / 256, 2d) [int8]
  const void* s_w_zo;
  const float* s_w_zo_s;
  const __nv_bfloat16* s_r_w;  // (S, H, DH, 4 DH)
  const float* s_bias;     // (S, 4, d)
  const float* s_gn;       // (S, d)
  const float* s_ln_ffn;   // (S, 2, d)
  const void* s_ffn_up;    // (S, ffn, d)
  const float* s_ffn_up_s; // (S, d / 256, ffn) [int8]
  const float* s_ffn_up_b; // (S, ffn)
  const void* s_ffn_down;  // (S, d, ffn)
  const float* s_ffn_down_s;  // (S, 1, d) [int8: one group over ffn]
  const float* s_ffn_down_b;  // (S, d)
  const float* ln_f;       // (2, d)
  const void* lm_w;        // (Vp, d)
  const float* lm_s;       // (d / 256, Vp) [int8]
  const float* lm_b;       // (Vp,)
  const float* embed;      // (V, d) f32
  const int64_t* token;    // (B,)
  // the carry, advanced in place
  float* conv_m;           // (M, B, 3, di)
  void* s_m;               // (M, B, H, DK, DV) f32 or bf16
  float* n_m;              // (M, B, H, DK)
  float* m_m;              // (M, B, H)
  float* conv_s;           // (S, B, 3, d)
  float* hcnm_s;           // (S, 4, B, H, DH)
  // activations
  float* x;                // (B, d)
  float* up;               // (B, 2 di)
  float* buf;              // (B, 4, di) [q | k | v | x_c]
  float* gpart;            // (B, 2H, di / 16) gate partials
  float* mpart;            // (B, H, nrc, DV) readout partials
  float* h_att;            // (B, di)
  float* y;                // (B, di)
  float* xs;               // (2, B, d) [x_c; xn]
  float* wif;              // (B, 2d)
  float* wzo;              // (B, 2d)
  float* hnew;             // (B, d)
  float* u;                // (B, ffn)
  float* logits;           // (B, Vp)
  // schedule
  const int* plan;         // per team: kKinds x (start, count), then the item lists
  int* counters;           // (n_stages + 1) x kCounterStride, zero at launch, zero again at exit
  long long* stamps;       // optional (null): (n_stages, teams, 2) %globaltimer ns, a team's wait passed and its signal
  int n_blocks, slstm_mask, B, d, H, di, ffn, Vp, n_grid;
  int region;              // dynamic shared memory of one team (set by the launch)
};
constexpr int kNumPtrs = 57;
constexpr int kNumInts = 9;
// mg_xlstm_step copies the pointers and the ints in this order.
static_assert(offsetof(StepArgs, n_blocks) == kNumPtrs * sizeof(void*), "StepArgs: kNumPtrs pointers first");
static_assert(offsetof(StepArgs, region) == offsetof(StepArgs, n_blocks) + kNumInts * sizeof(int),
              "StepArgs: then kNumInts ints");

struct TeamPlan {
  int count[kKinds], first[kKinds];
  int items[MAX_TEAM_ITEMS];
};

__device__ __forceinline__ void load_team_plan(const StepArgs& a, int team, TeamPlan& tp, int tid, int bar) {
  const int* hd = a.plan + (size_t)team * 2 * kKinds;
  if (tid < kKinds) {
    int first = 0;
    for (int k = 0; k < tid; ++k) first += __ldg(hd + 2 * k + 1);
    tp.count[tid] = __ldg(hd + 2 * tid + 1);
    tp.first[tid] = first;
    for (int i = 0; i < tp.count[tid]; ++i) tp.items[first + i] = __ldg(a.plan + __ldg(hd + 2 * tid) + i);
  }
  team_sync(bar);
}

// Items of each kind in one block's stage (xdecode_kernel.stage_items).
__device__ __forceinline__ int kind_items(const StepArgs& a, int kind) {
  const int DV = a.di / a.H, DH = a.d / a.H;
  switch (kind) {
    case kEmbed: return a.B;
    case kMUp: return gemv_tiles(2 * a.di);
    case kMMem: return a.B * a.H * (DV / xm_rows_per_item(DV));
    case kMOut: return a.B * a.H;
    case kMDown: return gemv_tiles(a.d);
    case kSPrep: return a.B * ((a.d + XS_PREP_COLS - 1) / XS_PREP_COLS);
    case kSIf: return gemv_tiles(2 * a.d);
    case kSZo: return gemv_tiles(2 * a.d);
    case kSCell: return a.H * (DH / XS_UNITS);
    case kSGn: return a.B * a.H;
    case kSUp: return gemv_tiles(a.ffn);
    case kSDown: return gemv_tiles(a.d);
    default: return gemv_tiles(a.Vp);
  }
}

__device__ __forceinline__ int qgroup_of(int K, int fmt) { return fmt == kBf16 ? 0 : (K % QGROUP == 0 ? QGROUP : K); }

// A GEMV of the pack: weights (N, K) of block-stacked `w` at layer l.
template <int FMT>
__device__ __forceinline__ GemvArgs gemv_args(const void* w, const float* w_s, int l, int K, int N, const float* x,
                                              float* out, int R) {
  constexpr int ESZ = FMT == kBf16 ? 2 : 1;
  GemvArgs g = {};
  const int qg = qgroup_of(K, FMT);
  g.x = x;
  g.w = static_cast<const char*>(w) + (size_t)l * N * K * ESZ;
  g.w_s = FMT == kBf16 ? nullptr : w_s + (size_t)l * (K / qg) * N;
  g.out = out;
  g.R = R;
  g.K = K;
  g.N = N;
  g.qgroup = qg;
  return g;
}

// A GEMV stage: tiles `tiles` of the (N, K) matrix of block-stacked `w` at
// layer l, prologue weights pw, pb (LayerNorm, eps 1e-6), epilogue bias.
template <int PRO, int EPI, int FMT, class Hook = NoHook>
__device__ __forceinline__ void gemv_stage(const void* w, const float* w_s, int l, int K, int N, const float* x,
                                               float* out, const float* pw, const float* pb, const float* bias, int R,
                                               const int* tiles, int n, int tid, int bar, char* dyn, GemvSmem* sm,
                                               Hook hook = Hook()) {
  GemvArgs g = gemv_args<FMT>(w, w_s, l, K, N, x, out, R);
  g.pw = pw;
  g.pb = pb;
  g.eps = kLnEps;
  g.bias = bias;
  gemv_list<PRO, EPI, FMT>(g, *sm, tiles, n, tid, bar, dyn, hook);
}

// The weight rows of tiles of the (N, K) matrix of block-stacked `w` at layer
// l, asked of L2.
template <int FMT>
__device__ void prefetch_tiles(const void* w, int l, int K, int N, const int* tiles, int n) {
  constexpr int ESZ = FMT == kBf16 ? 2 : 1;
  const char* base = static_cast<const char*>(w) + (size_t)l * N * K * ESZ;
  for (int i = 0; i < n; ++i) {
    const int n0 = tiles[i] * TILE_N, rows = min(TILE_N, N - n0);
    prefetch_l2(base + (size_t)n0 * K * ESZ, (size_t)rows * K * ESZ);
  }
}

// The epilogue of an x_m tile of the up-projection: the conv step and q, k,
// v of its 4 channel blocks, then the gate partials of its 16 channels.
static __device__ __noinline__ void xm_up_epilogue(const float* up, const float* conv_w, const float* conv_b,
                                                   float* conv_state, const float* qkv_w, float* buf,
                                                   const float* w_gate, float* gpart, int B, int H, int di, int tile,
                                                   int tid, int bar) {
  const int G = 2 * H;
  team_sync(bar);  // the tile's up values are stored
  if (tid < 4 * B) xm_prep_group(up, conv_w, conv_b, conv_state, qkv_w, buf, di, tid / 4, tile * 4 + tid % 4);
  team_sync(bar);
  if (tid < B * G)
    gpart[((size_t)(tid / G) * G + tid % G) * (di / XM_CHUNK) + tile] =
        xm_gate_partial(buf, w_gate, di, tid / G, tid % G, tile);
}

// gemv_list's hook for the up-projection of mLSTM block mi (its pointers by
// value: the kernel's parameters stay in the constant bank).
struct UpHook {
  const float *up, *conv_w, *conv_b;
  float* conv_state;
  const float* qkv_w;
  float* buf;
  const float* w_gate;
  float* gpart;
  int B, H, di, tid, bar;
  __device__ __forceinline__ void operator()(int tile) const {
    if (tile * TILE_N < di)
      xm_up_epilogue(up, conv_w, conv_b, conv_state, qkv_w, buf, w_gate, gpart, B, H, di, tile, tid, bar);
  }
};

// The matrix-memory item's prelude: warp 0 computes f', i' and m_new of head
// (b, h) from the gate partials into sc while the item's loads are in
// flight.
struct GatePrelude {
  const float *pi, *pf, *gate_b;
  const float* m_prev;
  float* sc;
  int nch, H, h;
  __device__ __forceinline__ void operator()(int tid) const {
    if (tid < 32) xm_gates_warp(pi, pf, nch, gate_b, *m_prev, H, h, tid, sc);
  }
};

// Where a team stands in the stage sequence: the kind and the layer (mLSTM
// block mi, sLSTM block si).
struct StagePos {
  int kind, mi, si;
};

// Ask L2 for what this team's items of stage p read that does not depend on
// the activations: GEMV tiles' weight rows, matrix-memory rows.
template <int FMT, typename S>
__device__ __forceinline__ void prefetch_stage(const StepArgs& a, const TeamPlan& tp, StagePos p) {
  const int n = tp.count[p.kind], d = a.d, di = a.di, DK = di / a.H;
  const int* it = tp.items + tp.first[p.kind];
  switch (p.kind) {
    case kMUp: prefetch_tiles<FMT>(a.m_w_up, p.mi, d, 2 * di, it, n); break;
    case kMDown: prefetch_tiles<FMT>(a.m_w_down, p.mi, di, d, it, n); break;
    case kSIf:
      prefetch_tiles<FMT>(a.s_w_if, p.si, d, 2 * d, it, n);
      prefetch_tiles<FMT>(a.s_w_zo, p.si, d, 2 * d, tp.items + tp.first[kSZo], tp.count[kSZo]);
      break;
    case kSUp: prefetch_tiles<FMT>(a.s_ffn_up, p.si, d, a.ffn, it, n); break;
    case kSDown: prefetch_tiles<FMT>(a.s_ffn_down, p.si, a.ffn, d, it, n); break;
    case kHead: prefetch_tiles<FMT>(a.lm_w, 0, d, a.Vp, it, n); break;
    case kSCell: {  // the first item of a head asks for all of its R (DH rows of 4 DH bf16)
      const int DH = d / a.H, groups = DH / XS_UNITS;
      for (int i = 0; i < n; ++i)
        if (it[i] % groups == 0)
          prefetch_l2(a.s_r_w + ((size_t)p.si * a.H + it[i] / groups) * DH * 4 * DH, (size_t)DH * 4 * DH * 2);
      break;
    }
    case kMMem: {
      const int rows = xm_rows_per_item(DK), nrc = DK / rows;
      const S* s_st = static_cast<const S*>(a.s_m) + (size_t)p.mi * a.B * a.H * DK * DK;
      for (int i = 0; i < n; ++i)
        prefetch_l2(s_st + ((size_t)(it[i] / nrc) * DK + (size_t)(it[i] % nrc) * rows) * DK,
                    (size_t)rows * DK * sizeof(S));
      break;
    }
    default: break;
  }
}

template <int FMT, typename S>
__global__ void __launch_bounds__(NT, 1) xstep_kernel(StepArgs a) {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  __shared__ GemvSmem gsm[TEAMS];
  __shared__ TeamPlan plans[TEAMS];
  __shared__ float reds[TEAMS][WARPS];
  __shared__ double red64s[TEAMS][2 * WARPS];
  __shared__ float scs[TEAMS][4];

  const int team_in = threadIdx.x / TEAM, tid = threadIdx.x % TEAM, bar = 1 + team_in;
  const int team = blockIdx.x * TEAMS + team_in;
  GemvSmem& sm = gsm[team_in];
  TeamPlan& tp = plans[team_in];
  float* red = reds[team_in];
  float* sc = scs[team_in];
  char* dyn = reinterpret_cast<char*>(dyn_smem) + (size_t)team_in * a.region;
  const int B = a.B, d = a.d, H = a.H, di = a.di, DK = di / H, DH = d / H, ffn = a.ffn;
  const int nrc = DK / xm_rows_per_item(DK), n_dh = DH / XS_UNITS, n_prep = (d + XS_PREP_COLS - 1) / XS_PREP_COLS;
  const bool head_in_regs = DK <= 2 * TEAM && nrc <= 32;  // xm_head_out's registers, else xm_head_out_wide
  load_team_plan(a, team, tp, tid, bar);

  int stage = 0, prev_total = 0;
  long long* stamp = a.stamps == nullptr ? nullptr : a.stamps + (size_t)team * 2;
  const size_t stamp_stride = (size_t)gridDim.x * TEAMS * 2;
  // Enter stage p with items of this team: ask L2 for its weights (they
  // stream while the team waits), then wait for the previous stage.
  auto wait_prev = [&](StagePos p) {
    if (tid == 0) prefetch_stage<FMT, S>(a, tp, p);
    if (stage > 0) team_wait(a.counters + (size_t)(stage - 1) * kCounterStride, prev_total, tid, bar);
    if (stamp != nullptr && tid == 0) stamp[stage * stamp_stride] = (long long)globaltimer_ns();
  };
  auto signal = [&](int n) {
    team_signal(a.counters + (size_t)stage * kCounterStride, n, tid, bar);
    if (stamp != nullptr && tid == 0) stamp[stage * stamp_stride + 1] = (long long)globaltimer_ns();
  };
  auto next = [&](int total) {
    prev_total = total;
    ++stage;
  };
  auto items = [&](int kind) { return tp.items + tp.first[kind]; };

  int mi = 0, si = 0;
  // The embedding rows.
  if (tp.count[kEmbed] > 0) {
    wait_prev({kEmbed, mi, si});
    for (int i = 0; i < tp.count[kEmbed]; ++i) {
      const int b = items(kEmbed)[i];
      const float* e = a.embed + (size_t)a.token[b] * d;
      for (int k = tid; k < d; k += TEAM) a.x[(size_t)b * d + k] = __ldg(e + k);
    }
    signal(tp.count[kEmbed]);
  }
  next(kind_items(a, kEmbed));

  for (int blk = 0; blk < a.n_blocks; ++blk) {
    if (!((a.slstm_mask >> blk) & 1)) {
      // mLSTM: up (+ prep and gate partials), memory, head items, down.
      if (tp.count[kMUp] > 0) {
        wait_prev({kMUp, mi, si});
        const UpHook hook{a.up, a.m_conv_w + (size_t)mi * 4 * di, a.m_conv_b + (size_t)mi * di,
                          a.conv_m + (size_t)mi * B * 3 * di, a.m_qkv_w + (size_t)mi * 12 * di, a.buf,
                          a.m_w_gate + (size_t)mi * 2 * H * 3 * di, a.gpart, B, H, di, tid, bar};
        const float* ln = a.m_ln + (size_t)mi * 2 * d;
        gemv_stage<kLayerNorm, kStore, FMT>(a.m_w_up, a.m_w_up_s, mi, d, 2 * di, a.x, a.up, ln, ln + d, nullptr, B,
                                            items(kMUp), tp.count[kMUp], tid, bar, dyn, &sm, hook);
        signal(tp.count[kMUp]);
      }
      next(kind_items(a, kMUp));

      if (tp.count[kMMem] > 0) {
        S* s_st = static_cast<S*>(a.s_m) + (size_t)mi * B * H * DK * DK;
        wait_prev({kMMem, mi, si});
        for (int i = 0; i < tp.count[kMMem]; ++i) {
          const int it = items(kMMem)[i], b = it / nrc / H, h = it / nrc % H, nch = di / XM_CHUNK;
          const float* pg = a.gpart + (size_t)b * 2 * H * nch;
          const GatePrelude gates{pg + (size_t)h * nch, pg + (size_t)(H + h) * nch, a.m_gate_b + (size_t)mi * 2 * H,
                                  a.m_m + ((size_t)mi * B + b) * H + h, sc, nch, H, h};
          xm_memory_rows<S>(a.buf, s_st, sc, a.mpart, b, h, it % nrc, H, di, tid, bar, reinterpret_cast<float*>(dyn),
                            gates);
        }
        signal(tp.count[kMMem]);
      }
      next(kind_items(a, kMMem));

      if (tp.count[kMOut] > 0) {
        wait_prev({kMOut, mi, si});
        for (int i = 0; i < tp.count[kMOut]; ++i) {
          const int bh = items(kMOut)[i];
          const float *gate_b = a.m_gate_b + (size_t)mi * 2 * H, *outnorm = a.m_outnorm + (size_t)mi * di,
                      *skip = a.m_skip + (size_t)mi * di;
          float *m_st = a.m_m + (size_t)mi * B * H, *n_st = a.n_m + (size_t)mi * B * H * DK;
          if (head_in_regs)
            xm_head_out(a.gpart, gate_b, m_st, n_st, a.buf, a.mpart, a.up, outnorm, skip, a.y, bh / H, bh % H, H, di,
                        kGroupEps, tid, bar, red, sc);
          else
            xm_head_out_wide(a.gpart, gate_b, m_st, n_st, a.buf, a.mpart, a.up, outnorm, skip, a.y, bh / H, bh % H, H,
                             di, kGroupEps, tid, bar, red, sc);
        }
        signal(tp.count[kMOut]);
      }
      next(kind_items(a, kMOut));

      if (tp.count[kMDown] > 0) {
        wait_prev({kMDown, mi, si});
        gemv_stage<kPlain, kResidual, FMT>(a.m_w_down, a.m_w_down_s, mi, di, d, a.y, a.x, nullptr, nullptr, nullptr, B,
                                           items(kMDown), tp.count[kMDown], tid, bar, dyn, &sm);
        signal(tp.count[kMDown]);
      }
      next(kind_items(a, kMDown));
      ++mi;
    } else {
      // sLSTM: prep, input gates, recurrence, group norm, FFN up, FFN down.
      if (tp.count[kSPrep] > 0) {
        wait_prev({kSPrep, mi, si});
        for (int i = 0; i < tp.count[kSPrep]; ++i) {
          const int it = items(kSPrep)[i];
          xs_prep_item(a.x, a.s_ln + (size_t)si * 2 * d, a.s_conv_w + (size_t)si * 4 * d, a.s_conv_b + (size_t)si * d,
                       a.conv_s + (size_t)si * B * 3 * d, a.xs, B, d, kLnEps, it / n_prep, it % n_prep, tid, bar,
                       red64s[team_in]);
        }
        signal(tp.count[kSPrep]);
      }
      next(kind_items(a, kSPrep));

      const int n_in = tp.count[kSIf] + tp.count[kSZo];
      if (n_in > 0) {
        wait_prev({kSIf, mi, si});
        gemv_stage<kPlain, kStore, FMT>(a.s_w_if, a.s_w_if_s, si, d, 2 * d, a.xs, a.wif, nullptr, nullptr, nullptr, B,
                                        items(kSIf), tp.count[kSIf], tid, bar, dyn, &sm);
        if (tp.count[kSIf] > 0 && tp.count[kSZo] > 0) team_sync(bar);
        gemv_stage<kPlain, kStore, FMT>(a.s_w_zo, a.s_w_zo_s, si, d, 2 * d, a.xs + (size_t)B * d, a.wzo, nullptr,
                                        nullptr, nullptr, B, items(kSZo), tp.count[kSZo], tid, bar, dyn, &sm);
        signal(n_in);
      }
      next(kind_items(a, kSIf) + kind_items(a, kSZo));

      if (tp.count[kSCell] > 0) {
        wait_prev({kSCell, mi, si});
        for (int i = 0; i < tp.count[kSCell]; ++i) {
          const int it = items(kSCell)[i];
          xs_cell_item(a.wif, a.wzo, a.s_r_w + (size_t)si * H * DH * 4 * DH, a.s_bias + (size_t)si * 4 * d,
                       a.hcnm_s + (size_t)si * 4 * B * d, a.hnew, B, H, DH, it / n_dh, it % n_dh, tid, bar, dyn);
        }
        signal(tp.count[kSCell]);
      }
      next(kind_items(a, kSCell));

      if (tp.count[kSGn] > 0) {
        wait_prev({kSGn, mi, si});
        for (int i = 0; i < tp.count[kSGn]; ++i) {
          const int bh = items(kSGn)[i];
          xs_gn_item(a.hnew, a.s_gn + (size_t)si * d, a.hcnm_s + (size_t)si * 4 * B * d, a.x, H, DH, kGroupEps,
                     bh / H, bh % H, tid, bar, red);
        }
        signal(tp.count[kSGn]);
      }
      next(kind_items(a, kSGn));

      if (tp.count[kSUp] > 0) {
        wait_prev({kSUp, mi, si});
        const float* ln = a.s_ln_ffn + (size_t)si * 2 * d;
        gemv_stage<kLayerNorm, kBiasGelu, FMT>(a.s_ffn_up, a.s_ffn_up_s, si, d, ffn, a.x, a.u, ln, ln + d,
                                               a.s_ffn_up_b + (size_t)si * ffn, B, items(kSUp), tp.count[kSUp], tid,
                                               bar, dyn, &sm);
        signal(tp.count[kSUp]);
      }
      next(kind_items(a, kSUp));

      if (tp.count[kSDown] > 0) {
        wait_prev({kSDown, mi, si});
        gemv_stage<kPlain, kBiasResidual, FMT>(a.s_ffn_down, a.s_ffn_down_s, si, ffn, d, a.u, a.x, nullptr, nullptr,
                                               a.s_ffn_down_b + (size_t)si * d, B, items(kSDown), tp.count[kSDown],
                                               tid, bar, dyn, &sm);
        signal(tp.count[kSDown]);
      }
      next(kind_items(a, kSDown));
      ++si;
    }
  }

  if (tp.count[kHead] > 0) {
    wait_prev({kHead, mi, si});
    gemv_stage<kLayerNorm, kBias, FMT>(a.lm_w, a.lm_s, 0, d, a.Vp, a.x, a.logits, a.ln_f, a.ln_f + d, a.lm_b, B,
                                       items(kHead), tp.count[kHead], tid, bar, dyn, &sm);
    signal(tp.count[kHead]);
  }
  ++stage;

  // The last block out resets the counters for the next launch.
  __syncthreads();
  if (threadIdx.x == 0) {
    int* done = a.counters + (size_t)stage * kCounterStride;
    int drawn;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;" : "=r"(drawn) : "l"(done) : "memory");
    if (drawn == (int)gridDim.x - 1) {
      for (int s = 0; s <= stage; ++s) a.counters[(size_t)s * kCounterStride] = 0;
    }
  }
}

bool step_shape_ok(const StepArgs& a, int fmt) {
  if (a.B < 1 || a.B > MAXR || a.H < 1 || a.n_blocks < 1 || a.n_blocks > 31) return false;
  if (a.d % a.H != 0 || a.di % a.H != 0) return false;
  const int DK = a.di / a.H, DH = a.d / a.H;
  // The matrix memory's items: 4 or 8 columns a thread, whole passes of the
  // team (DK <= XM_MAX_DK; the head item past 512 is xm_head_out_wide).
  if (!xm_shape_ok(DK)) return false;
  if (a.di % (4 * XM_CHUNK) != 0 || 2 * a.H * a.B > TEAM || 4 * a.B > TEAM) return false;
  if (DH % XS_UNITS != 0 || DH > XS_MAX_DH || DH % 8 != 0) return false;
  const int qg_ffn = fmt == kBf16 ? QGROUP : (a.ffn % QGROUP == 0 ? QGROUP : a.ffn);
  return gemv_shape_ok(a.B, a.d, 2 * a.di, fmt) && gemv_shape_ok(a.B, a.di, a.d, fmt) &&
         gemv_shape_ok(a.B, a.d, 2 * a.d, fmt) && gemv_shape_ok(a.B, a.d, a.ffn, fmt) &&
         gemv_shape_ok_grouped(a.B, a.ffn, a.d, fmt, qg_ffn) && gemv_shape_ok(a.B, a.d, a.Vp, fmt);
}

// Dynamic shared memory of one team: the largest of the GEMVs' sums and
// staged rows, the cell item's tile, and the matrix memory's readout sums
// (rpp x DV floats: 4 TEAM, or DV past DV = 4 TEAM).
size_t team_region(const StepArgs& a, int fmt) {
  const int DH = a.d / a.H, DK = a.di / a.H;
  const int qg = fmt == kBf16 ? 0 : QGROUP, qg_ffn = fmt == kBf16 ? 0 : (a.ffn % QGROUP == 0 ? QGROUP : a.ffn);
  size_t r = std::max({gemv_smem_bytes(a.B, a.d, qg, fmt), gemv_smem_bytes(a.B, a.di, qg, fmt),
                       gemv_smem_bytes(a.B, a.ffn, qg_ffn, fmt), (size_t)xs_cell_smem_bytes(a.B, DH),
                       (size_t)std::max(4 * TEAM, DK) * sizeof(float)});
  return (r + 127) / 128 * 128;
}

template <int FMT, typename S>
int launch_step(StepArgs& a, int* info_out, cudaStream_t stream) {
  const size_t region = team_region(a, FMT), smem = TEAMS * region;
  a.region = (int)region;
  auto kernel = xstep_kernel<FMT, S>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (a.n_grid > per_sm * mg_sm_count()) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  info_out[0] = a.n_grid;
  info_out[1] = NT;
  info_out[2] = (int)smem;
  info_out[3] = (int)attr.sharedSizeBytes;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(a.n_grid), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One xLSTM decode step in one launch. ptrs: the kNumPtrs pointers in
// StepArgs order (null for the scales of a bf16 pack); ints: n_blocks,
// slstm_mask, B, d, H, di, ffn, Vp, n_grid; fmt 0 bf16 or 1 W8A16; s_bf16 1
// for the matrix memory stored in bf16. info_out receives 4 ints: the grid,
// the threads a block, and the dynamic and static shared memory a block.
MG_EXPORT int mg_xlstm_step(const void* const* ptrs, int n_ptrs, const int* ints, int n_ints, int fmt, int s_bf16,
                            int* info_out, void* stream) {
  if (n_ptrs != kNumPtrs || n_ints != kNumInts || (fmt != kBf16 && fmt != kW8A16)) return (int)cudaErrorInvalidValue;
  StepArgs a;
  const void** dst = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  int* iv = &a.n_blocks;
  for (int i = 0; i < kNumInts; ++i) iv[i] = ints[i];
  if (!step_shape_ok(a, fmt) || a.plan == nullptr || a.counters == nullptr || a.n_grid < 1)
    return (int)cudaErrorInvalidValue;
  if (fmt != kBf16 && (a.m_w_up_s == nullptr || a.m_w_down_s == nullptr || a.s_w_if_s == nullptr ||
                       a.s_w_zo_s == nullptr || a.s_ffn_up_s == nullptr || a.s_ffn_down_s == nullptr ||
                       a.lm_s == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fmt == kBf16)
    return s_bf16 ? launch_step<kBf16, __nv_bfloat16>(a, info_out, s) : launch_step<kBf16, float>(a, info_out, s);
  return s_bf16 ? launch_step<kW8A16, __nv_bfloat16>(a, info_out, s) : launch_step<kW8A16, float>(a, info_out, s);
}
