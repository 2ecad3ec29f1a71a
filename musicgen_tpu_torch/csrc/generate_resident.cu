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
// Every work item runs the device functions of decode_ops.cuh that the
// per-token kernel chain (kernel B) runs: a GEMV tile's arithmetic
// (gemv_prologue, gemv_mma_chunk, gemv_write_sums, gemv_finish_tile),
// mixer_load / mixer_step and the tail's tail_slice_*. Only where a tile's
// weights come from, which SM computes an item and how stages wait on each
// other differ, so C and the chain compute the same bits and, with the same
// uniforms, emit the same tokens.
//
// What bounds it on an H100: the weights, streamed from HBM once a token
// (165.8 MB in bf16, 84.2 MB in int8 with its scales at full width: 49.5 /
// 25.1 us at 3.35 TB/s), and the chain of 3L + 2 dependent stages a token
// (32 at L = 10), each some microseconds of latency: a wait for the stage
// it reads, loads of activations another SM just wrote, a few products,
// the epilogue, the signal. The TPU kernel ran a sequential (token, stage)
// grid whose BlockSpec double buffers fetched stage s + 1's weights while
// stage s computed. The first port kept its stages but not that overlap,
// and took 0.32 ms a token in bf16 (0.38 in int8) on an H100 80GB HBM3 at
// 700 W; its ablation (PERF.md, section 6) put 44 us in the 32 grid.sync()
// barriers, 32 us in packing out_proj and the mixer onto 16 SMs, 29 us in
// the tail, and showed every stage several microseconds longer than its
// bytes, with 144-168 B of stack a thread spilled at 64 registers.
//
// Design: a persistent cooperative grid of one 512-thread block an SM (so
// 128 registers a thread and no spill), two 256-thread teams a block.
//  1. Spread (against the packing): the wrapper's plan
//     (ops/generate_kernel.resident_plan) hands each team its tiles and
//     mixer items, interleaved across blocks, so that a stage with fewer
//     items than teams puts one on each of that many SMs; out_proj's 64
//     tiles on 64 SMs, and the mixer's 256 items at batch 2 (a quarter of
//     a (row, head) each: 16 state rows) one a team over all 132 SMs.
//     Each team copies its part of the plan into shared memory.
//  2. A ring of weights (against the weight round trips): the whole token's
//     weight stream is known before it starts, so each team owns `slots`
//     shared-memory slots of 16 weight rows x `kch` k (a chunk: one in_proj
//     or lm_head tile, half an out_proj tile) and keeps them full with TMA
//     bulk copies (cp.async.bulk, one a row, into rows padded by 64 bytes so
//     that a quarter-warp's two rows fall on distinct banks), each slot
//     completing on its own mbarrier. When a team has finished a tile, its
//     last warp refills the tile's slots with the team's next chunks in
//     stream order (layer by layer in_proj, out_proj, then lm_head, then
//     the next token), across every stage boundary. The GEMV warps wait on
//     the slot's mbarrier (parity: the chunk's sequence number over the
//     slots) and read the weights from shared memory
//     (gemv_load_chunk_smem). The refill of a stage's last tile comes after
//     the stage's signal: the issuing warp only arrives at the signal's
//     barrier and waits for thread 0's release, so the burst of refills
//     that the whole grid issues at once stalls neither the signal's fence
//     nor the warps that go on.
//  3. Signals, not grid barriers: a stage's teams each add their item count
//     to the stage's counter (red.release.gpu after a barrier), and a team
//     that has work in a later stage waits (one thread spinning on relaxed
//     loads, one acquire fence, then a team barrier) only for the stage it
//     reads: in_proj(l) on out_proj(l - 1) (or the picks, at l = 0), the
//     mixer on in_proj, out_proj on the mixer, the head on the last
//     out_proj, the tail on the head. A team with nothing to do in a stage
//     does not wait for it. The counters only grow: stage s of token t waits
//     for (t + 1) x its items.
//  4. L2 prefetch (against the misses the weight stream causes: 166 MB a
//     token through a 50 MB L2 evicts every constant and state between two
//     uses): when a team reaches a stage, one thread prefetches
//     (cp.async.bulk.prefetch.L2) what its next stage reads besides weights.
//  5. The tail spread over the SMs: each of a row's 64 one-warp slices
//     (decode_ops.cuh, the functions of kernel B's cluster tail, so the two
//     give the same bits) runs on a warp of its own SM, first team first
//     (tail_slice_item): it waits for the head, loads its 280 logits,
//     grammar values and counts, publishes its (m_s, s_s), polls the row's
//     64 pairs, forms its weights and top-3 and publishes the list; slice
//     0's warp polls the row's 64 lists, merges them and picks. The pairs
//     and lists are 64-bit words that carry the token's tag, so a handoff is
//     a store and a poll, with no fence, counter or second load. The pick
//     loads what it reads besides the candidates while the lists arrive
//     (pick_ahead) and moves the window's counts by integer reds, so after
//     the merge only the embedding row is loaded before the signal. On one
//     block a row the tail was issue-bound (a full-precision exp a real id)
//     and its logits took Vp f32 of every block's shared memory; spread, a
//     slice is some hundreds of instructions a lane, and the ring has that
//     memory.
//
// Shared memory a block (the wrapper's plan computes the same budget):
//   region   2 teams x gemv_smem_bytes of the larger K: 20,736 B in bf16
//            at batch 2 (20,608 in W8A16, 12,544 in W8A8);
//   ring     2 teams x slots x 16 rows x (kch x esz + 64): kch = 1024,
//            33,792 B a slot in bf16 and 17,408 in int8; 3 slots a team in
//            bf16 (202,752 B), 5 in W8A16 (174,080 B), 6 in W8A8 (208,896 B);
//   static   the teams' GemvSmem, plans and copy cursors, the mbarriers;
// at most 227 KB (232,448 B) an SM (ops/generate_kernel.resident_plan
// computes the slots).
//
// On an H100 80GB HBM3 at 700 W this design took 0.196 ms a token in bf16
// and 0.225-0.228 in int8 with the tail on one block a row (the first
// port's: 0.319 / 0.376-0.380 in the same run), and takes 0.185-0.187 in
// bf16 and 0.216-0.220 in int8 with the tail spread.
// What still holds it back (PERF.md, section 6): each layer's three stages take
// about 14 us where their bytes need 3.9 us: a wait for the producers'
// signals, activations from L2, a few products and an epilogue, each some
// hundreds of nanoseconds to microseconds under the weight stream's load;
// the head streams 36.7 MB through the teams' slots; the tail is two
// exchanges through L2 behind counters.
//
// The states (conv and SSM, 1 MB and 10.5 MB at batch 2), the window counts,
// the ring of the window, the activations and the logits stay in device
// memory, updated in place. The launch never falls back: if the grid cannot
// be co-resident or the plan does not fit, the error is returned and the
// wrapper raises.
#include <algorithm>

#include "grid_sync.cuh"

using namespace mg;

namespace {

constexpr int NT = 512;                    // threads of a block: 2 teams
constexpr int TEAMS = NT / TEAM;
constexpr int kIssuer = TEAM - 32;         // first thread of the warp that issues a team's copies
constexpr int MAX_SLOTS = 8;               // ring slots a GEMV team may have
constexpr int SLOT_PAD = 64;               // bytes after each weight row of a slot
constexpr int ROW_ALIGN = 128;
constexpr int kKinds = 4;                  // the plan's work kinds
constexpr int MAX_TEAM_ITEMS = 32;         // items of all kinds a team may have (the plan checks it)
enum { kIn = 0, kMix = 1, kOut = 2, kHead = 3 };
constexpr int kCounterStride = 32;         // ints between two stages' counters (one 128-byte line each)
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
  // schedule
  const int* plan;             // per team: kKinds x (start, count), then the item lists
  int* counters;               // (3L + 2) x kCounterStride, then the tail's exchange (B x 64 x 5
                               // u64), all zero at launch
  int L, B, d_model, d_inner, nheads, headdim, d_state, conv_dim, d_in_proj, Vp, V;
  int dyn_start, length_start, time_start, tempo_start, ring, window_ticks, n_tokens, greedy;
  int kch, slots, n_blocks;
  // set by the launch
  int team_bytes;              // dynamic shared memory of one GEMV team's sums and staged rows
  int region_bytes;            // the GEMV teams' regions
  int slot_row;                // bytes of a weight row in a slot
};
constexpr int kNumPtrs = 34;
constexpr int kNumInts = 22;

__device__ __forceinline__ int bucket_of(const ResidentArgs& a, int64_t tok) {
  return (tok >= a.dyn_start) + (tok >= a.length_start) + (tok >= a.time_start) +
         (tok >= a.tempo_start);
}

// ---------------------------------------------------------------------------
// The named barriers of a team's signal (grid_sync.cuh has the counters'
// primitives) and the mbarriers of the ring.
// ---------------------------------------------------------------------------

// A team's signal barrier (named barrier TEAMS + bar, used for nothing
// else): the issuing warp only arrives at it (bar.arrive), so it must be
// another barrier than the team's own, which that warp may reach again
// before the others have passed this one.
__device__ __forceinline__ void signal_arrive(int bar) { named_arrive(TEAMS + bar, TEAM); }

__device__ __forceinline__ void signal_sync(int bar) { named_sync(TEAMS + bar, TEAM); }

// Warp 0 tells the issuing warp that the signal is out (named barrier
// 2 TEAMS + bar, of those two warps).
__device__ __forceinline__ void released_arrive(int bar) { named_arrive(2 * TEAMS + bar, 64); }

__device__ __forceinline__ void released_sync(int bar) { named_sync(2 * TEAMS + bar, 64); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT_%=:\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "\t@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// The plan and a GEMV team's weight stream.
// ---------------------------------------------------------------------------

// A team's part of the plan, copied into shared memory at the start: each
// kind's count and first item in `items`.
struct TeamPlan {
  int count[kKinds], first[kKinds];
  int items[MAX_TEAM_ITEMS];
};

__device__ void load_team_plan(const ResidentArgs& a, int team, TeamPlan& tp, int tid, int bar) {
  const int* h = a.plan + (size_t)team * 2 * kKinds;
  if (tid < kKinds) {
    int first = 0;
    for (int k = 0; k < tid; ++k) first += __ldg(h + 2 * k + 1);
    tp.count[tid] = __ldg(h + 2 * tid + 1);
    tp.first[tid] = first;
    for (int i = 0; i < tp.count[tid]; ++i) tp.items[first + i] = __ldg(a.plan + __ldg(h + 2 * tid) + i);
  }
  team_sync(bar);
}

__device__ __forceinline__ const int* plan_items(const TeamPlan& tp, int kind) { return tp.items + tp.first[kind]; }
__device__ __forceinline__ int plan_count(const TeamPlan& tp, int kind) { return tp.count[kind]; }

// The matrix of a GEMV kind at layer l: weights, N and K.
struct Mat {
  const char* w;
  int N, K;
};

template <int FMT>
__device__ __forceinline__ Mat mat_of(const ResidentArgs& a, int kind, int l) {
  constexpr int ESZ = FMT == kBf16 ? 2 : 1;
  if (kind == kIn)
    return {static_cast<const char*>(a.w_in) + (size_t)l * a.d_in_proj * a.d_model * ESZ, a.d_in_proj, a.d_model};
  if (kind == kOut)
    return {static_cast<const char*>(a.w_out) + (size_t)l * a.d_model * a.d_inner * ESZ, a.d_model, a.d_inner};
  return {static_cast<const char*>(a.lm_w), a.Vp, a.d_model};
}

__device__ __forceinline__ int chunks_of(const ResidentArgs& a, int K) { return (K + a.kch - 1) / a.kch; }

// Where a GEMV team's copies stand in its stream: chunk c of item idx of
// kind at layer l, and how many chunks are issued of `total`.
struct Cursor {
  int l, kind, idx, c, issued, total;
};

// Past the kinds in which the team has no item (or no item left), in stream
// order: (in, out) for each layer, then head, then the next token.
__device__ void cursor_skip_empty(const ResidentArgs& a, Cursor& cu, const TeamPlan& tp) {
  while (cu.issued < cu.total && cu.idx >= plan_count(tp, cu.kind)) {
    cu.idx = 0;
    if (cu.kind == kIn) {
      cu.kind = kOut;
    } else if (cu.kind == kOut) {
      if (cu.l + 1 < a.L) {
        cu.l += 1;
        cu.kind = kIn;
      } else {
        cu.kind = kHead;
      }
    } else {
      cu.l = 0;
      cu.kind = kIn;
    }
  }
}

// The last warp of a GEMV team (not one of the epilogue's) issues its next
// `n` chunks (each into slot issued % slots): lane 0 arms the slot's
// mbarrier with the chunk's bytes, lanes 0..15 copy one weight row each.
template <int FMT>
__device__ void ring_issue(const ResidentArgs& a, Cursor& shared_cu, const TeamPlan& tp, uint32_t ring, uint32_t full,
                           int n, int lane) {
  constexpr int ESZ = FMT == kBf16 ? 2 : 1;
  Cursor cu = shared_cu;
  for (int i = 0; i < n && cu.issued < cu.total; ++i) {
    const Mat m = mat_of<FMT>(a, cu.kind, cu.l);
    const int n0 = plan_items(tp, cu.kind)[cu.idx] * TILE_N, k0 = cu.c * a.kch;
    const int rows = min(TILE_N, m.N - n0), width = min(a.kch, m.K - k0);
    const int slot = cu.issued % a.slots;
    const uint32_t dst = ring + (uint32_t)slot * TILE_N * a.slot_row, bar = full + 8u * slot;
    if (lane == 0) {
      // The slot's last reads (generic proxy) come before the copy's writes.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(bar, (uint32_t)(rows * width * ESZ));
    }
    __syncwarp();
    if (lane < rows)
      bulk_copy(dst + (uint32_t)lane * a.slot_row, m.w + ((size_t)(n0 + lane) * m.K + k0) * ESZ,
                (uint32_t)(width * ESZ), bar);
    cu.issued += 1;
    cu.c += 1;
    if (cu.c == chunks_of(a, m.K)) {
      cu.c = 0;
      cu.idx += 1;
      cursor_skip_empty(a, cu, tp);
    }
  }
  __syncwarp();
  if (lane == 0) shared_cu = cu;
  __syncwarp();
}

// ---------------------------------------------------------------------------
// L2 prefetch of what a team's next stage reads besides its weights: the
// layer's constants and the states its items update, which the weight
// stream (166 MB a token in bf16) has evicted from the 50 MB L2 since the
// previous token, so that each would cost a dependent HBM round trip under
// full load. One thread issues them when the team reaches a stage, for the
// stage after it. They are hints: a range is cut inward to whole 16-byte
// units.
// ---------------------------------------------------------------------------

// Columns [c0, c1) of each of `rows` rows of `ld` floats from p.
__device__ __forceinline__ void prefetch_cols(const float* p, int rows, int ld, int c0, int c1) {
  for (int r = 0; r < rows; ++r) prefetch_l2(p + (size_t)r * ld + c0, (size_t)(c1 - c0) * sizeof(float));
}

// The int8 group scales (G, N) of columns [n0, n0 + 16).
__device__ __forceinline__ void prefetch_scales(const float* w_s, int G, int N, int n0) {
  if (w_s != nullptr) prefetch_cols(w_s, G, N, n0, min(n0 + TILE_N, N));
}

template <int FMT>
__device__ void prefetch_stage(const ResidentArgs& a, const TeamPlan& tp, int kind, int l) {
  const int di = a.d_inner, dc = a.conv_dim, nh = a.nheads;
  const int n = plan_count(tp, kind);
  const int* items = plan_items(tp, kind);
  for (int i = 0; i < n; ++i) {
    const int it = items[i];
    if (kind == kIn) {
      const int n0 = it * TILE_N, n1 = min(n0 + TILE_N, a.d_in_proj);
      if (FMT != kBf16) prefetch_scales(a.w_in_s + (size_t)l * (a.d_model / QGROUP) * a.d_in_proj, a.d_model / QGROUP,
                                        a.d_in_proj, n0);
      const int c0 = max(n0, di) - di, c1 = min(n1, di + dc) - di;
      if (c0 < c1) {
        prefetch_cols(a.conv_w + (size_t)l * 4 * dc, 4, dc, c0, c1);
        prefetch_cols(a.conv_b + (size_t)l * dc, 1, dc, c0, c1);
        prefetch_cols(a.conv + (size_t)l * a.B * 3 * dc, a.B * 3, dc, c0, c1);
      }
      const int h0 = max(n0, di + dc) - di - dc, h1 = min(n1, di + dc + nh) - di - dc;
      if (h0 < h1) prefetch_cols(a.dt_bias + (size_t)l * nh, 1, nh, h0, h1);
    } else if (kind == kMix) {
      // The item's 16 state rows (every batch row's columns): contiguous.
      prefetch_l2(a.ssm + ((size_t)l * di + (size_t)mixer_ch0(it, nh)) * a.B * a.d_state,
                  (size_t)(MIX_P / MIX_Q) * a.B * a.d_state * sizeof(float));
    } else if (kind == kOut) {
      if (i == 0) prefetch_l2(a.norm_w + (size_t)l * di, (size_t)di * sizeof(float));
      if (FMT != kBf16) prefetch_scales(a.w_out_s + (size_t)l * (di / QGROUP) * a.d_model, di / QGROUP, a.d_model,
                                        it * TILE_N);
    } else {
      if (i == 0) {
        prefetch_l2(a.ln_w, (size_t)a.d_model * sizeof(float));
        prefetch_l2(a.ln_b, (size_t)a.d_model * sizeof(float));
      }
      prefetch_cols(a.lm_b, 1, a.Vp, it * TILE_N, min(it * TILE_N + TILE_N, a.Vp));
      if (FMT != kBf16) prefetch_scales(a.lm_s, a.d_model / QGROUP, a.Vp, it * TILE_N);
    }
  }
}

// The team's stage after (kind, l) in its order (in, mix, out for each layer,
// then head, then the next token's), and its prefetch.
template <int FMT>
__device__ void prefetch_next(const ResidentArgs& a, const TeamPlan& tp, int kind, int l) {
  for (int step = 0; step < 3 * a.L + 1; ++step) {
    if (kind == kHead) {
      kind = kIn;
      l = 0;
    } else if (kind == kIn) {
      kind = kMix;
    } else if (kind == kMix) {
      kind = kOut;
    } else if (l + 1 < a.L) {
      kind = kIn;
      l += 1;
    } else {
      kind = kHead;
    }
    if (plan_count(tp, kind) > 0) {
      prefetch_stage<FMT>(a, tp, kind, l);
      return;
    }
  }
}

// A GEMV team's tiles of one stage, their weights from the ring. The
// prologue, the products, the sums and the epilogue are gemv_team's (the same
// functions); chunk c of a tile is the team's chunk cseq + c of its stream.
// The refill of the last tile's slots is left to ring_signal, after the
// stage's signal.
template <int PRO, int EPI, int FMT>
__device__ void ring_gemv(const ResidentArgs& ra, const GemvArgs& a, GemvSmem& sm, const TeamPlan& tp, int kind,
                          int tid, int bar, char* dyn, uint32_t ring, uint32_t full, int& cseq, Cursor& cu) {
  constexpr int KC = gemv_kchunk<FMT>(), WV = gemv_wv<FMT>(), ESZ = FMT == kBf16 ? 2 : 1;
  const GemvGeom q = gemv_geom<FMT>(a, tid);
  uint32_t* sums = reinterpret_cast<uint32_t*>(dyn);
  char* xs = dyn + gemv_sums_bytes(a.R, q.G);
  gemv_prologue<PRO, FMT>(a, sm, xs, tid, bar);

  const char* xrow = xs + (size_t)q.gq * q.ld;  // this lane's row of x: the mma's column gq
  const int n_ch = chunks_of(ra, a.K), row = ra.slot_row;
  uint4 wa[KC][WV], wb[KC][WV];
  const int* tiles = plan_items(tp, kind);
  const int n_tiles = plan_count(tp, kind);
  int buf = 0;
  for (int i = 0; i < n_tiles; ++i, buf ^= 1) {
    const int n0 = tiles[i] * TILE_N;
    const bool oka = FMT != kBf16 || n0 + q.gq < a.N, okb = FMT != kBf16 || n0 + q.gq + 8 < a.N;
    uint32_t* tsums = sums + (size_t)buf * q.slots * TILE_N * a.R;
    int waited = -1;
    for (int g = q.g0; g < q.G; g += q.gstep) {
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
      int ci[4] = {0, 0, 0, 0};
      for (int s = q.s0; s < q.SG; s += KC * q.sstep) {
        const int kk = g * q.gsz + s * KSTEP, c = kk / ra.kch, seq = cseq + c, slot = seq % ra.slots;
        if (c != waited) {
          mbar_wait(full + 8u * slot, (uint32_t)((seq / ra.slots) & 1));
          waited = c;
        }
        const uint32_t sa =
            ring + (uint32_t)(slot * TILE_N + q.gq) * row + (uint32_t)((kk - c * ra.kch + q.lk) * ESZ);
        gemv_load_chunk_smem<FMT>(wa, wb, sa, sa + 8 * row, oka, okb, s, q.sstep, q.SG, q.krem);
        gemv_mma_chunk<FMT>(cf, ci, wa, wb, xrow, g, s, q, a.R);
      }
      gemv_write_sums<FMT>(tsums, cf, ci, g, q, a.R);
    }
    team_sync(bar);
    // The tile's slots are free: the last warp refills them with the stream's
    // next chunks while the epilogue's threads (tid < 16 R) store.
    if (tid >= kIssuer && i + 1 < n_tiles) ring_issue<FMT>(ra, cu, tp, ring, full, n_ch, tid - kIssuer);
    cseq += n_ch;
    gemv_finish_tile<EPI, FMT>(a, sm, tsums, n0, tid, q);
  }
}

// What pick t of row b reads besides its candidates, loaded ahead (no load
// depends on the token): its two uniforms, the window's meta (start, head,
// tick sum) in every lane, and in lane l < kAhead the ring entry start + l
// if it is older than head. The pick then issues no load but the embedding
// row's.
constexpr int kAhead = 8;

struct PickAhead {
  float u_k, u_p;
  int start, head, wsum;
  int e_tok, e_c;  // lane l's ring entry start + l
};

__device__ __forceinline__ PickAhead pick_ahead(const ResidentArgs& a, int b, int t, int lane) {
  const int* m = a.meta + b * 3;
  PickAhead w;
  w.u_k = a.greedy ? 0.f : __ldg(a.uniforms + ((size_t)t * a.B + b) * 2);
  w.u_p = a.greedy ? 0.f : __ldg(a.uniforms + ((size_t)t * a.B + b) * 2 + 1);
  w.start = m[0];
  w.head = m[1];
  w.wsum = m[2];
  w.e_tok = 0;
  w.e_c = 0;
  const int e = w.start + lane;
  if (lane < kAhead && e < w.head) {
    w.e_tok = a.ring_tok[(size_t)b * a.ring + e % a.ring];
    w.e_c = a.ring_c[(size_t)b * a.ring + e % a.ring];
  }
  return w;
}

// Pick token t of row b from its candidates `cand` (prev: the token it
// consumed last; w: pick_ahead's loads), emit it, push it into the window
// (sample/sampler.push_token), gather its embedding row into x[b] and
// signal the tail's counter. One warp: lane 0 picks; the window's
// evictions are a prefix of the entries ahead (each removes a count from
// the tick sum, so the test wsum - ticks before it >= window_ticks can only
// turn false), found by a scan over the lanes, lane 0 going on one entry at
// a time past kAhead; the counts move by integer reds (exact in any order);
// every lane gathers a part of the row (float4, d_model % 64 == 0 by
// resident_shape_ok).
__device__ void pick_push_embed(const ResidentArgs& a, int b, int t, int64_t prev, const Top3& cand,
                                const PickAhead& w, int* c_tail) {
  const int lane = threadIdx.x % 32;
  int tok = 0;
  if (lane == 0) {
    if (a.greedy) {
      tok = cand.i[0];
    } else {
      // sample/sampler._sample_k tables as P(k=1), P(k=2) per field bucket.
      const int bucket = bucket_of(a, prev);
      const float u_k = w.u_k, u_p = w.u_p;
      const float p1 = bucket == 4 ? 0.6f : (bucket <= 1 ? 0.5f : 1.0f);
      const float p2 = bucket == 0 ? 0.5f : (bucket == 4 ? 0.4f : 0.0f);
      const int k = 1 + (u_k >= p1) + (u_k >= p1 + p2);
      const float v0 = cand.v[0];
      const float v1 = k >= 2 ? cand.v[1] : 0.f;
      const float v2 = k >= 3 ? cand.v[2] : 0.f;
      const float r = u_p * (v0 + v1 + v2);
      const int choice = (r >= v0) + (r >= v0 + v1);
      tok = cand.i[choice];
    }
    a.last[b] = tok;
    a.tokens[(size_t)b * a.n_tokens + t] = tok;
  }
  tok = __shfl_sync(0xffffffffu, tok, 0);
  constexpr int U = 8;
  const float4* erow = reinterpret_cast<const float4*>(a.embed + (size_t)tok * a.d_model);
  float4* xrow = reinterpret_cast<float4*>(a.x + (size_t)b * a.d_model);
  for (int base = lane; base < a.d_model / 4; base += U * 32) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = base + u * 32 < a.d_model / 4 ? __ldg(erow + base + u * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * 32 < a.d_model / 4) xrow[base + u * 32] = v[u];
  }

  // The push: the token into the ring at head, its count up, then the
  // evictions while the tick sum is >= window_ticks and start <= head.
  int* hist = a.hist + (size_t)b * a.V;
  int* rt = a.ring_tok + (size_t)b * a.ring;
  int* rc = a.ring_c + (size_t)b * a.ring;
  const int c_new = (tok >= a.time_start && tok < a.tempo_start) ? tok - a.time_start : 0;
  const int wsum = w.wsum + c_new;
  const int e = w.start + lane;
  const int e_tok = e == w.head ? tok : w.e_tok, e_c = e == w.head ? c_new : w.e_c;
  int incl = lane < kAhead ? e_c : 0;  // ticks of the entries ahead up to this lane's
#pragma unroll
  for (int o = 1; o < kAhead; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const bool evict = lane < kAhead && e <= w.head && wsum - (incl - e_c) >= a.window_ticks;
  if (evict) red_add(hist + e_tok, -1);
  const int n = __popc(__ballot_sync(0xffffffffu, evict));
  const int ticks = __shfl_sync(0xffffffffu, incl, n > 0 ? n - 1 : 0);
  if (lane == 0) {
    rt[w.head % a.ring] = tok;
    rc[w.head % a.ring] = c_new;
    red_add(hist + tok, 1);
    int start = w.start + n, ws = wsum - (n > 0 ? ticks : 0);
    // The window never starts past its newest token; the bound only guards
    // against an inconsistent window handed in by the caller.
    while (n == kAhead && ws >= a.window_ticks && start <= w.head) {
      const int s = start % a.ring;
      red_add(hist + rt[s], -1);
      ws -= rc[s];
      start += 1;
    }
    int* m = a.meta + b * 3;
    m[0] = start;
    m[1] = w.head + 1;
    m[2] = ws;
  }
  __syncwarp();
  if (lane == 0) red_release_add(c_tail, 1);
}

// Where the tail of token t exchanges its slices, per row b: the 64
// slices' (m_s, s_s) and lists in 64-bit words that carry a tag of the
// token, written and polled with no fence and no counter (a reader that
// sees a word's tag sees its value). The next token's slices overwrite them
// only after its head, which follows every pick of this token.
struct TailExchange {
  uint64_t* pairs;  // (B, TAIL_S, 2): (tag t + 1, the f32 bits of m_s), (tag, s_s)
  uint64_t* lists;  // (B, TAIL_S, 3): each (value bits, id, tag): see tail_entry
};

// A list entry: the value's 32 bits, the id in 15 bits (an empty entry's
// 0x7fffffff as kNoId, above every id of a row the slices cover), the
// token's tag in 17 bits.
constexpr uint32_t kNoId = 0x7fff;
constexpr uint32_t kTagMask = 0x1ffff;
static_assert(TAIL_S * TAIL_LANES * TAIL_EMAX < (int)kNoId, "a list entry holds every id in 15 bits");

__device__ __forceinline__ uint64_t tail_entry(float v, int i, uint32_t tag) {
  const uint32_t id = i == 0x7fffffff ? kNoId : (uint32_t)i;
  return ((uint64_t)(tag & kTagMask) << 47) | ((uint64_t)id << 32) | __float_as_uint(v);
}

// Polls the three entries of each of two slices' lists until all six carry
// `tag`, in every lane of the warp; unpacks them.
__device__ __forceinline__ void tail_poll_lists(const uint64_t* lo_p, const uint64_t* hi_p, uint32_t tag, Top3& lo,
                                                Top3& hi) {
  uint64_t w[6];
  bool ok;
  do {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k] = ld_relaxed_u64(lo_p + k);
      w[3 + k] = ld_relaxed_u64(hi_p + k);
    }
    ok = true;
#pragma unroll
    for (int k = 0; k < 6; ++k) ok = ok && (uint32_t)(w[k] >> 47) == (tag & kTagMask);
  } while (!__all_sync(0xffffffffu, ok));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t il = (uint32_t)(w[k] >> 32) & kNoId, ih = (uint32_t)(w[3 + k] >> 32) & kNoId;
    lo.v[k] = __uint_as_float((uint32_t)w[k]);
    lo.i[k] = il == kNoId ? 0x7fffffff : (int)il;
    hi.v[k] = __uint_as_float((uint32_t)w[3 + k]);
    hi.i[k] = ih == kNoId ? 0x7fffffff : (int)ih;
  }
}

// Slice s of row b of token t's tail, on one warp (any SM): wait for the
// head's logits, load the slice, publish its (m_s, s_s), poll the row's 64
// pairs, form lse, the weights and the slice's top-3 and publish the list.
// Slice 0's warp then loads the row's window ahead, polls the row's 64
// lists, merges them (decode_ops.cuh, the functions and bits of kernel B's
// cluster tail) and picks token t + 1 of the row.
__device__ void tail_slice_item(const ResidentArgs& a, const TailExchange& ex, int b, int s, int t,
                                const int* c_head, int head_target, int* c_tail) {
  const int lane = threadIdx.x % 32;
  const uint32_t tag = (uint32_t)t + 1;
  uint64_t* pairs = ex.pairs + (size_t)b * TAIL_S * 2;
  uint64_t* lists = ex.lists + (size_t)b * TAIL_S * 3;
  if (lane == 0) spin_until(c_head, head_target);
  __syncwarp();
  const int64_t prev = a.last[b];
  TailSlice sl;
  tail_slice_load(sl, a.logits + (size_t)b * a.Vp, a.gram + (size_t)bucket_of(a, prev) * a.Vp,
                  a.hist + (size_t)b * a.V, a.Vp, a.V, s, lane);
  float ms, ss;
  tail_slice_pair(sl, ms, ss);
  if (lane == 0) {
    st_relaxed_u64(pairs + 2 * s, ((uint64_t)tag << 32) | __float_as_uint(ms));
    st_relaxed_u64(pairs + 2 * s + 1, ((uint64_t)tag << 32) | __float_as_uint(ss));
  }
  uint64_t pw[4];
  bool ok;
  do {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      pw[k] = ld_relaxed_u64(pairs + 2 * lane + k);
      pw[2 + k] = ld_relaxed_u64(pairs + 2 * (lane + 32) + k);
    }
    ok = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) ok = ok && (uint32_t)(pw[k] >> 32) == tag;
  } while (!__all_sync(0xffffffffu, ok));
  const float lse = tail_lse(__uint_as_float((uint32_t)pw[0]), __uint_as_float((uint32_t)pw[1]),
                             __uint_as_float((uint32_t)pw[2]), __uint_as_float((uint32_t)pw[3]));
  Top3 top;
  tail_slice_top3(sl, a.V, lse, a.dyn_start, a.length_start, top);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) st_relaxed_u64(lists + 3 * s + k, tail_entry(top.v[k], top.i[k], tag));
  }
  if (s != 0) return;
  const PickAhead w = pick_ahead(a, b, t + 1, lane);
  Top3 lo, hi;
  tail_poll_lists(lists + 3 * lane, lists + 3 * (lane + 32), tag, lo, hi);
  top3_rows(top, lo, hi);
  pick_push_embed(a, b, t + 1, prev, top, w, c_tail);
}

// The end of a GEMV stage: the team's signal, then the refill of its last
// tile's `n_ch` slots. The issuing warp arrives at the signal's barrier
// without waiting, and issues once thread 0's release is out: a copy the TMA
// unit cannot take yet (the whole grid refills at once after in_proj)
// stalls that warp alone, and the release's fence does not queue behind the
// refill's reads.
template <int FMT>
__device__ void ring_signal(const ResidentArgs& a, int* ctr, int n, int tid, int bar, Cursor& cu, const TeamPlan& tp,
                            uint32_t ring, uint32_t full, int n_ch) {
  if (tid >= kIssuer) {
    signal_arrive(bar);
    released_sync(bar);
    ring_issue<FMT>(a, cu, tp, ring, full, n_ch, tid - kIssuer);
  } else {
    signal_sync(bar);
    if (tid == 0) red_release_add(ctr, n);
    if (tid < 32) released_arrive(bar);
  }
}

template <int FMT>
__global__ void __launch_bounds__(NT, 1) generate_kernel(ResidentArgs a) {
  // Dynamic shared memory: [region: each GEMV team's sums and staged
  // activations][ring: each GEMV team's slots].
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  __shared__ GemvSmem gsm[TEAMS];
  __shared__ __align__(8) uint64_t full_bars[TEAMS][MAX_SLOTS];
  __shared__ Cursor cursors[TEAMS];
  __shared__ TeamPlan plans[TEAMS];

  const int team_in = threadIdx.x / TEAM, tid = threadIdx.x % TEAM, bar = 1 + team_in;
  const int team = blockIdx.x * TEAMS + team_in;
  const int L = a.L, di = a.d_inner, dip = a.d_in_proj, nh = a.nheads;
  int* c_in = a.counters;
  int* c_mix = a.counters + (size_t)L * kCounterStride;
  int* c_out = a.counters + (size_t)2 * L * kCounterStride;
  int* c_head = a.counters + (size_t)3 * L * kCounterStride;
  int* c_tail = a.counters + (size_t)(3 * L + 1) * kCounterStride;
  TailExchange ex;
  ex.pairs = reinterpret_cast<uint64_t*>(a.counters + (size_t)(3 * L + 2) * kCounterStride);
  ex.lists = ex.pairs + (size_t)a.B * TAIL_S * 2;
  // This warp's slice of each token's tail, if any: slice q is warp q / (TEAMS
  // n_blocks) of team (q / n_blocks) % TEAMS of block q % n_blocks, so the
  // slices go to as many SMs as there are, first team first.
  const int tail_q = (tid / 32) * TEAMS * a.n_blocks + team_in * a.n_blocks + blockIdx.x;
  const int n_in = gemv_tiles(dip), n_out = gemv_tiles(a.d_model), n_head = gemv_tiles(a.Vp), n_mix = a.B * nh * MIX_Q;

  GemvSmem& sm = gsm[team_in];
  char* dyn = reinterpret_cast<char*>(dyn_smem) + (size_t)team_in * a.team_bytes;
  const uint32_t ring = smem_u32(dyn_smem + a.region_bytes) + (uint32_t)team_in * a.slots * TILE_N * a.slot_row;
  const uint32_t full = smem_u32(&full_bars[team_in][0]);  // slot s's mbarrier at full + 8 s
  Cursor& cu = cursors[team_in];
  TeamPlan& tp = plans[team_in];
  int cseq = 0;  // chunks of the stream this team has consumed

  load_team_plan(a, team, tp, tid, bar);
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) mbar_init(full + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int per_token = a.L * (plan_count(tp, kIn) * chunks_of(a, a.d_model) +
                                 plan_count(tp, kOut) * chunks_of(a, di)) +
                          plan_count(tp, kHead) * chunks_of(a, a.d_model);
    cu = {0, kIn, 0, 0, 0, per_token * a.n_tokens};
    cursor_skip_empty(a, cu, tp);
  }
  __syncthreads();
  if (tid >= kIssuer) ring_issue<FMT>(a, cu, tp, ring, full, a.slots, tid - kIssuer);
  if (blockIdx.x < a.B && threadIdx.x < 32) {
    Top3 cand;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cand.v[k] = a.cand_v[blockIdx.x * 3 + k];
      cand.i[k] = (int)a.cand_i[blockIdx.x * 3 + k];
    }
    pick_push_embed(a, blockIdx.x, 0, a.last[blockIdx.x], cand, pick_ahead(a, blockIdx.x, 0, threadIdx.x), c_tail);
  }

  for (int t = 0; t < a.n_tokens; ++t) {
    for (int l = 0; l < L; ++l) {
      if (plan_count(tp, kIn) > 0) {
        GemvArgs in = {};
        const Mat m = mat_of<FMT>(a, kIn, l);
        in.x = a.x;
        in.w = m.w;
        in.w_s = FMT == kBf16 ? nullptr : a.w_in_s + (size_t)l * (a.d_model / QGROUP) * dip;
        in.out = a.zx;
        in.R = a.B; in.K = a.d_model; in.N = dip;
        in.di = di; in.dc = a.conv_dim; in.nh = nh;
        in.conv_w = a.conv_w + (size_t)l * 4 * a.conv_dim;
        in.conv_b = a.conv_b + (size_t)l * a.conv_dim;
        in.dt_bias = a.dt_bias + (size_t)l * nh;
        in.conv_state = a.conv + (size_t)l * a.B * 3 * a.conv_dim;
        if (tid == 0) prefetch_next<FMT>(a, tp, kIn, l);
        if (l == 0)
          team_wait(c_tail, a.B * (t + 1), tid, bar);
        else
          team_wait(c_out + (size_t)(l - 1) * kCounterStride, n_out * (t + 1), tid, bar);
        ring_gemv<kPlain, kInProj, FMT>(a, in, sm, tp, kIn, tid, bar, dyn, ring, full, cseq, cu);
        ring_signal<FMT>(a, c_in + (size_t)l * kCounterStride, plan_count(tp, kIn), tid, bar, cu, tp, ring, full,
                         chunks_of(a, a.d_model));
      }

      const int n_my_mix = plan_count(tp, kMix);
      if (n_my_mix > 0) {
        if (tid == 0) prefetch_next<FMT>(a, tp, kMix, l);
        float* ssm = a.ssm + (size_t)l * di * a.B * a.d_state;
        const float *a_hl = a.a_h + (size_t)l * nh, *d_hl = a.d_h + (size_t)l * nh;
        const int* mix = plan_items(tp, kMix);
        // The first item's state rows are this team's own, written by it a
        // token ago: they load while in_proj finishes, as in kernel B.
        MixerLoad m;
        mixer_load(m, a_hl, d_hl, ssm, a.B, nh, mix[0], tid);
        team_wait(c_in + (size_t)l * kCounterStride, n_in * (t + 1), tid, bar);
        for (int i = 0; i < n_my_mix; ++i) {
          if (i > 0) mixer_load(m, a_hl, d_hl, ssm, a.B, nh, mix[i], tid);
          mixer_step(m, a.zx, dip, di, nh, ssm, a.g, a.B, mix[i], tid);
        }
        team_signal(c_mix + (size_t)l * kCounterStride, n_my_mix, tid, bar);
      }

      if (plan_count(tp, kOut) > 0) {
        GemvArgs out = {};
        const Mat m = mat_of<FMT>(a, kOut, l);
        out.x = a.g;
        out.w = m.w;
        out.w_s = FMT == kBf16 ? nullptr : a.w_out_s + (size_t)l * (di / QGROUP) * a.d_model;
        out.out = a.x;
        out.R = a.B; out.K = di; out.N = a.d_model;
        out.pw = a.norm_w + (size_t)l * di;
        out.eps = kRmsEps;
        if (tid == 0) prefetch_next<FMT>(a, tp, kOut, l);
        team_wait(c_mix + (size_t)l * kCounterStride, n_mix * (t + 1), tid, bar);
        ring_gemv<kRms, kStore, FMT>(a, out, sm, tp, kOut, tid, bar, dyn, ring, full, cseq, cu);
        ring_signal<FMT>(a, c_out + (size_t)l * kCounterStride, plan_count(tp, kOut), tid, bar, cu, tp, ring, full,
                         chunks_of(a, di));
      }
    }

    if (plan_count(tp, kHead) > 0) {
      GemvArgs head = {};
      head.x = a.x;
      head.w = a.lm_w;
      head.w_s = FMT == kBf16 ? nullptr : a.lm_s;
      head.out = a.logits;
      head.R = a.B; head.K = a.d_model; head.N = a.Vp;
      head.pw = a.ln_w; head.pb = a.ln_b; head.eps = kLnEps; head.bias = a.lm_b;
      if (tid == 0) prefetch_next<FMT>(a, tp, kHead, L - 1);
      if (blockIdx.x < a.B && team_in == 0 && tid == 0) {
        // The tail's grammar row (the bucket of the token consumed last) and
        // window counts.
        prefetch_l2(a.gram + (size_t)bucket_of(a, a.last[blockIdx.x]) * a.Vp, (size_t)a.Vp * sizeof(float));
        prefetch_l2(a.hist + (size_t)blockIdx.x * a.V, (size_t)a.V * sizeof(int));
      }
      team_wait(c_out + (size_t)(L - 1) * kCounterStride, n_out * (t + 1), tid, bar);
      ring_gemv<kLayerNorm, kBias, FMT>(a, head, sm, tp, kHead, tid, bar, dyn, ring, full, cseq, cu);
      ring_signal<FMT>(a, c_head, plan_count(tp, kHead), tid, bar, cu, tp, ring, full, chunks_of(a, a.d_model));
    }

    if (t + 1 < a.n_tokens && tail_q < a.B * TAIL_S)
      tail_slice_item(a, ex, tail_q / TAIL_S, tail_q % TAIL_S, t, c_head, n_head * (t + 1), c_tail);
  }
}

bool resident_shape_ok(const ResidentArgs& a, int fmt) {
  if (a.B < 1 || a.B > MAXR || a.L < 1 || a.n_tokens < 1 || a.ring < 1 || a.window_ticks < 1) return false;
  if (a.headdim != MIX_P || a.d_state != MIX_N || a.nheads * MIX_P != a.d_inner) return false;
  if (a.conv_dim != a.d_inner + 2 * a.d_state || a.d_in_proj != 2 * a.d_inner + 2 * a.d_state + a.nheads)
    return false;
  // The tail: slices that cover the row, a warp for each of the B x 64.
  if (!tail_shape_ok(a.Vp, a.V) || a.n_blocks * (NT / 32) < a.B * TAIL_S) return false;
  // The ring copies whole 64-k steps: no K tail.
  if (a.d_model % KSTEP != 0 || a.d_inner % KSTEP != 0) return false;
  return gemv_shape_ok(a.B, a.d_model, a.d_in_proj, fmt) && gemv_shape_ok(a.B, a.d_inner, a.d_model, fmt) &&
         gemv_shape_ok(a.B, a.d_model, a.Vp, fmt);
}

// The plan's chunk and slots: a chunk is a whole number of steps (bf16) or
// groups (int8), and a tile's chunks fit the ring at once.
bool ring_ok(const ResidentArgs& a, int fmt) {
  const int unit = fmt == kBf16 ? KSTEP : QGROUP;
  if (a.kch < unit || a.kch % unit != 0) return false;
  const int most = std::max((a.d_model + a.kch - 1) / a.kch, (a.d_inner + a.kch - 1) / a.kch);
  return a.slots >= most && a.slots <= MAX_SLOTS;
}

template <int FMT>
int launch_resident(const void* const* p, int n_ptrs, const int* v, int n_ints, int* info_out, void* stream) {
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
  a.plan = static_cast<const int*>(p[i++]);
  a.counters = static_cast<int*>(const_cast<void*>(p[i++]));
  int j = 0;
  a.L = v[j++]; a.B = v[j++]; a.d_model = v[j++]; a.d_inner = v[j++]; a.nheads = v[j++];
  a.headdim = v[j++]; a.d_state = v[j++]; a.conv_dim = v[j++]; a.d_in_proj = v[j++];
  a.Vp = v[j++]; a.V = v[j++]; a.dyn_start = v[j++]; a.length_start = v[j++];
  a.time_start = v[j++]; a.tempo_start = v[j++]; a.ring = v[j++]; a.window_ticks = v[j++];
  a.n_tokens = v[j++];
  a.greedy = v[j++];
  a.kch = v[j++]; a.slots = v[j++]; a.n_blocks = v[j++];
  if (i != kNumPtrs || j != kNumInts || !resident_shape_ok(a, FMT) || !ring_ok(a, FMT))
    return (int)cudaErrorInvalidValue;
  if (FMT != kBf16 && (a.w_in_s == nullptr || a.w_out_s == nullptr || a.lm_s == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.plan == nullptr || a.counters == nullptr || a.n_blocks < a.B) return (int)cudaErrorInvalidValue;

  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t esz = FMT == kBf16 ? 2 : 1;
  const size_t team_bytes = std::max(gemv_smem_bytes(a.B, a.d_model, QGROUP, FMT),
                                     gemv_smem_bytes(a.B, a.d_inner, QGROUP, FMT));
  const size_t region = (TEAMS * team_bytes + ROW_ALIGN - 1) / ROW_ALIGN * ROW_ALIGN;
  a.team_bytes = (int)team_bytes;
  a.region_bytes = (int)region;
  a.slot_row = (int)(a.kch * esz + SLOT_PAD);
  const size_t smem = region + (size_t)TEAMS * a.slots * TILE_N * a.slot_row;
  e = cudaFuncSetAttribute(generate_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, generate_kernel<FMT>, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (a.n_blocks > per_sm * mg_sm_count()) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, generate_kernel<FMT>);
  if (e != cudaSuccess) return (int)e;
  info_out[0] = a.n_blocks;
  info_out[1] = NT;
  info_out[2] = (int)smem;
  info_out[3] = (int)attr.sharedSizeBytes;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)generate_kernel<FMT>, dim3(a.n_blocks), dim3(NT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per weight format. ptrs: the kNumPtrs device pointers in
// ResidentArgs order (null for the scales of the bf16 pack); ints: the
// kNumInts sizes in ResidentArgs order. info_out receives 4 ints: the grid,
// the threads a block, and the dynamic and static shared memory a block.

MG_EXPORT int mg_generate_resident_bf16(const void* const* ptrs, int n_ptrs, const int* ints,
                                        int n_ints, int* info_out, void* stream) {
  return launch_resident<kBf16>(ptrs, n_ptrs, ints, n_ints, info_out, stream);
}

MG_EXPORT int mg_generate_resident_w8a16(const void* const* ptrs, int n_ptrs, const int* ints,
                                         int n_ints, int* info_out, void* stream) {
  return launch_resident<kW8A16>(ptrs, n_ptrs, ints, n_ints, info_out, stream);
}

MG_EXPORT int mg_generate_resident_w8a8(const void* const* ptrs, int n_ptrs, const int* ints,
                                        int n_ints, int* info_out, void* stream) {
  return launch_resident<kW8A8>(ptrs, n_ptrs, ints, n_ints, info_out, stream);
}
