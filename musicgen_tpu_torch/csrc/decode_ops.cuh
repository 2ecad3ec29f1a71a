// Device code of the one-token decode math, shared by the per-token kernels
// (kernel B and its int8 variants B': decode_gemv.cu, decode_mixer.cu,
// decode_tail.cu; kernels F and G: decode_gemv.cu, xlstm_decode.cu; kernel
// J's product: decode_ablate.cu) and the resident whole-generation kernel
// (C: generate_resident.cu).
//
// Each function handles one work item:
//   gemv_team    the output columns of one GEMV that a 256-thread team owns
//                (tiles of 16 columns on the tensor cores, every format),
//                after the team's prologue; its parts (gemv_prologue,
//                gemv_mma_chunk, gemv_write_sums, gemv_finish_tile) are what
//                the resident kernel runs on weights it has copied into
//                shared memory (gemv_load_chunk_smem);
//   mixer_load,  a quarter of one (batch row, head) of the SSM state update:
//   mixer_step   16 of the head's 64 state rows (256 threads);
//   tail_slice_* one warp's slice of the grammar/penalty/top-3 tail of a
//                row (kernel B spreads a row's 64 slices over a thread-block
//                cluster, the resident kernel over its teams).
// A per-token kernel is a grid of such items; the resident kernel walks the
// same items over its persistent blocks, each stage waiting for the ones it
// reads. A column's
// reduction order and a row's statistics depend only on the item, never on
// which block computes it, so both paths compute the same bits. The build
// passes -fmad=false for the same reason: no multiply-add is contracted
// differently where a function is inlined.
//
// Weight formats (template FMT), all K-contiguous, W[n, k]:
//   kBf16   bf16 weights, activations rounded to bf16, f32 sums (`_dot` in
//           musicgen_tpu/ops/pallas_decode.py): one K-group over all of K
//           with no scale.
//   kW8A16  int8 weights with (K / qgroup, N) f32 group scales
//           (`_w8dot` :163): S_g = (sum_k bf16(pro(x))[r, k] * w[n, k]) *
//           s_w[g, n], the int8 weight promoted to bf16 exactly, f32 sums.
//   kW8A8   the same pack (`_qdot` :138): q = clip(rint(pro(x) / s_x),
//           +-127), rounded half to even, s_x = max(max|pro(x)|, 1e-20) / 127
//           per (row, 256-group); S_g = float(sum_k q * w) * s_x * s_w, the
//           integer sum exact in int32.
//   int8: out[r, n] = epi(sum_g S_g) with the S_g added group by group, in
//   the TPU kernel's order. A pack whose K is not a multiple of 256 has one
//   group over all of K (qgroup = K; W8A16 only: the xLSTM FFN's
//   down-projection, K = 1408, kernel G).
//
// Every format runs on the tensor cores through one function, gemv_team. A
// team first takes its prologue's row statistics in the plain versions'
// formula, the sums taken in f64 and rounded once (gemv_row_stats_exact),
// and writes pro(x) into its dynamic shared memory once: rounded to bf16
// (bf16, W8A16) or quantised to int8 (W8A8), each row padded so that a
// quarter-warp's 16-byte reads fall on distinct banks, rows R..7 read as
// zeros. It then walks tiles of 16 columns, the next tile's first weights in
// flight through the current tile's barrier and epilogue. In a tile,
// mma.sync (m16n8k16 bf16, the bf16 weights fed to it as loaded and int8
// ones converted to bf16 in registers; m16n8k32 s8 for W8A8) takes the 16
// columns of W as its rows and x's R <= 8 rows as its 8 columns. A k-step is
// 64 k: lane (g = lane / 4, t = lane % 4) loads the 16 k at k + 16 t of
// columns n0 + g and n0 + g + 8 (16 bytes each in int8, 32 in bf16), and
// the k-slots of each mma are permuted within the step to match (the sum
// over k does not care). The team's 8 warps split K: with G >= 8 groups warp
// w sums whole groups w, w + 8, ...; with G < 8 groups (bf16: G = 1), 8 / G
// warps share a group, each a fixed stride of its steps. Each warp writes
// its group sums (f32, or int32 for W8A8) into shared memory; after a team
// barrier one thread per (row, column) adds the warps' sums of each group in
// warp order, scales the whole group sum and adds the groups in order (int8),
// applies the epilogue and stores. Two buffers of sums let the next tile
// start without a second barrier. A bf16 GEMV takes any N and K % 8 == 0:
// a ragged last tile loads zeros for its columns past N and stores none of
// them, and a K that is not whole steps is staged and loaded as zeros past K.
// Rounding points: pro(x) in f32, rounded once to bf16 at the stage (bf16,
// W8A16); the products exact (int32 in W8A8; bf16 x bf16 into the mma's f32
// sums otherwise); in int8 each group's sum scaled once, then added to the
// f32 result group by group. The W8A8 result thus equals the plain
// version's bit for bit when its int8 activations and scales do.
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
constexpr int MIX_P = 64;           // headdim the mixer is written for
constexpr int MIX_N = 64;           // d_state
constexpr int MIX_Q = 4;            // mixer items a head: quarters of its state rows
constexpr int MIX_RPW = MIX_P / MIX_Q / WARPS;  // state rows a warp of an item (2)
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

// 16 bytes from shared memory at a shared-window address.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// ---------------------------------------------------------------------------
// GEMV: out[r, n] = sum_k pro(x)[r, k] * W[n, k], then the epilogue.
// ---------------------------------------------------------------------------

struct GemvArgs {
  const float* x;                 // (R, K) f32 activations
  const void* w;                  // (N, K) bf16 or int8, K-contiguous
  const float* w_s;               // (K / qgroup, N) f32 group scales [int8]
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
  int qgroup;                     // int8 K-group; 0 means QGROUP (bf16: one group, all of K)
};

// Shared memory of one GEMV team.
struct GemvSmem {
  // The warps' partial row statistics (gemv_row_stats_exact), read before
  // the barrier that ends it, so one GEMV's never meets another's.
  double red64[2 * MAXR * WARPS];
  float mul[MAXR], sub[MAXR];     // prologue row statistics
  float sx[MAXR * GMAX];          // W8A8 activation scales (row, group)
};

template <int PRO>
__device__ __forceinline__ float pro_apply(float v, const GemvSmem& sm, int r, float pw, float pb) {
  if (PRO == kRms) return v * sm.mul[r] * pw;
  if (PRO == kLayerNorm) return (v - sm.sub[r]) * sm.mul[r] * pw + pb;
  return v;
}

// Per-row statistics of the prologue, RMSNorm rsqrt(mean(x^2) + eps) or
// LayerNorm mean and rsqrt(E[x^2] - mean^2 + eps), in the plain versions'
// formula (torch.mean, then torch.rsqrt): the sums of x and of the f32
// squares x * x are taken in f64, where their order does not show, each
// rounded once to f32, and the factor is rsqrtf. So the activations equal
// the plain version's wherever torch's f32 mean is the correctly rounded
// one: a bf16 activation one rounding apart, or an int8 one one level apart,
// would grow through a stack of layers. Every team recomputes them from the
// R x K activations instead of a separate launch.
__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int PRO>
__device__ void gemv_row_stats_exact(const GemvArgs& a, GemvSmem& sm, int tid, int bar) {
  const int lane = tid % 32, warp = tid / 32;
  for (int r = 0; r < a.R; ++r) {
    double s1 = 0.0, s2 = 0.0;
    for (int k = tid; k < a.K; k += TEAM) {
      const float v = a.x[(size_t)r * a.K + k];
      s1 += (double)v;
      s2 += (double)(v * v);
    }
    s1 = warp_sum_d(s1);
    s2 = warp_sum_d(s2);
    if (lane == 0) {
      sm.red64[r * WARPS + warp] = s1;
      sm.red64[(MAXR + r) * WARPS + warp] = s2;
    }
  }
  team_sync(bar);
  if (tid < a.R) {
    const int r = tid;
    double s1 = 0.0, s2 = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      s1 += sm.red64[r * WARPS + w];
      s2 += sm.red64[(MAXR + r) * WARPS + w];
    }
    const float mean = (float)(s1 / a.K), msq = (float)(s2 / a.K);
    if (PRO == kRms) {
      sm.mul[r] = rsqrtf(msq + a.eps);
      sm.sub[r] = 0.f;
    } else {
      sm.mul[r] = rsqrtf(msq - mean * mean + a.eps);
      sm.sub[r] = mean;
    }
  }
  team_sync(bar);
}

// The epilogue of output (r, n), value v (before any bias); the one thread
// that owns (r, n) stores it.
template <int EPI>
__device__ __forceinline__ void gemv_epilogue(const GemvArgs& a, int r, int n, float v) {
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
    // (row, channel) of the state belongs to this thread alone.
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

// ---------------------------------------------------------------------------
// The products on the tensor cores, every format (see the header).
// ---------------------------------------------------------------------------

constexpr int TILE_N = 16;          // output columns of a tile: the mma's 16 rows
constexpr int KSTEP = 64;           // k of one step: 16 k of a column for each of 4 lanes
constexpr int XPAD16 = 8;           // bf16 after each staged W8A16 row (16 bytes)
constexpr int XPADB = 32;           // bf16 after each staged bf16 row (64 bytes)
constexpr int XPAD8 = 64;           // int8 after each staged W8A8 row
constexpr int BF16_MAX_K = 8192;    // K of a bf16 GEMV: its R x K staged activations fit a block

// 16-byte weight words a lane loads for one column and step (16 k).
template <int FMT>
__host__ __device__ constexpr int gemv_wv() { return FMT == kBf16 ? 2 : 1; }
// Steps a warp loads before it uses any: 64 bytes a column and lane in every
// format (two steps in int8, one in bf16). Two bf16 steps would hold 32
// registers of weights, and under the 64 registers of 4 teams an SM the
// kernels then spill.
template <int FMT>
__host__ __device__ constexpr int gemv_kchunk() { return FMT == kBf16 ? 1 : 2; }

// K in whole steps (a bf16 K tail is staged and loaded as zeros).
__host__ __device__ inline int gemv_kpad(int K) { return (K + KSTEP - 1) / KSTEP * KSTEP; }
// K-groups of a row: bf16 has one, over all of K, and no scale.
__host__ __device__ inline int gemv_groups(int K, int qgroup, int fmt) {
  return fmt == kBf16 ? 1 : K / (qgroup > 0 ? qgroup : QGROUP);
}
// Tiles of N columns; a ragged last tile (bf16) reads zeros past N.
__host__ __device__ inline int gemv_tiles(int N) { return (N + TILE_N - 1) / TILE_N; }
// Slots of group sums a tile writes: one per warp (G < 8) or per group.
__host__ __device__ inline int gemv_slots(int G) { return G < WARPS ? WARPS : G; }
// Bytes of one staged row of activations: bf16 (bf16, W8A16) or int8 (W8A8),
// padded so that the 16-byte reads of a quarter-warp (two rows) fall on
// distinct banks.
__host__ __device__ inline int gemv_stage_ld(int K, int fmt) {
  return fmt == kW8A8 ? K + XPAD8 : fmt == kW8A16 ? 2 * (K + XPAD16) : 2 * (gemv_kpad(K) + XPADB);
}
// Bytes of the two buffers of group sums.
__host__ __device__ inline int gemv_sums_bytes(int R, int G) { return 2 * gemv_slots(G) * TILE_N * R * 4; }

// Dynamic shared memory of one team for a GEMV: the sums, then the staged
// activations.
inline size_t gemv_smem_bytes(int R, int K, int qgroup, int fmt) {
  return (size_t)gemv_sums_bytes(R, gemv_groups(K, qgroup, fmt)) + (size_t)R * gemv_stage_ld(K, fmt);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Bytes i and i + 1 of u (int8, biased to v + 128 by u ^ 0x80808080) as two
// bf16, exactly: 2^23 + (v + 128) is an f32 whose low mantissa bits hold the
// byte; less 2^23 + 128 it is v, whose upper 16 bits are its bf16.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t biased, int i) {
  const float lo = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7541 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// pro(x) into the team's staging rows, once: bf16 (bf16, W8A16) or int8
// (W8A8), 8 k a thread; a bf16 row's K tail, up to whole steps, is zeros. In
// W8A8 the 32 threads of a warp stage one (row, 256-group) together: they
// take its scale s_x = max(max|pro(x)|, 1e-20) / 127 with shuffles (a
// maximum does not depend on its order), keep it in sm.sx, and quantise with
// the plain version's expression.
template <int PRO, int FMT>
__device__ void gemv_stage(const GemvArgs& a, GemvSmem& sm, char* xs, int tid, int bar) {
  constexpr int V = 8;
  const int ld = gemv_stage_ld(a.K, FMT), per_row = (FMT == kBf16 ? gemv_kpad(a.K) : a.K) / V, G = a.K / QGROUP;
  const int total = a.R * per_row;
  for (int base = 0; base < total; base += TEAM) {  // uniform over a warp: the shuffles need every lane
    const int i = base + tid;
    const bool on = i < total;
    const int r = on ? i / per_row : 0, k0 = on ? V * (i % per_row) : 0;
    const bool in = on && (FMT != kBf16 || k0 < a.K);  // only a bf16 row has a tail
    const bool pin = FMT != kBf16 || in;                 // int8: pw, pb at k0 = 0 for a lane past the rows
    float v[V];
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 xq = in ? ld4(a.x + (size_t)r * a.K + k0 + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 w4 = PRO != kPlain && pin ? __ldg(reinterpret_cast<const float4*>(a.pw + k0 + 4 * q))
                                             : make_float4(1.f, 1.f, 1.f, 1.f);
      const float4 b4 = PRO == kLayerNorm && pin ? __ldg(reinterpret_cast<const float4*>(a.pb + k0 + 4 * q))
                                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = pro_apply<PRO>(xq.x, sm, r, w4.x, b4.x);
      v[4 * q + 1] = pro_apply<PRO>(xq.y, sm, r, w4.y, b4.y);
      v[4 * q + 2] = pro_apply<PRO>(xq.z, sm, r, w4.z, b4.z);
      v[4 * q + 3] = pro_apply<PRO>(xq.w, sm, r, w4.w, b4.w);
    }
    if constexpr (FMT != kW8A8) {
      if (on)
        *reinterpret_cast<uint4*>(xs + (size_t)r * ld + 2 * k0) =
            in ? make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                            pack_bf16x2(v[6], v[7]))
               : make_uint4(0u, 0u, 0u, 0u);
    } else {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(v[j]));
      const float s = fmaxf(warp_max(m), 1e-20f) * (1.0f / 127.0f);
      if (on && tid % 32 == 0) sm.sx[r * G + k0 / QGROUP] = s;
      uint32_t word[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t packed = 0;
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const float qv = fminf(fmaxf(rintf(v[4 * j + i2] / s), -127.f), 127.f);
          packed |= ((uint32_t)(int)qv & 0xffu) << (8 * i2);
        }
        word[j] = packed;
      }
      if (on) *reinterpret_cast<uint2*>(xs + (size_t)r * ld + k0) = make_uint2(word[0], word[1]);
    }
  }
  team_sync(bar);
}

// The weights of the chunk of steps s, s + sstep, ... (below SG) of columns n0 + g
// (from pa) and n0 + g + 8 (from pb), this lane's 16 k of each: in int8 the
// 16 bytes at k + 16 t of the step; in bf16 the 16 bytes at k + 8 t and at
// k + 32 + 8 t, so that each load of the 4 lanes of a column reads 64
// contiguous bytes. Zero past the last step; in bf16 also past K (krem: the
// k left from the lane's first k of step 0) and for a column past N (ok
// false; its pointer is then not read).
template <int FMT>
__device__ __forceinline__ void gemv_load_chunk(uint4 (&wa)[gemv_kchunk<FMT>()][gemv_wv<FMT>()],
                                                uint4 (&wb)[gemv_kchunk<FMT>()][gemv_wv<FMT>()], const char* pa,
                                                const char* pb, bool oka, bool okb, int s, int sstep, int SG,
                                                int krem) {
  constexpr int KC = gemv_kchunk<FMT>(), WV = gemv_wv<FMT>(), STEP_BYTES = KSTEP * (FMT == kBf16 ? 2 : 1);
#pragma unroll
  for (int u = 0; u < KC; ++u) {
    const int su = s + u * sstep;
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const bool in = su < SG && (FMT != kBf16 || su * KSTEP + 32 * v < krem);
      const int off = su * STEP_BYTES + 64 * v;
      wa[u][v] = in && oka ? __ldg(reinterpret_cast<const uint4*>(pa + off)) : make_uint4(0u, 0u, 0u, 0u);
      wb[u][v] = in && okb ? __ldg(reinterpret_cast<const uint4*>(pb + off)) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The same weights from a tile's rows in shared memory (the resident kernel's
// ring, csrc/generate_resident.cu): sa and sb are the shared-memory addresses
// of columns n0 + g and n0 + g + 8 at the lane's first k of step s, so the
// 16-byte words and the zeros are those gemv_load_chunk gives.
template <int FMT>
__device__ __forceinline__ void gemv_load_chunk_smem(uint4 (&wa)[gemv_kchunk<FMT>()][gemv_wv<FMT>()],
                                                     uint4 (&wb)[gemv_kchunk<FMT>()][gemv_wv<FMT>()], uint32_t sa,
                                                     uint32_t sb, bool oka, bool okb, int s, int sstep, int SG,
                                                     int krem) {
  constexpr int KC = gemv_kchunk<FMT>(), WV = gemv_wv<FMT>(), STEP_BYTES = KSTEP * (FMT == kBf16 ? 2 : 1);
#pragma unroll
  for (int u = 0; u < KC; ++u) {
    const int su = s + u * sstep;
#pragma unroll
    for (int v = 0; v < WV; ++v) {
      const bool in = su < SG && (FMT != kBf16 || su * KSTEP + 32 * v < krem);
      const uint32_t off = (uint32_t)((su - s) * STEP_BYTES + 64 * v);
      wa[u][v] = in && oka ? lds128(sa + off) : make_uint4(0u, 0u, 0u, 0u);
      wb[u][v] = in && okb ? lds128(sb + off) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// A team's share of a GEMV's tiles: which groups and steps each warp sums,
// where the staged activations and the sums live (gemv_team).
struct GemvGeom {
  int gsz, G, SG;     // k of a group, groups, 64-k steps of a group
  int wpg, g0, gstep; // warps sharing a group; this warp's first group and group stride
  int s0, sstep;      // this warp's first step in a group and step stride
  int slots, ld;      // slots of group sums; bytes of a staged row
  int gq, t, warp, lk, krem;
};

template <int FMT>
__device__ __forceinline__ GemvGeom gemv_geom(const GemvArgs& a, int tid) {
  GemvGeom q;
  const int lane = tid % 32;
  q.warp = tid / 32;
  q.gq = lane / 4;
  q.t = lane % 4;
  q.gsz = FMT == kBf16 ? gemv_kpad(a.K) : (a.qgroup > 0 ? a.qgroup : QGROUP);
  q.G = FMT == kBf16 ? 1 : a.K / q.gsz;
  q.SG = q.gsz / KSTEP;
  // This warp's share of every tile: groups g0, g0 + gstep, ... below G, and
  // in each the steps s0, s0 + sstep, ... below SG; wpg warps share a group.
  q.wpg = q.G < WARPS ? WARPS / q.G : 1;
  q.g0 = q.G < WARPS ? (q.warp < q.G * q.wpg ? q.warp / q.wpg : q.G) : q.warp;
  q.gstep = q.G < WARPS ? q.G : WARPS;
  q.s0 = q.warp % q.wpg;
  q.sstep = q.wpg;
  q.slots = gemv_slots(q.G);
  q.ld = gemv_stage_ld(a.K, FMT);
  q.lk = FMT == kBf16 ? 8 * q.t : 16 * q.t;  // this lane's first k of a step
  q.krem = a.K - q.lk;                        // bf16 (one group): the k left from it in step 0
  return q;
}

// The team's prologue: row statistics (kRms, kLayerNorm), then pro(x) staged.
template <int PRO, int FMT>
__device__ __forceinline__ void gemv_prologue(const GemvArgs& a, GemvSmem& sm, char* xs, int tid, int bar) {
  if (PRO != kPlain) gemv_row_stats_exact<PRO>(a, sm, tid, bar);
  gemv_stage<PRO, FMT>(a, sm, xs, tid, bar);
}

// The products of one chunk of steps s, s + sstep, ... of group g on the
// loaded weights wa, wb (gemv_load_chunk or gemv_load_chunk_smem).
template <int FMT>
__device__ __forceinline__ void gemv_mma_chunk(float (&cf)[4], int (&ci)[4],
                                               const uint4 (&wa)[gemv_kchunk<FMT>()][gemv_wv<FMT>()],
                                               const uint4 (&wb)[gemv_kchunk<FMT>()][gemv_wv<FMT>()],
                                               const char* xrow, int g, int s, const GemvGeom& q, int R) {
  constexpr int KC = gemv_kchunk<FMT>();
#pragma unroll
  for (int u = 0; u < KC; ++u) {
    const int su = s + u * q.sstep;
    if (su >= q.SG) break;
    const int k = g * q.gsz + su * KSTEP + q.lk;  // this lane's first k of the step
    if constexpr (FMT != kW8A8) {
      // The lane's 16 x in the order of its 16 weights: bf16 k + 0..7
      // and k + 32..39, W8A16 k + 0..15.
      uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
      if (q.gq < R) {
        x0 = *reinterpret_cast<const uint4*>(xrow + 2 * k);
        x1 = *reinterpret_cast<const uint4*>(xrow + 2 * k + (FMT == kBf16 ? 64 : 16));
      }
      const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      // mma j: k-slots 2t, 2t+1 <- the lane's weights 4j + 0, 1; slots
      // 2t+8, 2t+9 <- 4j + 2, 3. bf16: words 2j and 2j + 1 of its 32
      // bytes, fed to the mma as loaded; W8A16: bytes 4j .. 4j + 3 of
      // its 16, converted to bf16 in registers.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a0, a1, a2, a3;
        if constexpr (FMT == kBf16) {
          a0 = word_of(wa[u][j / 2], 2 * (j % 2));
          a1 = word_of(wb[u][j / 2], 2 * (j % 2));
          a2 = word_of(wa[u][j / 2], 2 * (j % 2) + 1);
          a3 = word_of(wb[u][j / 2], 2 * (j % 2) + 1);
        } else {
          const uint32_t ba = word_of(wa[u][0], j) ^ 0x80808080u, bb = word_of(wb[u][0], j) ^ 0x80808080u;
          a0 = s8x2_to_bf16x2(ba, 0);
          a1 = s8x2_to_bf16x2(bb, 0);
          a2 = s8x2_to_bf16x2(ba, 2);
          a3 = s8x2_to_bf16x2(bb, 2);
        }
        mma_bf16_16816(cf, a0, a1, a2, a3, xw[2 * j], xw[2 * j + 1]);
      }
    } else {
      uint4 xq = make_uint4(0u, 0u, 0u, 0u);
      if (q.gq < R) xq = *reinterpret_cast<const uint4*>(xrow + k);
      const uint32_t xw[4] = {xq.x, xq.y, xq.z, xq.w};
      const uint32_t w_a[4] = {wa[u][0].x, wa[u][0].y, wa[u][0].z, wa[u][0].w};
      const uint32_t w_b[4] = {wb[u][0].x, wb[u][0].y, wb[u][0].z, wb[u][0].w};
      // mma j: k-slots 4t..4t+3 <- k + 8j + 0..3; slots 4t+16..4t+19 <- k + 8j + 4..7.
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_s8_16832(ci, w_a[2 * j], w_b[2 * j], w_a[2 * j + 1], w_b[2 * j + 1], xw[2 * j], xw[2 * j + 1]);
    }
  }
}

// A warp's sums of group g into its slot of the tile's buffer of sums.
template <int FMT>
__device__ __forceinline__ void gemv_write_sums(uint32_t* tsums, const float (&cf)[4], const int (&ci)[4], int g,
                                                const GemvGeom& q, int R) {
  // c[0], c[1]: column gq, rows 2t, 2t + 1; c[2], c[3]: column gq + 8.
  uint32_t* slot = tsums + (size_t)(q.G < WARPS ? q.warp : g) * TILE_N * R;
  const uint32_t c[4] = {FMT == kW8A8 ? (uint32_t)ci[0] : __float_as_uint(cf[0]),
                         FMT == kW8A8 ? (uint32_t)ci[1] : __float_as_uint(cf[1]),
                         FMT == kW8A8 ? (uint32_t)ci[2] : __float_as_uint(cf[2]),
                         FMT == kW8A8 ? (uint32_t)ci[3] : __float_as_uint(cf[3])};
  if (2 * q.t < R) {
    slot[(2 * q.t) * TILE_N + q.gq] = c[0];
    slot[(2 * q.t) * TILE_N + q.gq + 8] = c[2];
  }
  if (2 * q.t + 1 < R) {
    slot[(2 * q.t + 1) * TILE_N + q.gq] = c[1];
    slot[(2 * q.t + 1) * TILE_N + q.gq + 8] = c[3];
  }
}

// After the team barrier that ends a tile: one thread per (row, column) adds
// the warps' sums of each group in warp order; in int8 each group's sum is
// scaled whole and the groups added in order; then the epilogue.
template <int EPI, int FMT>
__device__ __forceinline__ void gemv_finish_tile(const GemvArgs& a, const GemvSmem& sm, const uint32_t* tsums, int n0,
                                                 int tid, const GemvGeom& q) {
  if (tid < TILE_N * a.R && (FMT != kBf16 || n0 + tid % TILE_N < a.N)) {
    const int r = tid / TILE_N, n = n0 + tid % TILE_N;
    float acc = 0.f;
    for (int g = 0; g < q.G; ++g) {
      const uint32_t* p = tsums + (size_t)(q.G < WARPS ? g * q.wpg : g) * TILE_N * a.R + tid;
      // The scale's load first: its latency overlaps the reads of the sums.
      const float sw = FMT == kBf16 ? 1.f : __ldg(a.w_s + (size_t)g * a.N + n);
      if (FMT == kW8A8) {
        int part = (int)p[0];
        for (int u = 1; u < q.wpg; ++u) part += (int)p[(size_t)u * TILE_N * a.R];
        acc = acc + (float)part * sm.sx[r * q.G + g] * sw;
      } else {
        float part = __uint_as_float(p[0]);
        for (int u = 1; u < q.wpg; ++u) part = part + __uint_as_float(p[(size_t)u * TILE_N * a.R]);
        acc = FMT == kBf16 ? part : acc + part * sw;
      }
    }
    gemv_epilogue<EPI>(a, r, n, acc);
  }
}

// The columns team `team` of `n_teams` owns, and their products: tiles of
// TILE_N columns, tile = team, team + n_teams, ... A team without a tile
// returns at once (the test is uniform over the team, so its barriers stay
// matched). `dyn` is the team's gemv_smem_bytes of dynamic shared memory.
// DEP: the team waits (grid_dep_wait) between its first weights and the
// prologue, so that a launch made as a programmatic dependent of the one
// that writes x fetches weights before that one has ended.
template <int PRO, int EPI, int FMT, bool DEP = false>
__device__ void gemv_team(const GemvArgs& a, GemvSmem& sm, int team, int n_teams, int tid, int bar, char* dyn) {
  constexpr int KC = gemv_kchunk<FMT>(), WV = gemv_wv<FMT>(), ESZ = FMT == kBf16 ? 2 : 1;
  const int n_tiles = gemv_tiles(a.N);
  if (team >= n_tiles) return;
  const GemvGeom q = gemv_geom<FMT>(a, tid);
  uint32_t* sums = reinterpret_cast<uint32_t*>(dyn);
  char* xs = dyn + gemv_sums_bytes(a.R, q.G);
  const char* wbytes = static_cast<const char*>(a.w);

  // The first chunk's weights are in flight while the prologue runs.
  uint4 wa[KC][WV], wb[KC][WV];
  if (q.g0 < q.G) {
    const int na = team * TILE_N + q.gq;
    const char* pa = wbytes + (size_t)na * a.K * ESZ + (size_t)(q.lk + q.g0 * q.gsz) * ESZ;
    gemv_load_chunk<FMT>(wa, wb, pa, pa + (size_t)8 * a.K * ESZ, FMT != kBf16 || na < a.N,
                         FMT != kBf16 || na + 8 < a.N, q.s0, q.sstep, q.SG, q.krem);
  }
  if (DEP) grid_dep_wait();
  gemv_prologue<PRO, FMT>(a, sm, xs, tid, bar);

  const char* xrow = xs + (size_t)q.gq * q.ld;  // this lane's row of x: the mma's column gq
  bool loaded = true;
  int buf = 0;
  for (int tile = team; tile < n_tiles; tile += n_teams, buf ^= 1) {
    const int n0 = tile * TILE_N;
    const bool oka = FMT != kBf16 || n0 + q.gq < a.N, okb = FMT != kBf16 || n0 + q.gq + 8 < a.N;
    uint32_t* tsums = sums + (size_t)buf * q.slots * TILE_N * a.R;
    for (int g = q.g0; g < q.G; g += q.gstep) {
      const char* pa = wbytes + (size_t)(n0 + q.gq) * a.K * ESZ + (size_t)(q.lk + g * q.gsz) * ESZ;
      const char* pb = pa + (size_t)8 * a.K * ESZ;
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
      int ci[4] = {0, 0, 0, 0};
      for (int s = q.s0; s < q.SG; s += KC * q.sstep) {
        if (!loaded) gemv_load_chunk<FMT>(wa, wb, pa, pb, oka, okb, s, q.sstep, q.SG, q.krem);
        loaded = false;
        gemv_mma_chunk<FMT>(cf, ci, wa, wb, xrow, g, s, q, a.R);
      }
      gemv_write_sums<FMT>(tsums, cf, ci, g, q, a.R);
    }
    // The next tile's first chunk is in flight through the barrier and this
    // tile's epilogue.
    if (q.g0 < q.G && tile + n_teams < n_tiles) {
      const int na = (tile + n_teams) * TILE_N + q.gq;
      const char* pa = wbytes + (size_t)na * a.K * ESZ + (size_t)(q.lk + q.g0 * q.gsz) * ESZ;
      gemv_load_chunk<FMT>(wa, wb, pa, pa + (size_t)8 * a.K * ESZ, FMT != kBf16 || na < a.N,
                           FMT != kBf16 || na + 8 < a.N, q.s0, q.sstep, q.SG, q.krem);
      loaded = true;
    }
    team_sync(bar);
    gemv_finish_tile<EPI, FMT>(a, sm, tsums, n0, tid, q);
  }
}

// Blocks of a per-token GEMV launch: a team per tile, at most 4 an SM.
inline int gemv_blocks(int N) {
  const int want = gemv_tiles(N), cap = 4 * mg_sm_count();
  return want < cap ? want : cap;
}

// Launch a per-token GEMV kernel (one team a block) with its dynamic shared
// memory, as a programmatic dependent of the launch ahead where `dependent`;
// returns the cudaError_t of the launch.
template <typename Kernel>
int gemv_launch(Kernel kernel, const GemvArgs& a, int fmt, void* stream, bool dependent = false) {
  const size_t smem = gemv_smem_bytes(a.R, a.K, a.qgroup, fmt);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)mg_launch(kernel, dim3(gemv_blocks(a.N)), dim3(TEAM), smem, stream, dependent, a);
}

// The shapes a GEMV takes: R <= 8 rows, K % 8 == 0, any N. bf16: K <=
// BF16_MAX_K (the staged rows). int8: N in tiles of 16 columns, K <= 4096 in
// groups of qgroup = 256 (or one group, qgroup = K, W8A16 only), each a whole
// number of 64-k steps.
inline bool gemv_shape_ok_grouped(int R, int K, int N, int fmt, int qgroup) {
  if (R < 1 || R > MAXR || K <= 0 || N <= 0 || K % 8 != 0) return false;
  if (fmt == kBf16) return K <= BF16_MAX_K;
  if (qgroup != QGROUP && !(fmt == kW8A16 && qgroup == K)) return false;
  return N % TILE_N == 0 && K % qgroup == 0 && qgroup % KSTEP == 0 && K <= GMAX * QGROUP;
}

inline bool gemv_shape_ok(int R, int K, int N, int fmt) { return gemv_shape_ok_grouped(R, K, N, fmt, QGROUP); }

// ---------------------------------------------------------------------------
// Mixer: the selective-state step of one item (row b, head h, quarter q),
// 256 threads:
//   h_state = exp(dt * A) * h_state + (dt * x) B^T;  y = h_state C + D x;
//   g = y * silu(z)
// for the head's state rows p in [16 q, 16 q + 16). State layout S[h*P + p,
// b*N + n]; each warp owns MIX_RPW = 2 rows p, each lane the state columns n
// and n + 32 (one coalesced 256-byte row), updated in place. A row's
// arithmetic, and its y as one warp_sum over the same lanes, do not depend
// on how the head's rows are split into items, so every split computes the
// same bits. In two parts: mixer_load, what the in_proj launch does not write
// (the item's state rows, A and D of its head), and mixer_step, which reads
// zx and computes; kernel B's mixer waits for in_proj between the two.
// ---------------------------------------------------------------------------

struct MixerLoad {
  float ah, dd;                             // A and D of the head
  float st0[MIX_RPW], st1[MIX_RPW];         // the warp's state rows, columns lane and lane + 32
};

// Item `item` = (b * nheads + h) * MIX_Q + q: its batch row b, head h and
// first state row (channel h * P + 16 q).
__device__ __forceinline__ int mixer_b(int item, int nh) { return item / MIX_Q / nh; }
__device__ __forceinline__ int mixer_h(int item, int nh) { return item / MIX_Q % nh; }
__device__ __forceinline__ int mixer_ch0(int item, int nh) {
  return mixer_h(item, nh) * MIX_P + item % MIX_Q * (MIX_P / MIX_Q);
}

__device__ __forceinline__ void mixer_load(MixerLoad& m, const float* a_h, const float* d_h, const float* ssm, int R,
                                           int nh, int item, int tid) {
  const int lane = tid % 32, warp = tid / 32, b = mixer_b(item, nh), h = mixer_h(item, nh);
  m.ah = __ldg(a_h + h);
  m.dd = __ldg(d_h + h);
#pragma unroll
  for (int i = 0; i < MIX_RPW; ++i) {
    const int ch = mixer_ch0(item, nh) + warp * MIX_RPW + i;
    const float* srow = ssm + (size_t)ch * R * MIX_N + (size_t)b * MIX_N;
    m.st0[i] = srow[lane];
    m.st1[i] = srow[lane + 32];
  }
}

// Every load of zx first, so that their latencies overlap (a store to the
// state could alias a later row's loads, so the compiler would not hoist
// them itself); then the same arithmetic row by row.
__device__ __forceinline__ void mixer_step(const MixerLoad& m, const float* zx, int nz, int di, int nh, float* ssm,
                                           float* g, int R, int item, int tid) {
  const int lane = tid % 32, warp = tid / 32, b = mixer_b(item, nh), h = mixer_h(item, nh);
  const float* row = zx + (size_t)b * nz;
  const int dc = di + 2 * MIX_N;
  const float dtv = row[di + dc + h];
  const float b0 = row[2 * di + lane], b1 = row[2 * di + lane + 32];
  const float c0 = row[2 * di + MIX_N + lane], c1 = row[2 * di + MIX_N + lane + 32];
  const int ch0 = mixer_ch0(item, nh) + warp * MIX_RPW;
  float xv[MIX_RPW], zv[MIX_RPW];
#pragma unroll
  for (int i = 0; i < MIX_RPW; ++i) {
    xv[i] = row[di + ch0 + i];
    zv[i] = row[ch0 + i];
  }
  const float decay = expf(dtv * m.ah);
#pragma unroll
  for (int i = 0; i < MIX_RPW; ++i) {
    const int ch = ch0 + i;
    const float dtx = xv[i] * dtv;
    float* srow = ssm + (size_t)ch * R * MIX_N + (size_t)b * MIX_N;
    const float s0 = m.st0[i] * decay + dtx * b0;
    const float s1 = m.st1[i] * decay + dtx * b1;
    srow[lane] = s0;
    srow[lane + 32] = s1;
    const float yv = warp_sum(s0 * c0 + s1 * c1);
    if (lane == 0) g[(size_t)b * di + ch] = (yv + xv[i] * m.dd) * (zv[i] * sigmoidf_(zv[i]));
  }
}

// ---------------------------------------------------------------------------
// Sampler tail of one row. Over the real ids i < V:
//   lse = logsumexp(x);  w = (lse - x) * grammar[bucket];
//   w /= min(exp(hist * ln base), 1.2)  (base 1.01 pitch, 1.02 dyn);
// then the top-3 of w under (value descending, index ascending); pad ids in
// [V, Vp) get weight 0.
//
// Every bit of the result is fixed by one partition of the row, whichever
// blocks and warps compute it:
//   slices  TAIL_S = 64 slices of n = ceil(Vp / 64) ids (tail_slice_ids),
//           the last ones ragged or empty, each one warp's: lane l of slice
//           s holds the ids s n + l + 32 k, k = 0, 1, ... (at most
//           TAIL_EMAX = 9, so Vp <= 64 x 32 x 9 = 18,432: tail_shape_ok);
//   slice   m_s = the largest real logit of the slice; s_s = each lane's
//           exp(x - m_s) added in k order, the lanes added by the xor
//           butterfly (16, 8, 4, 2, 1) of warp_sum;
//   row     m = max_s m_s; total = the s_s * exp(m_s - m) added in slice
//           order (tail_lse); lse = log(total) + m;
//   top-3   each lane's sorted list of its ids' weights, merged with any
//           other list in any order: a selection under a total order is
//           exact, so it does not matter which warp holds which slice.
// Nothing is added by an atomic. A slice's warp runs tail_slice_load,
// tail_slice_pair, then (with the row's lse) tail_slice_top3; only the
// exchange of the 64 pairs and the 64 lists differs between the two
// kernels that run it: kernel B's sample_tail (decode_tail.cu) spreads a
// row's slices over a thread-block cluster and exchanges them through
// distributed shared memory; the resident kernel (C, generate_resident.cu)
// spreads them over its teams and exchanges them through global memory
// behind counters. So the two compute the same bits (-fmad=false and no
// reassociation). ops/decode_kernel.sample_tail_sliced writes the same
// partition in PyTorch.
// ---------------------------------------------------------------------------

constexpr int TAIL_S = 64;                     // slices of a row, one warp each
constexpr int TAIL_LANES = 32;                 // lanes of a slice
constexpr int TAIL_EMAX = 9;                   // ids a lane holds at most

__host__ __device__ inline int tail_slice_ids(int Vp) { return (Vp + TAIL_S - 1) / TAIL_S; }

// Whether the slices cover a row of Vp ids, V of them real.
__host__ __device__ inline bool tail_shape_ok(int Vp, int V) {
  return V >= 3 && V <= Vp && tail_slice_ids(Vp) <= TAIL_LANES * TAIL_EMAX;
}

// A sorted list of the best three (weight, id) pairs seen.
struct Top3 {
  float v[3];
  int i[3];
};

// (v, i) beats (bv, bi) when larger, or equal with a lower index.
__device__ __forceinline__ bool tail_better(float v, int i, float bv, int bi) { return v > bv || (v == bv && i < bi); }

__device__ __forceinline__ void top3_init(Top3& t) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.v[k] = -INFINITY;
    t.i[k] = 0x7fffffff;
  }
}

// (v, i) into the list, ids arriving in increasing order (a lane's scan):
// an equal weight then never beats an entry, so the test is v > entry.
__device__ __forceinline__ void top3_push(Top3& t, float v, int i) {
  if (!(v > t.v[2])) return;
  if (!(v > t.v[1])) {
    t.v[2] = v;
    t.i[2] = i;
    return;
  }
  t.v[2] = t.v[1];
  t.i[2] = t.i[1];
  if (!(v > t.v[0])) {
    t.v[1] = v;
    t.i[1] = i;
    return;
  }
  t.v[1] = t.v[0];
  t.i[1] = t.i[0];
  t.v[0] = v;
  t.i[0] = i;
}

// The best three of the sorted lists a and (bv, bi), their ids disjoint,
// into a: three steps of a merge, each taking the better of the two heads.
__device__ __forceinline__ void top3_merge(Top3& a, const float (&bv)[3], const int (&bi)[3]) {
  const bool t0 = tail_better(a.v[0], a.i[0], bv[0], bi[0]);
  const float x1 = t0 ? a.v[1] : a.v[0], y1 = t0 ? bv[0] : bv[1];
  const int xi1 = t0 ? a.i[1] : a.i[0], yi1 = t0 ? bi[0] : bi[1];
  const bool t1 = tail_better(x1, xi1, y1, yi1);
  // The heads after two picks: a2, b0 (a a); a1, b1 (a b or b a); a0, b2 (b b).
  const bool aa = t0 && t1, bb = !t0 && !t1;
  const float x2 = aa ? a.v[2] : (bb ? a.v[0] : a.v[1]), y2 = aa ? bv[0] : (bb ? bv[2] : bv[1]);
  const int xi2 = aa ? a.i[2] : (bb ? a.i[0] : a.i[1]), yi2 = aa ? bi[0] : (bb ? bi[2] : bi[1]);
  const bool t2 = tail_better(x2, xi2, y2, yi2);
  const float c0 = t0 ? a.v[0] : bv[0];
  const int ci0 = t0 ? a.i[0] : bi[0];
  a.v[2] = t2 ? x2 : y2;
  a.i[2] = t2 ? xi2 : yi2;
  a.v[1] = t1 ? x1 : y1;
  a.i[1] = t1 ? xi1 : yi1;
  a.v[0] = c0;
  a.i[0] = ci0;
}

// The lists of a warp's lanes (their ids disjoint) merged, in every lane
// (a rolled loop: the resident kernel fetches the tail's code anew each
// token).
__device__ __forceinline__ void top3_warp(Top3& t) {
#pragma unroll 1
  for (int o = 16; o > 0; o >>= 1) {
    float v[3];
    int i[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __shfl_xor_sync(0xffffffffu, t.v[k], o);
      i[k] = __shfl_xor_sync(0xffffffffu, t.i[k], o);
    }
    top3_merge(t, v, i);
  }
}

// The row's top-3 from its 64 slices' lists, in every lane of a warp: lane
// l merges lists l and l + 32, then the warp merges the lanes'.
__device__ __forceinline__ void top3_rows(Top3& t, const Top3& lo, const Top3& hi) {
  t = lo;
  top3_merge(t, hi.v, hi.i);
  top3_warp(t);
}

// The row's lse from the slices' (m_s, s_s), lane l of a warp holding the
// pairs of slices l (m0, s0) and l + 32 (m1, s1): m = max_s m_s; each lane
// forms its two terms s_s exp(m_s - m), and every lane adds the 64 terms in
// slice order, so all 32 return the same bits. A slice without a real id
// has (-inf, 0) and adds 0. Called by whole warps.
__device__ __forceinline__ float tail_lse(float m0, float s0, float m1, float s1) {
  const float m = warp_max(fmaxf(m0, m1));
  const float t0 = s0 * expf(m0 - m), t1 = s1 * expf(m1 - m);
  float total = 0.f;
#pragma unroll
  for (int s = 0; s < 32; ++s) total += __shfl_sync(0xffffffffu, t0, s);
#pragma unroll
  for (int s = 0; s < 32; ++s) total += __shfl_sync(0xffffffffu, t1, s);
  return logf(total) + m;
}

// A lane's part of its warp's slice: the logits, grammar values and window
// counts of ids base + 32 k (real below vend, in the row below end).
struct TailSlice {
  float xv[TAIL_EMAX], gv[TAIL_EMAX];
  int hv[TAIL_EMAX];
  int base, end, vend;
};

// Lane `lane` of slice s loads its ids, all in flight at once: x the row's
// Vp logits, g its grammar row, h its V window counts. x and h may have
// been written by other SMs (plain loads after the caller's acquire); the
// grammar is read-only.
__device__ __forceinline__ void tail_slice_load(TailSlice& t, const float* x, const float* g, const int* h, int Vp,
                                                int V, int s, int lane) {
  const int n = tail_slice_ids(Vp);
  t.base = s * n + lane;
  t.end = min((s + 1) * n, Vp);
  t.vend = min(t.end, V);
#pragma unroll
  for (int k = 0; k < TAIL_EMAX; ++k) {
    const int i = t.base + k * TAIL_LANES;
    t.xv[k] = i < t.vend ? x[i] : 0.f;
    t.hv[k] = i < t.vend ? h[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < TAIL_EMAX; ++k) {
    const int i = t.base + k * TAIL_LANES;
    t.gv[k] = i < t.vend ? __ldg(g + i) : 0.f;
  }
}

// The slice's (m_s, s_s), in every lane of the warp.
__device__ __forceinline__ void tail_slice_pair(const TailSlice& t, float& ms, float& ss) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < TAIL_EMAX; ++k)
    if (t.base + k * TAIL_LANES < t.vend) m = fmaxf(m, t.xv[k]);
  ms = warp_max(m);
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < TAIL_EMAX; ++k)
    if (t.base + k * TAIL_LANES < t.vend) a += expf(t.xv[k] - ms);
  ss = warp_sum(a);
}

// The weight of id i (x its logit, g its grammar value, h its window count).
// Where the count is 0 or the id has no penalty base, the divisor is
// exp(0) = 1 and the division exact, so neither is computed.
__device__ __forceinline__ float tail_weight(int i, int V, float x, float g, int h, float lse, int dyn_start,
                                             int length_start) {
  if (i >= V || !(g > 0.f)) return 0.f;
  const float wv = (lse - x) * g;
  if (h == 0 || i >= length_start) return wv;
  return wv / fminf(expf((float)h * (i < dyn_start ? kLn101 : kLn102)), 1.2f);
}

// The slice's weights, each lane's top-3 in one pass (its ids rise), merged
// over the warp: the slice's list, in every lane.
__device__ __forceinline__ void tail_slice_top3(const TailSlice& t, int V, float lse, int dyn_start, int length_start,
                                                Top3& top) {
  top3_init(top);
#pragma unroll
  for (int k = 0; k < TAIL_EMAX; ++k) {
    const int i = t.base + k * TAIL_LANES;
    if (i < t.end) top3_push(top, tail_weight(i, V, t.xv[k], t.gv[k], t.hv[k], lse, dyn_start, length_start), i);
  }
  top3_warp(top);
}

}  // namespace mg
