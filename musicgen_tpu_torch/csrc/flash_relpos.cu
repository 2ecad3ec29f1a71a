// Kernel D: flash attention forward with the Transformer-XL relative-position
// term and the always-visible metadata columns, for the Transformer prefill
// and (with its LSE output) the training forward.
//
// Replaces musicgen_tpu/ops/pallas_attention.py `_flash_relpos_kernel` (via
// `_flash_fwd` and `flash_relpos_attention`). Per (b, h) and query row t:
//   s[t, c] = (q_t . k_c + BD[t, c]) * scale,  BD[t, c] = q_t . rel[c - t + T - 1]
//   for c <= t and 0 above the diagonal (the TPU kernel reads zero padding
//   there); visible where c <= t or c < n_meta;
//   out_t = softmax_c(s[t, :]) . V
// q, k, v and rel are rounded to bf16 and the products summed in f32; the
// probabilities are rounded to bf16 before P.V, as the TPU kernel does. The
// online softmax walks 128-column key tiles in order, as the TPU kernel does
// with block_k = 128: the running maximum moves once a tile, P is
// bf16(exp(s - m_new)) and the row sum adds the unrounded p, so the points
// where the probabilities are rounded are those of the plain version
// (ops/attention_kernel.flash_relpos_attention_plain).
//
// What bounds it on an H100: operations. At the main path (B*H = 16,
// T = 2054, d = 128) the visible (t, c) pairs are about 2.1 M per head, and
// AC, BD and P.V each cost 2 * 128 flops per pair: about 26 GFLOP a launch,
// 26 us at the 989 TFLOP/s dense bf16 peak, against 84 MB of f32 inputs and
// output (25 us at 3.35 TB/s).
//
// Design: FA2's structure on mma.sync m16n8k16 (bf16 in, f32 out), fed by
// cp.async; one 8-warp block per (b*h, 128-row query tile). Against what
// held the first version (64-row tiles, every operand converted to bf16 per
// tile, scores through shared memory) back:
//  1. Overlap: the next key tile's K and band rows are copied while the
//     softmax and P.V run, the tile's V while its band and AC products run
//     (cp.async groups, one stage each: 217 KB of shared memory leave one
//     block an SM). Two block barriers a tile.
//  2. bf16 staged once: a first launch (stage_bf16_kernel) writes bf16 copies
//     of k and v as (B*H, T, 128) and of rel's first T rows as (H, T, 128)
//     into the caller's buffer (21 MB at the main path, read back from L2);
//     tiles are then copied as they are, half the bytes of f32. q is
//     converted once a block and its A fragments stay in registers for the
//     whole key loop, for AC and the band product.
//  3. Operands are read with ldmatrix (.trans for V, so no transpose is
//     stored) from rows padded to 272 bytes: 8 rows of 16 bytes fall in 8
//     distinct bank groups.
//  4. Scores, the running max and sum (shuffles inside a lane quad) and P
//     stay in registers, FA2's layout: a warp owns 16 query rows across the
//     128 columns of a tile, P's C fragments are repacked as P.V's A
//     fragments, and no block barrier sits inside the softmax. exp(s - m) is
//     exp2 of scores pre-scaled by log2 e; below the diagonal tile no mask
//     is computed.
//  5. BD per warp: a warp needs the band columns u = c - i + 15 (i its row
//     0..15, c the tile column), 16 + 128 - 1 of them, padded to 144: nine
//     passes of one pair of n-tiles in a rolled loop (8 accumulators each;
//     one pass of all nine, 72 accumulators, was 25% slower, and AC runs
//     pair by pair for the same reason). Each pass writes q.band^T to the
//     warp's own f32 scratch (row stride 152: conflict-free float2 stores,
//     2-way skewed reads), and BD[i][c] is read back at column c - i + 15
//     after a __syncwarp. The band slides by 128 rows a key tile: of the
//     256-row window a block needs, 128 rows (one chunk) are new each tile,
//     loaded into the ring slot the previous tile no longer needs; rows
//     outside [0, T) come in as zeros.
//  6. Heavy blocks first: blockIdx.y counts the query tiles from the last
//     (most key tiles) down, and blockIdx.x the (b, h) pairs, so the grid's
//     heavy tiles start before its light ones. On the diagonal key tile a
//     warp skips the column pairs right of its last row (and the band
//     beyond them), except in tile 0, which holds the metadata columns.
// A warp whose 16 rows all lie at or past T does no product but keeps to
// the block's barriers. Nothing depends on T being a multiple of a tile.
// Masked scores are the finite -1e30, so a row never sees exp(-inf - -inf).
// What still holds it back: every B fragment serves one 16-row m-tile, so
// each mma.sync needs half an ldmatrix.x4; wgmma, which reads B once for 64
// rows, is the next step.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp,
// m + log l, as the TPU kernel's training forward does: kernel E
// (flash_relpos_bwd.cu) recomputes the probabilities from it. The prefill
// passes null and runs the same instructions up to that store.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int HD = 128;                  // head dim the kernel is written for
constexpr int BQ = 128;                  // query rows of a block
constexpr int BK = 128;                  // key columns of a tile
constexpr int NT = 256;                  // 8 warps
constexpr int NW = NT / 32;
constexpr int WR = BQ / NW;              // 16 query rows a warp
constexpr int LDT = HD + 8;              // bf16 row stride of the staged tiles (272 B)
constexpr int NBP = (WR + BK) / 16;      // 9 pairs of band n-tiles: 144 columns (143 used)
constexpr int LDW = 152;                 // f32 row stride of a warp's band scratch
constexpr float kNeg = -1e30f;

constexpr int kTileBytes = BK * LDT * 2;                          // 34,816
constexpr int kWarpBytes = WR * LDW * 4;                          // 9,728
constexpr int kSmem = 4 * kTileBytes + NW * kWarpBytes;          // K, V, 2 band chunks, 8 scratches
static_assert(kSmem == 217088, "shared-memory budget: 4 x 34,816 + 8 x 9,728 bytes");
static_assert(kSmem <= 232448, "one block must fit in an H100 SM's 227 KB");
static_assert(BQ == BK, "the diagonal key tile of query tile i is key tile i");
static_assert(LDW >= 16 * NBP, "the scratch holds a warp's 144 band columns");
static_assert(WR * LDT * 2 <= kWarpBytes, "a warp's bf16 q rows fit in its scratch");
static_assert(BQ + BK == 2 * 128, "the band window is two 128-row chunks");

// Rows row0 .. row0 + 127 of a (n_rows, 128) bf16 matrix to a [128][LDT]
// tile at `dst`; rows outside [0, n_rows) become zero. All 256 threads.
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0, int n_rows) {
#pragma unroll
  for (int i = 0; i < BK * HD / 8 / NT; ++i) {
    const int id = threadIdx.x + i * NT, r = id >> 4, c = (id & 15) * 8;
    const int row = row0 + r;
    const bool ok = row >= 0 && row < n_rows;
    cp_async16(dst + (uint32_t)(r * LDT + c) * 2, src + (long long)(ok ? row : 0) * HD + c, ok);
  }
}

// k and v (f32, (b, h, t) strides sb, sh, st) and rel's first T rows to bf16:
// stage = [k (B*H, T, 128) | v (B*H, T, 128) | rel (H, T, 128)], 8 values
// (16 bytes) a step.
__global__ void __launch_bounds__(256) stage_bf16_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                                         long long sb, long long sh, long long st,
                                                         const float* __restrict__ rel, long long rel_sh,
                                                         __nv_bfloat16* __restrict__ stage, int H, int T,
                                                         long long n_kv, long long n_all) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_all;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i & 15) * 8;
    const float* src;
    if (i < 2 * n_kv) {
      const bool is_v = i >= n_kv;
      const long long row = (is_v ? i - n_kv : i) >> 4;
      const long long bh = row / T;
      const int t = (int)(row - bh * T), b = (int)(bh / H), h = (int)(bh % H);
      src = (is_v ? v : k) + b * sb + h * sh + t * st + c;
    } else {
      const long long row = (i - 2 * n_kv) >> 4;
      const int h = (int)(row / T), t = (int)(row % T);
      src = rel + h * rel_sh + (long long)t * HD + c;
    }
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 e = __ldg(reinterpret_cast<const float4*>(src + 4));
    uint4 o;
    o.x = pack_bf16(a.x, a.y);
    o.y = pack_bf16(a.z, a.w);
    o.z = pack_bf16(e.x, e.y);
    o.w = pack_bf16(e.z, e.w);
    *reinterpret_cast<uint4*>(stage + i * 8) = o;
  }
}

// One pair of band n-tiles, columns col .. col + 15 of a warp's product
// q_i . rel[base + u] (the block's window rows o .. o + 15), to its f32
// scratch. A pass holds 8 accumulators where one pass over the 9 pairs
// would hold 72 beside the 64 of O and the 32 of q's fragments.
__device__ __forceinline__ void band_pair(float* scr, const uint32_t (&qa)[8][4], uint32_t s_band, int kt, int o,
                                          int col, int lane) {
  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const uint32_t slot = s_band + (uint32_t)(((kt + (o >> 7)) & 1) * kTileBytes);
  const int row = (o & 127) + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t bf[4];
    ldsm_x4(bf, slot + (uint32_t)(row * LDT + ks * 16 + ((lane >> 3) & 1) * 8) * 2);
    mma16816(acc[0], qa[ks], bf[0], bf[1]);
    mma16816(acc[1], qa[ks], bf[2], bf[3]);
  }
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = col + 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(scr + g * LDW + c) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(scr + (g + 8) * LDW + c) = make_float2(acc[n][2], acc[n][3]);
  }
}

__global__ void __launch_bounds__(NT, 1) flash_relpos_kernel(
    const float* __restrict__ q, long long sb, long long sh, long long st, const __nv_bfloat16* __restrict__ k_st,
    const __nv_bfloat16* __restrict__ v_st, const __nv_bfloat16* __restrict__ rel_st, float* __restrict__ out,
    float* __restrict__ lse, int H, int T, int n_meta, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem), s_v = s_k + kTileBytes, s_band = s_v + kTileBytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  float* scr = reinterpret_cast<float*>(smem + 4 * kTileBytes + warp * kWarpBytes);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy query tiles first
  const int q0 = qt * BQ, r0 = q0 + warp * WR;
  const int n_tiles = qt + 1;                 // key tiles 0 .. qt (the diagonal)
  const int w0 = T - BQ - q0;                 // rel row of band chunk 0's first row
  const int o0 = BQ - WR - warp * WR;         // window row of the warp's band column 0
  const bool live = r0 < T;
  const __nv_bfloat16* kb = k_st + (long long)bh * T * HD;
  const __nv_bfloat16* vb = v_st + (long long)bh * T * HD;
  const __nv_bfloat16* relh = rel_st + (long long)h * T * HD;

  // Chunk m of the band (rel rows w0 + 128 m ..) lives in ring slot m & 1;
  // key tile kt reads chunks kt and kt + 1.
  load_tile(s_k, kb, 0, T);
  load_tile(s_band, relh, w0, T);
  load_tile(s_band + kTileBytes, relh, w0 + BK, T);
  cp_async_commit();

  // The warp's 16 q rows to bf16 in its scratch, then to A fragments that
  // stay in registers for the whole key loop.
  uint32_t qa[HD / 16][4];
  {
    __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(scr);
    const float* qb = q + b * sb + h * sh;
#pragma unroll 4
    for (int i = lane; i < WR * HD / 4; i += 32) {
      const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < T) x = __ldg(reinterpret_cast<const float4*>(qb + (long long)(r0 + r) * st + d));
      *reinterpret_cast<uint2*>(sq + r * LDT + d) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
    __syncwarp();
    const uint32_t a = smem_u32(sq) + (uint32_t)((lane & 15) * LDT + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) ldsm_x4(qa[ks], a + ks * 32);
    __syncwarp();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // Running max (of the scores times log2 e) and sum of rows g and g + 8;
  // l is this lane's part. exp(s - m) is computed as exp2(s' - m').
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * 1.4426950408889634f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const bool diag = kt == qt;
    // Pairs of n-tiles (16 columns) the warp needs: on the diagonal tile
    // only those up to its last row (all in tile 0, for the metadata
    // columns), and the band pairs up to u = 16 warp + 15.
    const int n_pairs = (diag && kt > 0) ? warp + 1 : BK / 16;
    const int n_band = diag ? warp + 1 : NBP;
    cp_async_wait_all();  // K tile kt and band chunks kt, kt + 1
    __syncthreads();      // ... for every warp; and every warp is done with V tile kt - 1
    load_tile(s_v, vb, k0, T);
    cp_async_commit();

    float s[BK / 8][4];
    if (live) {
#pragma unroll 1
      for (int p = 0; p < n_band; ++p) band_pair(scr, qa, s_band, kt, o0 + 16 * p, 16 * p, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int p = 0; p < BK / 16; ++p) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          if (p < n_pairs) {
            uint32_t bf[4];
            const int row = 16 * p + (lane & 7) + (lane >> 4) * 8;
            ldsm_x4(bf, s_k + (uint32_t)(row * LDT + ks * 16 + ((lane >> 3) & 1) * 8) * 2);
            mma16816(s[2 * p], qa[ks], bf[0], bf[1]);
            mma16816(s[2 * p + 1], qa[ks], bf[2], bf[3]);
          }
        }
      }
      __syncwarp();  // the band scratch is complete
      // BD[r][j] at scratch column j - r + 15; below the diagonal tile every
      // column is visible and below the diagonal.
      const float* bd_row = scr + g * (LDW - 1) + 2 * t4 + WR - 1;
      if (!diag) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[n][i] = (s[n][i] + bd_row[(i >> 1) * 8 * (LDW - 1) + 8 * n + (i & 1)]) * scale2;
      } else {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = g + 8 * (i >> 1), j = 8 * n + 2 * t4 + (i & 1);
            const int t = r0 + r, c = k0 + j;
            const float bd = c <= t ? bd_row[(i >> 1) * 8 * (LDW - 1) + 8 * n + (i & 1)] : 0.f;
            const bool vis = c < T && (c <= t || c < n_meta);
            s[n][i] = vis ? (s[n][i] + bd) * scale2 : kNeg;
          }
        }
      }
    }
    cp_async_wait_all();  // V tile kt
    __syncthreads();      // every warp is done with K tile kt and band chunk kt; V tile kt is in
    if (kt + 1 < n_tiles) {
      load_tile(s_k, kb, k0 + BK, T);
      load_tile(s_band + (uint32_t)((kt & 1) * kTileBytes), relh, w0 + (kt + 2) * BK, T);
    }
    cp_async_commit();

    // Online softmax in registers; P as the A fragments of P.V.
    uint32_t pa[BK / 16][4];
    if (live) {
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
        const float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
    }
    if (live) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks < n_pairs) {
#pragma unroll
          for (int p = 0; p < HD / 16; ++p) {
            uint32_t bf[4];
            const int row = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldsm_x4_trans(bf, s_v + (uint32_t)(row * LDT + 16 * p + (lane >> 4) * 8) * 2);
            mma16816(o[2 * p], pa[ks], bf[0], bf[1]);
            mma16816(o[2 * p + 1], pa[ks], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // out[b, t, h, :] = O / l, l summed over the lane quad.
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int t = r0 + g + 8 * hi;
    if (t < T) {
      const float l = hi ? l1 : l0, inv_l = 1.f / l;
      float* orow = out + (((long long)b * T + t) * H + h) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
            make_float2(o[n][2 * hi] * inv_l, o[n][2 * hi + 1] * inv_l);
      if (lse != nullptr && t4 == 0) lse[(long long)bh * T + t] = (hi ? m1 : m0) * 0.6931471805599453f + logf(l);
    }
  }
}

}  // namespace

// q, k, v: f32 (B, H, T, 128) with element (b, h, t, d) at b*sb + h*sh + t*st
// + d (all three with the same strides, 16-byte aligned rows); rel: f32
// (H, >= T, 128), head h at h*rel_sh; out: f32 (B, T, H, 128) contiguous;
// lse: null, or f32 (B*H, T) contiguous; stage: bf16 scratch of
// (2*B*H + H) * T * 128 values, 16-byte aligned (k, v, then rel; see
// ops/attention_kernel.staging_views).
MG_EXPORT int mg_flash_relpos(const float* q, const float* k, const float* v, long long sb, long long sh,
                              long long st, const float* rel, long long rel_sh, float* out, float* lse, void* stage,
                              int B, int H, int T, int D, int n_meta, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D != HD || n_meta < 1 || n_meta > BK || stage == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n_q = (T + BQ - 1) / BQ;
  if (n_q > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_relpos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* k_st = static_cast<__nv_bfloat16*>(stage);
  const long long kv = (long long)B * H * T * HD;
  const long long n_kv = kv / 8, n_all = (2 * kv + (long long)H * T * HD) / 8;
  const long long blocks = std::min<long long>((n_all + 255) / 256, 8LL * mg_sm_count());
  stage_bf16_kernel<<<(unsigned)blocks, 256, 0, s>>>(k, v, sb, sh, st, rel, rel_sh, k_st, H, T, n_kv, n_all);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, n_q);
  flash_relpos_kernel<<<grid, NT, kSmem, s>>>(q, sb, sh, st, k_st, k_st + kv, k_st + 2 * kv, out, lse, H, T, n_meta,
                                              scale);
  return (int)cudaGetLastError();
}
