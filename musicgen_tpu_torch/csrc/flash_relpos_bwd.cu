// Kernel E: the backward of kernel D (flash rel-pos attention), for training.
//
// Replaces musicgen_tpu/ops/pallas_attention.py `_flash_bwd_dq_kernel` (dQ
// and dRel: E1, E3 and the combine here) and `_flash_bwd_dkv_kernel` (dK and
// dV: E2), via `_flash_bwd` under the custom VJP of
// `flash_relpos_attention_train`. Per (b, h), with the forward's scores
// s = (q.k^T + BD) * scale (BD[t, c] = q_t . rel[c - t + T - 1] for c <= t,
// 0 above the diagonal; visible where c <= t or c < n_meta) and its row
// log-sum-exp `lse` (kernel D with its LSE output):
//   p = exp(s - lse);  dp = dO.V^T;  dS = p * (dp - delta) * scale,
//   delta_t = sum_d O[t, d] dO[t, d]
//   dV = p^T.dO;  dK = dS^T.Q;  dQ = dS.K + dP_band.Band
//   dRel[i] = sum over b and (t, c <= t) with c - t + T - 1 = i of dS[t, c] q_t
// Products take bf16 operands (q, k, v, dO, rel, p and dS rounded to bf16)
// and sum in f32, as the TPU kernels do; the plain version is
// ops/attention_kernel.flash_relpos_attention_bwd_plain, and each launch
// below has its own plain version there.
//
// What bounds it on an H100: operations. At the training shape (B*H = 16,
// T = 2054, d = 128) there are about 2.11 M visible (t, c) pairs a head, and
// the least backward does 8 products of 2 * 128 flops a pair (AC, BD, dp,
// dV, dK, dS.K, dP_band.Band, dRel): about 69 GFLOP, 70 us at the 989 TFLOP/s
// dense bf16 peak, against 151 MB of f32 inputs and outputs (45 us at
// 3.35 TB/s). This design recomputes AC, BD and dp in each of its three
// product launches (about 16 products a pair counted in 64 x 64 tiles, the
// band products' padding included).
//
// Five launches (graph-capturable, no atomics, no state between calls):
//  stage    bf16 copies of q, k, v, dO as (B*H, T, 128) and of rel's first T
//           rows as (H, T, 128), and delta as f32 (B*H, T), in one pass.
//  E1 (dq)  one block per (b*h, 64-row query tile), heavy tiles first; loops
//           over the key tiles up to the diagonal; dQ in registers.
//  E2 (dkv) one block per (b*h, 64-column key tile), heavy tiles first;
//           loops over the query tiles from the diagonal on; dK, dV in
//           registers.
//  E3 (drel) one block per (head, tile diagonal delta = qt - kt), heavy
//           diagonals first: every tile of a diagonal uses the same 127
//           rel rows, so the block keeps them resident, loops over the batch
//           and the diagonal's tiles in a fixed order and sums its band in
//           registers, then writes it to its slot (h, delta) of 128 rows.
//  combine  rel row i is covered by two slots (a diagonal's upper 64 rows
//           and its neighbour's lower 64): drel[h, i] = slot_lo + slot_hi,
//           in that order, and 0 for rows >= T.
// So every gradient, dRel included, has the same bits on every call and
// graph replay.
//
// Against what held the first version (two launches, E1 dQ + dRel and E2
// dK + dV) back, as an ablation of it by phase measured it in CUDA graphs
// at the training shape on an H100 80GB HBM3 at 700 W (PERF.md):
//  1. Staging: the f32 -> bf16 conversion of k, v (q, dO) and 127 band rows
//     at every tile, synchronous, was 0.80 / 0.43 ms of E1 / E2's 1.43 / 0.72.
//     Now one pass writes bf16 once (38 MB at the training shape, read back
//     from L2), and each tile's operands are copied as they are with
//     cp.async into a second buffer while the current tile computes (one
//     block barrier a tile in E1, two in E2 and E3).
//  2. Fragments: every operand is read with ldmatrix (.trans where the
//     product needs it transposed: K and the band in dQ, P^T, dS^T, dO and
//     Q in dK/dV, dP_band^T and Q in dRel) from rows padded to 272 bytes.
//  3. dRel: 0.34 ms of E1 were f32 atomicAdds into dRel, in no fixed order.
//     E3 sums each diagonal's band in registers; no float atomic is left.
//  4. The band product: 64 + 64 - 1 = 127 band rows a 64-row tile (2x the
//     work of AC) became, per warp, 16 + 32 - 1 = 47 (padded to 48) for the
//     warp's 16 rows and 32 columns (1.5x AC). A warp's BD[i][j] is read
//     back from its f32 scratch at column j - i + 15, as kernel D does.
//  5. Scheduling: E1 ran its light query tiles first, so its last wave
//     likely waited on 33-tile blocks (its staging alone took 1.8x E2's
//     for the same bytes a tile; no variant isolated the order). Every
//     launch now starts its heavy blocks
//     first (E1 from the last query tile, E2 from key tile 0, E3 from
//     diagonal 0).
// Warp layout of the recompute, shared by E1, E2 and E3: 8 warps, warp w
// owns the tile's rows 16 (w & 3) .. + 15 and columns 32 (w >> 2) .. + 31;
// AC, dp, p and dS stay in registers (FA2's layout). E1 feeds dS to dQ as
// A fragments straight from registers, and its unsheared band through a
// warp-private bf16 scratch; E2 writes bf16 P and dS to shared memory for
// the dK/dV products, in which warp w owns keys 16 (w & 3) and 64 columns of
// d; E3 writes bf16 dS unsheared into a block tile (dP_band[r][c - r + 63])
// for the dRel product, in which each warp owns two 16-row blocks of the band
// (chosen so that every warp has five 16-row k-steps with nonzero rows) and
// 64 columns of d.
// Nothing depends on T being a multiple of a tile: rows and columns at or
// beyond T are copied in as zero and masked, band rows outside [0, T) are
// zero. Warps whose rows lie past T compute zeros and keep to the barriers.
// What still holds it back (chip_smoke.py [8 flash-bwd], same card): the
// five launches take 0.95 ms in a CUDA graph, 13.6x the bound; E1, E2 and
// E3 each spend 4.2-4.8 us a 64 x 64 tile on an SM, where their products
// (4.75-6 units of 64 x 64 x 128) and the ldmatrix loads that feed them
// (a B fragment feeds one 16-row m-tile) are most of the work. The
// recompute of AC, BD and dp in three launches is half the products; E3's
// heaviest block (diagonal 0, 2 x 33 tiles at batch 2) sets its length.
// wgmma (B read once for 64 rows) and 32-row warp tiles are the next steps.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int HD = 128;         // head dim the kernel is written for
constexpr int BT = 64;          // rows of a query tile and columns of a key tile; rows of a band chunk
constexpr int NT = 256;         // 8 warps
constexpr int LDT = HD + 8;     // bf16 row stride of the staged tiles (272 B)
constexpr int WB = 48;          // band columns of a warp: 16 + 32 - 1, padded
constexpr int LDW = 56;         // f32 row stride of a warp's band scratch
constexpr int LDJ = 56;         // bf16 row stride of E1's unsheared dS (a warp's 16 x 48)
constexpr int LDS = BT + 8;     // bf16 row stride of E2's P and dS tiles (144 B)
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTile = BT * LDT * 2;            // 17,408: 64 staged rows
constexpr int kScr = 16 * LDW * 4;             // 3,584: a warp's f32 band scratch
constexpr int kJ = 16 * LDJ * 2;               // 1,792: a warp's unsheared dS (E1)
constexpr int kPS = BT * LDS * 2;              // 9,216: P or dS (E2)
constexpr int kSmemDq = 9 * kTile + 8 * kScr + 8 * kJ;         // Q, dO, 2 K, 2 V, 3 band chunks
constexpr int kSmemDkv = 9 * kTile + 8 * kScr + 2 * kPS;      // K, V, 2 Q, 2 dO, 3 band chunks
constexpr int kSmemDrel = 11 * kTile + 8 * kScr;              // 2 band chunks, 2 x (Q, dO, K, V), dP_band
static_assert(kSmemDq == 199680 && kSmemDkv == 203776 && kSmemDrel == 220160, "shared-memory budget");
static_assert(kSmemDrel <= 232448, "one block must fit in an H100 SM's 227 KB");
static_assert(WB == 16 + 32, "three pairs of band n-tiles a warp");

// Rows row0 .. row0 + 63 of a (n_rows, 128) bf16 matrix to a [64][LDT] tile
// at `dst`; rows outside [0, n_rows) become zero. All 256 threads.
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int row0, int n_rows) {
#pragma unroll
  for (int i = 0; i < BT * HD / 8 / NT; ++i) {
    const int id = threadIdx.x + i * NT, r = id >> 4, c = (id & 15) * 8;
    const int row = row0 + r;
    const bool ok = row >= 0 && row < n_rows;
    cp_async16(dst + (uint32_t)(r * LDT + c) * 2, src + (long long)(ok ? row : 0) * HD + c, ok);
  }
}

// Band chunk m of a head: rel rows T - 64 (m + 1) .. T - 64 m - 1. The
// window of tile diagonal delta = qt - kt is chunk delta (window rows
// 0..63) then chunk delta - 1 (64..127): window row w is rel row
// T - 64 - 64 delta + w, i.e. c - t + T - 1 for tile row r and column c at
// w = c - r + 63.
__device__ __forceinline__ void load_chunk(uint32_t dst, const __nv_bfloat16* relh, int m, int T) {
  load_rows(dst, relh, T - BT * (m + 1), T);
}

// The 8 A fragments (k-steps of 16) of rows r0 .. r0 + 15 of a staged tile.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[HD / 16][4], uint32_t tile, int r0, int lane) {
  const uint32_t addr = tile + (uint32_t)((r0 + (lane & 15)) * LDT + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) ldsm_x4(a[ks], addr + ks * 32);
}

struct Rows {  // a warp's view of its tile: positions and the per-row lse, delta
  int q0, k0;  // first query row and key column of the tile
  int rg, ch;  // the warp's rows 16 rg.., columns 32 ch..
  float lse2[2], dl[2];  // rows g and g + 8: lse * log2 e, delta
};

// The warp's 16 x 32 piece of a tile: p (if WITH_P) and dS in the C-fragment
// layout of 4 n-tiles (columns 32 ch + 8 n + 2 t4 + {0, 1}, rows g, g + 8).
// qa: the warp's q A fragments; s_do, s_k, s_v: the tile's dO rows, K and V
// rows; band_lo, band_hi: the slots of window rows 0..63 and 64..127; scr:
// the warp's f32 scratch.
template <bool WITH_P>
__device__ __forceinline__ void recompute(const uint32_t (&qa)[HD / 16][4], uint32_t s_do, uint32_t s_k, uint32_t s_v,
                                          uint32_t band_lo, uint32_t band_hi, float* scr, const Rows& w, int T,
                                          int n_meta, float scale, float (&p)[4][4], float (&ds)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  // BD: the warp's rows against its 48 window rows 48 + 32 ch - 16 rg + u,
  // u = j - i + 15, three pairs of n-tiles into the f32 scratch.
#pragma unroll 1
  for (int pp = 0; pp < WB / 16; ++pp) {
    const int wr = 48 + 32 * w.ch - 16 * w.rg + 16 * pp;  // a multiple of 16: one chunk
    const uint32_t slot = wr < BT ? band_lo : band_hi;
    const int row = (wr & (BT - 1)) + (lane & 7) + (lane >> 4) * 8;
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t bf[4];
      ldsm_x4(bf, slot + (uint32_t)(row * LDT + ks * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma16816(acc[0], qa[ks], bf[0], bf[1]);
      mma16816(acc[1], qa[ks], bf[2], bf[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = 16 * pp + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(scr + g * LDW + c) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(scr + (g + 8) * LDW + c) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  // AC = q.k^T and dp = dO.v^T over the warp's 32 columns.
  float s[4][4] = {}, dp[4][4] = {};
  const uint32_t a_do = s_do + (uint32_t)((16 * w.rg + (lane & 15)) * LDT + (lane >> 4) * 8) * 2;
  const int krow = 32 * w.ch + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t da[4];
    ldsm_x4(da, a_do + ks * 32);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const uint32_t off = (uint32_t)((krow + 16 * pp) * LDT + ks * 16 + ((lane >> 3) & 1) * 8) * 2;
      uint32_t bf[4];
      ldsm_x4(bf, s_k + off);
      mma16816(s[2 * pp], qa[ks], bf[0], bf[1]);
      mma16816(s[2 * pp + 1], qa[ks], bf[2], bf[3]);
      ldsm_x4(bf, s_v + off);
      mma16816(dp[2 * pp], da, bf[0], bf[1]);
      mma16816(dp[2 * pp + 1], da, bf[2], bf[3]);
    }
  }
  __syncwarp();  // the band scratch is complete
  const float scale2 = scale * kLog2e;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + 8 * (e >> 1), j = 8 * n + 2 * t4 + (e & 1);
      const int t = w.q0 + 16 * w.rg + i, c = w.k0 + 32 * w.ch + j;
      const bool vis = t < T && c < T && (c <= t || c < n_meta);
      const float bd = c <= t ? scr[i * LDW + j - i + 15] : 0.f;
      const float pv = vis ? exp2f((s[n][e] + bd) * scale2 - w.lse2[e >> 1]) : 0.f;
      if (WITH_P) p[n][e] = pv;
      ds[n][e] = pv * (dp[n][e] - w.dl[e >> 1]) * scale;
    }
  }
  __syncwarp();  // every lane has read the scratch before the next tile writes it
}

// The warp's lse and delta rows (g, g + 8) of query tile q0, for (b*h) bh.
__device__ __forceinline__ void load_row_stats(Rows& w, const float* lse, const float* delta, long long bh, int T) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int t = w.q0 + 16 * w.rg + g + 8 * hi;
    const bool ok = t < T;
    w.lse2[hi] = ok ? __ldg(lse + bh * T + t) * kLog2e : 0.f;
    w.dl[hi] = ok ? __ldg(delta + bh * T + t) : 0.f;
  }
}

// The staged tensors of (b*h) bh and head h: q, k, v, dO as (B*H, T, 128)
// then rel as (H, T, 128), bf16.
struct Staged {
  const __nv_bfloat16 *q, *k, *v, *dout, *rel;
  __device__ Staged(const __nv_bfloat16* stage, long long bh, int h, int B, int H, int T) {
    const long long n = (long long)B * H * T * HD, o = bh * T * HD;
    q = stage + o;
    k = stage + n + o;
    v = stage + 2 * n + o;
    dout = stage + 3 * n + o;
    rel = stage + 4 * n + (long long)h * T * HD;
  }
};

// The stage launch. Units of 8 values (16 bytes of bf16 out): 4 sections of
// B*H*T*16 units (q, k, v, dO; (b, h, t) strides of each) then H*T*16 of
// rel. Lanes 16 apart hold rows: the dO section also sums out * dO over its
// row's 16 lanes into delta. The loop is warp-uniform, for the shuffles.
__global__ void __launch_bounds__(256) stage_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                    const float* __restrict__ v, long long sb, long long sh,
                                                    long long st, const float* __restrict__ dout, long long dsb,
                                                    long long dsh, long long dst_, const float* __restrict__ out,
                                                    long long osb, long long osh, long long ost,
                                                    const float* __restrict__ rel, long long rel_sh,
                                                    __nv_bfloat16* __restrict__ stage, float* __restrict__ delta,
                                                    int H, int T, long long n_sec, long long n_all) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n_all; base += stride) {
    const long long i = base + lane;
    const bool ok = i < n_all;
    const int sec = ok ? (int)min(i / n_sec, 4LL) : 5;
    const long long row = ok ? (i - sec * n_sec) >> 4 : 0;
    const int c = (int)(i & 15) * 8;
    float part = 0.f;
    if (ok) {
      const float* src;
      if (sec < 4) {
        const long long bh = row / T;
        const int t = (int)(row - bh * T), b = (int)(bh / H), h = (int)(bh % H);
        src = sec == 3 ? dout + b * dsb + h * dsh + t * dst_ + c
                       : (sec == 0 ? q : sec == 1 ? k : v) + b * sb + h * sh + t * st + c;
        if (sec == 3) {
          const float* o = out + b * osb + h * osh + t * ost + c;
          const float4 o0 = __ldg(reinterpret_cast<const float4*>(o));
          const float4 o1 = __ldg(reinterpret_cast<const float4*>(o + 4));
          const float4 d0 = __ldg(reinterpret_cast<const float4*>(src));
          const float4 d1 = __ldg(reinterpret_cast<const float4*>(src + 4));
          part = o0.x * d0.x + o0.y * d0.y + o0.z * d0.z + o0.w * d0.w + o1.x * d1.x + o1.y * d1.y +
                 o1.z * d1.z + o1.w * d1.w;
        }
      } else {
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
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) part += __shfl_xor_sync(0xffffffffu, part, x);
    if (ok && sec == 3 && (i & 15) == 0) delta[row] = part;
  }
}

// E1: dQ. Grid (B*H, query tiles), the last query tile first.
__global__ void __launch_bounds__(NT, 1) dq_kernel(const __nv_bfloat16* __restrict__ stage,
                                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                                   float* __restrict__ dq, int B, int H, int T, int n_meta,
                                                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const uint32_t s_q = smem_u32(smem), s_do = s_q + kTile, s_k = s_q + 2 * kTile, s_v = s_q + 4 * kTile,
                 s_band = s_q + 6 * kTile;
  float* scr = reinterpret_cast<float*>(smem + 9 * kTile + warp * kScr);
  __nv_bfloat16* sj = reinterpret_cast<__nv_bfloat16*>(smem + 9 * kTile + 8 * kScr + warp * kJ);
  const int bh = blockIdx.x, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const Staged x(stage, bh, h, B, H, T);
  Rows w;
  w.q0 = qt * BT;
  w.rg = warp & 3;
  w.ch = warp >> 2;

  // Chunk m lives in ring slot m mod 3 (m >= -1); key tile kt reads chunks
  // qt - kt and qt - kt - 1.
  auto slot = [&](int m) { return s_band + (uint32_t)(((m + 3) % 3) * kTile); };
  load_rows(s_q, x.q, w.q0, T);
  load_rows(s_do, x.dout, w.q0, T);
  load_rows(s_k, x.k, 0, T);
  load_rows(s_v, x.v, 0, T);
  load_chunk(slot(qt), x.rel, qt, T);
  load_chunk(slot(qt - 1), x.rel, qt - 1, T);
  cp_async_commit();
  {  // the unsheared dS positions no tile writes stay zero
    uint32_t* z = reinterpret_cast<uint32_t*>(sj);
    for (int i = lane; i < kJ / 4; i += 32) z[i] = 0u;
  }
  load_row_stats(w, lse, delta, bh, T);

  float acc[HD / 8][4] = {};
  uint32_t qa[HD / 16][4];
  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt's operands are in; every warp is done with tile kt - 1's
    if (kt == 0) load_a_frags(qa, s_q, 16 * w.rg, lane);
    if (kt < qt) {
      const int nb = (kt + 1) & 1;
      load_rows(s_k + nb * kTile, x.k, (kt + 1) * BT, T);
      load_rows(s_v + nb * kTile, x.v, (kt + 1) * BT, T);
      load_chunk(slot(qt - kt - 2), x.rel, qt - kt - 2, T);
    }
    cp_async_commit();
    const int d = qt - kt, cb = kt & 1;
    const uint32_t kk = s_k + cb * kTile, lo = slot(d), hi = slot(d - 1);
    w.k0 = kt * BT;
    float p[4][4], ds[4][4];
    recompute<false>(qa, s_do, kk, s_v + cb * kTile, lo, hi, scr, w, T, n_meta, scale, p, ds);

    // dQ += dS.K over the warp's 32 keys: dS's C fragments are the A fragments.
#pragma unroll
    for (int kk2 = 0; kk2 < 2; ++kk2) {
      const uint32_t ua[4] = {pack_bf16(ds[2 * kk2][0], ds[2 * kk2][1]), pack_bf16(ds[2 * kk2][2], ds[2 * kk2][3]),
                              pack_bf16(ds[2 * kk2 + 1][0], ds[2 * kk2 + 1][1]),
                              pack_bf16(ds[2 * kk2 + 1][2], ds[2 * kk2 + 1][3])};
      const int row = 32 * w.ch + 16 * kk2 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, kk + (uint32_t)(row * LDT + 16 * np + (lane >> 4) * 8) * 2);
        mma16816(acc[2 * np], ua, bf[0], bf[1]);
        mma16816(acc[2 * np + 1], ua, bf[2], bf[3]);
      }
    }
    // dQ += dP_band.Band: dS (c <= t) unsheared to sj[i][j - i + 15].
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), j = 8 * n + 2 * t4 + (e & 1);
        const bool below = w.k0 + 32 * w.ch + j <= w.q0 + 16 * w.rg + i;
        sj[i * LDJ + j - i + 15] = __float2bfloat16_rn(below ? ds[n][e] : 0.f);
      }
    }
    __syncwarp();
    const uint32_t a_j = smem_u32(sj) + (uint32_t)((lane & 15) * LDJ + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int ku = 0; ku < WB / 16; ++ku) {
      uint32_t ub[4];
      ldsm_x4(ub, a_j + ku * 32);
      const int wr = 48 + 32 * w.ch - 16 * w.rg + 16 * ku;
      const uint32_t bs = wr < BT ? lo : hi;
      const int row = (wr & (BT - 1)) + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + (uint32_t)(row * LDT + 16 * np + (lane >> 4) * 8) * 2);
        mma16816(acc[2 * np], ub, bf[0], bf[1]);
        mma16816(acc[2 * np + 1], ub, bf[2], bf[3]);
      }
    }
    __syncwarp();  // the unsheared scratch is read before the next tile writes it
  }

  // The two warps of a row group each hold half the keys' sum: each takes
  // the other's half of d through shared memory (a + b == b + a, so both
  // halves have one order), then writes its own half.
  cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + 2 * kTile);  // the K and V buffers: 8 warps x 16 x 64 f32
  // (Selects between constant indices keep acc in registers.)
  const bool second = w.ch == 1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * t4;
    float* r = red + (size_t)warp * 16 * 64;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = second ? acc[n][e] : acc[8 + n][e];
    *reinterpret_cast<float2*>(r + g * 64 + c) = make_float2(o[0], o[1]);
    *reinterpret_cast<float2*>(r + (g + 8) * 64 + c) = make_float2(o[2], o[3]);
  }
  __syncthreads();
  const float* r = red + (size_t)(warp ^ 4) * 16 * 64;  // the partner warp: same rows, other keys
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = w.q0 + 16 * w.rg + g + 8 * hi;
      const int c = 8 * n + 2 * t4;
      const float2 o = *reinterpret_cast<const float2*>(r + (g + 8 * hi) * 64 + c);
      const float m0 = second ? acc[8 + n][2 * hi] : acc[n][2 * hi];
      const float m1 = second ? acc[8 + n][2 * hi + 1] : acc[n][2 * hi + 1];
      if (t < T)
        *reinterpret_cast<float2*>(dq + ((long long)bh * T + t) * HD + w.ch * 64 + c) = make_float2(m0 + o.x, m1 + o.y);
    }
  }
}

// E2: dK and dV. Grid (B*H, key tiles), key tile 0 (the most query tiles) first.
__global__ void __launch_bounds__(NT, 1) dkv_kernel(const __nv_bfloat16* __restrict__ stage,
                                                    const float* __restrict__ lse, const float* __restrict__ delta,
                                                    float* __restrict__ dk, float* __restrict__ dv, int B, int H,
                                                    int T, int n_meta, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const uint32_t s_k = smem_u32(smem), s_v = s_k + kTile, s_q = s_k + 2 * kTile, s_do = s_k + 4 * kTile,
                 s_band = s_k + 6 * kTile;
  float* scr = reinterpret_cast<float*>(smem + 9 * kTile + warp * kScr);
  unsigned char* ps = smem + 9 * kTile + 8 * kScr;
  uint32_t* sp = reinterpret_cast<uint32_t*>(ps);
  uint32_t* sds = reinterpret_cast<uint32_t*>(ps + kPS);
  const int bh = blockIdx.x, h = bh % H;
  const int kt = blockIdx.y, n_q = (T + BT - 1) / BT;
  const Staged x(stage, bh, h, B, H, T);
  Rows w;
  w.k0 = kt * BT;
  w.rg = warp & 3;
  w.ch = warp >> 2;
  const int kg = warp & 3, dh = warp >> 2;  // the dK/dV layout: keys 16 kg.., d 64 dh..

  // Query tile qt = kt + m (m = 0, 1, ...) reads chunks m and m - 1; chunk m
  // lives in ring slot m mod 3.
  auto slot = [&](int m) { return s_band + (uint32_t)(((m + 3) % 3) * kTile); };
  load_rows(s_k, x.k, w.k0, T);
  load_rows(s_v, x.v, w.k0, T);
  load_rows(s_q, x.q, w.k0, T);
  load_rows(s_do, x.dout, w.k0, T);
  load_chunk(slot(0), x.rel, 0, T);
  load_chunk(slot(-1), x.rel, -1, T);
  cp_async_commit();

  float acc_k[8][4] = {}, acc_v[8][4] = {};
  for (int m = 0; kt + m < n_q; ++m) {
    cp_async_wait_all();
    __syncthreads();  // tile m's operands are in; every warp is done with tile m - 1's
    if (kt + m + 1 < n_q) {
      const int nb = (m + 1) & 1;
      load_rows(s_q + nb * kTile, x.q, (kt + m + 1) * BT, T);
      load_rows(s_do + nb * kTile, x.dout, (kt + m + 1) * BT, T);
      load_chunk(slot(m + 1), x.rel, m + 1, T);
    }
    cp_async_commit();
    const uint32_t qq = s_q + (m & 1) * kTile, dd = s_do + (m & 1) * kTile;
    w.q0 = (kt + m) * BT;
    load_row_stats(w, lse, delta, bh, T);
    uint32_t qa[HD / 16][4];
    load_a_frags(qa, qq, 16 * w.rg, lane);
    float p[4][4], ds[4][4];
    recompute<true>(qa, dd, s_k, s_v, slot(m), slot(m - 1), scr, w, T, n_meta, scale, p, ds);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int o = ((16 * w.rg + g + 8 * hi) * LDS + 32 * w.ch + 8 * n + 2 * t4) / 2;
        sp[o] = pack_bf16(p[n][2 * hi], p[n][2 * hi + 1]);
        sds[o] = pack_bf16(ds[n][2 * hi], ds[n][2 * hi + 1]);
      }
    }
    __syncthreads();  // P and dS of the whole tile
    // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] q[r][d].
#pragma unroll
    for (int kq = 0; kq < BT / 16; ++kq) {
      const uint32_t arow =
          (uint32_t)((16 * kq + (lane & 7) + (lane >> 4) * 8) * LDS + 16 * kg + ((lane >> 3) & 1) * 8) * 2;
      uint32_t ap[4], ad[4];
      ldsm_x4_trans(ap, smem_u32(sp) + arow);
      ldsm_x4_trans(ad, smem_u32(sds) + arow);
      const int brow = 16 * kq + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint32_t off = (uint32_t)(brow * LDT + 64 * dh + 16 * np + (lane >> 4) * 8) * 2;
        uint32_t bf[4];
        ldsm_x4_trans(bf, dd + off);
        mma16816(acc_v[2 * np], ap, bf[0], bf[1]);
        mma16816(acc_v[2 * np + 1], ap, bf[2], bf[3]);
        ldsm_x4_trans(bf, qq + off);
        mma16816(acc_k[2 * np], ad, bf[0], bf[1]);
        mma16816(acc_k[2 * np + 1], ad, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int s = w.k0 + 16 * kg + g + 8 * hi;
      if (s < T) {
        const long long o = ((long long)bh * T + s) * HD + 64 * dh + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(dk + o) = make_float2(acc_k[n][2 * hi], acc_k[n][2 * hi + 1]);
        *reinterpret_cast<float2*>(dv + o) = make_float2(acc_v[n][2 * hi], acc_v[n][2 * hi + 1]);
      }
    }
  }
}

// E3: dRel's slots. Grid (H, tile diagonals), diagonal 0 (the most tiles)
// first. The block of diagonal d walks b = 0 .. B-1, then key tiles kt = 0 ..
// n - 1 - d (query tile kt + d), and sums dP_band^T.Q for window rows 0..127
// into slot (h, d): f32 (H, n, 128, 128).
__global__ void __launch_bounds__(NT, 1) drel_kernel(const __nv_bfloat16* __restrict__ stage,
                                                     const float* __restrict__ lse, const float* __restrict__ delta,
                                                     float* __restrict__ slots, int B, int H, int T, int n_meta,
                                                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const uint32_t s_lo = smem_u32(smem), s_hi = s_lo + kTile, s_ops = s_lo + 2 * kTile;  // then 2 x (Q, dO, K, V)
  float* scr = reinterpret_cast<float*>(smem + 10 * kTile + warp * kScr);
  __nv_bfloat16* spb = reinterpret_cast<__nv_bfloat16*>(smem + 10 * kTile + 8 * kScr);  // [64 r][LDT] window rows
  const int h = blockIdx.x, d = blockIdx.y, n_t = (T + BT - 1) / BT;
  const int per_b = n_t - d, n_it = B * per_b;
  Rows w;
  w.rg = warp & 3;
  w.ch = warp >> 2;
  // The dRel layout: two 16-row blocks of the window and 64 columns of d. A
  // block ub has nonzero dP_band rows only in k-steps max(0, 3 - ub) ..
  // min(3, 7 - ub): 1, 2, 3, 4, 4, 3, 2, 1 of them, so the pairs (0, 3),
  // (1, 2), (4, 7), (5, 6) have five each.
  const int pair = warp & 3, dh = warp >> 2;
  const int ub0 = pair < 2 ? pair : 2 + pair, ub1 = pair < 2 ? 3 - pair : 9 - pair;

  auto ops = [&](int buf, int which) { return s_ops + (uint32_t)((buf * 4 + which) * kTile); };
  auto issue = [&](int it, int buf) {  // the operands of iteration it
    const int b = it / per_b, kt = it - b * per_b;
    const Staged x(stage, (long long)b * H + h, h, B, H, T);
    load_rows(ops(buf, 0), x.q, (kt + d) * BT, T);
    load_rows(ops(buf, 1), x.dout, (kt + d) * BT, T);
    load_rows(ops(buf, 2), x.k, kt * BT, T);
    load_rows(ops(buf, 3), x.v, kt * BT, T);
  };
  {
    const Staged x(stage, h, h, B, H, T);
    load_chunk(s_lo, x.rel, d, T);
    load_chunk(s_hi, x.rel, d - 1, T);
  }
  issue(0, 0);
  cp_async_commit();
  {  // the window positions no tile writes stay zero
    uint32_t* z = reinterpret_cast<uint32_t*>(spb);
    for (int i = threadIdx.x; i < kTile / 4; i += NT) z[i] = 0u;
  }

  float acc[2][8][4] = {};
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();  // iteration it's operands are in; every warp is done with it - 1's and with dP_band
    if (it + 1 < n_it) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int b = it / per_b, kt = it - b * per_b, buf = it & 1;
    w.q0 = (kt + d) * BT;
    w.k0 = kt * BT;
    load_row_stats(w, lse, delta, (long long)b * H + h, T);
    uint32_t qa[HD / 16][4];
    load_a_frags(qa, ops(buf, 0), 16 * w.rg, lane);
    float p[4][4], ds[4][4];
    recompute<false>(qa, ops(buf, 1), ops(buf, 2), ops(buf, 3), s_lo, s_hi, scr, w, T, n_meta, scale, p, ds);
    // dP_band[r][c - r + 63] = dS[r][c] for c <= t.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * w.rg + g + 8 * (e >> 1), c = 32 * w.ch + 8 * n + 2 * t4 + (e & 1);
        spb[r * LDT + c - r + BT - 1] = __float2bfloat16_rn(w.k0 + c <= w.q0 + r ? ds[n][e] : 0.f);
      }
    }
    __syncthreads();  // dP_band of the whole tile
    // acc[x][window row 16 ub_x + .][d 64 dh + .] += sum_r dP_band[r][row] q[r][d].
    const uint32_t qq = ops(buf, 0);
#pragma unroll
    for (int kr = 0; kr < BT / 16; ++kr) {
      const bool use0 = kr >= 3 - ub0 && kr <= 7 - ub0, use1 = kr >= 3 - ub1 && kr <= 7 - ub1;
      if (!use0 && !use1) continue;
      uint32_t bq[4][4];
      const int brow = 16 * kr + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4_trans(bq[np], qq + (uint32_t)(brow * LDT + 64 * dh + 16 * np + (lane >> 4) * 8) * 2);
      const int arow = 16 * kr + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
      for (int x2 = 0; x2 < 2; ++x2) {
        if (!(x2 ? use1 : use0)) continue;
        uint32_t a[4];
        ldsm_x4_trans(a, smem_u32(spb) + (uint32_t)(arow * LDT + 16 * (x2 ? ub1 : ub0) + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma16816(acc[x2][2 * np], a, bq[np][0], bq[np][1]);
          mma16816(acc[x2][2 * np + 1], a, bq[np][2], bq[np][3]);
        }
      }
    }
  }

#pragma unroll
  for (int x2 = 0; x2 < 2; ++x2) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int wr = 16 * (x2 ? ub1 : ub0) + g + 8 * hi;
        float* o = slots + (((long long)h * n_t + d) * 2 * BT + wr) * HD + 64 * dh + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(o) = make_float2(acc[x2][n][2 * hi], acc[x2][n][2 * hi + 1]);
      }
    }
  }
}

// The combine: drel[h, i] = slot(h, d1)[w1] + slot(h, d1 + 1)[w1 + 64] for
// i < T (d1 = (T - 1 - i) / 64, w1 = i - T + 64 + 64 d1), in that order;
// zero for T <= i < R. Four values a thread.
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ slots, float* __restrict__ drel,
                                                      long long drel_sh, int H, int T, int R, int n_t) {
  const long long n_all = (long long)H * R * (HD / 4);
  for (long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x; id < n_all;
       id += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(id % (HD / 4)) * 4;
    const long long hr = id / (HD / 4);
    const int h = (int)(hr / R), i = (int)(hr % R);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < T) {
      const int d1 = (T - 1 - i) / BT, w1 = i - T + BT + BT * d1;
      v = __ldg(reinterpret_cast<const float4*>(slots + (((long long)h * n_t + d1) * 2 * BT + w1) * HD + c));
      if (d1 + 1 < n_t) {
        const float4 u = __ldg(
            reinterpret_cast<const float4*>(slots + (((long long)h * n_t + d1 + 1) * 2 * BT + w1 + BT) * HD + c));
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
    }
    *reinterpret_cast<float4*>(drel + h * drel_sh + (long long)i * HD + c) = v;
  }
}

bool bad_shape(int B, int H, int T, int D, int n_meta) {
  return B < 1 || H < 1 || T < 1 || D != HD || n_meta < 1 || n_meta > BT || (T + BT - 1) / BT > 65535;
}

int grid_stride_blocks(long long n) { return (int)std::min<long long>((n + 255) / 256, 8LL * mg_sm_count()); }

}  // namespace

// q, k, v: f32 (B, H, T, 128), element (b, h, t, d) at b*sb + h*sh + t*st + d
// (one set of strides, 16-byte aligned rows); dout and out: the same shape
// with their own strides; rel: f32 (H, >= T, 128), head h at h*rel_sh.
// stage: bf16 of (4*B*H + H)*T*128 values, 16-byte aligned (q, k, v, dO,
// then rel's first T rows; ops/attention_kernel.bwd_stage_plain); delta:
// f32 (B*H, T).
MG_EXPORT int mg_flash_bwd_stage(const float* q, const float* k, const float* v, long long sb, long long sh,
                                 long long st, const float* dout, long long dsb, long long dsh, long long dst_,
                                 const float* out, long long osb, long long osh, long long ost, const float* rel,
                                 long long rel_sh, void* stage, float* delta, int B, int H, int T, int D,
                                 void* stream) {
  if (bad_shape(B, H, T, D, 1) || stage == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_sec = (long long)B * H * T * (HD / 8), n_all = 4 * n_sec + (long long)H * T * (HD / 8);
  stage_kernel<<<grid_stride_blocks(n_all), 256, 0, (cudaStream_t)stream>>>(
      q, k, v, sb, sh, st, dout, dsb, dsh, dst_, out, osb, osh, ost, rel, rel_sh,
      static_cast<__nv_bfloat16*>(stage), delta, H, T, n_sec, n_all);
  return (int)cudaGetLastError();
}

// E1. lse: f32 (B*H, T); dq: f32 (B, H, T, 128) contiguous.
MG_EXPORT int mg_flash_bwd_dq(const void* stage, const float* lse, const float* delta, float* dq, int B, int H, int T,
                              int D, int n_meta, float scale, void* stream) {
  if (bad_shape(B, H, T, D, n_meta)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3(B * H, (T + BT - 1) / BT), NT, kSmemDq, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(stage), lse, delta, dq, B, H, T, n_meta, scale);
  return (int)cudaGetLastError();
}

// E2. dk, dv: f32 (B, H, T, 128) contiguous.
MG_EXPORT int mg_flash_bwd_dkv(const void* stage, const float* lse, const float* delta, float* dk, float* dv, int B,
                               int H, int T, int D, int n_meta, float scale, void* stream) {
  if (bad_shape(B, H, T, D, n_meta)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<<<dim3(B * H, (T + BT - 1) / BT), NT, kSmemDkv, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(stage), lse, delta, dk, dv, B, H, T, n_meta, scale);
  return (int)cudaGetLastError();
}

// E3. slots: f32 (H, ceil(T / 64), 128, 128).
MG_EXPORT int mg_flash_bwd_drel(const void* stage, const float* lse, const float* delta, float* slots, int B, int H,
                                int T, int D, int n_meta, float scale, void* stream) {
  if (bad_shape(B, H, T, D, n_meta)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(drel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDrel);
  if (e != cudaSuccess) return (int)e;
  drel_kernel<<<dim3(H, (T + BT - 1) / BT), NT, kSmemDrel, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(stage), lse, delta, slots, B, H, T, n_meta, scale);
  return (int)cudaGetLastError();
}

// The combine. drel: f32 (H, R >= T, 128), head h at h*drel_sh, rows 16-byte aligned.
MG_EXPORT int mg_flash_bwd_drel_combine(const float* slots, float* drel, long long drel_sh, int H, int T, int R,
                                        void* stream) {
  if (H < 1 || T < 1 || R < T || (T + BT - 1) / BT > 65535) return (int)cudaErrorInvalidValue;
  const long long n_all = (long long)H * R * (HD / 4);
  combine_kernel<<<grid_stride_blocks(n_all), 256, 0, (cudaStream_t)stream>>>(slots, drel, drel_sh, H, T, R,
                                                                             (T + BT - 1) / BT);
  return (int)cudaGetLastError();
}
