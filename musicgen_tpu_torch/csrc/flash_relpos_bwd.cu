// Kernel E: the backward of kernel D (flash rel-pos attention), for training.
//
// Replaces musicgen_tpu/ops/pallas_attention.py `_flash_bwd_dq_kernel` (E1
// here) and `_flash_bwd_dkv_kernel` (E2 here), via `_flash_bwd` under the
// custom VJP of `flash_relpos_attention_train`. Per (b, h), with the forward's
// scores s = (q.k^T + BD) * scale (BD[t, c] = q_t . rel[c - t + T - 1] for
// c <= t, 0 above the diagonal; visible where c <= t or c < n_meta) and its
// row log-sum-exp `lse` (kernel D with its LSE output):
//   p = exp(s - lse);  dp = dO.V^T;  dS = p * (dp - delta) * scale,
//   delta_t = sum_d O[t, d] dO[t, d]   (computed by the caller, as XLA did)
//   dV = p^T.dO;  dK = dS^T.Q;  dQ = dS.K + dP_band.Band
//   dRel[i] = sum over (t, c <= t) with c - t + T - 1 = i of dS[t, c] q_t
// Products take bf16 operands (q, k, v, dO, rel, p and dS rounded to bf16)
// and sum in f32, as the TPU kernels do; the plain version is
// ops/attention_kernel.flash_relpos_attention_bwd_plain.
//
// What bounds it on an H100: operations. At the training shape (B*H = 16,
// T = 2054, d = 128) there are about 2.11 M visible (t, c) pairs a head, and
// the least backward does 8 products of 2 * 128 flops a pair (AC, BD, dp,
// dV, dK, dS.K, dP_band.Band, dRel): about 69 GFLOP, 70 us at the 989 TFLOP/s
// dense bf16 peak, against 151 MB of f32 inputs and outputs (45 us at
// 3.35 TB/s). This first version recomputes AC, BD and dp in both launches
// (11 products a pair) and is not tuned.
//
// Design (simple and right first; fusing E1 and E2, wgmma and TMA are later
// work). Tiles are 64 query rows by 64 key columns, 256 threads (8 warps),
// mma.sync m16n8k16 (bf16 in, f32 out). Both launches recompute a tile the
// same way: q, dO, k, v and the rel band of 64 + 64 - 1 rows go to bf16 in
// shared memory; the band product Q.Band^T (64 x 128) is kept in shared
// memory and BD read from it at band row c - r + 63 (as kernel D does); AC
// and dp stay in registers; p and dS are formed in registers from the f32
// lse and delta rows and written to shared memory in bf16. Operands whose
// product needs them transposed are read as bf16 pairs from two rows.
//  * E1, dQ + dRel: one block per (b*h, 64-row query tile), looping over the
//    key tiles up to the diagonal (tile 0 always: it holds the metadata
//    columns). dQ sums in registers. dS is also "unsheared" into a
//    zero-initialised bf16 band tile, dP_band[r][c - r + 63] = dS[r][c] (the
//    TPU kernel's roll and permutation matmuls are an artifact of its vector
//    unit; here it is a scatter into shared memory), which gives
//    dQ += dP_band.Band and dRel_band = dP_band^T.Q. The TPU kernel summed
//    dRel per b*h in VMEM (1.25 MB at this T), which does not fit in 227 KB,
//    and blocks here run in no order: each block adds its band into the f32
//    (H, rows, 128) dRel with atomicAdd, which also sums over the batch (XLA's
//    sum in the TPU version). Only rel rows in [0, T) are written; the
//    caller zero-fills the buffer.
//  * E2, dK + dV: one block per (b*h, 64-column key tile), looping over the
//    query tiles from the diagonal on (every query tile for key tile 0).
//    dK and dV sum in registers.
// Nothing depends on T being a multiple of a tile: rows and columns at or
// beyond T are staged as zero and masked, band rows outside [0, T) are zero.
// Shared memory: 174,592 bytes a block (one block an SM).
#include "common.cuh"

namespace {

constexpr int HD = 128;          // head dim the kernel is written for
constexpr int BQ = 64;           // query rows of a tile
constexpr int BK = 64;           // key columns of a tile
constexpr int NBAND = BQ + BK;   // 127 band rows used, padded to 128
constexpr int LDB = HD + 8;      // bf16 row stride of the [row][d] tiles
constexpr int LDT = BK + 8;      // bf16 row stride of the [r][c] tiles (p, dS)
constexpr int LDJ = NBAND + 8;   // bf16 row stride of the unsheared [r][j] tile
constexpr int LDP = NBAND + 4;   // f32 row stride of the band product
constexpr int NT = 256;          // 8 warps
static_assert(BQ == 64 && BK == 64 && NT == 256, "the warp layout below assumes 64 x 64 tiles and 8 warps");

constexpr size_t kRowTile = (size_t)BQ * LDB * 2;  // q, dO, k, v (BQ == BK)
constexpr size_t kBandBytes = (size_t)NBAND * LDB * 2;
constexpr size_t kPBBytes = (size_t)BQ * LDP * 4;
constexpr size_t kTileBytes = (size_t)BQ * LDT * 2;  // p, dS
constexpr size_t kPJBytes = (size_t)BQ * LDJ * 2;
constexpr size_t kStatBytes = (size_t)2 * BQ * 4;
constexpr size_t kSmem = 4 * kRowTile + kBandBytes + kPBBytes + 2 * kTileBytes + kPJBytes + kStatBytes;

struct Smem {
  __nv_bfloat16 *q, *dout, *k, *v, *band, *p, *ds, *pj;
  float *pb, *lse, *delta;
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem s;
  s.q = reinterpret_cast<__nv_bfloat16*>(base);
  s.dout = reinterpret_cast<__nv_bfloat16*>(base + kRowTile);
  s.k = reinterpret_cast<__nv_bfloat16*>(base + 2 * kRowTile);
  s.v = reinterpret_cast<__nv_bfloat16*>(base + 3 * kRowTile);
  s.band = reinterpret_cast<__nv_bfloat16*>(base + 4 * kRowTile);
  s.pb = reinterpret_cast<float*>(base + 4 * kRowTile + kBandBytes);
  s.p = reinterpret_cast<__nv_bfloat16*>(base + 4 * kRowTile + kBandBytes + kPBBytes);
  s.ds = reinterpret_cast<__nv_bfloat16*>(base + 4 * kRowTile + kBandBytes + kPBBytes + kTileBytes);
  s.pj = reinterpret_cast<__nv_bfloat16*>(base + 4 * kRowTile + kBandBytes + kPBBytes + 2 * kTileBytes);
  s.lse = reinterpret_cast<float*>(base + 4 * kRowTile + kBandBytes + kPBBytes + 2 * kTileBytes + kPJBytes);
  s.delta = s.lse + BQ;
  return s;
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Two bf16 values from two addresses, packed low half first.
__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t4 = lane % 4). A is the 16 x 16
// tile at (m0, k0), B the 16 x 8 tile at (k0, n0); `ld` is the row stride of
// the shared-memory array S holding the matrix.
// A with S = A row-major ([m][k]).
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* s, int ld, int m0, int k0, int g, int t4) {
  const __nv_bfloat16* p = s + (m0 + g) * ld + k0 + 2 * t4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// A with S = A^T row-major ([k][m]).
__device__ __forceinline__ void frag_a_t(uint32_t a[4], const __nv_bfloat16* s, int ld, int m0, int k0, int g,
                                         int t4) {
  const __nv_bfloat16* p = s + (k0 + 2 * t4) * ld + m0 + g;
  a[0] = pack2(p, p + ld);
  a[1] = pack2(p + 8, p + ld + 8);
  a[2] = pack2(p + 8 * ld, p + 9 * ld);
  a[3] = pack2(p + 8 * ld + 8, p + 9 * ld + 8);
}
// B with S = B^T row-major ([n][k]).
__device__ __forceinline__ void frag_b(uint32_t b[2], const __nv_bfloat16* s, int ld, int k0, int n0, int g, int t4) {
  const __nv_bfloat16* p = s + (n0 + g) * ld + k0 + 2 * t4;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
// B with S = B row-major ([k][n]).
__device__ __forceinline__ void frag_b_t(uint32_t b[2], const __nv_bfloat16* s, int ld, int k0, int n0, int g,
                                         int t4) {
  const __nv_bfloat16* p = s + (k0 + 2 * t4) * ld + n0 + g;
  b[0] = pack2(p, p + ld);
  b[1] = pack2(p + 8 * ld, p + 9 * ld);
}

// Rows [0, nrows) of 128 f32 values, row r at row(r) and valid when ok(r),
// to bf16 rows of stride LDB at `dst`; invalid rows become zero.
template <class Valid, class Row>
__device__ void stage_rows(__nv_bfloat16* dst, int nrows, Valid ok, Row row) {
  for (int i = threadIdx.x; i < nrows * (HD / 4); i += NT) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok(r)) x = __ldg(reinterpret_cast<const float4*>(row(r) + d));
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst + r * LDB + d);
    o[0] = __floats2bfloat162_rn(x.x, x.y);
    o[1] = __floats2bfloat162_rn(x.z, x.w);
  }
}

// The query side of a tile: q and dO rows, lse and delta.
__device__ void stage_query(const Smem& sm, const float* qb, const float* dob, long long st, long long dst_,
                            const float* lse, const float* delta, long long row0, int q_start, int T) {
  stage_rows(sm.q, BQ, [&](int r) { return q_start + r < T; }, [&](int r) { return qb + (long long)(q_start + r) * st; });
  stage_rows(sm.dout, BQ, [&](int r) { return q_start + r < T; },
             [&](int r) { return dob + (long long)(q_start + r) * dst_; });
  if (threadIdx.x < BQ) {
    const int t = q_start + threadIdx.x;
    sm.lse[threadIdx.x] = t < T ? lse[row0 + t] : 0.f;
    sm.delta[threadIdx.x] = t < T ? delta[row0 + t] : 0.f;
  }
}

// The 127 rel rows of a tile's band: row j holds rel[band0 + j].
__device__ void stage_band(const Smem& sm, const float* relh, int band0, int T) {
  stage_rows(sm.band, NBAND, [&](int j) { return j < NBAND - 1 && band0 + j >= 0 && band0 + j < T; },
             [&](int j) { return relh + (long long)(band0 + j) * HD; });
}

// Recompute one 64 x 64 tile (query row r, key column c) from the staged
// operands: bf16(p) to sm.p when `with_p`, bf16(dS) to sm.ds and, when
// `with_band`, unsheared to sm.pj[r][c - r + 63] (which the caller zeroed).
// Starts after a barrier that made the staging visible; ends with one.
__device__ void recompute_tile(const Smem& sm, int q_start, int k_start, int T, int n_meta, float scale, bool with_p,
                               bool with_band) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  uint32_t a[4], b[2];
  {  // band product pb[r][j] = q_r . band_j: rows 16 mt.., columns 64 half.. (8 n-tiles)
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      frag_a(a, sm.q, LDB, mt * 16, k0, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b(b, sm.band, LDB, k0, (half * 8 + j) * 8, g, t4);
        mma16816(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = mt * 16 + g, c = (half * 8 + j) * 8 + 2 * t4;
      sm.pb[r * LDP + c] = acc[j][0];
      sm.pb[r * LDP + c + 1] = acc[j][1];
      sm.pb[(r + 8) * LDP + c] = acc[j][2];
      sm.pb[(r + 8) * LDP + c + 1] = acc[j][3];
    }
  }
  // AC = q.k^T and dp = dO.v^T: rows 16 mt.., columns 32 half.. (4 n-tiles).
  float acc_s[4][4], acc_dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_s[j][i] = acc_dp[j][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 16) {
    uint32_t ad[4];
    frag_a(a, sm.q, LDB, mt * 16, k0, g, t4);
    frag_a(ad, sm.dout, LDB, mt * 16, k0, g, t4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      frag_b(b, sm.k, LDB, k0, (half * 4 + j) * 8, g, t4);
      mma16816(acc_s[j], a, b);
      frag_b(b, sm.v, LDB, k0, (half * 4 + j) * 8, g, t4);
      mma16816(acc_dp[j], ad, b);
    }
  }
  __syncthreads();  // the band product is complete
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 16 + g + 8 * (i >> 1), c = (half * 4 + j) * 8 + 2 * t4 + (i & 1);
      const int t = q_start + r, s = k_start + c;
      float p = 0.f, ds = 0.f;
      if (t < T && s < T && (s <= t || s < n_meta)) {
        const float sv = (acc_s[j][i] + sm.pb[r * LDP + c - r + BQ - 1]) * scale;
        p = expf(sv - sm.lse[r]);
        ds = p * (acc_dp[j][i] - sm.delta[r]) * scale;
      }
      const __nv_bfloat16 ds16 = __float2bfloat16_rn(ds);
      if (with_p) sm.p[r * LDT + c] = __float2bfloat16_rn(p);
      sm.ds[r * LDT + c] = ds16;
      if (with_band) sm.pj[r * LDJ + c - r + BQ - 1] = ds16;
    }
  }
  __syncthreads();
}

// E1: dQ and dRel. Grid (query tiles, B*H).
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, long long sb, long long sh,
    long long st, const float* __restrict__ dout, long long dsb, long long dsh, long long dst_,
    const float* __restrict__ rel, long long rel_sh, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ drel, long long drel_sh, int H, int T, int n_meta, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_start = blockIdx.x * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  const float* qb = q + b * sb + h * sh;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* relh = rel + h * rel_sh;
  float* drelh = drel + h * drel_sh;

  float acc_dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dq[j][i] = 0.f;

  stage_query(sm, qb, dob, st, dst_, lse, delta, (long long)bh * T, q_start, T);
  const int last_row = min(q_start + BQ - 1, T - 1);
  const int n_tiles = last_row / BK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * BK;
    const int band0 = T - 1 + k_start - q_start - (BQ - 1);
    stage_band(sm, relh, band0, T);
    stage_rows(sm.k, BK, [&](int c) { return k_start + c < T; }, [&](int c) { return kb + (long long)(k_start + c) * st; });
    stage_rows(sm.v, BK, [&](int c) { return k_start + c < T; }, [&](int c) { return vb + (long long)(k_start + c) * st; });
    uint32_t* pj32 = reinterpret_cast<uint32_t*>(sm.pj);
    for (int i = threadIdx.x; i < BQ * LDJ / 2; i += NT) pj32[i] = 0u;
    __syncthreads();
    recompute_tile(sm, q_start, k_start, T, n_meta, scale, false, true);

    uint32_t a[4], bb[2];
    // dQ += dS.K (k staged [c][d]) and dP_band.Band (band staged [j][d]).
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      frag_a(a, sm.ds, LDT, mt * 16, k0, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_t(bb, sm.k, LDB, k0, (half * 8 + j) * 8, g, t4);
        mma16816(acc_dq[j], a, bb);
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < NBAND; k0 += 16) {
      frag_a(a, sm.pj, LDJ, mt * 16, k0, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_t(bb, sm.band, LDB, k0, (half * 8 + j) * 8, g, t4);
        mma16816(acc_dq[j], a, bb);
      }
    }
    // dRel_band[j][d] = sum_r dP_band[r][j] q[r][d]: warp w owns band rows 16 w.. and all 128 d.
    {
      float acc_r[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_r[n][i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < BQ; k0 += 16) {
        frag_a_t(a, sm.pj, LDJ, warp * 16, k0, g, t4);
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          frag_b_t(bb, sm.q, LDB, k0, n * 8, g, t4);
          mma16816(acc_r[n], a, bb);
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int j = warp * 16 + g + 8 * i2, ridx = band0 + j;
        if (j < NBAND - 1 && ridx >= 0 && ridx < T) {
          float* row = drelh + (long long)ridx * HD;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            atomicAdd(row + n * 8 + 2 * t4, acc_r[n][2 * i2]);
            atomicAdd(row + n * 8 + 2 * t4 + 1, acc_r[n][2 * i2 + 1]);
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites the staged operands
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = q_start + mt * 16 + g + 8 * hi;
      if (t < T) {
        const int d = (half * 8 + j) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dq + ((long long)bh * T + t) * HD + d) =
            make_float2(acc_dq[j][2 * hi], acc_dq[j][2 * hi + 1]);
      }
    }
  }
}

// E2: dK and dV. Grid (key tiles, B*H).
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, long long sb, long long sh,
    long long st, const float* __restrict__ dout, long long dsb, long long dsh, long long dst_,
    const float* __restrict__ rel, long long rel_sh, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int T, int n_meta, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k_start = blockIdx.x * BK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  const float* qb = q + b * sb + h * sh;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* relh = rel + h * rel_sh;

  stage_rows(sm.k, BK, [&](int c) { return k_start + c < T; }, [&](int c) { return kb + (long long)(k_start + c) * st; });
  stage_rows(sm.v, BK, [&](int c) { return k_start + c < T; }, [&](int c) { return vb + (long long)(k_start + c) * st; });
  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[j][i] = acc_dv[j][i] = 0.f;

  const int n_q = (T + BQ - 1) / BQ;
  for (int qt = k_start / BQ; qt < n_q; ++qt) {  // key tile 0 starts at query tile 0
    const int q_start = qt * BQ;
    const int band0 = T - 1 + k_start - q_start - (BQ - 1);
    stage_query(sm, qb, dob, st, dst_, lse, delta, (long long)bh * T, q_start, T);
    stage_band(sm, relh, band0, T);
    __syncthreads();
    recompute_tile(sm, q_start, k_start, T, n_meta, scale, true, false);

    uint32_t a[4], bb[2];
    // dV[c][d] += sum_r p[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] q[r][d].
#pragma unroll
    for (int k0 = 0; k0 < BQ; k0 += 16) {
      frag_a_t(a, sm.p, LDT, mt * 16, k0, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_t(bb, sm.dout, LDB, k0, (half * 8 + j) * 8, g, t4);
        mma16816(acc_dv[j], a, bb);
      }
      frag_a_t(a, sm.ds, LDT, mt * 16, k0, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_t(bb, sm.q, LDB, k0, (half * 8 + j) * 8, g, t4);
        mma16816(acc_dk[j], a, bb);
      }
    }
    __syncthreads();  // before the next tile overwrites the staged operands
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int s = k_start + mt * 16 + g + 8 * hi;
      if (s < T) {
        const int d = (half * 8 + j) * 8 + 2 * t4;
        const long long o = ((long long)bh * T + s) * HD + d;
        *reinterpret_cast<float2*>(dk + o) = make_float2(acc_dk[j][2 * hi], acc_dk[j][2 * hi + 1]);
        *reinterpret_cast<float2*>(dv + o) = make_float2(acc_dv[j][2 * hi], acc_dv[j][2 * hi + 1]);
      }
    }
  }
}

bool bad_shape(int B, int H, int T, int D, int n_meta) {
  return B < 1 || H < 1 || T < 1 || D != HD || n_meta < 1 || n_meta > BK;
}

}  // namespace

// q, k, v: f32 (B, H, T, 128), element (b, h, t, d) at b*sb + h*sh + t*st + d
// (one set of strides, 16-byte aligned rows); dout: the same shape with its
// own strides; rel: f32 (H, >= T, 128), head h at h*rel_sh; lse, delta: f32
// (B*H, T) contiguous; dq: f32 (B, H, T, 128) contiguous; drel: f32
// (H, >= T, 128), head h at h*drel_sh, zero-filled by the caller (E1 adds
// rows [0, T) into it).
MG_EXPORT int mg_flash_bwd_dq(const float* q, const float* k, const float* v, long long sb, long long sh, long long st,
                              const float* dout, long long dsb, long long dsh, long long dst_, const float* rel,
                              long long rel_sh, const float* lse, const float* delta, float* dq, float* drel,
                              long long drel_sh, int B, int H, int T, int D, int n_meta, float scale, void* stream) {
  if (bad_shape(B, H, T, D, n_meta)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<<<grid, NT, kSmem, (cudaStream_t)stream>>>(q, k, v, sb, sh, st, dout, dsb, dsh, dst_, rel,
                                                                 rel_sh, lse, delta, dq, drel, drel_sh, H, T, n_meta,
                                                                 scale);
  return (int)cudaGetLastError();
}

// As mg_flash_bwd_dq; dk, dv: f32 (B, H, T, 128) contiguous.
MG_EXPORT int mg_flash_bwd_dkv(const float* q, const float* k, const float* v, long long sb, long long sh, long long st,
                               const float* dout, long long dsb, long long dsh, long long dst_, const float* rel,
                               long long rel_sh, const float* lse, const float* delta, float* dk, float* dv, int B,
                               int H, int T, int D, int n_meta, float scale, void* stream) {
  if (bad_shape(B, H, T, D, n_meta)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<<<grid, NT, kSmem, (cudaStream_t)stream>>>(q, k, v, sb, sh, st, dout, dsb, dsh, dst_, rel,
                                                                  rel_sh, lse, delta, dk, dv, H, T, n_meta, scale);
  return (int)cudaGetLastError();
}
