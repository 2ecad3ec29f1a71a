// Kernel D: flash attention forward with the Transformer-XL relative-position
// term and the always-visible metadata columns, for the Transformer prefill.
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
// with block_k = 128, so the running maxima, and with them the points where
// the probabilities are rounded, are the same as in the plain version
// (ops/attention_kernel.flash_relpos_attention_plain).
//
// What bounds it on an H100: operations. At the main path (B*H = 16,
// T = 2054, d = 128) the visible (t, c) pairs are about 2.1 M per head, and
// AC, BD and P.V each cost 2 * 128 flops per pair: about 26 GFLOP a launch,
// 26 us at the 989 TFLOP/s dense bf16 peak, against 84 MB of f32 inputs and
// output (25 us at 3.35 TB/s).
//
// Design (a simple first kernel; wgmma/TMA is later work): one 256-thread
// block per (b*h, 64-row query tile), looping over the 128-column key tiles up
// to the diagonal (tile 0 also holds the metadata columns; every other tile
// is skipped, as `tile_needed` does). Per tile, q, k, v (transposed) and the
// rel band of 64 + 128 - 1 rows go to bf16 in shared memory, and the three
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// out). The band product Q.Band^T (64 x 192) is kept in shared memory and BD
// read from it per (r, c) at band row c - r + 63: the TPU kernel's roll/shear
// is an artifact of its vector unit. Band rows outside [0, T) are zero, so the
// real T is used with bounds checks and nothing depends on T being padded.
// Masked scores are the finite -1e30, so a row never sees exp(-inf - -inf).
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp,
// m + log l, as the TPU kernel's training forward does: kernel E
// (flash_relpos_bwd.cu) recomputes the probabilities from it. The prefill
// passes null and runs the same instructions up to that store.
#include "common.cuh"

namespace {

constexpr int HD = 128;               // head dim the kernel is written for
constexpr int BQ = 64;                // query rows of a block
constexpr int BK = 128;               // key columns of a tile
constexpr int NBAND = BQ + BK;        // 191 band rows used, padded to 192
constexpr int LDB = HD + 8;           // bf16 row stride in shared memory
constexpr int LDP = NBAND + 4;        // f32 row stride of the band product
constexpr int LDS = BK + 4;           // f32 row stride of the score tile
constexpr int NT = 256;               // 8 warps
constexpr float kNeg = -1e30f;

constexpr size_t kQBytes = (size_t)BQ * LDB * 2;
constexpr size_t kKBytes = (size_t)BK * LDB * 2;     // k tile, then the f32 scores
constexpr size_t kVBytes = (size_t)HD * LDB * 2;     // v^T tile
constexpr size_t kBandBytes = (size_t)NBAND * LDB * 2;
constexpr size_t kPBBytes = (size_t)BQ * LDP * 4;    // band product, then bf16 P
constexpr size_t kStatBytes = (size_t)3 * BQ * 4;
constexpr size_t kSmem = kQBytes + kKBytes + kVBytes + kBandBytes + kPBBytes + kStatBytes;
static_assert((size_t)BQ * LDS * 4 <= kKBytes, "scores must fit in the k tile");
static_assert((size_t)BQ * LDB * 2 <= kPBBytes, "P must fit in the band product");

__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Rows [0, nrows) of 128 f32 values, row r at row(r) and valid when ok(r),
// to bf16 rows of stride LDB at `dst`; invalid rows become zero.
template <class Valid, class Row>
__device__ void stage_rows(__nv_bfloat16* dst, int nrows, Valid ok, Row row) {
  for (int i = threadIdx.x; i < nrows * (HD / 4); i += NT) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok(r)) v = __ldg(reinterpret_cast<const float4*>(row(r) + d));
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst + r * LDB + d);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

__global__ void __launch_bounds__(NT) flash_relpos_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    long long sb, long long sh, long long st, const float* __restrict__ rel, long long rel_sh,
    float* __restrict__ out, float* __restrict__ lse, int H, int T, int n_meta, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);
  float* ss = reinterpret_cast<float*>(smem + kQBytes);  // scores, over the k tile
  __nv_bfloat16* svt = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + kKBytes);
  __nv_bfloat16* sband = reinterpret_cast<__nv_bfloat16*>(smem + kQBytes + kKBytes + kVBytes);
  float* spb = reinterpret_cast<float*>(smem + kQBytes + kKBytes + kVBytes + kBandBytes);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(spb);  // P, over the band product
  float* s_m = reinterpret_cast<float*>(smem + kQBytes + kKBytes + kVBytes + kBandBytes + kPBBytes);
  float* s_l = s_m + BQ;
  float* s_alpha = s_l + BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_start = blockIdx.x * BQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3;            // the warp's 16-row slice of the tile
  const int half = warp >> 2;         // which half of the columns it owns
  const float* qb = q + b * sb + h * sh;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const float* relh = rel + h * rel_sh;

  stage_rows(sq, BQ, [&](int r) { return q_start + r < T; }, [&](int r) { return qb + (long long)(q_start + r) * st; });
  if (threadIdx.x < BQ) {
    s_m[threadIdx.x] = kNeg;
    s_l[threadIdx.x] = 0.f;
  }
  float acc_o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_o[j][i] = 0.f;

  const int last_row = min(q_start + BQ - 1, T - 1);
  const int n_tiles = last_row / BK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * BK;
    // Band row j holds rel[base0 - (BQ - 1) + j], base0 = T - 1 + k_start - q_start.
    const int band0 = T - 1 + k_start - q_start - (BQ - 1);
    stage_rows(sk, BK, [&](int c) { return k_start + c < T; },
               [&](int c) { return kb + (long long)(k_start + c) * st; });
    stage_rows(sband, NBAND, [&](int j) { return j < NBAND - 1 && band0 + j >= 0 && band0 + j < T; },
               [&](int j) { return relh + (long long)(band0 + j) * HD; });
    for (int i = threadIdx.x; i < BK * (HD / 4); i += NT) {  // v^T: svt[d][c]
      const int c = i / (HD / 4), d = (i % (HD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k_start + c < T) x = __ldg(reinterpret_cast<const float4*>(vb + (long long)(k_start + c) * st + d));
      svt[(d + 0) * LDB + c] = __float2bfloat16_rn(x.x);
      svt[(d + 1) * LDB + c] = __float2bfloat16_rn(x.y);
      svt[(d + 2) * LDB + c] = __float2bfloat16_rn(x.z);
      svt[(d + 3) * LDB + c] = __float2bfloat16_rn(x.w);
    }
    __syncthreads();

    // BD band product: spb[r][j] = q_r . band_j (12 of the 24 n-tiles).
    {
      float acc_b[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_b[j][i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 16) {
        const __nv_bfloat16* ar = sq + (mt * 16 + g) * LDB + k0 + 2 * t4;
        const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * LDB), a2 = ld32(ar + 8), a3 = ld32(ar + 8 * LDB + 8);
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const __nv_bfloat16* br = sband + ((half * 12 + j) * 8 + g) * LDB + k0 + 2 * t4;
          mma16816(acc_b[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int r = mt * 16 + g, c = (half * 12 + j) * 8 + 2 * t4;
        spb[r * LDP + c] = acc_b[j][0];
        spb[r * LDP + c + 1] = acc_b[j][1];
        spb[(r + 8) * LDP + c] = acc_b[j][2];
        spb[(r + 8) * LDP + c + 1] = acc_b[j][3];
      }
    }
    // AC: q_r . k_c (8 of the 16 n-tiles), kept in registers.
    float acc_s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_s[j][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      const __nv_bfloat16* ar = sq + (mt * 16 + g) * LDB + k0 + 2 * t4;
      const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * LDB), a2 = ld32(ar + 8), a3 = ld32(ar + 8 * LDB + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* br = sk + ((half * 8 + j) * 8 + g) * LDB + k0 + 2 * t4;
        mma16816(acc_s[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
      }
    }
    __syncthreads();  // every read of the k tile is done; the band product is complete

    // Scores over the k tile: (AC + BD) * scale, masked.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + 8 * (i >> 1), c = (half * 8 + j) * 8 + 2 * t4 + (i & 1);
        const int t = q_start + r, s = k_start + c;
        const bool vis = s < T && (s <= t || s < n_meta);
        ss[r * LDS + c] = vis ? (acc_s[j][i] + spb[r * LDP + c - r + BQ - 1]) * scale : kNeg;
      }
    }
    __syncthreads();

    // Online softmax, one warp per 8 rows: P = bf16(exp(s - m_new)).
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float sv[BK / 32];
      float mc = kNeg;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        sv[i] = ss[r * LDS + lane + 32 * i];
        mc = fmaxf(mc, sv[i]);
      }
      mc = warp_max(mc);
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;
        sp[r * LDB + lane + 32 * i] = __float2bfloat16_rn(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P . V (8 of the 16 n-tiles of d).
    {
      const float al0 = s_alpha[mt * 16 + g], al1 = s_alpha[mt * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc_o[j][0] *= al0;
        acc_o[j][1] *= al0;
        acc_o[j][2] *= al1;
        acc_o[j][3] *= al1;
      }
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        const __nv_bfloat16* ar = sp + (mt * 16 + g) * LDB + k0 + 2 * t4;
        const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * LDB), a2 = ld32(ar + 8), a3 = ld32(ar + 8 * LDB + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* br = svt + ((half * 8 + j) * 8 + g) * LDB + k0 + 2 * t4;
          mma16816(acc_o[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
        }
      }
    }
    __syncthreads();  // before the next tile overwrites k, v^T, the band and P
  }

  // out[b, t, h, :] = O / l
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = mt * 16 + g + 8 * hi, t = q_start + r;
      if (t < T) {
        const float inv_l = 1.f / s_l[r];
        const int d = (half * 8 + j) * 8 + 2 * t4;
        float2 o = make_float2(acc_o[j][2 * hi] * inv_l, acc_o[j][2 * hi + 1] * inv_l);
        *reinterpret_cast<float2*>(out + (((long long)b * T + t) * H + h) * HD + d) = o;
      }
    }
  }
  if (lse != nullptr && threadIdx.x < BQ && q_start + (int)threadIdx.x < T)
    lse[(long long)bh * T + q_start + threadIdx.x] = s_m[threadIdx.x] + logf(s_l[threadIdx.x]);
}

}  // namespace

// q, k, v: f32 (B, H, T, 128) with element (b, h, t, d) at b*sb + h*sh + t*st
// + d (all three with the same strides, 16-byte aligned rows); rel: f32
// (H, >= T, 128), head h at h*rel_sh; out: f32 (B, T, H, 128) contiguous;
// lse: null, or f32 (B*H, T) contiguous.
MG_EXPORT int mg_flash_relpos(const float* q, const float* k, const float* v, long long sb, long long sh,
                              long long st, const float* rel, long long rel_sh, float* out, float* lse, int B,
                              int H, int T, int D, int n_meta, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || D != HD || n_meta < 1 || n_meta > BK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_relpos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_relpos_kernel<<<grid, NT, kSmem, (cudaStream_t)stream>>>(q, k, v, sb, sh, st, rel, rel_sh, out, lse, H,
                                                                 T, n_meta, scale);
  return (int)cudaGetLastError();
}
