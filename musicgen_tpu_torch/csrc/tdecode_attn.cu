// Kernel F, attention: one Transformer decode step's rel-pos attention over
// the ring KV cache and the 6 metadata slots, split over the ring.
//
// Replaces the attention of musicgen_tpu/ops/pallas_transformer_decode.py
// `_tdecode_kernel` (`_attn_math`). Per (batch row b, head h), with q the
// bf16-rounded query and c = stream_idx mod S the newest ring position:
//   ring slot r:  s_r = (q . K_ring[r] + q . rel_ring[(r - c - 1) mod S]) * scale
//   meta slot j:  s_j = (q . K_meta[j] + q . rel_meta[j]) * scale   (j < 6)
//   out = softmax(s) . [V_ring; V_meta]   (f32 sums of bf16 products)
// with rel_ring[u] = rel_emb[u + 6] (the TPU kernel's roll(q . rel_ring^T,
// c + 1): out[r] = y[(r - c - 1) mod S]) and scale = d_model^-0.5.
//
// The TPU kernel reads the ring as a read-only input, so ring slot c still
// holds the token that the new one evicts; it patches that slot's score and
// V term in registers with the new K and V, and the caller scatters them into
// the ring afterwards. Here that fix is not needed: the QKV GEMV of the same
// layer (mg_t_qkv_ln, epilogue kKvRing) has already written the new K and V,
// rounded to bf16 exactly as the fix rounds them, into slot c when this
// launch starts, so the attention reads the whole ring. (The plain twin,
// ops/tdecode_kernel.attention_plain, keeps the fix, as the JAX math does;
// both read the same numbers.) Ring rows are read through the read-only path:
// they were written by an earlier launch.
//
// What bounds it on an H100: bytes. At B = 2, S = 2048 and d_model 1024 a
// layer reads 8 MB of K ring, 8 MB of V ring and 4 MB of rel table (bf16);
// the scores are 2 flops per byte.
//
// Design: one (b, h) alone would fill 16 of 132 SMs, so the S slots of each
// (b, h) are split over S / 64 blocks of 128 threads (flash decoding). A warp
// takes one slot at a time, each lane 4 of the 128 head lanes (256-byte
// coalesced rows of K, rel and V). A split writes its partial max m, sum
// l = sum exp(s - m) and V accumulator sum bf16(exp(s - m)) V; the combine
// launch rescales the splits by exp(m_s - m) and divides by the total. The
// probabilities are rounded to bf16 before the V sum as in the TPU kernel, but
// relative to the split's maximum rather than normalised, so the two differ
// by bf16 rounding of the probabilities (2^-9 relative each) and f32 order.
#include "common.cuh"

namespace {

constexpr int HD = 128;
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int MAX_META = 8;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void bf16x4(uint2 u, float f[4]) {
  f[0] = bf16_lo(u.x);
  f[1] = bf16_hi(u.x);
  f[2] = bf16_lo(u.y);
  f[3] = bf16_hi(u.y);
}

__global__ void __launch_bounds__(NT) attn_split_kernel(
    const float* __restrict__ zx, int ldzx, const __nv_bfloat16* __restrict__ k_ring,
    const __nv_bfloat16* __restrict__ v_ring, const __nv_bfloat16* __restrict__ rel_ring,
    const __nv_bfloat16* __restrict__ k_meta, const __nv_bfloat16* __restrict__ v_meta,
    const __nv_bfloat16* __restrict__ rel_meta, int H, int S, int dm, int c, int n_meta, float scale,
    int per_split, float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc) {
  extern __shared__ float sc[];         // per_split + MAX_META scores, then probabilities
  __shared__ float red[NW * HD];
  const int split = blockIdx.x, nsplit = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = split * per_split, r1 = min(S, r0 + per_split);
  const int n_ring = max(0, r1 - r0);
  const int n_items = n_ring + (split == 0 ? n_meta : 0);

  float qv[4];
  {
    const float4 q4 = *reinterpret_cast<const float4*>(zx + (size_t)b * ldzx + h * HD + lane * 4);
    qv[0] = bf16_round(q4.x);
    qv[1] = bf16_round(q4.y);
    qv[2] = bf16_round(q4.z);
    qv[3] = bf16_round(q4.w);
  }
  const size_t lane_off = (size_t)h * HD + lane * 4;

  // Scores, one slot per warp at a time (item i < n_ring: ring slot r0 + i;
  // else metadata slot i - n_ring).
  for (int i = warp; i < n_items; i += NW) {
    const __nv_bfloat16 *krow, *rrow;
    if (i < n_ring) {
      const int r = r0 + i;
      const int u = ((r - c - 1) % S + S) % S;
      krow = k_ring + ((size_t)b * S + r) * dm;
      rrow = rel_ring + (size_t)u * dm;
    } else {
      const int j = i - n_ring;
      krow = k_meta + ((size_t)b * MAX_META + j) * dm;
      rrow = rel_meta + (size_t)j * dm;
    }
    float kf[4], rf[4];
    bf16x4(__ldg(reinterpret_cast<const uint2*>(krow + lane_off)), kf);
    bf16x4(__ldg(reinterpret_cast<const uint2*>(rrow + lane_off)), rf);
    float ac = 0.f, bd = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      ac = fmaf(qv[d], kf[d], ac);
      bd = fmaf(qv[d], rf[d], bd);
    }
    ac = warp_sum(ac);
    bd = warp_sum(bd);
    if (lane == 0) sc[i] = (ac + bd) * scale;
  }
  __syncthreads();

  // The split's max and sum, then bf16 probabilities in place.
  float m = kNeg;
  for (int i = threadIdx.x; i < n_items; i += NT) m = fmaxf(m, sc[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float l = 0.f;
  for (int i = threadIdx.x; i < n_items; i += NT) {
    const float p = expf(sc[i] - m);
    l += p;
    sc[i] = bf16_round(p);
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0];
  for (int w = 1; w < NW; ++w) l += red[w];
  __syncthreads();

  // V: each warp sums its slots over the 4 lanes of d it holds.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = warp; i < n_items; i += NW) {
    const __nv_bfloat16* vrow = i < n_ring ? v_ring + ((size_t)b * S + r0 + i) * dm
                                           : v_meta + ((size_t)b * MAX_META + i - n_ring) * dm;
    float vf[4];
    bf16x4(__ldg(reinterpret_cast<const uint2*>(vrow + lane_off)), vf);
    const float p = sc[i];
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[d] = fmaf(p, vf[d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) red[warp * HD + lane * 4 + d] = acc[d];
  __syncthreads();
  if (threadIdx.x < HD) {
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a += red[w * HD + threadIdx.x];
    part_acc[((size_t)bh * nsplit + split) * HD + threadIdx.x] = a;
  }
  if (threadIdx.x == 0) {
    part_m[bh * nsplit + split] = m;
    part_l[bh * nsplit + split] = l;
  }
}

// out[b, h*128 + d] = sum_s acc_s[d] exp(m_s - m) / sum_s l_s exp(m_s - m).
__global__ void __launch_bounds__(HD) attn_combine_kernel(const float* __restrict__ part_m,
                                                           const float* __restrict__ part_l,
                                                           const float* __restrict__ part_acc,
                                                           float* __restrict__ out, int H, int dm, int nsplit) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, d = threadIdx.x;
  const float* pm = part_m + (size_t)bh * nsplit;
  const float* pl = part_l + (size_t)bh * nsplit;
  float m = kNeg;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pm[s]);
  float denom = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pm[s] - m);
    denom += pl[s] * w;
    a += part_acc[((size_t)bh * nsplit + s) * HD + d] * w;
  }
  out[(size_t)b * dm + h * HD + d] = a / denom;
}

}  // namespace

// zx: (B, ldzx) f32 with the query in columns [0, dm); rings (B, S, dm) bf16
// (this layer's); rel_ring (S, dm); k_meta, v_meta (B, 8, dm); rel_meta
// (8, dm); partials (B*H, ceil(S / per_split), 128) and (B*H, nsplit).
MG_EXPORT int mg_tdecode_attn_split(const float* zx, int ldzx, const void* k_ring, const void* v_ring,
                                    const void* rel_ring, const void* k_meta, const void* v_meta,
                                    const void* rel_meta, int B, int H, int S, int dm, int c, int n_meta,
                                    float scale, int per_split, float* part_m, float* part_l,
                                    float* part_acc, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dm != H * HD || c < 0 || c >= S || n_meta < 0 || n_meta > MAX_META ||
      per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + per_split - 1) / per_split;
  const size_t smem = (size_t)(per_split + MAX_META) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_split_kernel<<<dim3(nsplit, B * H), NT, smem, (cudaStream_t)stream>>>(
      zx, ldzx, static_cast<const __nv_bfloat16*>(k_ring), static_cast<const __nv_bfloat16*>(v_ring),
      static_cast<const __nv_bfloat16*>(rel_ring), static_cast<const __nv_bfloat16*>(k_meta),
      static_cast<const __nv_bfloat16*>(v_meta), static_cast<const __nv_bfloat16*>(rel_meta), H, S, dm, c,
      n_meta, scale, per_split, part_m, part_l, part_acc);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_tdecode_attn_combine(const float* part_m, const float* part_l, const float* part_acc, float* out,
                                      int B, int H, int dm, int nsplit, void* stream) {
  if (B < 1 || H < 1 || dm != H * HD || nsplit < 1) return (int)cudaErrorInvalidValue;
  attn_combine_kernel<<<B * H, HD, 0, (cudaStream_t)stream>>>(part_m, part_l, part_acc, out, H, dm, nsplit);
  return (int)cudaGetLastError();
}
