// Kernel F, attention: one Transformer decode step's rel-pos attention over
// the ring KV cache and the 6 metadata slots, in one launch a layer.
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
// both read the same numbers.) The ring rows that the bulk copies read were
// written by an earlier launch on the same stream.
//
// What bounds it on an H100: bytes. At B = 2, S = 2048 and d_model 1024 a
// layer reads 8 MB of K ring, 8 MB of V ring and 4 MB of rel table (bf16),
// 21 MB in all (6.3 us at 3.35 TB/s); the scores are 2 flops per byte.
//
// Design (flash decoding, one launch):
// - The grid is (S / 64 splits, H heads, batch groups). A block takes one
//   head and a run of 64 ring slots (split 0 also the meta slots) for a
//   group of up to MAX_BG batch rows, so the rel rows it reads serve every
//   row of the group: at B <= 4 the rel table is read once a layer.
// - At its start the block's threads issue one TMA bulk copy
//   (cp.async.bulk) for each 256-byte row (one head) of the run's rel and K
//   tables, landing on one mbarrier, and of its V tables, landing on a
//   second, so a block has all of its 106 KB (B = 2) in flight at once; at
//   B = 2 the 256 blocks fit the 132 SMs, two to an SM, in one wave. Rows
//   sit 272 bytes apart, so the eight rows of an ldmatrix hit eight
//   distinct bank groups (a bulk copy cannot swizzle), and rows past the
//   run are zeroed to whole tiles of 16 slots. The first design, 16-byte
//   cp.async copies from every thread, took longer to land the rows when
//   they sat in L2.
// - Scores and the V sum run on the tensor cores (mma.sync m16n8k16, bf16
//   in, f32 sums): q and the probabilities are bf16 values already, so the
//   products are exact. Scores: a warp takes 16 slots of one batch row, A
//   the K rows and the rel rows, B q in all 8 columns; the two terms of the
//   even and odd k steps sum in four accumulators, added at the end.
//   Softmax: one warp per batch row. V sum: warp w takes head lanes
//   16w .. 16w + 15, A the V rows transposed by ldmatrix, B the
//   probabilities. A warp loads its fragments before its products.
// - Combine: each block writes its partials (the split's max m, its sum
//   l = sum exp(s - m) and its V sum of bf16(exp(s - m))) to a workspace,
//   then takes a ticket of its (group, head); the block that draws the last
//   ticket combines the splits in split order s = 0..n-1 by exp(m_s - m),
//   writes the (B, dm) output and resets the ticket to 0, so the next launch
//   (and a CUDA-graph replay) starts clean. The wrapper zeroes the tickets
//   once, when it creates them. One thread takes the ticket after the
//   block's barrier with one acquire-release atomic, and the last block
//   issues every load of the combine before it waits on any. A thread-block
//   cluster with a DSMEM reduction was not taken: a cluster holds at most 16
//   blocks, and the 32 splits of S = 2048 would need blocks of 128 slots
//   (190 KB each at B = 2), one block an SM and half the blocks of this
//   design, and any S past 16 splits a second level through global memory.
// The probabilities are rounded to bf16 before the V sum as in the TPU
// kernel, but relative to the split's maximum rather than normalised, so the
// two differ by bf16 rounding of the probabilities (2^-9 relative each) and
// f32 order; ops/tdecode_kernel.attn_split_plain and attn_combine_plain
// round at the kernel's points. Launches that share a ticket buffer must be
// ordered on one stream.
#include "common.cuh"

namespace {

constexpr int HD = 128;            // head width
constexpr int ROW_BYTES = HD * 2;  // one head's bf16 row
constexpr int CHUNKS = ROW_BYTES / 16;
constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int SPLIT = 64;  // ring slots a block takes (ops/tdecode_kernel.ATTN_SPLIT)
constexpr int MAX_META = 8;
constexpr int ROWS = (SPLIT + MAX_META + 15) / 16 * 16;  // a block's rows of each table, whole tiles of 16
constexpr int MAX_TILES = ROWS / 16;
constexpr int MAX_BG = 4;  // batch rows a block stages
constexpr float kNeg = -1e30f;
static_assert(ROWS <= 96, "the softmax holds three items a lane");

constexpr int RS = ROW_BYTES + 16;  // row stride in shared memory: chunk j of row i in bank group (i + j) % 8

__device__ __forceinline__ uint32_t row_off(int i, int chunk) { return (uint32_t)(i * RS + (chunk << 4)); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrive on the barrier and expect `bytes` of bulk copies to land on it.
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

// `bytes` global -> shared by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

struct AttnArgs {
  const float* zx;
  int ldzx;
  const __nv_bfloat16 *k_ring, *v_ring, *rel_ring, *k_meta, *v_meta, *rel_meta;
  int B, H, S, dm, c, n_meta, bg;
  float scale;
  float *part_m, *part_l, *part_acc, *out;
  unsigned* tickets;
};

// Shared memory of a block: rel rows, K rows and V rows of bg batch rows,
// then q (bg x 128 f32) and the scores, then probabilities (bg x ROWS f32).
__host__ __device__ constexpr size_t attn_smem_bytes(int bg) {
  return (size_t)(1 + 2 * bg) * ROWS * RS + (size_t)bg * (HD + ROWS) * sizeof(float);
}

__global__ void __launch_bounds__(NT, 2) attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int split = blockIdx.x, nsplit = gridDim.x, h = blockIdx.y, bg = a.bg;
  const int b0 = blockIdx.z * bg, nb = min(bg, a.B - b0);
  const int r0 = split * SPLIT, n_ring = min(a.S - r0, SPLIT);
  const int n_items = n_ring + (split == 0 ? a.n_meta : 0);  // item i < n_ring: ring slot r0 + i; else meta i - n_ring
  const int n_tiles = (n_items + 15) / 16;                    // items padded with zero rows to whole tiles
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  unsigned char* rel_s = smem;
  unsigned char* k_s = rel_s + (size_t)ROWS * RS;
  unsigned char* v_s = k_s + (size_t)bg * ROWS * RS;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)bg * ROWS * RS);
  float* sc = q_s + bg * HD;
  const size_t col = (size_t)h * HD;

  // Copies: one bulk copy a row, rel and K rows on bars[0], V rows on
  // bars[1]. Table t = 0 is rel, t = 1 + b the K rows of batch row b0 + b.
  __shared__ __align__(8) uint64_t bars[2];
  const uint32_t bar0 = smem_u32(&bars[0]), bar1 = smem_u32(&bars[1]);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bar0, (uint32_t)((1 + nb) * n_items * ROW_BYTES));
    mbar_expect(bar1, (uint32_t)(nb * n_items * ROW_BYTES));
  }
  __syncthreads();
  for (int idx = tid; idx < (1 + nb) * n_items; idx += NT) {
    const int t = idx / n_items, i = idx % n_items;
    const __nv_bfloat16* src;
    if (i < n_ring) {
      const int r = r0 + i;
      int u = r - a.c - 1;
      if (u < 0) u += a.S;  // the rel rows of a run wrap at u = S - 1 -> 0 at most once
      src = t == 0 ? a.rel_ring + (size_t)u * a.dm : a.k_ring + ((size_t)(b0 + t - 1) * a.S + r) * a.dm;
    } else {
      const int j = i - n_ring;
      src = t == 0 ? a.rel_meta + (size_t)j * a.dm : a.k_meta + ((size_t)(b0 + t - 1) * MAX_META + j) * a.dm;
    }
    unsigned char* dst = t == 0 ? rel_s : k_s + (size_t)(t - 1) * ROWS * RS;
    bulk_copy(smem_u32(dst) + row_off(i, 0), src + col, ROW_BYTES, bar0);
  }
  for (int idx = tid; idx < nb * n_items; idx += NT) {
    const int b = idx / n_items, i = idx % n_items;
    const __nv_bfloat16* src = i < n_ring ? a.v_ring + ((size_t)(b0 + b) * a.S + r0 + i) * a.dm
                                          : a.v_meta + ((size_t)(b0 + b) * MAX_META + i - n_ring) * a.dm;
    bulk_copy(smem_u32(v_s + (size_t)b * ROWS * RS) + row_off(i, 0), src + col, ROW_BYTES, bar1);
  }
  // Rows past the items, to whole tiles, are zero in every table.
  const int pad = n_tiles * 16 - n_items;
  for (int idx = tid; idx < (1 + 2 * nb) * pad * CHUNKS; idx += NT) {
    const int t = idx / (pad * CHUNKS), k = idx % (pad * CHUNKS);
    unsigned char* base = t == 0    ? rel_s
                          : t <= nb ? k_s + (size_t)(t - 1) * ROWS * RS
                                    : v_s + (size_t)(t - 1 - nb) * ROWS * RS;
    *reinterpret_cast<uint4*>(base + row_off(n_items + k / CHUNKS, k % CHUNKS)) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < nb * HD; idx += NT)
    q_s[idx] = bf16_round(a.zx[(size_t)(b0 + idx / HD) * a.ldzx + col + idx % HD]);
  mbar_wait(bar0, 0);
  __syncthreads();

  // Scores: warp task (b, tile) sums q . K and q . rel of 16 slots, in four
  // chains (K and rel, even and odd k steps). ldmatrix lane l gives row
  // tile * 16 + l % 16 at 16-byte chunk 2 ks + l / 16. Each half of the k
  // steps loads its fragments before its products.
  for (int task = warp; task < nb * n_tiles; task += NW) {
    const int b = task / n_tiles, tile = task % n_tiles, row = tile * 16 + (lane & 15);
    const float* q = q_s + b * HD + 2 * t4;
    const uint32_t k_base = smem_u32(k_s + (size_t)b * ROWS * RS), r_base = smem_u32(rel_s);
    uint32_t qf[HD / 16][2];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      qf[ks][0] = pack_bf16(q[16 * ks], q[16 * ks + 1]);
      qf[ks][1] = pack_bf16(q[16 * ks + 8], q[16 * ks + 9]);
    }
    float acc[4][4] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t kf[4][4], rf[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t off = row_off(row, 2 * (4 * half + j) + (lane >> 4));
        ldsm_x4(kf[j], k_base + off);
        ldsm_x4(rf[j], r_base + off);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma16816(acc[j & 1], kf[j], qf[4 * half + j][0], qf[4 * half + j][1]);
        mma16816(acc[2 + (j & 1)], rf[j], qf[4 * half + j][0], qf[4 * half + j][1]);
      }
    }
    if (t4 == 0) {  // rows g and g + 8 of the tile (every column holds the same sums)
      const int i = tile * 16 + g;
      if (i < n_items) sc[b * ROWS + i] = ((acc[0][0] + acc[1][0]) + (acc[2][0] + acc[3][0])) * a.scale;
      if (i + 8 < n_items) sc[b * ROWS + i + 8] = ((acc[0][2] + acc[1][2]) + (acc[2][2] + acc[3][2])) * a.scale;
    }
  }
  __syncthreads();

  // The split's max and sum per batch row (one warp each, three items a
  // lane), then bf16 probabilities in place, zero on the padding rows.
  if (warp < nb) {
    float* s = sc + warp * ROWS;
    float v[3];
    float m = kNeg;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < n_items ? s[i] : kNeg;
      m = fmaxf(m, v[k]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = lane + 32 * k;
      const float p = i < n_items ? expf(v[k] - m) : 0.f;
      l += p;
      if (i < n_tiles * 16) s[i] = bf16_round(p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t part = ((size_t)(b0 + warp) * a.H + h) * nsplit + split;
      a.part_m[part] = m;
      a.part_l[part] = l;
    }
  }
  mbar_wait(bar1, 0);
  __syncthreads();

  // V: warp w sums head lanes 16 w .. 16 w + 15 over the slots: A = V^T
  // (ldmatrix.trans of 8 slot rows a matrix), B = the probabilities, in two
  // chains (even, odd tiles); a batch row's fragments load before its
  // products.
  const int vrow = ((lane >> 4) << 3) + (lane & 7), vchunk = 2 * warp + ((lane >> 3) & 1);
#pragma unroll
  for (int b = 0; b < MAX_BG; ++b) {
    if (b < nb) {
      const uint32_t v_base = smem_u32(v_s + (size_t)b * ROWS * RS);
      const float* p = sc + b * ROWS + 2 * t4;
      uint32_t vf[MAX_TILES][4], pf[MAX_TILES][2];
#pragma unroll
      for (int ks = 0; ks < MAX_TILES; ++ks) {
        if (ks < n_tiles) {
          ldsm_x4_trans(vf[ks], v_base + row_off(ks * 16 + vrow, vchunk));
          pf[ks][0] = pack_bf16(p[16 * ks], p[16 * ks + 1]);
          pf[ks][1] = pack_bf16(p[16 * ks + 8], p[16 * ks + 9]);
        }
      }
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < MAX_TILES; ++ks)
        if (ks < n_tiles) mma16816(acc[ks & 1], vf[ks], pf[ks][0], pf[ks][1]);
      if (t4 == 0) {
        float* out = a.part_acc + (((size_t)(b0 + b) * a.H + h) * nsplit + split) * HD + 16 * warp + g;
        out[0] = acc[0][0] + acc[1][0];
        out[8] = acc[0][2] + acc[1][2];
      }
    }
  }

  // The last block of this (group, head) to finish combines the splits.
  __syncthreads();
  unsigned* ticket = a.tickets + blockIdx.z * a.H + h;
  if (tid == 0) {
    // Release the block's partials (ordered before by the barrier) and
    // acquire the other blocks' in one atomic.
    unsigned drawn;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(drawn) : "l"(ticket) : "memory");
    last = drawn == (unsigned)nsplit - 1;
  }
  __syncthreads();
  if (!last) return;
  float* wts = reinterpret_cast<float*>(v_s);  // (bg, nsplit) exp(m_s - m), then (bg, nsplit) l_s exp(m_s - m)
  float* lw = wts + bg * nsplit;
  float pre[32];  // the first 32 splits' sums of this thread's (b, d), loaded before the weights
  if (tid < nb * HD) {
    const float* pacc = a.part_acc + ((size_t)(b0 + tid / HD) * a.H + h) * nsplit * HD + tid % HD;
#pragma unroll
    for (int k = 0; k < 32; ++k) pre[k] = k < nsplit ? __ldcg(pacc + (size_t)k * HD) : 0.f;
  }
  if (warp < nb) {
    const size_t base = ((size_t)(b0 + warp) * a.H + h) * nsplit;
    float m = kNeg;
    for (int s = lane; s < nsplit; s += 32) m = fmaxf(m, __ldcg(a.part_m + base + s));
    m = warp_max(m);
    for (int s = lane; s < nsplit; s += 32) {
      const float w = expf(__ldcg(a.part_m + base + s) - m);
      wts[warp * nsplit + s] = w;
      lw[warp * nsplit + s] = __ldcg(a.part_l + base + s) * w;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * HD; idx += NT) {
    const int b = idx / HD, d = idx % HD;
    const float* w = wts + b * nsplit;
    const float* pacc = a.part_acc + ((size_t)(b0 + b) * a.H + h) * nsplit * HD + d;
    float denom = 0.f, s = 0.f;
    int k = 0;
    if (idx == tid) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < nsplit) {
          denom += lw[b * nsplit + j];
          s += pre[j] * w[j];
        }
      }
      k = 32;
    }
    for (; k < nsplit; ++k) {
      denom += lw[b * nsplit + k];
      s += __ldcg(pacc + (size_t)k * HD) * w[k];
    }
    a.out[(size_t)(b0 + b) * a.dm + col + d] = s / denom;
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

// zx: (B, ldzx) f32 with the query in columns [0, dm); rings (B, S, dm) bf16
// (this layer's); rel_ring (S, dm); k_meta, v_meta (B, 8, dm); rel_meta
// (8, dm); the workspace part_m, part_l (B*H, nsplit) and part_acc (B*H,
// nsplit, 128) f32 with nsplit = ceil(S / per_split) and per_split =
// SPLIT (the caller's split must be the kernel's); tickets: at least
// ceil(B / MAX_BG) * H zeroed words, left zero by every launch; out (B, dm)
// f32.
MG_EXPORT int mg_tdecode_attn(const float* zx, int ldzx, const void* k_ring, const void* v_ring, const void* rel_ring,
                              const void* k_meta, const void* v_meta, const void* rel_meta, int B, int H, int S,
                              int dm, int c, int n_meta, float scale, int per_split, float* part_m, float* part_l,
                              float* part_acc, void* tickets, float* out, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dm != H * HD || c < 0 || c >= S || n_meta < 0 || n_meta > MAX_META ||
      per_split != SPLIT || ldzx < dm)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  const int groups = (B + MAX_BG - 1) / MAX_BG, bg = (B + groups - 1) / groups;
  // The combine's weights reuse the V rows' shared memory.
  if ((size_t)2 * nsplit * sizeof(float) > (size_t)ROWS * RS) return (int)cudaErrorInvalidValue;
  // Bulk copies take 16-byte aligned rows.
  const void* rows[] = {k_ring, v_ring, rel_ring, k_meta, v_meta, rel_meta};
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = attn_smem_bytes(bg);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  AttnArgs a;
  a.zx = zx;
  a.ldzx = ldzx;
  a.k_ring = static_cast<const __nv_bfloat16*>(k_ring);
  a.v_ring = static_cast<const __nv_bfloat16*>(v_ring);
  a.rel_ring = static_cast<const __nv_bfloat16*>(rel_ring);
  a.k_meta = static_cast<const __nv_bfloat16*>(k_meta);
  a.v_meta = static_cast<const __nv_bfloat16*>(v_meta);
  a.rel_meta = static_cast<const __nv_bfloat16*>(rel_meta);
  a.B = B;
  a.H = H;
  a.S = S;
  a.dm = dm;
  a.c = c;
  a.n_meta = n_meta;
  a.bg = bg;
  a.scale = scale;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.out = out;
  a.tickets = static_cast<unsigned*>(tickets);
  attn_kernel<<<dim3(nsplit, H, groups), NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
