// Kernel H: the sLSTM recurrence of the prefill, over the whole sequence.
//
// Replaces musicgen_tpu/ops/pallas_slstm.py `_slstm_kernel` (via
// `slstm_pallas`). Per step t, for each (batch row b, head h):
//
//   pre[g, e] = wx[b, t, g, h, e] + sum_d h_{t-1}[d] R[g, h, d, e] + bias[g, h, e]
//   m_t = max(f + m, i);  i' = exp(i - m_t);  f' = exp(f + m - m_t)
//   c_t = f' c + i' tanh(z);  n_t = f' n + i';  h_t = sigmoid(o) c_t / n_t
//
// in f32 throughout, R in f32 as in the TPU kernel (no tensor-core product).
// The state starts at h = c = n = 0 and m = -inf, as
// ops/slstm.slstm_init_state; at the first step f' is set to 0 directly, so
// -inf - (-inf) never reaches an exp.
//
// What bounds it on an H100: the T steps are strictly sequential, and each
// step of a head multiplies h_{t-1} by the head's R_h, 4 x DH x DH f32 (1 MB
// at DH = 256): latency, not bytes or operations. R_h does not fit one SM's
// 227 KB, so a single block would stream it from L2 at every step.
//
// Design: one thread-block cluster of CS blocks (ranks) a head and a group
// of up to BR = 8 batch rows, launched with cudaLaunchKernelEx. CS is 16
// (non-portable; 64 KB of R a rank at DH = 256) where it divides DH, else 8.
//  * Rank r owns the hidden units e in [r U, (r + 1) U), U = DH / CS, with
//    all four gate columns of each, so the cell update (c, n, m in registers
//    for the whole sequence) stays on the rank; only h crosses SMs.
//  * The rank's slab of R_h, (DH, 4 U) f32, is one contiguous block of the
//    wrapper's re-layout (ops/slstm_kernel pack_r_slabs, (H, CS, DH, 4 U));
//    it is copied into shared memory once (cp.async) and read from there at
//    every step.
//  * A step: thread (ks, q) sums h_{t-1}[b, d] R[d, col] over K slice ks (the
//    U rows of rank ks's units) and columns 4q .. 4q + 3 for every row b of
//    the group (f32 FMA, in d order). The slices' partial sums meet in shared
//    memory and the thread owning (b, unit) adds them in slice order (no
//    atomics: every launch gives the same bits), adds wx and the bias,
//    updates the cell and pushes h_t[b, e] into every rank's h buffer for
//    step t + 1 with st.async, 16 bytes (four units) a store.
//  * The pushes complete transactions on the receiver's mbarrier for that
//    buffer and that source rank, so slice ks of step t + 1 starts as soon as
//    rank ks's slice of h_t has landed: no cluster-wide barrier in the loop.
//    The waits carry a suspend-time hint, so the waiting warps sleep rather
//    than poll beside the cell warp. The h buffers are double-buffered by the
//    parity of t: a rank pushes h_t into a peer's buffer only after the
//    peer's h_{t-1} has reached it, and the peer sends that only once its
//    step t - 1 has read the buffer's previous contents, h_{t-2}. A block
//    barrier ends each step. The partial sums alternate between two buffers
//    by the parity of t as well: with the same barriers, one buffer compiled
//    to more registers and measured 0.1-0.2 ms slower a launch on an H100
//    at (B, T, H, DH) = (2, 2054, 4, 256) (PERF.md, kernel H).
//  * wx is off the dependent path: each cell thread loads its four gate
//    inputs of step t + 1 into registers at the start of step t.
// Heads wider than 256 run slstm_wide_kernel (below): the same partition
// with part of each rank's slab read from L2 at every step. A head width
// that is no multiple of 8 is padded by the wrapper with zero units.
// Row groups are independent clusters; nothing crosses clusters, so they
// need not be co-resident. The TPU kernel's T chunks, padding and pad
// masking were artefacts of its grid: this loops over the real T.
//
// The launch never falls back: a shape the kernel does not take, or a
// cluster launch the card refuses, returns the error and the wrapper raises.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // = the largest DH: one K slice x quad of columns a thread
constexpr int kMaxDh = 256;     // slstm_cluster_kernel's largest DH: the whole slab in shared memory
constexpr int kMaxWideDh = 1024;  // slstm_wide_kernel's: one thread per K slice x quad of columns
constexpr int kMaxRows = 8;    // BR, the rows of a cluster's group
constexpr int kSmemLimit = 232448;  // 227 KB, the most shared memory a block can take
constexpr uint32_t kSuspendNs = 1000000;  // an mbarrier wait's suspend-time hint

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of transactions: the barrier's
// current phase completes when they have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed; acquires what the
// pushes that completed it wrote.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1, %2;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(kSuspendNs)
      : "memory");
}

// v into rank `rank`'s copy of *p, completing 4 (16) bytes of its copy of *bar.
__device__ __forceinline__ void push(const float* p, uint32_t rank, float v, const uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(peer_addr(p, rank)),
               "f"(v), "r"(peer_addr(bar, rank))
               : "memory");
}

__device__ __forceinline__ void push(const float* p, uint32_t rank, float4 v, const uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   peer_addr(p, rank)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(peer_addr(bar, rank))
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
  return v;
}

// Bytes of dynamic shared memory: the slab (DH, 4U), two buffers of the
// slices' partial sums (CS, NB, 4U) and two h buffers (NB, DH), f32.
__host__ __device__ inline size_t smem_bytes(int DH, int CS, int NB) {
  const size_t U = DH / CS;
  return 4 * ((size_t)DH * 4 * U + 2 * 4 * (size_t)NB * DH + 2 * (size_t)NB * DH);
}

// grid (CS, H, row groups), cluster (CS, 1, 1), kThreads threads.
// NB = BR: the rows of a full group (the last group may hold fewer, nb).
template <int NB, int CS>
__global__ void __launch_bounds__(kThreads, 1) slstm_cluster_kernel(
    const float* __restrict__ wx,     // (B, T, 4, H, DH)
    const float* __restrict__ slabs,  // (H, CS, DH, 4U): slab[h, r, d, g U + u] = R[g, h, d, r U + u]
    const float* __restrict__ bias,   // (4, H, DH)
    float* __restrict__ h_out,        // (B, T, H, DH)
    float* __restrict__ state,        // (4, B, H, DH): final h, c, n, m
    int B, int T, int H, int DH, unsigned long long* __restrict__ stamps, int n_stamp_steps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t mbar[2][CS];  // [parity of the h buffer][source rank]
  const int U = DH / CS, NC = 4 * U;
  const int rank = (int)cluster_rank(), h = blockIdx.y, b0 = blockIdx.z * NB, nb = min(NB, B - b0);
  const int j = threadIdx.x, lane = j & 31;
  float* slab = smem;                             // (DH, NC)
  float* part = slab + (size_t)DH * NC;           // (2, CS, NB, NC)
  float* hbuf = part + 2 * (size_t)CS * NB * NC;  // (2, NB, DH)

  const float* src = slabs + ((size_t)h * CS + rank) * DH * NC;
  for (int i = 4 * j; i < DH * NC; i += 4 * kThreads) cp_async16(smem_u32(slab + i), src + i, true);
  cp_async_commit();
  for (int i = j; i < 2 * NB * DH; i += kThreads) hbuf[i] = 0.f;  // h_{-1} = 0; rows >= nb stay 0
  const uint32_t slice_bytes = 4u * nb * U;  // what a source rank pushes a step
  if (j < 2 * CS) {
    mbar_init(&mbar[j / CS][j % CS]);
    mbar_expect(&mbar[j / CS][j % CS], slice_bytes);  // each buffer's first fill
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The product: K slice ks (rows ks U .. ks U + U - 1 of the slab: rank
  // ks's units of h), columns 4q .. 4q + 3.
  const bool prod = j < DH;
  const int ks = j / U, q = j % U;
  // The cell: row cb, unit cu (hidden unit e of the head); its wx in registers a step ahead.
  const bool cell = j < nb * U, cell_warp = j - lane < nb * U;
  const int cb = j / U, cu = j % U, e = rank * U + cu;
  const size_t wrow = (size_t)H * DH;
  const float* wxc = wx + (size_t)(b0 + cb) * T * 4 * wrow + (size_t)h * DH + e;
  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = cell ? __ldg(bias + ((size_t)g * H + h) * DH + e) : 0.f;
  float c = 0.f, n = 0.f, m = -INFINITY, hv = 0.f;
  float wcur[4] = {0.f, 0.f, 0.f, 0.f}, wnext[4] = {0.f, 0.f, 0.f, 0.f};
  if (cell) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wcur[g] = __ldg(wxc + (size_t)g * wrow);
  }
  const bool stamp = stamps != nullptr && j == 0 && rank == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  if (stamp) {
    stamps[0] = globaltimer();
    stamps[1] = clock64();
  }

  cp_async_wait_all();
  cluster_sync();  // the slab, the zeroed h buffers and the armed mbarriers are in place in every rank
  for (int t = 0; t < T; ++t) {
    const bool st_on = stamp && t < n_stamp_steps;
    unsigned long long* st = st_on ? stamps + 4 + 3 * (size_t)t : nullptr;
    if (st_on) st[0] = clock64();
    if (cell && t + 1 < T) {
#pragma unroll
      for (int g = 0; g < 4; ++g) wnext[g] = __ldg(wxc + ((size_t)(t + 1) * 4 + g) * wrow);
    }
    if (prod) {
      if (t > 0) {  // rank ks's slice of h_{t-1} has landed in hbuf[t & 1]
        mbar_wait(&mbar[t & 1][ks], (((t + 1) >> 1) - 1) & 1);
        if (q == 0) mbar_expect(&mbar[t & 1][ks], slice_bytes);  // the buffer's next fill
      }
      const float* sl = slab + (size_t)ks * U * NC + 4 * q;
      const float* hk = hbuf + (t & 1) * NB * DH + ks * U;
      float acc[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      if (U % 4 == 0) {
        for (int d = 0; d < U; d += 4) {
          float4 hv4[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) hv4[b] = *reinterpret_cast<const float4*>(hk + b * DH + d);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 w = *reinterpret_cast<const float4*>(sl + (size_t)(d + k) * NC);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const float x = k == 0 ? hv4[b].x : k == 1 ? hv4[b].y : k == 2 ? hv4[b].z : hv4[b].w;
              acc[b][0] = fmaf(x, w.x, acc[b][0]);
              acc[b][1] = fmaf(x, w.y, acc[b][1]);
              acc[b][2] = fmaf(x, w.z, acc[b][2]);
              acc[b][3] = fmaf(x, w.w, acc[b][3]);
            }
          }
        }
      } else {
        for (int d = 0; d < U; ++d) {
          const float4 w = *reinterpret_cast<const float4*>(sl + (size_t)d * NC);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float x = hk[b * DH + d];
            acc[b][0] = fmaf(x, w.x, acc[b][0]);
            acc[b][1] = fmaf(x, w.y, acc[b][1]);
            acc[b][2] = fmaf(x, w.z, acc[b][2]);
            acc[b][3] = fmaf(x, w.w, acc[b][3]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
        *reinterpret_cast<float4*>(part + (((size_t)(t & 1) * CS + ks) * NB + b) * NC + 4 * q) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
    __syncthreads();
    if (st_on) st[1] = clock64();
    if (cell) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* p = part + ((size_t)(t & 1) * CS * NB + cb) * NC + g * U + cu;
        float rec = 0.f;
#pragma unroll
        for (int s = 0; s < CS; ++s) rec += p[(size_t)s * NB * NC];
        pre[g] = (wcur[g] + rec) + bg[g];
      }
      const float m_new = fmaxf(pre[1] + m, pre[0]);
      const float i_act = expf(pre[0] - m_new);
      const float f_act = m == -INFINITY ? 0.f : expf(pre[1] + m - m_new);
      c = f_act * c + i_act * tanhf(pre[2]);
      n = f_act * n + i_act;
      m = m_new;
      hv = sigmoidf_(pre[3]) * c / n;
    }
    if (t + 1 < T && cell_warp) {
      // h_t[cb, e] into every rank's buffer for step t + 1.
      const float* dst = hbuf + ((t + 1) & 1) * NB * DH + cb * DH + e;
      const uint64_t* bar = &mbar[(t + 1) & 1][rank];
      if (U % 4 == 0) {
        // Four units a 16-byte store: lane 4k + i pushes its group's to ranks i, i + 4, ...
        const int g0 = lane & ~3;
        const float4 v4 = make_float4(__shfl_sync(0xffffffffu, hv, g0), __shfl_sync(0xffffffffu, hv, g0 + 1),
                                      __shfl_sync(0xffffffffu, hv, g0 + 2), __shfl_sync(0xffffffffu, hv, g0 + 3));
        if (cell) {
#pragma unroll
          for (int r = lane & 3; r < CS; r += 4) push(dst - (cu & 3), (uint32_t)r, v4, bar);
        }
      } else if (cell) {
#pragma unroll
        for (int r = 0; r < CS; ++r) push(dst, (uint32_t)r, hv, bar);
      }
    }
    if (st_on) st[2] = clock64();
    __syncthreads();
    if (cell) h_out[(((size_t)(b0 + cb) * T + t) * H + h) * DH + e] = hv;
#pragma unroll
    for (int g = 0; g < 4; ++g) wcur[g] = wnext[g];
  }
  cluster_sync();  // no rank leaves while a peer may still push into its shared memory
  if (stamp) {
    stamps[2] = globaltimer();
    stamps[3] = clock64();
  }
  if (cell) {
    const size_t o = ((size_t)(b0 + cb) * H + h) * DH + e, plane = (size_t)B * H * DH;
    state[o] = hv;
    state[plane + o] = c;
    state[2 * plane + o] = n;
    state[3 * plane + o] = m;
  }
}

// Wide heads, kMaxDh < DH <= kMaxWideDh: the slab (DH, 4U) no longer fits
// in shared memory (256 KB a rank at DH = 512, 1 MB at DH = 1024). Shared
// memory holds one buffer of partial sums (CS, NB, 4U), the two h buffers
// and, in what is left, the first KR rows of each K slice of the slab
// (CS, KR, 4U); the other U - KR rows of each slice are read from global
// memory at every step, where the head's R_h (4 MB at DH = 512, 16 MB at
// DH = 1024) stays in the 50 MB L2. The partition, the sums' order (d in
// order within a slice, slices in order), the cell and the pushes are
// slstm_cluster_kernel's; a block has one thread per (K slice, quad of
// columns), DH threads rounded up to a warp. One buffer of partial sums
// serves every step: the cells read it before the step's closing barrier,
// and the next step's products write it after.
__host__ __device__ inline size_t wide_smem_bytes(int DH, int CS, int NB, int KR) {
  const size_t NC = 4 * (size_t)(DH / CS);
  return 4 * ((size_t)CS * KR * NC + (size_t)CS * NB * NC + 2 * (size_t)NB * DH);
}

// The rows of each K slice that stay in shared memory, read back from the
// launch's smem bytes (-1 where no KR gives them).
inline int wide_resident_rows(int DH, int CS, int NB, int smem) {
  const size_t fixed = wide_smem_bytes(DH, CS, NB, 0), row = 4 * (size_t)CS * 4 * (DH / CS);
  if ((size_t)smem < fixed || ((size_t)smem - fixed) % row) return -1;
  return (int)(((size_t)smem - fixed) / row);
}

template <int NB>
__device__ __forceinline__ void fma_rows(float (&acc)[NB][4], const float* hk, int DH, float4 w) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float x = hk[b * DH];
    acc[b][0] = fmaf(x, w.x, acc[b][0]);
    acc[b][1] = fmaf(x, w.y, acc[b][1]);
    acc[b][2] = fmaf(x, w.z, acc[b][2]);
    acc[b][3] = fmaf(x, w.w, acc[b][3]);
  }
}

template <int NB, int CS>
__global__ void __launch_bounds__(kMaxWideDh, 1) slstm_wide_kernel(
    const float* __restrict__ wx, const float* __restrict__ slabs, const float* __restrict__ bias,
    float* __restrict__ h_out, float* __restrict__ state, int B, int T, int H, int DH, int KR,
    unsigned long long* __restrict__ stamps, int n_stamp_steps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t mbar[2][CS];  // [parity of the h buffer][source rank]
  const int U = DH / CS, NC = 4 * U, nthreads = blockDim.x;
  const int rank = (int)cluster_rank(), h = blockIdx.y, b0 = blockIdx.z * NB, nb = min(NB, B - b0);
  const int j = threadIdx.x, lane = j & 31;
  float* res = smem;                             // (CS, KR, NC): rows s U .. s U + KR - 1 of the slab
  float* part = res + (size_t)CS * KR * NC;      // (CS, NB, NC)
  float* hbuf = part + (size_t)CS * NB * NC;     // (2, NB, DH)

  const float* src = slabs + ((size_t)h * CS + rank) * DH * NC;
  for (int i = j; i < CS * KR * U; i += nthreads) {  // U quads a row
    const int s = i / (KR * U);
    cp_async16(smem_u32(res + 4 * (size_t)i), src + (size_t)s * U * NC + 4 * (size_t)(i - s * KR * U), true);
  }
  cp_async_commit();
  for (int i = j; i < 2 * NB * DH; i += nthreads) hbuf[i] = 0.f;
  const uint32_t slice_bytes = 4u * nb * U;
  if (j < 2 * CS) {
    mbar_init(&mbar[j / CS][j % CS]);
    mbar_expect(&mbar[j / CS][j % CS], slice_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const bool prod = j < DH;
  const int ks = j / U, q = j % U;
  const bool cell = j < nb * U, cell_warp = j - lane < nb * U;
  const int cb = j / U, cu = j % U, e = rank * U + cu;
  const size_t wrow = (size_t)H * DH;
  const float* wxc = wx + (size_t)(b0 + cb) * T * 4 * wrow + (size_t)h * DH + e;
  float bg[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bg[g] = cell ? __ldg(bias + ((size_t)g * H + h) * DH + e) : 0.f;
  float c = 0.f, n = 0.f, m = -INFINITY, hv = 0.f;
  float wcur[4] = {0.f, 0.f, 0.f, 0.f}, wnext[4] = {0.f, 0.f, 0.f, 0.f};
  if (cell) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wcur[g] = __ldg(wxc + (size_t)g * wrow);
  }
  const bool stamp = stamps != nullptr && j == 0 && rank == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  if (stamp) {
    stamps[0] = globaltimer();
    stamps[1] = clock64();
  }

  cp_async_wait_all();
  cluster_sync();
  for (int t = 0; t < T; ++t) {
    const bool st_on = stamp && t < n_stamp_steps;
    unsigned long long* st = st_on ? stamps + 4 + 3 * (size_t)t : nullptr;
    if (st_on) st[0] = clock64();
    if (cell && t + 1 < T) {
#pragma unroll
      for (int g = 0; g < 4; ++g) wnext[g] = __ldg(wxc + ((size_t)(t + 1) * 4 + g) * wrow);
    }
    if (prod) {
      if (t > 0) {
        mbar_wait(&mbar[t & 1][ks], (((t + 1) >> 1) - 1) & 1);
        if (q == 0) mbar_expect(&mbar[t & 1][ks], slice_bytes);
      }
      const float* rs = res + (size_t)ks * KR * NC + 4 * q;  // resident rows 0 .. KR - 1 of slice ks
      const float* gs = src + (size_t)ks * U * NC + 4 * q;   // the slice's rows in global memory
      const float* hk = hbuf + (t & 1) * NB * DH + ks * U;
      float acc[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      for (int d = 0; d < KR; ++d) fma_rows<NB>(acc, hk + d, DH, *reinterpret_cast<const float4*>(rs + (size_t)d * NC));
      int d = KR;
      for (; d + 4 <= U; d += 4) {  // four loads in flight before their products
        float4 w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = __ldg(reinterpret_cast<const float4*>(gs + (size_t)(d + k) * NC));
#pragma unroll
        for (int k = 0; k < 4; ++k) fma_rows<NB>(acc, hk + d + k, DH, w[k]);
      }
      for (; d < U; ++d) fma_rows<NB>(acc, hk + d, DH, __ldg(reinterpret_cast<const float4*>(gs + (size_t)d * NC)));
#pragma unroll
      for (int b = 0; b < NB; ++b)
        *reinterpret_cast<float4*>(part + ((size_t)ks * NB + b) * NC + 4 * q) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
    __syncthreads();
    if (st_on) st[1] = clock64();
    if (cell) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* p = part + (size_t)cb * NC + g * U + cu;
        float rec = 0.f;
#pragma unroll
        for (int s = 0; s < CS; ++s) rec += p[(size_t)s * NB * NC];
        pre[g] = (wcur[g] + rec) + bg[g];
      }
      const float m_new = fmaxf(pre[1] + m, pre[0]);
      const float i_act = expf(pre[0] - m_new);
      const float f_act = m == -INFINITY ? 0.f : expf(pre[1] + m - m_new);
      c = f_act * c + i_act * tanhf(pre[2]);
      n = f_act * n + i_act;
      m = m_new;
      hv = sigmoidf_(pre[3]) * c / n;
    }
    if (t + 1 < T && cell_warp) {
      const float* dst = hbuf + ((t + 1) & 1) * NB * DH + cb * DH + e;
      const uint64_t* bar = &mbar[(t + 1) & 1][rank];
      if (U % 4 == 0) {
        const int g0 = lane & ~3;
        const float4 v4 = make_float4(__shfl_sync(0xffffffffu, hv, g0), __shfl_sync(0xffffffffu, hv, g0 + 1),
                                      __shfl_sync(0xffffffffu, hv, g0 + 2), __shfl_sync(0xffffffffu, hv, g0 + 3));
        if (cell) {
#pragma unroll
          for (int r = lane & 3; r < CS; r += 4) push(dst - (cu & 3), (uint32_t)r, v4, bar);
        }
      } else if (cell) {
#pragma unroll
        for (int r = 0; r < CS; ++r) push(dst, (uint32_t)r, hv, bar);
      }
    }
    if (st_on) st[2] = clock64();
    __syncthreads();
    if (cell) h_out[(((size_t)(b0 + cb) * T + t) * H + h) * DH + e] = hv;
#pragma unroll
    for (int g = 0; g < 4; ++g) wcur[g] = wnext[g];
  }
  cluster_sync();
  if (stamp) {
    stamps[2] = globaltimer();
    stamps[3] = clock64();
  }
  if (cell) {
    const size_t o = ((size_t)(b0 + cb) * H + h) * DH + e, plane = (size_t)B * H * DH;
    state[o] = hv;
    state[plane + o] = c;
    state[2 * plane + o] = n;
    state[3 * plane + o] = m;
  }
}

// The launch's shape as the wrapper's scan_geometry gives it; false where
// the kernel does not take it.
bool geometry_ok(int B, int T, int H, int DH, int CS, int NB, int smem) {
  if (!(B >= 1 && T >= 1 && H >= 1 && DH >= 8 && DH <= kMaxWideDh && DH % 8 == 0 && (CS == 8 || CS == 16) &&
        DH % CS == 0 && NB >= 1 && NB <= kMaxRows && NB <= B && smem + 2 * CS * (int)sizeof(uint64_t) <= kSmemLimit))
    return false;
  if (DH <= kMaxDh) return (size_t)smem == smem_bytes(DH, CS, NB);
  const int kr = wide_resident_rows(DH, CS, NB, smem);
  return kr >= 0 && kr <= DH / CS;
}

template <int NB, int CS>
cudaError_t launch(const float* wx, const float* slabs, const float* bias, float* h_out, float* state, int B, int T,
                   int H, int DH, int smem, unsigned long long* stamps, int n_stamp_steps, int* max_clusters,
                   cudaStream_t stream) {
  auto kernel = slstm_cluster_kernel<NB, CS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && CS > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, H, (B + NB - 1) / NB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, wx, slabs, bias, h_out, state, B, T, H, DH, stamps, n_stamp_steps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int NB, int CS>
cudaError_t launch_wide(const float* wx, const float* slabs, const float* bias, float* h_out, float* state, int B,
                        int T, int H, int DH, int smem, unsigned long long* stamps, int n_stamp_steps,
                        int* max_clusters, cudaStream_t stream) {
  auto kernel = slstm_wide_kernel<NB, CS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && CS > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, H, (B + NB - 1) / NB);
  cfg.blockDim = dim3((DH + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  const int kr = wide_resident_rows(DH, CS, NB, smem);
  e = cudaLaunchKernelEx(&cfg, kernel, wx, slabs, bias, h_out, state, B, T, H, DH, kr, stamps, n_stamp_steps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int CS>
cudaError_t dispatch_rows(const float* wx, const float* slabs, const float* bias, float* h_out, float* state, int B,
                          int T, int H, int DH, int NB, int smem, unsigned long long* stamps, int n_stamp_steps,
                          int* max_clusters, cudaStream_t stream) {
  switch (NB) {
#define MG_SLSTM_NB(k)                                                                                              \
  case k:                                                                                                           \
    return DH > kMaxDh ? launch_wide<k, CS>(wx, slabs, bias, h_out, state, B, T, H, DH, smem, stamps, n_stamp_steps, \
                                            max_clusters, stream)                                                    \
                       : launch<k, CS>(wx, slabs, bias, h_out, state, B, T, H, DH, smem, stamps, n_stamp_steps,      \
                                       max_clusters, stream);
    MG_SLSTM_NB(1)
    MG_SLSTM_NB(2)
    MG_SLSTM_NB(3)
    MG_SLSTM_NB(4)
    MG_SLSTM_NB(5)
    MG_SLSTM_NB(6)
    MG_SLSTM_NB(7)
    MG_SLSTM_NB(8)
#undef MG_SLSTM_NB
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const float* wx, const float* slabs, const float* bias, float* h_out, float* state, int B, int T,
                     int H, int DH, int CS, int NB, int smem, unsigned long long* stamps, int n_stamp_steps,
                     int* max_clusters, cudaStream_t stream) {
  if (CS == 16)
    return dispatch_rows<16>(wx, slabs, bias, h_out, state, B, T, H, DH, NB, smem, stamps, n_stamp_steps,
                             max_clusters, stream);
  return dispatch_rows<8>(wx, slabs, bias, h_out, state, B, T, H, DH, NB, smem, stamps, n_stamp_steps, max_clusters,
                          stream);
}

}  // namespace

// h_out (B, T, H, DH) and the final (h, c, n, m) as state (4, B, H, DH), from
// the zero state, with R as the wrapper's slabs (H, CS, DH, 4 DH / CS). The
// geometry (CS ranks a cluster, NB rows a group, smem bytes of dynamic
// shared memory a block) is ops/slstm_kernel.scan_geometry's; a launch that
// disagrees with it is refused. stamps (null, or 4 + 3 n_stamp_steps u64):
// the first cluster's rank 0, thread 0, records %globaltimer and clock64 at
// the loop's start and end, and clock64 at the start of each of its first
// steps, after its product and after its cell and pushes.
MG_EXPORT int mg_slstm_scan(const float* wx, const float* slabs, const float* bias, float* h_out, float* state,
                            int B, int T, int H, int DH, int CS, int NB, int smem, void* stamps, int n_stamp_steps,
                            void* stream) {
  if (!geometry_ok(B, T, H, DH, CS, NB, smem) || n_stamp_steps < 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(wx, slabs, bias, h_out, state, B, T, H, DH, CS, NB, smem, (unsigned long long*)stamps,
                       stamps == nullptr ? 0 : n_stamp_steps, nullptr, (cudaStream_t)stream);
}

// cudaOccupancyMaxActiveClusters of that launch into *out.
MG_EXPORT int mg_slstm_scan_clusters(int B, int T, int H, int DH, int CS, int NB, int smem, int* out) {
  if (!geometry_ok(B, T, H, DH, CS, NB, smem)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, B, T, H, DH, CS, NB, smem, nullptr, 0, out,
                       nullptr);
}
