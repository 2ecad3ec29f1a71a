// Kernel A: Mamba-2 SSD chunked scan, forward (prefill).
//
// Replaces musicgen_tpu/ops/pallas_ssd.py `_ssd_kernel` (wrapper
// `ssd_chunked_pallas`). Same contract: x (B,T,H,P), dt (B,T,H), A (H,),
// B/C (B,T,G,N) -> y (B,T,H,P) and the final state (B,H,P,N) from a zero
// state, f32, P = N = 64, any T (a ragged last chunk is zero-filled: dt = 0
// leaves the state exact, as the model's trailing pad steps do).
//
//   within a chunk:  y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   chunk's own end: S_c  = sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
//   across chunks:   h_{c+1} = exp(cum_last,c) h_c + S_c,  y_t += exp(cum_t) C_t . h_c
//
// What bounds it on an H100. Its inputs and outputs are 79 MB at the
// main-path shape (B=2, T=2304, H=32): 0.024 ms at 3.35 TB/s, against 0.015
// ms for the recurrence's f32 work (2.4 GFLOP) at a third of the dense TF32
// rate. The chunked form below adds a scratch of the chunks' end states (as
// large as x, written and read once) and y_diag written and read back, so
// it moves about 226 MB; and its products, four 64x64x64 a chunk in three
// TF32 passes each, run on mma.sync (PERF.md has the times).
//
// Design. The TPU kernel carried the (P,N) state in VMEM along a sequential
// grid axis; the first port kept that as one block a (batch, head) walking
// its 36 chunks in f32 FMA (64 blocks on 132 SMs). Here the chunks run in
// parallel, in two launches:
//   1. ssd_chunk_kernel, one 128-thread block a (chunk, head, batch):
//      2,304 blocks at the main path, four a SM. B and C (shared by the
//      group's heads, mostly from L2) are loaded by cp.async in one group
//      and x in the next, so that the scores C B^T are computed while x is in
//      flight; warp 0 takes the chunk's cumsum of dt*A as a warp scan
//      meanwhile. Then y_diag = ((C B^T) o L)(dt x), written to y, and the
//      chunk's own end state S_c, written to the scratch (B, NC, H, P, N),
//      the cumsum to (B, H, NC*Q). Warp w owns rows [16w, 16w+16) of the
//      causal products and all 8 column tiles, those above the diagonal
//      masked to zero: fixed loop bounds let the compiler interleave the
//      tiles (bounds that grow with w, skipping those tiles, were slower).
//      The scores feed the second product from registers: its k order is
//      permuted so that the accumulator fragment is the operand fragment.
//   2. ssd_pass_kernel, one 128-thread block a (16 state rows p, head,
//      batch): 256 blocks, two a SM. It walks the chunks in order with its
//      slice of the state in registers (each warp a copy), a ring of three
//      stages of (C tile, S_c slice, y_diag slice, cumsum) in flight by
//      cp.async, and per chunk adds exp(cum_t) C_t . h_c into y and steps the
//      state, h <- exp(cum_last) h + S_c. It writes the final state.
// Every sum has a fixed order and no value depends on another (b, h) pair:
// the same bits on every call, replay and batch size; no atomics.
//
// Accuracy: f32 inputs, and the products on the tensor cores as 3xTF32
// (mma.sync m16n8k8): v = hi + lo with hi = v with its low 13 mantissa bits
// cleared and lo = (v - hi) likewise, each product a_lo b_hi + a_hi b_lo +
// a_hi b_hi with f32 sums, about 2^-21 relative a term, against 2^-11 for
// one TF32 pass, which would sit near TOL_F32 (1e-4 of the largest output);
// f32 FMA would take more issue slots than the three passes. The gates
// (cumsum, exp) and the state recurrence stay in f32.
#include "common.cuh"

namespace {

constexpr int Q = 64;       // chunk length
constexpr int D = 64;       // headdim P == d_state N
constexpr int NT = 128;     // 4 warps a block in both launches
// Launch 1: row stride of the x, B and C tiles, 4 mod 32 floats: every
// fragment read below falls on 32 distinct banks.
constexpr int LD = D + 4;
constexpr size_t kChunkSmem = (3 * Q * LD + 3 * Q) * sizeof(float);
// Launch 2: state rows a block, stages in flight, and row strides (8 mod 32
// floats for the float2 reads of C and S_c; 24 for the y slice).
constexpr int PS = 16;
constexpr int PT = PS / 8;  // 8-row tiles of the state a block
constexpr int STAGES = 3;
constexpr int LDC = D + 8;
constexpr int LDS = D + 8;
constexpr int LDY = PS + 8;
constexpr int kStageFloats = Q * LDC + PS * LDS + Q * LDY + Q;
constexpr size_t kPassSmem = (size_t)STAGES * kStageFloats * sizeof(float);

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// The 3xTF32 split: hi = v truncated to TF32, lo = (v - hi) truncated.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b on one 16x8x8 tile in 3xTF32, from f32 fragments: a (16x8, row
// major: a0 (g, k0), a1 (g + 8, k0), a2 (g, k1), a3 (g + 8, k1)), b (8x8:
// b0 (k0, g), b1 (k1, g)), with g = lane / 4 and k0, k1 the lane's two k.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

__device__ __forceinline__ void mma3(float d[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

__global__ void __launch_bounds__(NT, 4) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ chunk_states, float* __restrict__ cum_out, int T, int H, int G, int NC) {
  extern __shared__ __align__(16) float sm[];
  float* sX = sm;             // [s][p]  x_s, then dt_s x_s
  float* sB = sX + Q * LD;    // [s][n]  B_s
  float* sC = sB + Q * LD;    // [t][n]  C_t
  float* sDt = sC + Q * LD;   // [s]
  float* sCum = sDt + Q;      // [s]     inclusive cumsum of dt*A in the chunk
  float* sW = sCum + Q;       // [s]     exp(cum_last - cum_s)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int t0 = c * Q;

  // B and C in one group, x in the next; rows past T zero-filled.
  for (int i = tid; i < Q * (D / 4); i += NT) {
    const int s = i >> 4, q = (i & 15) * 4, t = t0 + s;
    const bool in = t < T;
    const size_t bo = in ? (((size_t)b * T + t) * G + g) * D + q : 0;
    cp_async16(smem_u32(sB + s * LD + q), Bm + bo, in);
    cp_async16(smem_u32(sC + s * LD + q), Cm + bo, in);
  }
  cp_async_commit();
  for (int i = tid; i < Q * (D / 4); i += NT) {
    const int s = i >> 4, q = (i & 15) * 4, t = t0 + s;
    const bool in = t < T;
    cp_async16(smem_u32(sX + s * LD + q), x + (in ? (((size_t)b * T + t) * H + h) * D + q : 0), in);
  }
  cp_async_commit();

  // The chunk's cumsum of dt*A: lane l holds steps 2l and 2l + 1; a
  // Kogge-Stone scan of the pairs' sums.
  if (warp == 0) {
    const float a = A[h];
    const int ta = t0 + 2 * lane;
    const float d0 = ta < T ? dt[((size_t)b * T + ta) * H + h] : 0.f;
    const float d1 = ta + 1 < T ? dt[((size_t)b * T + ta + 1) * H + h] : 0.f;
    const float v0 = d0 * a, v1 = d1 * a;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float c0 = excl + v0;
    sDt[2 * lane] = d0;
    sDt[2 * lane + 1] = d1;
    sCum[2 * lane] = c0;
    sCum[2 * lane + 1] = c0 + v1;
  }
  cp_async_wait_1();
  __syncthreads();
  if (tid < Q) {
    sW[tid] = expf(sCum[Q - 1] - sCum[tid]);
    cum_out[((size_t)b * H + h) * NC * Q + t0 + tid] = sCum[tid];
  }

  // This warp's 16 rows of the two causal products. Every warp takes all 8
  // column tiles, those above the diagonal too (masked to zero below): the
  // tile loops then have fixed bounds, which the compiler interleaves; with
  // bounds that grow with the warp, the warps' unequal loads and the run-time
  // branches cost more than the extra products.
  const int r0 = 16 * warp;

  // Scores S[t][s] = C_t . B_s (k = n in order).
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int k0 = 8 * ks + tig;
    FragA fa;
    fa.set(sC[(r0 + gid) * LD + k0], sC[(r0 + gid + 8) * LD + k0], sC[(r0 + gid) * LD + k0 + 4],
           sC[(r0 + gid + 8) * LD + k0 + 4]);
#pragma unroll
    for (int st = 0; st < 8; ++st)
      mma3(acc[st], fa, sB[(8 * st + gid) * LD + k0], sB[(8 * st + gid) * LD + k0 + 4]);
  }
  // Mask and decay: M[t][s] = S[t][s] exp(cum_t - cum_s) for s <= t.
#pragma unroll
  for (int st = 0; st < 8; ++st) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + gid + 8 * (e >> 1), s = 8 * st + 2 * tig + (e & 1);
      acc[st][e] = s <= t ? acc[st][e] * expf(sCum[t] - sCum[s]) : 0.f;
    }
  }

  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < Q * D; i += NT) {
    const int s = i >> 6, p = i & 63;
    sX[s * LD + p] *= sDt[s];
  }
  __syncthreads();

  // y_diag[t][p] = sum_s M[t][s] (dt x)[s][p]. The accumulator of tile st
  // holds columns s = 8 st + 2 tig, + 1 of rows g, g + 8: taken as the
  // operand's k0 = 2 tig, k1 = 2 tig + 1 (a permuted k order), it is the A
  // fragment as it stands.
  float accY[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) accY[j][0] = accY[j][1] = accY[j][2] = accY[j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    FragA fa;
    fa.set(acc[st][0], acc[st][2], acc[st][1], acc[st][3]);
    const int s0 = 8 * st + 2 * tig;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) mma3(accY[pt], fa, sX[s0 * LD + 8 * pt + gid], sX[(s0 + 1) * LD + 8 * pt + gid]);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + r0 + gid + 8 * hr;
    if (t < T) {
      float* yr = y + (((size_t)b * T + t) * H + h) * D + 2 * tig;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        *reinterpret_cast<float2*>(yr + 8 * pt) = make_float2(accY[pt][2 * hr], accY[pt][2 * hr + 1]);
    }
  }

  // The chunk's end state S_c[p][n] = sum_s (dt x)[s][p] w_s B[s][n], k = s
  // in the permuted order 2 tig, 2 tig + 1 of each 8; rows p from 16 w.
  const int p0 = 16 * warp;
#pragma unroll
  for (int j = 0; j < 8; ++j) accY[j][0] = accY[j][1] = accY[j][2] = accY[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int s0 = 8 * ks + 2 * tig;
    const float w0 = sW[s0], w1 = sW[s0 + 1];
    FragA fa;
    fa.set(sX[s0 * LD + p0 + gid] * w0, sX[s0 * LD + p0 + gid + 8] * w0, sX[(s0 + 1) * LD + p0 + gid] * w1,
           sX[(s0 + 1) * LD + p0 + gid + 8] * w1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma3(accY[nt], fa, sB[s0 * LD + 8 * nt + gid], sB[(s0 + 1) * LD + 8 * nt + gid]);
  }
  float* so = chunk_states + (((size_t)b * NC + c) * H + h) * D * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* sr = so + (p0 + gid + 8 * hr) * D + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(sr + 8 * nt) = make_float2(accY[nt][2 * hr], accY[nt][2 * hr + 1]);
  }
}

__global__ void __launch_bounds__(NT, 2) ssd_pass_kernel(
    const float* __restrict__ Cm, const float* __restrict__ chunk_states, const float* __restrict__ cum,
    float* __restrict__ y, float* __restrict__ state_out, int T, int H, int G, int NC) {
  extern __shared__ __align__(16) float sm[];
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp;

  // Stage layout: C [t][n], S_c [p][n] (this block's rows), y_diag [t][p], cumsum [t].
  auto stage = [&](int k) { return sm + k * kStageFloats; };
  auto issue = [&](int c) {
    float* sC = stage(c % STAGES);
    float* sS = sC + Q * LDC;
    float* sY = sS + PS * LDS;
    float* sCum = sY + Q * LDY;
    const int t0 = c * Q;
    for (int i = tid; i < Q * (D / 4); i += NT) {
      const int t = i >> 4, q = (i & 15) * 4;
      const bool in = t0 + t < T;
      cp_async16(smem_u32(sC + t * LDC + q), Cm + (in ? (((size_t)b * T + t0 + t) * G + g) * D + q : 0), in);
    }
    const float* src = chunk_states + ((((size_t)b * NC + c) * H + h) * D + p0) * D;
    for (int i = tid; i < PS * (D / 4); i += NT) {
      const int r = i >> 4, q = (i & 15) * 4;
      cp_async16(smem_u32(sS + r * LDS + q), src + r * D + q, true);
    }
    for (int i = tid; i < Q * (PS / 4); i += NT) {
      const int t = i / (PS / 4), q = (i % (PS / 4)) * 4;
      const bool in = t0 + t < T;
      cp_async16(smem_u32(sY + t * LDY + q), y + (in ? (((size_t)b * T + t0 + t) * H + h) * D + p0 + q : 0), in);
    }
    if (tid < Q / 4) cp_async16(smem_u32(sCum + 4 * tid), cum + ((size_t)b * H + h) * NC * Q + t0 + 4 * tid, true);
  };

  // This block's state rows p0 + 8 pt + gid, columns 8 ks + 2 tig, + 1: the
  // B fragments of y_off's product (k = n, permuted as in launch 1).
  float hs[PT][8][2];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) hs[pt][ks][0] = hs[pt][ks][1] = 0.f;

  issue(0);
  cp_async_commit();
  if (NC > 1) issue(1);
  cp_async_commit();
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_1();
    __syncthreads();
    if (c + 2 < NC) issue(c + 2);
    cp_async_commit();
    const float* sC = stage(c % STAGES);
    const float* sS = sC + Q * LDC;
    const float* sY = sS + PS * LDS;
    const float* sCum = sY + Q * LDY;

    // y_off[t][p] = exp(cum_t) sum_n C[t][n] h[p][n], added into y.
    float acc[PT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float2 c0 = *reinterpret_cast<const float2*>(sC + (r0 + gid) * LDC + 8 * ks + 2 * tig);
      const float2 c1 = *reinterpret_cast<const float2*>(sC + (r0 + gid + 8) * LDC + 8 * ks + 2 * tig);
      FragA fa;
      fa.set(c0.x, c1.x, c0.y, c1.y);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) mma3(acc[pt], fa, hs[pt][ks][0], hs[pt][ks][1]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tl = r0 + gid + 8 * hr, t = c * Q + tl;
      if (t < T) {
        const float et = expf(sCum[tl]);
        float* yr = y + (((size_t)b * T + t) * H + h) * D + p0 + 2 * tig;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          const float2 yd = *reinterpret_cast<const float2*>(sY + tl * LDY + 8 * pt + 2 * tig);
          *reinterpret_cast<float2*>(yr + 8 * pt) =
              make_float2(yd.x + acc[pt][2 * hr] * et, yd.y + acc[pt][2 * hr + 1] * et);
        }
      }
    }
    // h <- exp(cum_last) h + S_c.
    const float decay = expf(sCum[Q - 1]);
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const float2 sv = *reinterpret_cast<const float2*>(sS + (8 * pt + gid) * LDS + 8 * ks + 2 * tig);
        hs[pt][ks][0] = hs[pt][ks][0] * decay + sv.x;
        hs[pt][ks][1] = hs[pt][ks][1] * decay + sv.y;
      }
  }
  cp_async_wait_all();
  if (warp == 0) {
    float* so = state_out + (((size_t)b * H + h) * D + p0) * D;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        *reinterpret_cast<float2*>(so + (8 * pt + gid) * D + 8 * ks + 2 * tig) = make_float2(hs[pt][ks][0], hs[pt][ks][1]);
  }
}

}  // namespace

// y, the final state, and the scratch: chunk_states (B, NC, H, P, N) and
// cum (B, H, NC * 64), NC = ceil(T / 64), allocated by the caller.
MG_EXPORT int mg_ssd_scan(const float* x, const float* dt, const float* A, const float* Bm,
                          const float* Cm, float* y, float* state, float* chunk_states, float* cum, int batch,
                          int T, int H, int G, int P, int N, void* stream) {
  if (P != D || N != D || G <= 0 || H % G != 0 || batch <= 0 || T <= 0 || batch > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int nc = (T + Q - 1) / Q;
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kChunkSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPassSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_chunk_kernel<<<dim3(nc, H, batch), NT, kChunkSmem, s>>>(x, dt, A, Bm, Cm, y, chunk_states, cum, T, H, G, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_pass_kernel<<<dim3(D / PS, H, batch), NT, kPassSmem, s>>>(Cm, chunk_states, cum, y, state, T, H, G, nc);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_ssd_scan_geometry(int* out) {
  // chunk length, threads, launch 1's and launch 2's dynamic shared memory,
  // state rows a pass block, stages
  out[0] = Q;
  out[1] = NT;
  out[2] = (int)kChunkSmem;
  out[3] = (int)kPassSmem;
  out[4] = PS;
  out[5] = STAGES;
  return 0;
}

MG_EXPORT const char* mg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
