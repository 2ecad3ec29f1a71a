// Kernel A: Mamba-2 SSD chunked scan, forward (prefill).
//
// Replaces musicgen_tpu/ops/pallas_ssd.py `_ssd_kernel` (wrapper
// `ssd_chunked_pallas`). Same contract: x (B,T,H,P), dt (B,T,H), A (H,),
// B/C (B,T,G,N) -> y (B,T,H,P) and the final state (B,H,P,N), f32.
//
//   within a chunk:  y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   across chunks:   y_t += exp(cum_t) C_t . h_in,
//                    h_out = exp(cum_last) h_in + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
//
// What bounds it on an H100: the four 64x64x64 products per chunk, in f32
// FMA out of shared memory; the inputs are read once (about 10 MB per layer
// at the main-path shape B=2, T=2304, H=32, P=N=64).
//
// Design: the TPU kernel carried the (P,N) state in VMEM across a sequential
// grid axis. Blocks on Hopper run in no order, so here ONE block owns one
// (batch, head) pair and loops over the chunks itself, with the state in
// shared memory for the whole sequence. The chunk is Q = 64 (the function
// does not depend on Q): Q x Q scores take 16 KB, and the five 64x64 tiles
// (B, C, dt*x, scores, state) fit in 84 KB of dynamic shared memory. Rows are
// padded to 65 floats so that transposed reads fall on distinct banks. Each
// of the 256 threads owns a 4x4 register tile of every 64x64 result. A ragged
// last chunk is zero-filled: dt = 0 leaves the state exact, as the trailing
// pad steps of the model's prefill do. B*H blocks (64 at the main path) use
// about half of the 132 SMs; wgmma/TMA and a split over chunks are later work.
#include "common.cuh"

namespace {

constexpr int Q = 64;       // chunk length
constexpr int D = 64;       // headdim P == d_state N
constexpr int LD = D + 1;   // padded shared-memory row stride
constexpr int NT = 256;     // 16 x 16 threads, 4 x 4 outputs each

constexpr size_t kSmemFloats = 4 * Q * LD + D * LD + 3 * Q;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

// acc[r][c] += sum_k L(i_r, k) * R(k, j_c) * ks(k)
// with i_r = ty + 16 r, j_c = tx + 16 c; L(i,k) = L[i*lsi + k*lsk],
// R(k,j) = R[k*rsk + j*rsj]; ks = kscale[k] or 1.
__device__ __forceinline__ void tile_mm(float acc[4][4], const float* L, int lsi, int lsk,
                                        const float* R, int rsk, int rsj,
                                        const float* kscale, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float ks = kscale ? kscale[k] : 1.f;
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = L[(ty + 16 * r) * lsi + k * lsk];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = R[k * rsk + (tx + 16 * c) * rsj] * ks;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ state_out, int T, int H, int G) {
  extern __shared__ float sm[];
  float* sB = sm;             // [s][n]  B_s
  float* sC = sB + Q * LD;    // [t][n]  C_t
  float* sX = sC + Q * LD;    // [s][p]  dt_s x_s
  float* sS = sX + Q * LD;    // [t][s]  masked, decayed scores
  float* sH = sS + Q * LD;    // [p][n]  carried state
  float* sDt = sH + D * LD;   // [s]
  float* sCum = sDt + Q;      // [s]     inclusive cumsum of dt*A in the chunk
  float* sW = sCum + Q;       // [s]     exp(cum_last - cum_s)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];

  for (int i = tid; i < D * LD; i += NT) sH[i] = 0.f;

  for (int c0 = 0; c0 < T; c0 += Q) {
    if (tid < Q) {
      const int t = c0 + tid;
      sDt[tid] = t < T ? dt[((size_t)b * T + t) * H + h] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < Q * D; i += NT) {
      const int s = i / D, d = i % D, t = c0 + s;
      const bool in = t < T;
      const size_t xo = (((size_t)b * T + t) * H + h) * D + d;
      const size_t bo = (((size_t)b * T + t) * G + g) * D + d;
      sX[s * LD + d] = in ? x[xo] * sDt[s] : 0.f;
      sB[s * LD + d] = in ? Bm[bo] : 0.f;
      sC[s * LD + d] = in ? Cm[bo] : 0.f;
    }
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < Q; ++s) {
        run += sDt[s] * a;
        sCum[s] = run;
      }
    }
    __syncthreads();
    if (tid < Q) sW[tid] = expf(sCum[Q - 1] - sCum[tid]);

    // Scores C_t . B_s, and the inter-chunk term C_t . h_in.
    float accS[4][4] = {}, accY[4][4] = {};
    tile_mm(accS, sC, LD, 1, sB, 1, LD, nullptr, ty, tx);
    tile_mm(accY, sC, LD, 1, sH, 1, LD, nullptr, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      const float ct = sCum[t];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = tx + 16 * c;
        sS[t * LD + s] = s <= t ? accS[r][c] * expf(ct - sCum[s]) : 0.f;
        accY[r][c] *= expf(ct);
      }
    }
    __syncthreads();

    // Intra-chunk term: y_t += sum_s S[t,s] (dt x)_s.
    tile_mm(accY, sS, LD, 1, sX, LD, 1, nullptr, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = c0 + ty + 16 * r;
      if (t < T) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          y[(((size_t)b * T + t) * H + h) * D + tx + 16 * c] = accY[r][c];
      }
    }

    // State: h[p,n] = exp(cum_last) h[p,n] + sum_s (dt x)_s[p] w_s B_s[n].
    // Each thread rewrites only the state entries it owns.
    float accH[4][4] = {};
    tile_mm(accH, sX, 1, LD, sB, LD, 1, sW, ty, tx);
    const float dl = expf(sCum[Q - 1]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* hp = &sH[(ty + 16 * r) * LD + tx + 16 * c];
        *hp = *hp * dl + accH[r][c];
      }
    __syncthreads();
  }

  float* so = state_out + ((size_t)b * H + h) * D * D;
  for (int i = tid; i < D * D; i += NT) so[i] = sH[(i / D) * LD + i % D];
}

}  // namespace

MG_EXPORT int mg_ssd_scan(const float* x, const float* dt, const float* A, const float* Bm,
                          const float* Cm, float* y, float* state, int batch, int T, int H,
                          int G, int P, int N, void* stream) {
  if (P != D || N != D || G <= 0 || H % G != 0 || batch <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<<<batch * H, NT, kSmemBytes, (cudaStream_t)stream>>>(x, dt, A, Bm, Cm, y, state,
                                                                       T, H, G);
  return (int)cudaGetLastError();
}

MG_EXPORT const char* mg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
