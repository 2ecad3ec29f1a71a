// Kernel I: the bf16 weight-streaming probe, a skinny product
//
//   y (M, N) = bf16(x) (M, K) . W^T,  W (N, K) bf16    (f32 accumulation, M <= 8)
//
// Replaces experiments/hw_characterize.py `mm_kernel` (launched by
// `pallas_mm`), the probe that asks whether a hand kernel streams bf16
// weights at the memory's rate when a decode step multiplies them by a few
// rows. At the probe's shape (M 8, K 1024, N 4352, the Mamba in_proj's
// padded width) one product reads 8.9 MB of weights and does 71 MFLOP: at
// 3.35 TB/s it takes at least 2.66 us, and its 4 operations per weight byte
// are far below the card's 295 a byte, so the weights' bytes bound it.
//
// Layout: W is (N, K), K-contiguous, as the port's decode packs hold their
// matrices; the probe's entry point transposes the JAX script's (K, N).
//
// Design, its own (it does not use decode_ops.cuh's GEMV). With f32 FMAs on
// the CUDA cores, 8 rows x 8 columns of sums a thread leave too few warps
// on an SM to hide the loads' latency (such a kernel took 14 us a launch on
// an H100 80GB HBM3 at 700 W). So the products run on the tensor cores, as
// mma.sync.m16n8k16 (bf16 in, f32 sums): the mma's 16 rows are 16 columns n
// of W and its 8 columns the 8 rows of x, so M = 8 fills it exactly.
//   * A block of 256 threads owns 16 columns: 272 blocks at N 4352, two or
//     three on each of the 132 SMs, all resident at once. Its 8 warps split
//     K in steps of 32, round robin.
//   * In a step, lane (g = lane / 4, t = lane % 4) loads 16 bytes of column
//     n0 + g and of n0 + g + 8 at k = k0 + 8 t: each column's 64 bytes of the
//     step are one coalesced read. The mma sums over k in any order, so the
//     16 k-slots of one mma take k0 + 8 t + 0..3 and a second mma k0 + 8 t +
//     4..7; x is read with the same map.
//   * Each thread issues kUnroll steps' loads (32 bytes each) before it uses
//     any; the first ones are in flight while x is staged.
//   * x (M x K, rounded to bf16, rows M..7 zero) is staged once a block in
//     shared memory, each row padded by 64 bytes so that the 16-byte reads of
//     a quarter-warp fall on distinct banks.
//   * The 8 warps' 16 x 8 sums meet in shared memory and are added in warp
//     order: the result does not depend on the threads' timing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 16;    // columns of a block: the mma's 16 rows
constexpr int kStepK = 32;    // k of one step: two mma of 16 k-slots
constexpr int kUnroll = 4;    // steps a thread loads before using any
constexpr int kMaxM = 8;      // rows of x: the mma's 8 columns
constexpr int kPad = 32;      // bf16 of padding after each staged row of x
constexpr int kMaxK = 4096;   // staged x: 8 x (K + 32) bf16 <= 66 KB

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// Steps s0, s0 + 8, ... (kUnroll of them) of columns a and b, zero past K.
__device__ __forceinline__ void load_steps(uint4 (&va)[kUnroll], uint4 (&vb)[kUnroll], const __nv_bfloat16* wa,
                                           const __nv_bfloat16* wb, int s0, int steps) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int s = s0 + u * kWarps;
    const bool ok = s < steps;
    va[u] = ok ? __ldg(reinterpret_cast<const uint4*>(wa + s * kStepK)) : make_uint4(0u, 0u, 0u, 0u);
    vb[u] = ok ? __ldg(reinterpret_cast<const uint4*>(wb + s * kStepK)) : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads) probe_mm_kernel(const float* __restrict__ x,
                                                            const __nv_bfloat16* __restrict__ w,
                                                            float* __restrict__ y, int M, int K, int N) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (8, K + kPad)
  __shared__ float red[kWarps][kTileN * kMaxM];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTileN, ldx = K + kPad, steps = K / kStepK;
  const __nv_bfloat16* wa = w + (size_t)(n0 + g) * K + 8 * t;
  const __nv_bfloat16* wb = wa + (size_t)8 * K;

  uint4 va[kUnroll], vb[kUnroll];
  load_steps(va, vb, wa, wb, warp, steps);
  // x -> bf16 in shared memory while the first loads are in flight.
  const int row4 = K / 4;
  for (int i = tid; i < kMaxM * row4; i += kThreads) {
    const int r = i / row4, k = 4 * (i % row4);
    const float4 v = r < M ? __ldg(reinterpret_cast<const float4*>(x + (size_t)r * K + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint2*>(xs + (size_t)r * ldx + k) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  __syncthreads();

  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = warp; s0 < steps; s0 += kWarps * kUnroll) {
    if (s0 != warp) load_steps(va, vb, wa, wb, s0, steps);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      if (s < steps) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + (size_t)g * ldx + s * kStepK + 8 * t);
        mma_bf16(c, va[u].x, vb[u].x, va[u].y, vb[u].y, xv.x, xv.y);
        mma_bf16(c, va[u].z, vb[u].z, va[u].w, vb[u].w, xv.z, xv.w);
      }
    }
  }

  // c[0], c[1]: column n0 + g, rows 2t and 2t + 1; c[2], c[3]: column n0 + g + 8.
  red[warp][(2 * t) * kTileN + g] = c[0];
  red[warp][(2 * t + 1) * kTileN + g] = c[1];
  red[warp][(2 * t) * kTileN + g + 8] = c[2];
  red[warp][(2 * t + 1) * kTileN + g + 8] = c[3];
  __syncthreads();
  if (tid < kTileN * kMaxM) {
    const int r = tid / kTileN, n = tid % kTileN;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += red[q][tid];
    if (r < M) y[(size_t)r * N + n0 + n] = v;
  }
}

}  // namespace

// y = bf16(x) . W^T. x (M, K) f32, w (N, K) bf16, both 16-byte aligned;
// M <= 8, K % 32 == 0, K <= 4096, N % 16 == 0; y (M, N) f32.
MG_EXPORT int mg_probe_mm(const float* x, const void* w, float* y, int M, int K, int N, void* stream) {
  if (M < 1 || M > kMaxM || K < kStepK || K % kStepK != 0 || K > kMaxK || N < kTileN || N % kTileN != 0 ||
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(x)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMaxM * (K + kPad) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(probe_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_mm_kernel<<<N / kTileN, kThreads, smem, (cudaStream_t)stream>>>(x, static_cast<const __nv_bfloat16*>(w), y,
                                                                       M, K, N);
  return (int)cudaGetLastError();
}
