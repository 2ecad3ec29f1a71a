// Kernel J: the ablations of kernel B's decode step, which split a step's
// device time between streaming the weights, the products, the epilogues
// and the selective-state (SSD) update.
//
// Replaces experiments/kernel_ablate.py `make_variant` (launched by
// `call_variant`), whose variants of the TPU decode kernel each drop a part
// of the step. Here a variant is a chain of launches on one stream
// (ops/ablate_kernel.py assembles them as `decode_kernel.StepOps`):
//
//   V_dma    mg_ablate_stream a layer, then the head product (mg_ablate_gemv)
//   V_mm     mg_ablate_gemv twice a layer (in_proj, out_proj), then the head
//   V_nossd  kernel B's in_proj_conv, mg_ablate_nossd, kernel B's
//            out_proj_rms a layer, then the head product
//   V_full   kernel B itself (decode_gemv.cu, decode_mixer.cu)
//
// In the three ablated variants the head is bf16(x) . lm_w over the padded
// vocabulary, without the final LayerNorm and the bias, as in the TPU
// variants.
//
// mg_ablate_gemv runs the GEMV device code of kernel B (decode_ops.cuh
// gemv_team<kPlain, kStore, kBf16>, the bf16 product with the plain
// prologue and a store, as mg_x_gemv runs it): no new GEMV. Its one addition
// is a split of the columns between two outputs in the same launch, so that
// V_mm's in_proj writes the z columns (the first d_inner) contiguously for
// the out_proj product that reads them, as the TPU variant's slice
// zx[:, :d_inner] does, without a copy launch.
//
// mg_ablate_stream is the "touch every block" variant. On the TPU, a
// BlockSpec moved a layer's whole weight blocks into VMEM even though the
// body read eight rows; on the H100 a load reads only what it names. So this
// kernel reads EVERY byte of the layer's w_in (4256 x 1024 bf16) and w_out
// (1024 x 2048 bf16) with 16-byte loads, grid-stride over all SMs, and
// folds them into an XOR of their 32-bit words. The XOR is written to `sink`
// only when the caller passes one (chip_smoke.py checks it against the host's
// XOR of the same weights), and nvcc cannot drop a load whose value feeds a
// store under a condition known only at run time. The conv and SSM states
// are read and written in place, times `keep` (1 in V_dma: they pass
// through, as the TPU variant's aliased state blocks did, still moved both
// ways). The new x follows the TPU variant:
//   x[r, c] += 1e-6 * W_in[r, c] + 1e-6 * W_out[r, c]
// in JAX's (K, N) layout, which is w_in[c, r] and w_out[c, r] here.
// What bounds it: the 12.9 MB of weights and 2.2 MB of state a layer, at the
// memory's rate (4.5 us a layer at 3.35 TB/s).
//
// mg_ablate_nossd is the mixer without the SSD: g = x_ssd * D[h] * silu(z)
// from in_proj_conv's zx, and the SSM state decays in place (* 0.999), as the
// TPU variant's. It moves the 1 MB state twice: a few us a layer.
#include "decode_ops.cuh"

using namespace mg;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte weight loads a thread issues before using them

// ---------------------------------------------------------------------------
// The plain bf16 GEMV of kernel B, its columns split between two outputs.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TEAM) ablate_gemv_kernel(GemvArgs a0, GemvArgs a1, int teams0) {
  __shared__ GemvSmem sm;
  if ((int)blockIdx.x < teams0)
    gemv_team<kPlain, kStore, kBf16>(a0, sm, blockIdx.x, teams0, threadIdx.x, 1);
  else
    gemv_team<kPlain, kStore, kBf16>(a1, sm, blockIdx.x - teams0, gridDim.x - teams0, threadIdx.x, 1);
}

// ---------------------------------------------------------------------------
// V_dma's layer.
// ---------------------------------------------------------------------------

struct StreamArgs {
  const float* x;               // (B, dm)
  const uint4* w_in;            // (n_in, dm) bf16, as 16-byte words
  const uint4* w_out;           // (dm, di) bf16
  const __nv_bfloat16* w_in_h;  // the same, as bf16 elements
  const __nv_bfloat16* w_out_h;
  float* conv;                  // n_conv floats, in place
  float4* ssm;                  // n_ssm / 4 float4, in place
  float* x_out;                 // (B, dm)
  unsigned int* sink;           // XOR of every 32-bit weight word, or null
  long long n_in4, n_out4;      // 16-byte words of w_in and w_out
  int B, dm, n_in, di, n_conv, n_ssm4;
  float keep;
};

__device__ __forceinline__ unsigned int xor4(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

__global__ void __launch_bounds__(kThreads) ablate_stream_kernel(StreamArgs a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = a.n_in4 + a.n_out4;
  unsigned int acc = 0u;
  for (long long base = t0; base < total; base += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      v[u] = i < a.n_in4 ? __ldg(a.w_in + i) : i < total ? __ldg(a.w_out + (i - a.n_in4)) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc ^= xor4(v[u]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (a.sink != nullptr && threadIdx.x % 32 == 0) atomicXor(a.sink, acc);

  for (long long i = t0; i < a.n_ssm4; i += stride) {
    float4 s = a.ssm[i];
    s.x *= a.keep; s.y *= a.keep; s.z *= a.keep; s.w *= a.keep;
    a.ssm[i] = s;
  }
  for (long long i = t0; i < a.n_conv; i += stride) a.conv[i] *= a.keep;
  for (long long i = t0; i < (long long)a.B * a.dm; i += stride) {
    const int r = (int)(i / a.dm), c = (int)(i % a.dm);
    const float t1 = __bfloat162float(a.w_in_h[(size_t)c * a.dm + r]);
    const float t2 = __bfloat162float(a.w_out_h[(size_t)c * a.di + r]);
    a.x_out[i] = a.x[i] + t1 * 1e-6f + t2 * 1e-6f;
  }
}

// ---------------------------------------------------------------------------
// V_nossd's mixer.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ablate_nossd_kernel(const float* __restrict__ zx,
                                                                const float* __restrict__ d_h, float4* ssm,
                                                                float* __restrict__ g, int B, int nz, int di, int P,
                                                                int n_ssm4, float scale) {
  const int stride = gridDim.x * kThreads;
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  for (int i = t0; i < n_ssm4; i += stride) {
    float4 s = ssm[i];
    s.x *= scale; s.y *= scale; s.z *= scale; s.w *= scale;
    ssm[i] = s;
  }
  for (int i = t0; i < B * di; i += stride) {
    const int b = i / di, c = i % di;
    const float z = zx[(size_t)b * nz + c];
    const float y = zx[(size_t)b * nz + di + c] * __ldg(d_h + c / P);
    g[i] = y * (z * sigmoidf_(z));
  }
}

int grid_for(long long items, int cap) {
  const long long want = (items + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

}  // namespace

// out0 (R, split) and out1 (R, N - split) = x . W^T for W (N, K) bf16,
// K-contiguous: columns [0, split) go to out0, the rest to out1 (null when
// split == N). One launch; the two column ranges share the grid in
// proportion, at most 4 blocks an SM as in kernel B.
MG_EXPORT int mg_ablate_gemv(const float* x, const void* w, float* out0, float* out1, int R, int K, int N, int split,
                             void* stream) {
  if (!gemv_shape_ok(R, K, N, kBf16) || split < 1 || split > N || (split < N && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  GemvArgs a0 = {}, a1 = {};
  a0.x = x; a0.w = w; a0.out = out0; a0.R = R; a0.K = K; a0.N = split;
  a1 = a0;
  a1.w = static_cast<const __nv_bfloat16*>(w) + (size_t)split * K; a1.out = out1; a1.N = N - split;
  const int cap = 4 * mg_sm_count();
  const int want0 = (split + WARPS - 1) / WARPS, want1 = (N - split + WARPS - 1) / WARPS;
  int teams0 = want0, teams1 = want1;
  if (want0 + want1 > cap) {
    teams0 = (int)((long long)cap * split / N);
    teams0 = teams0 < 1 ? 1 : teams0;
    teams1 = want1 > 0 ? (cap - teams0 > 1 ? cap - teams0 : 1) : 0;
  }
  ablate_gemv_kernel<<<teams0 + teams1, TEAM, 0, (cudaStream_t)stream>>>(a0, a1, teams0);
  return (int)cudaGetLastError();
}

// V_dma's layer: reads every byte of w_in (n_in, dm) and w_out (dm, di),
// scales the states by `keep` in place, and writes
// x_out = x + 1e-6 w_in[c, r] + 1e-6 w_out[c, r]. sink: null, or a u32 the
// XOR of the weights' 32-bit words is XORed into.
MG_EXPORT int mg_ablate_stream(const float* x, const void* w_in, const void* w_out, float* conv, float* ssm,
                               float* x_out, int B, int dm, int n_in, int di, int n_conv, int n_ssm, float keep,
                               unsigned int* sink, void* stream) {
  const long long in_bytes = 2LL * n_in * dm, out_bytes = 2LL * dm * di;
  if (B < 1 || dm < B || n_in < dm || di < B || in_bytes % 16 != 0 || out_bytes % 16 != 0 || n_ssm % 4 != 0 ||
      n_conv < 0 || ((reinterpret_cast<uintptr_t>(w_in) | reinterpret_cast<uintptr_t>(w_out) |
                      reinterpret_cast<uintptr_t>(ssm)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  StreamArgs a = {};
  a.x = x;
  a.w_in = static_cast<const uint4*>(w_in); a.w_out = static_cast<const uint4*>(w_out);
  a.w_in_h = static_cast<const __nv_bfloat16*>(w_in); a.w_out_h = static_cast<const __nv_bfloat16*>(w_out);
  a.conv = conv; a.ssm = reinterpret_cast<float4*>(ssm); a.x_out = x_out; a.sink = sink;
  a.n_in4 = in_bytes / 16; a.n_out4 = out_bytes / 16;
  a.B = B; a.dm = dm; a.n_in = n_in; a.di = di; a.n_conv = n_conv; a.n_ssm4 = n_ssm / 4; a.keep = keep;
  const int grid = grid_for((a.n_in4 + a.n_out4 + kUnroll - 1) / kUnroll, 16 * mg_sm_count());
  ablate_stream_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// V_nossd's mixer: g (B, di) = zx[:, di:2di] * d_h[c / P] * silu(zx[:, :di]),
// ssm (n_ssm floats) *= scale in place.
MG_EXPORT int mg_ablate_nossd(const float* zx, const float* d_h, float* ssm, float* g, int B, int nz, int di, int P,
                              int n_ssm, float scale, void* stream) {
  if (B < 1 || P < 1 || di % P != 0 || nz < 2 * di || n_ssm % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(ssm) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int items = n_ssm / 4 > B * di ? n_ssm / 4 : B * di;
  ablate_nossd_kernel<<<grid_for(items, 16 * mg_sm_count()), kThreads, 0, (cudaStream_t)stream>>>(
      zx, d_h, reinterpret_cast<float4*>(ssm), g, B, nz, di, P, n_ssm / 4, scale);
  return (int)cudaGetLastError();
}
