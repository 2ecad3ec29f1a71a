// Shared helpers for the port's hand-written Hopper kernels.
//
// Every exported entry point has a plain C signature (raw device pointers,
// ints, the CUDA stream as void*) so that Python binds it with ctypes, and
// returns the cudaError_t of the launch (cudaGetLastError right after it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MG_EXPORT extern "C" __attribute__((visibility("default")))

// Round an f32 activation to bf16 (round-to-nearest-even, as jnp.astype)
// and back: the decode products take bf16 operands with f32 accumulation.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two bf16 values packed in one 32-bit word (little-endian: low half first).
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// jax.nn.gelu(v, approximate=True), torch's gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanhf_(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
}

// jax.nn.softplus(v) == logaddexp(v, 0), in its overflow-safe form.
__device__ __forceinline__ float softplusf_(float v) { return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); }

// The tensor-core and shared-memory primitives of the mma.sync kernels
// (flash_relpos.cu, flash_relpos_bwd.cu, tdecode_attn.cu).

// c += a.b on one m16n8k16 tile: bf16 operands in their mma fragments, f32 sums.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until every copy this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Thread-block clusters (kernels B's tail and H): this block's rank, the
// cluster barrier whole or split (an arrive and a wait), and the address of
// `p` (this block's shared memory) in rank `rank`'s.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// A store into another block's shared memory (an address from peer_addr).
__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Two f32 values rounded to bf16 (round to nearest even), packed low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Programmatic dependent launch (Hopper). A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization (mg_launch, dependent)
// may start before the launch ahead of it on the stream has ended: once
// every block of that launch has run grid_dep_trigger, or exited.
// grid_dep_wait returns when that launch has ended and its writes are
// visible; in a launch made without the attribute it returns at once. So a
// block may read before grid_dep_wait only what the launch ahead does not
// write. Kernel B's chain launches its mixer behind in_proj and out_proj
// behind the mixer this way (ops/decode_kernel.KERNEL_OPS).
__device__ __forceinline__ void grid_dep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void grid_dep_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// Launch `kernel` on `stream`, as a programmatic dependent of the launch
// ahead of it where `dependent`; returns the cudaError_t of the launch.
template <typename... Params, typename... Args>
cudaError_t mg_launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, void* stream, bool dependent,
                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Streaming multiprocessors of the current device, read once per process.
inline int mg_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}
