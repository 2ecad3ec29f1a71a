// Signals between the stages of a persistent kernel, shared by the resident
// Mamba loop (kernel C, generate_resident.cu) and the one-launch xLSTM step
// (kernel G, xlstm_step.cu). A stage's teams each add their item count to
// the stage's counter after their last store (team_signal: a team barrier,
// then one release-add); a team that reads the stage waits until the
// counter reaches the stage's item count (team_wait: one thread spins on
// relaxed loads, then one acquire fence, then the team barrier). No grid
// barrier and no float atomic.
#pragma once

#include "decode_ops.cuh"

namespace mg {

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A 64-bit word written and read whole at GPU scope, with no fence: a value
// that carries its own tag (the resident kernel's tail exchange), so a
// reader that sees the tag sees the value.
__device__ __forceinline__ void st_relaxed_u64(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
// An integer add that returns nothing (exact, so its order does not matter).
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_relaxed_u64(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread waits until a stage's counter reaches target (relaxed reads,
// then one acquire fence: the acquire pattern); then the team's (or
// block's) barrier orders every thread's later reads after the producers'
// writes.
__device__ __forceinline__ void spin_until(const int* ctr, int target) {
  while (ld_relaxed(ctr) < target) {
  }
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void team_wait(const int* ctr, int target, int tid, int bar) {
  if (tid == 0) spin_until(ctr, target);
  team_sync(bar);
}

// After the team's last store of a stage: every thread's writes, then one
// release-add of the team's item count.
__device__ __forceinline__ void team_signal(int* ctr, int n, int tid, int bar) {
  team_sync(bar);
  if (tid == 0) red_release_add(ctr, n);
}

// Named barrier `id` of `count` threads: arrive without waiting, or wait.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// An L2 prefetch hint of [p, p + bytes), cut inward to whole 16-byte units.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const uintptr_t lo = (reinterpret_cast<uintptr_t>(p) + 15) & ~(uintptr_t)15;
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(p) + bytes) & ~(uintptr_t)15;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(lo), "r"((uint32_t)(hi - lo)) : "memory");
}

}  // namespace mg
