// Kernel B, sampler tail: grammar filter, repetition penalty and exact top-3
// over one row of logits per batch element.
//
// Replaces `_tail_math` inside musicgen_tpu/ops/pallas_decode.py
// `_decode_kernel` (the `tail_inputs` variant reached from
// `fused_sample_step`). Per row, over the real vocabulary ids < V:
//   lse  = logsumexp(logits)
//   w    = (lse - logits) * grammar[bucket]      (0 where the grammar is 0)
//   w   /= min(exp(hist * ln base), 1.2)         (base 1.01 pitch, 1.02 dyn)
//   top-3 of w, ties to the lowest index
// Pad ids in [V, Vp) get weight 0.
//
// What bounds it on an H100: latency, not bytes. A row is 17,920 floats of
// logits, 17,914 ints of counts and a grammar row (~215 KB per row, a 0.0001
// ms bound at batch 2); what takes the time is the chain of dependent steps:
// the loads, the row's maximum, its sum, the top-3. The first port ran a row
// on one 1024-thread block (2 of 132 SMs at batch 2) in seven sweeps of the
// row through shared memory with six block-wide reductions between them:
// 0.0109 ms in a CUDA graph on an H100 80GB HBM3 at 700 W.
//
// Design: one thread-block cluster of CS = 16 blocks of 4 warps a row
// (cudaLaunchKernelEx), each warp one of the row's 64 slices (decode_ops.cuh
// fixes the partition and every sum). Each lane loads its ids' logits,
// window counts and grammar values (at most 9 ids of each, all in flight at
// once) into registers, and the warp forms its slice's maximum and sum of
// exp(x - m_s) by shuffles: no block barrier. Each warp pushes its (m_s,
// s_s) into every rank's shared memory (st.shared::cluster) and one cluster
// barrier makes them visible, so every warp forms the row's lse itself,
// adding the slices in slice order. The weights are formed in registers and
// each lane keeps a sorted top-3 in one pass; a warp merges its lanes' lists
// by shuffles, and each warp leader pushes its list into rank 0, which after
// a second cluster barrier merges the row's 64 lists and writes vals and
// idx. Two cluster exchanges in place of six block reductions, one pass over
// the row in place of seven; no atomics, so the bits do not depend on the
// launch, and equal those of the resident kernel's tail, which runs the
// same per-slice functions spread over its teams.
#include "decode_ops.cuh"

using namespace mg;

namespace {

constexpr int kMaxRows = 8;         // batch rows (ops/decode_kernel.py MAX_ROWS)
constexpr int WPB = 4;              // warps (slices) a block
constexpr int CS = TAIL_S / WPB;    // blocks a cluster: one cluster a row

// grid (R x CS), cluster (CS, 1, 1), WPB x 32 threads: warp j of block
// `rank` of row blockIdx.x / CS holds slice rank x WPB + j.
__global__ void __launch_bounds__(WPB * 32) sample_tail_kernel(const float* logits, int Vp, int V, const float* gram,
                                                              const int* hist, const int64_t* bucket, int dyn_start,
                                                              int length_start, float* vals, int64_t* idx) {
  __shared__ float pair_m[TAIL_S], pair_s[TAIL_S];  // every slice's (m_s, s_s), pushed by its warp
  __shared__ Top3 tops[TAIL_S];                     // rank 0's: every slice's list
  cluster_arrive_relaxed();  // with the wait below: every block of the cluster has started
  const uint32_t rank = cluster_rank();
  const int row = blockIdx.x / CS, lane = threadIdx.x % 32;
  const int s = (int)rank * WPB + threadIdx.x / 32;
  TailSlice sl;
  tail_slice_load(sl, logits + (size_t)row * Vp, gram + (size_t)bucket[row] * Vp, hist + (size_t)row * V, Vp, V, s,
                  lane);

  // Exchange 1: the slice's (m_s, s_s) into every rank, then the row's lse.
  float ms, ss;
  tail_slice_pair(sl, ms, ss);
  cluster_wait();
  if (lane < CS) {
    st_peer(peer_addr(&pair_m[s], lane), ms);
    st_peer(peer_addr(&pair_s[s], lane), ss);
  }
  cluster_arrive();
  cluster_wait();
  const float lse = tail_lse(pair_m[lane], pair_s[lane], pair_m[lane + 32], pair_s[lane + 32]);

  // The weights and the slice's top-3 in one pass.
  Top3 top;
  tail_slice_top3(sl, V, lse, dyn_start, length_start, top);

  // Exchange 2: every slice's list into rank 0, which merges the row's.
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      st_peer(peer_addr(&tops[s].v[k], 0), top.v[k]);
      st_peer(peer_addr(&tops[s].i[k], 0), top.i[k]);
    }
  }
  cluster_arrive();  // the other ranks leave: nothing reads their shared memory any more
  if (rank != 0) return;
  cluster_wait();
  if (threadIdx.x < 32) {
    top3_rows(top, tops[lane], tops[lane + 32]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        vals[row * 3 + k] = top.v[k];
        idx[row * 3 + k] = top.i[k];
      }
    }
  }
}

}  // namespace

// vals (R, 3) and idx (R, 3) of the rows of logits (R, Vp), one cluster of
// CS blocks a row (ops/decode_kernel.tail_geometry). A row the slices do not
// cover (decode_ops.cuh tail_shape_ok) is refused.
MG_EXPORT int mg_sample_tail(const float* logits, int R, int Vp, int V, const float* gram,
                             const int* hist, const int64_t* bucket, int dyn_start,
                             int length_start, float* vals, int64_t* idx, void* stream) {
  if (R < 1 || R > kMaxRows || !tail_shape_ok(Vp, V)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(sample_tail_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * CS);
  cfg.blockDim = dim3(WPB * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, sample_tail_kernel, logits, Vp, V, gram, hist, bucket, dyn_start, length_start, vals,
                         idx);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
