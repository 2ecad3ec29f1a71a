// Kernel G as a chain of launches, one a stage: the per-stage form of the
// xLSTM decode step (ops/xdecode_kernel.py KERNEL_OPS chains them). The
// one-launch step (xlstm_step.cu) runs the same items and is what generation
// takes on the card; this chain is its oracle, held launch by launch to the
// plain versions (chip_smoke.py [9 xdecode <stage>]) and bit for bit to the
// step ([9 xstep]).
//
// Replaces musicgen_tpu/ops/pallas_xlstm_decode.py `_xlstm_kernel` (via
// `fused_xlstm_logits_step` and `fused_xlstm_sample_step`): its mLSTM block
// (`_mlstm_block_math` :208) and sLSTM block (`_slstm_block_math` :321), in
// its formats: bf16 weights, W8A16 weights (`_w8dot`), and the mLSTM matrix
// memory stored in bf16 (`-sb16`; f32 math). The head and the sampler tail
// are kernel B's launches (mg_lm_head_ln, mg_sample_tail).
//
// Per mLSTM block (x is the (B, d) f32 residual stream), each launch a grid
// of xlstm_ops.cuh items:
//   mg_x_gemv LN+store       up = W_up LN(x)                       [x_m | z]
//   mg_xm_prep               conv step + silu -> x_c; q, k = blockwise(x_c),
//                            v = blockwise(x_m)                (a thread each)
//   mg_xm_gates              one block a (b, h): i, f = W_gate [q | k | v] + b
//                            in f32 (16-channel partials added in order); m,
//                            f', i'; n = f' n + i' k / sqrt(DK);
//                            denom = max(|q.n|, e^-m)
//   mg_xm_memory             one block a (b, h, 16 rows): S = f' S +
//                            (i' k / sqrt(DK)) v^T and the rows' readout
//                            partials; the last block of a (b, h) (ticket)
//                            adds them in order: h = q.S / denom
//   mg_xm_out                headnorm(h) * outnorm + skip * x_c, * silu(z)
//   mg_x_gemv plain+residual x += W_down y
// Per sLSTM block:
//   mg_xs_prep               one block a (row, 128 columns): xn = LN(x);
//                            conv step + silu -> x_c
//   mg_x_gemv (twice)        W_if x_c -> [i | f];  W_zo xn -> [z | o]
//   mg_xs_cell               one block a (head, 16 units): bf16(h) . R_h
//                            (bf16, both rows on one read), the exp-gated
//                            cell; the last block of a head (ticket): group
//                            norm, x += gn(h) * gn_scale
//   mg_x_gemv LN+bias+gelu   u = gelu(W_up LN(x) + b)  (pad lanes stay 0)
//   mg_x_gemv bias+residual  x += W_down u + b
//
// Every rounding point of the TPU kernel is kept: bf16 activations into the
// big products (f32 sums), the gate products in f32, bf16 h times bf16 R in
// the sLSTM recurrence, and S rounded to bf16 only at its store under -sb16
// (the readout q.S uses the f32 update). The TPU kernel's rank-2 Mosaic
// layouts (S2[h*DK+kk, b*DV+vv], eye(B) and one-hot contractions, m in nm's
// pad lanes, the 7-band lane-shift form of the blocksize-4 products) are
// layout, not math: here the state is (B, H, DK, DV) row-major and the
// blocksize-4 products are direct 4 x 4 block products.
//
// What bounds it on an H100: bytes. At batch 2 a token reads about 190 MB of
// bf16 weights and reads and writes the 7 mLSTM matrix memories (117 MB in
// f32, 59 MB in bf16); a few FMAs per byte. The GEMVs are kernel B's
// (decode_ops.cuh gemv_team: tiles of 16 columns on the tensor cores, bf16
// or W8A16 weights, x staged once a team); the other stages are spread over
// many blocks, each thread keeping several loads in flight. 68 launches a
// token with the head and the tail; the host paces them.
#include <math.h>

#include "xlstm_ops.cuh"

using namespace mg;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 512;  // gate chunks of the gates kernel: di <= 8192

// ---------------------------------------------------------------------------
// The GEMVs
// ---------------------------------------------------------------------------

template <int PRO, int EPI, int FMT>
__global__ void __launch_bounds__(TEAM, 4) x_gemv_kernel(GemvArgs a) {
  extern __shared__ uint4 gemv_dyn[];
  __shared__ GemvSmem sm;
  gemv_team<PRO, EPI, FMT>(a, sm, blockIdx.x, gridDim.x, threadIdx.x, 1, reinterpret_cast<char*>(gemv_dyn));
}

template <int PRO, int EPI>
int x_gemv_launch(const GemvArgs& a, int fmt, void* stream) {
  if (fmt == kBf16) return gemv_launch(x_gemv_kernel<PRO, EPI, kBf16>, a, fmt, stream);
  return gemv_launch(x_gemv_kernel<PRO, EPI, kW8A16>, a, fmt, stream);
}

// ---------------------------------------------------------------------------
// mLSTM
// ---------------------------------------------------------------------------

// One thread per (row b, 4-channel block n). buf (B, 4, di) = [q | k | v | x_c].
__global__ void xm_prep_kernel(const float* __restrict__ up, const float* __restrict__ conv_w,
                               const float* __restrict__ conv_b, float* __restrict__ conv_state,
                               const float* __restrict__ qkv_w, float* __restrict__ buf, int B, int di) {
  const int nb = di / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * nb) return;
  xm_prep_group(up, conv_w, conv_b, conv_state, qkv_w, buf, di, idx / nb, idx % nb);
}

// One block per (b, h): the gate partials of every 16-channel chunk, added
// in chunk order; the stabilised gates, the normalizer update and the
// readout's denominator. sc (B, H, 4) = (f', i', denom, 0).
__global__ void __launch_bounds__(TEAM) xm_gates_kernel(const float* __restrict__ buf,
                                                        const float* __restrict__ w_gate,
                                                        const float* __restrict__ gate_b, float* __restrict__ n_st,
                                                        float* __restrict__ m_st, float* __restrict__ sc, int H,
                                                        int di) {
  __shared__ __align__(16) float part[2 * kMaxChunks];
  __shared__ float red[WARPS];
  __shared__ float act[3];
  const int b = blockIdx.x / H, h = blockIdx.x % H, nch = di / XM_CHUNK, tid = threadIdx.x;
  for (int i = tid; i < 2 * nch; i += TEAM) part[i] = xm_gate_partial(buf, w_gate, di, b, i < nch ? h : H + h, i % nch);
  __syncthreads();
  if (tid < 32) xm_gates_warp(part, part + nch, nch, gate_b, m_st[b * H + h], H, h, tid, act);
  __syncthreads();
  const float denom = xm_norm_denom(buf, n_st, act[0], act[1], act[2], b, h, H, di, tid, 0, red);
  if (tid == 0) {
    m_st[b * H + h] = act[2];
    float* o = sc + ((size_t)b * H + h) * 4;
    o[0] = act[0];
    o[1] = act[1];
    o[2] = denom;
    o[3] = 0.f;
  }
}

// A block of tickets per (b, h) or head: the block that draws the last
// ticket of its group (an acquire-release atomic after the block's barrier)
// runs the group's combine and resets the ticket, so the next launch and a
// CUDA-graph replay start clean.
__device__ __forceinline__ bool last_of(unsigned* ticket, unsigned n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned drawn;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(drawn) : "l"(ticket) : "memory");
    last = drawn == n - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  return last;
}

// One block per (b, h, row chunk): xm_memory_rows; the last block of a
// (b, h) adds the chunks' readout partials in order, over sc's denominator.
template <typename S>
__global__ void __launch_bounds__(TEAM) xm_memory_kernel(const float* __restrict__ buf, const float* __restrict__ sc,
                                                         S* __restrict__ s_st, float* __restrict__ mpart,
                                                         unsigned* __restrict__ tickets, float* __restrict__ h_att,
                                                         int H, int di) {
  __shared__ float red[XM_MAX_DK];  // rpp x DV <= XM_MAX_DK floats
  const int DK = di / H, nrc = DK / xm_rows_per_item(DK);
  const int bh = blockIdx.x / nrc, b = bh / H, h = bh % H;
  const float* g = sc + (size_t)bh * 4;
  xm_memory_rows<S>(buf, s_st, g, mpart, b, h, blockIdx.x % nrc, H, di, threadIdx.x, 0, red, NoPrelude());
  if (last_of(tickets + bh, (unsigned)nrc)) xm_head_readout(mpart, g[2], h_att, b, h, H, di, threadIdx.x);
}

// One block per (b, h): y = (headnorm(h) * outnorm + skip * x_c) * silu(z).
__global__ void __launch_bounds__(TEAM) xm_out_kernel(const float* __restrict__ h_att, const float* __restrict__ buf,
                                                      const float* __restrict__ up,
                                                      const float* __restrict__ outnorm,
                                                      const float* __restrict__ skip, float* __restrict__ y, int H,
                                                      int di, float eps) {
  __shared__ float red[WARPS];
  xm_out_item(h_att, buf, up, outnorm, skip, y, blockIdx.x / H, blockIdx.x % H, H, di, eps, threadIdx.x, 0, red);
}

// ---------------------------------------------------------------------------
// sLSTM
// ---------------------------------------------------------------------------

// One block per (row, 128 columns): xn = LN(x), the conv step on xn and
// silu. xs (2, B, d) = [x_c; xn].
__global__ void __launch_bounds__(TEAM) xs_prep_kernel(const float* __restrict__ x, const float* __restrict__ ln,
                                                       const float* __restrict__ conv_w,
                                                       const float* __restrict__ conv_b,
                                                       float* __restrict__ conv_state, float* __restrict__ xs, int B,
                                                       int d, float eps) {
  __shared__ double red64[2 * WARPS];
  const int nch = (d + XS_PREP_COLS - 1) / XS_PREP_COLS;
  xs_prep_item(x, ln, conv_w, conv_b, conv_state, xs, B, d, eps, blockIdx.x / nch, blockIdx.x % nch, threadIdx.x, 0,
               red64);
}

// One block per (head, XS_UNITS units): xs_cell_item; the last block of a
// head runs its group norm and residual for every row (xs_gn_item).
__global__ void __launch_bounds__(TEAM) xs_cell_kernel(const float* __restrict__ wif, const float* __restrict__ wzo,
                                                       const __nv_bfloat16* __restrict__ r_w,
                                                       const float* __restrict__ bias, const float* __restrict__ gn,
                                                       float* __restrict__ hcnm, float* __restrict__ hnew,
                                                       unsigned* __restrict__ tickets, float* __restrict__ x, int B,
                                                       int H, int DH, float eps) {
  extern __shared__ __align__(16) unsigned char cell_smem[];
  __shared__ float red[WARPS];
  const int groups = DH / XS_UNITS, h = blockIdx.x / groups;
  xs_cell_item(wif, wzo, r_w, bias, hcnm, hnew, B, H, DH, h, blockIdx.x % groups, threadIdx.x, 0,
               reinterpret_cast<char*>(cell_smem));
  if (last_of(tickets + h, (unsigned)groups))
    for (int b = 0; b < B; ++b) xs_gn_item(hnew, gn, hcnm, x, H, DH, eps, b, h, threadIdx.x, 0, red);
}

}  // namespace

// The xLSTM step's GEMVs: out = epi(pro(x) . W^T). pro: 0 plain, 2 LayerNorm
// (pw, pb, eps); epi: 0 store, 5 out += v + bias, 6 out += v, 7 gelu(v +
// bias). fmt 0 bf16 or 1 W8A16 (w_s (K / qgroup, N); qgroup 256, or K for
// one group; N % 16 == 0, see gemv_shape_ok_grouped).
MG_EXPORT int mg_x_gemv(const float* x, const float* pw, const float* pb, const void* w, const float* w_s,
                        const float* bias, float* out, int R, int K, int N, int qgroup, float eps, int pro, int epi,
                        int fmt, void* stream) {
  if ((fmt != kBf16 && fmt != kW8A16) || !gemv_shape_ok_grouped(R, K, N, fmt, qgroup)) return (int)cudaErrorInvalidValue;
  if (fmt != kBf16 && w_s == nullptr) return (int)cudaErrorInvalidValue;
  GemvArgs a = {};
  a.x = x; a.w = w; a.w_s = w_s; a.out = out;
  a.R = R; a.K = K; a.N = N; a.pw = pw; a.pb = pb; a.eps = eps; a.bias = bias;
  a.qgroup = fmt == kBf16 ? 0 : qgroup;
  if (pro == kLayerNorm && epi == kStore) return x_gemv_launch<kLayerNorm, kStore>(a, fmt, stream);
  if (pro == kLayerNorm && epi == kBiasGelu) return x_gemv_launch<kLayerNorm, kBiasGelu>(a, fmt, stream);
  if (pro == kPlain && epi == kStore) return x_gemv_launch<kPlain, kStore>(a, fmt, stream);
  if (pro == kPlain && epi == kResidual) return x_gemv_launch<kPlain, kResidual>(a, fmt, stream);
  if (pro == kPlain && epi == kBiasResidual) return x_gemv_launch<kPlain, kBiasResidual>(a, fmt, stream);
  return (int)cudaErrorInvalidValue;
}

MG_EXPORT int mg_xm_prep(const float* up, const float* conv_w, const float* conv_b, float* conv_state,
                         const float* qkv_w, float* buf, int B, int di, void* stream) {
  if (B < 1 || di % 4 != 0) return (int)cudaErrorInvalidValue;
  const int n = B * (di / 4);
  xm_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(up, conv_w, conv_b, conv_state,
                                                                                      qkv_w, buf, B, di);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_xm_gates(const float* buf, const float* w_gate, const float* gate_b, float* n_st, float* m_st,
                          float* sc, int B, int H, int di, void* stream) {
  if (B < 1 || H < 1 || di % H != 0 || di % (4 * XM_CHUNK) != 0 || di / XM_CHUNK > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  xm_gates_kernel<<<B * H, kThreads, 0, (cudaStream_t)stream>>>(buf, w_gate, gate_b, n_st, m_st, sc, H, di);
  return (int)cudaGetLastError();
}

// The shapes of the matrix memory's items (xlstm_ops.cuh xm_memory_rows).
static bool xm_memory_shape_ok(int H, int di) {
  return H >= 1 && di % H == 0 && xm_shape_ok(di / H);
}

// s_bf16: 0 for an f32 matrix memory, 1 for bf16 storage (-sb16). mpart:
// (B, H, nrc, DV) f32 scratch; tickets: B * H zeros (left zero).
MG_EXPORT int mg_xm_memory(const float* buf, const float* sc, void* s_st, float* mpart, void* tickets, float* h_att,
                           int B, int H, int di, int s_bf16, void* stream) {
  if (B < 1 || !xm_memory_shape_ok(H, di)) return (int)cudaErrorInvalidValue;
  const int DK = di / H, grid = B * H * (DK / xm_rows_per_item(DK));
  unsigned* t = static_cast<unsigned*>(tickets);
  if (s_bf16)
    xm_memory_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        buf, sc, static_cast<__nv_bfloat16*>(s_st), mpart, t, h_att, H, di);
  else
    xm_memory_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(buf, sc, static_cast<float*>(s_st), mpart, t,
                                                                         h_att, H, di);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_xm_out(const float* h_att, const float* buf, const float* up, const float* outnorm,
                        const float* skip, float* y, int B, int H, int di, float eps, void* stream) {
  if (B < 1 || H < 1 || di % H != 0) return (int)cudaErrorInvalidValue;
  xm_out_kernel<<<B * H, kThreads, 0, (cudaStream_t)stream>>>(h_att, buf, up, outnorm, skip, y, H, di, eps);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_xs_prep(const float* x, const float* ln, const float* conv_w, const float* conv_b, float* conv_state,
                         float* xs, int B, int d, float eps, void* stream) {
  if (B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int grid = B * ((d + XS_PREP_COLS - 1) / XS_PREP_COLS);
  xs_prep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, ln, conv_w, conv_b, conv_state, xs, B, d, eps);
  return (int)cudaGetLastError();
}

// hnew: (B, d) f32 scratch; tickets: H zeros (left zero).
MG_EXPORT int mg_xs_cell(const float* wif, const float* wzo, const void* r_w, const float* bias, const float* gn,
                         float* hcnm, float* hnew, void* tickets, float* x, int B, int H, int DH, float eps,
                         void* stream) {
  if (B < 1 || B > MAXR || H < 1 || DH < XS_UNITS || DH % XS_UNITS != 0 || DH > XS_MAX_DH)
    return (int)cudaErrorInvalidValue;
  const int smem = xs_cell_smem_bytes(B, DH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(xs_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  xs_cell_kernel<<<H * (DH / XS_UNITS), kThreads, smem, (cudaStream_t)stream>>>(
      wif, wzo, static_cast<const __nv_bfloat16*>(r_w), bias, gn, hcnm, hnew, static_cast<unsigned*>(tickets), x, B,
      H, DH, eps);
  return (int)cudaGetLastError();
}
