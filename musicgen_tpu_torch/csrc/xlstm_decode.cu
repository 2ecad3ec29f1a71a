// Kernel G: the one-token decode step of the whole xLSTM stack, as a chain of
// launches on one stream (ops/xdecode_kernel.py chains them).
//
// Replaces musicgen_tpu/ops/pallas_xlstm_decode.py `_xlstm_kernel` (via
// `fused_xlstm_logits_step` and `fused_xlstm_sample_step`): its mLSTM block
// (`_mlstm_block_math` :208) and sLSTM block (`_slstm_block_math` :321), in
// its three formats: bf16 weights, W8A16 weights (`_w8dot`), and the mLSTM
// matrix memory stored in bf16 (`-sb16`; f32 math). The head and the sampler
// tail are kernel B's launches (mg_lm_head_ln, mg_sample_tail).
//
// Per mLSTM block (x is the (B, d) f32 residual stream):
//   mg_x_gemv LN+store       up = W_up LN(x)                       [x_m | z]
//   mg_xm_prep               conv step + silu -> x_c; q, k = blockwise(x_c),
//                            v = blockwise(x_m)
//   mg_xm_gates              i, f = W_gate [q | k | v] + b in f32; m, f', i';
//                            n = f' n + i' k / sqrt(DK); denom = max(|q.n|, e^-m)
//   mg_xm_memory             S = f' S + (i' k / sqrt(DK)) v^T;  h = q.S / denom
//   mg_xm_out                headnorm(h) * outnorm + skip * x_c, * silu(z)
//   mg_x_gemv plain+residual x += W_down y
// Per sLSTM block:
//   mg_xs_prep               xn = LN(x); conv step + silu -> x_c
//   mg_x_gemv (twice)        W_if x_c -> [i | f];  W_zo xn -> [z | o]
//   mg_xs_cell               bf16(h) . R_h (bf16), exp-gated cell, group norm,
//                            x += gn(h) * gn_scale
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
// f32, 59 MB in bf16); a few FMAs per byte. Design: the GEMVs are kernel B's
// (decode_ops.cuh gemv_team: tiles of 16 columns on the tensor cores, bf16
// or W8A16 weights, x staged once a team; all rows on one weight read);
// mg_xm_memory reads each S element once and writes it
// once (a warp per 32 columns of one (b, h), 8 warps splitting the 512 rows,
// the readout reduced across warps in shared memory); the small launches are
// elementwise or one block per (b, h). 68 launches a token with the tail:
// the host paces the chain (a CUDA graph of the step and fewer, fused
// launches are later work).
#include <math.h>

#include "decode_ops.cuh"

using namespace mg;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDk = 1024;  // mLSTM head width the memory kernel stages
constexpr int kMaxDh = 256;   // sLSTM head width (one thread per gate column)

// Sum over the block (blockDim.x a multiple of 32, at most 1024 threads).
__device__ float block_sum_all(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

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
  const int b = idx / nb, n = idx % nb;
  const float* xm = up + (size_t)b * 2 * di + 4 * n;
  float* cs = conv_state + (size_t)b * 3 * di;
  float xmv[4], xc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * n + j;
    xmv[j] = xm[j];
    const float s0 = cs[c], s1 = cs[di + c], s2 = cs[2 * di + c];
    const float y = s0 * __ldg(conv_w + c) + s1 * __ldg(conv_w + di + c) + s2 * __ldg(conv_w + 2 * di + c) +
                    xmv[j] * __ldg(conv_w + 3 * di + c) + __ldg(conv_b + c);
    cs[c] = s1;
    cs[di + c] = s2;
    cs[2 * di + c] = xmv[j];
    xc[j] = y * sigmoidf_(y);
  }
  float* row = buf + (size_t)b * 4 * di;
#pragma unroll
  for (int p = 0; p < 3; ++p) {  // q, k from x_c; v from x_m; W[p, n, j, i] (out j, in i)
    const float* w = qkv_w + ((size_t)p * nb + n) * 16;
    const float* src = p < 2 ? xc : xmv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = fmaf(src[i], __ldg(w + 4 * j + i), acc);
      row[(size_t)p * di + 4 * n + j] = acc;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) row[3 * (size_t)di + 4 * n + j] = xc[j];
}

// One block per (b, h): the f32 gate products, the stabilised gates, the
// normalizer update and the readout's denominator. sc (B, H, 4) =
// (f', i', denom, unused).
__global__ void __launch_bounds__(kThreads) xm_gates_kernel(const float* __restrict__ buf,
                                                            const float* __restrict__ w_gate,
                                                            const float* __restrict__ gate_b, float* __restrict__ n_st,
                                                            float* __restrict__ m_st, float* __restrict__ sc, int H,
                                                            int di) {
  __shared__ float red[32];
  __shared__ float gates[2];
  const int b = blockIdx.x / H, h = blockIdx.x % H, DK = di / H;
  const float* gin = buf + (size_t)b * 4 * di;  // [q | k | v], 3 di
  const float* wi = w_gate + (size_t)h * 3 * di;
  const float* wf = w_gate + (size_t)(H + h) * 3 * di;
  float si = 0.f, sf = 0.f;
  for (int c = threadIdx.x; c < 3 * di; c += blockDim.x) {
    const float g = gin[c];
    si = fmaf(g, __ldg(wi + c), si);
    sf = fmaf(g, __ldg(wf + c), sf);
  }
  si = block_sum_all(si, red);
  sf = block_sum_all(sf, red);
  if (threadIdx.x == 0) {
    gates[0] = si + __ldg(gate_b + h);
    gates[1] = sf + __ldg(gate_b + H + h);
  }
  __syncthreads();
  const float i_pre = gates[0], f_pre = gates[1];
  const float log_f = -softplusf_(-f_pre);  // jax.nn.log_sigmoid
  const float m_prev = m_st[b * H + h];
  const float m_new = fmaxf(log_f + m_prev, i_pre);
  const float f_act = expf(log_f + m_prev - m_new);
  const float i_act = expf(i_pre - m_new);
  const float rs = 1.0f / sqrtf((float)DK);
  float* n = n_st + ((size_t)b * H + h) * DK;
  const float* q = gin + (size_t)h * DK;
  const float* k = gin + di + (size_t)h * DK;
  float qn = 0.f;
  for (int kk = threadIdx.x; kk < DK; kk += blockDim.x) {
    const float nv = f_act * n[kk] + i_act * (k[kk] * rs);
    n[kk] = nv;
    qn = fmaf(q[kk], nv, qn);
  }
  qn = block_sum_all(qn, red);
  if (threadIdx.x == 0) {
    m_st[b * H + h] = m_new;
    float* o = sc + ((size_t)b * H + h) * 4;
    o[0] = f_act;
    o[1] = i_act;
    o[2] = fmaxf(fabsf(qn), expf(-m_new));
    o[3] = 0.f;
  }
}

__device__ __forceinline__ float load_s(const float* s, size_t i) { return s[i]; }
__device__ __forceinline__ float load_s(const __nv_bfloat16* s, size_t i) { return __bfloat162float(s[i]); }
__device__ __forceinline__ void store_s(float* s, size_t i, float v) { s[i] = v; }
__device__ __forceinline__ void store_s(__nv_bfloat16* s, size_t i, float v) { s[i] = __float2bfloat16_rn(v); }

// Grid (B * H, DV / 32), 8 warps: warp w walks rows kk of its eighth of DK
// for the block's 32 columns; every S element is read once and written once.
template <typename S>
__global__ void __launch_bounds__(kThreads) xm_memory_kernel(const float* __restrict__ buf,
                                                             const float* __restrict__ sc, S* __restrict__ s_st,
                                                             float* __restrict__ h_att, int H, int di) {
  __shared__ float q_s[kMaxDk], ik_s[kMaxDk];
  __shared__ float red[WARPS][32];
  const int b = blockIdx.x / H, h = blockIdx.x % H, DK = di / H, DV = DK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int vv = blockIdx.y * 32 + lane;
  const float* row = buf + (size_t)b * 4 * di;
  const float* g = sc + ((size_t)b * H + h) * 4;
  const float f_act = g[0], i_act = g[1], denom = g[2];
  const float rs = 1.0f / sqrtf((float)DK);
  for (int kk = threadIdx.x; kk < DK; kk += blockDim.x) {
    q_s[kk] = row[(size_t)h * DK + kk];
    ik_s[kk] = i_act * (row[di + (size_t)h * DK + kk] * rs);
  }
  __syncthreads();
  const float v = row[2 * (size_t)di + (size_t)h * DV + vv];
  S* s = s_st + ((size_t)b * H + h) * DK * DV + vv;
  const int rows = DK / WARPS, k0 = warp * rows;
  float acc = 0.f;
#pragma unroll 4
  for (int kk = k0; kk < k0 + rows; ++kk) {
    const float sn = load_s(s, (size_t)kk * DV) * f_act + ik_s[kk] * v;
    store_s(s, (size_t)kk * DV, sn);
    acc = fmaf(q_s[kk], sn, acc);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    h_att[(size_t)b * di + (size_t)h * DV + vv] = t / denom;
  }
}

// One block per (b, h): y = (headnorm(h) * outnorm + skip * x_c) * silu(z).
__global__ void __launch_bounds__(kThreads) xm_out_kernel(const float* __restrict__ h_att,
                                                          const float* __restrict__ buf, const float* __restrict__ up,
                                                          const float* __restrict__ outnorm,
                                                          const float* __restrict__ skip, float* __restrict__ y,
                                                          int H, int di, float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x / H, h = blockIdx.x % H, DV = di / H;
  const float* hr = h_att + (size_t)b * di + (size_t)h * DV;
  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < DV; e += blockDim.x) {
    const float v = hr[e];
    s1 += v;
    s2 += v * v;
  }
  s1 = block_sum_all(s1, red);
  s2 = block_sum_all(s2, red);
  const float mean = s1 / DV, var = s2 / DV - mean * mean;
  const float inv = 1.f / sqrtf(var + eps);
  for (int e = threadIdx.x; e < DV; e += blockDim.x) {
    const int c = h * DV + e;
    const float hn = (hr[e] - mean) * inv * __ldg(outnorm + c) + __ldg(skip + c) * buf[((size_t)b * 4 + 3) * di + c];
    const float z = up[(size_t)b * 2 * di + di + c];
    y[(size_t)b * di + c] = hn * (z * sigmoidf_(z));
  }
}

// ---------------------------------------------------------------------------
// sLSTM
// ---------------------------------------------------------------------------

// One block per row: xn = LN(x) (eps, E[x^2] - mean^2), then the conv step on
// xn and silu. xs (2, B, d) = [x_c; xn].
__global__ void __launch_bounds__(kThreads) xs_prep_kernel(const float* __restrict__ x, const float* __restrict__ ln,
                                                           const float* __restrict__ conv_w,
                                                           const float* __restrict__ conv_b,
                                                           float* __restrict__ conv_state, float* __restrict__ xs, int d,
                                                           float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * d;
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float v = xr[c];
    s1 += v;
    s2 += v * v;
  }
  s1 = block_sum_all(s1, red);
  s2 = block_sum_all(s2, red);
  const float mean = s1 / d, inv = 1.f / sqrtf(s2 / d - mean * mean + eps);
  float* cs = conv_state + (size_t)b * 3 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float xn = (xr[c] - mean) * inv * __ldg(ln + c) + __ldg(ln + d + c);
    const float s0 = cs[c], s1c = cs[d + c], s2c = cs[2 * d + c];
    const float y = s0 * __ldg(conv_w + c) + s1c * __ldg(conv_w + d + c) + s2c * __ldg(conv_w + 2 * d + c) +
                    xn * __ldg(conv_w + 3 * d + c) + __ldg(conv_b + c);
    cs[c] = s1c;
    cs[d + c] = s2c;
    cs[2 * d + c] = xn;
    xs[(size_t)b * d + c] = y * sigmoidf_(y);
    xs[((size_t)gridDim.x + b) * d + c] = xn;
  }
}

// One block per (b, h), one thread per gate column j = g * DH + e: the
// recurrent term bf16(h_prev) . R_h[:, j] (bf16 weights, f32 sums), the
// exp-gated cell, the head's group norm and the residual. State hcnm
// (4, B, H, DH) in place; x (B, d) += gn(h) * gn_scale.
__global__ void __launch_bounds__(4 * kMaxDh) xs_cell_kernel(
    const float* __restrict__ wif, const float* __restrict__ wzo, const __nv_bfloat16* __restrict__ r_w,
    const float* __restrict__ bias, const float* __restrict__ gn, float* __restrict__ hcnm, float* __restrict__ x,
    int B, int H, int DH, float eps) {
  __shared__ float hb[kMaxDh];
  __shared__ float pre[4 * kMaxDh];
  __shared__ float red[32];
  const int b = blockIdx.x / H, h = blockIdx.x % H, d = H * DH;
  const int j = threadIdx.x, g = j / DH, e = j % DH;
  const size_t plane = (size_t)B * H * DH, off = ((size_t)b * H + h) * DH;
  if (j < DH) hb[j] = bf16_round(hcnm[off + j]);
  __syncthreads();
  {
    const __nv_bfloat16* rc = r_w + (size_t)h * DH * 4 * DH + j;  // R_h[:, j], stride 4 DH
    float acc = 0.f;
    for (int dd = 0; dd < DH; ++dd) acc = fmaf(hb[dd], __bfloat162float(rc[(size_t)dd * 4 * DH]), acc);
    const int c = h * DH + e;
    const float wxv = g < 2 ? wif[(size_t)b * 2 * d + (size_t)g * d + c] : wzo[(size_t)b * 2 * d + (size_t)(g - 2) * d + c];
    pre[j] = (wxv + acc) + __ldg(bias + (size_t)g * d + c);
  }
  __syncthreads();
  float hv = 0.f;
  if (j < DH) {
    const float ip = pre[j], fp = pre[DH + j], zp = pre[2 * DH + j], op = pre[3 * DH + j];
    const float m_prev = hcnm[3 * plane + off + j];
    const float m_new = fmaxf(fp + m_prev, ip);
    const float i_act = expf(ip - m_new);
    const float f_act = expf(fp + m_prev - m_new);
    const float c = f_act * hcnm[plane + off + j] + i_act * tanhf(zp);
    const float n = f_act * hcnm[2 * plane + off + j] + i_act;
    hv = sigmoidf_(op) * c / n;
    hcnm[off + j] = hv;
    hcnm[plane + off + j] = c;
    hcnm[2 * plane + off + j] = n;
    hcnm[3 * plane + off + j] = m_new;
  }
  const float s1 = block_sum_all(j < DH ? hv : 0.f, red);
  const float s2 = block_sum_all(j < DH ? hv * hv : 0.f, red);
  if (j < DH) {
    const float mean = s1 / DH, inv = 1.f / sqrtf(s2 / DH - mean * mean + eps);
    const int c = h * DH + j;
    x[(size_t)b * d + c] = x[(size_t)b * d + c] + (hv - mean) * inv * __ldg(gn + c);
  }
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
  if (B < 1 || H < 1 || di % H != 0) return (int)cudaErrorInvalidValue;
  xm_gates_kernel<<<B * H, kThreads, 0, (cudaStream_t)stream>>>(buf, w_gate, gate_b, n_st, m_st, sc, H, di);
  return (int)cudaGetLastError();
}

// s_bf16: 0 for an f32 matrix memory, 1 for bf16 storage (-sb16).
MG_EXPORT int mg_xm_memory(const float* buf, const float* sc, void* s_st, float* h_att, int B, int H, int di,
                           int s_bf16, void* stream) {
  if (B < 1 || H < 1 || di % H != 0) return (int)cudaErrorInvalidValue;
  const int DK = di / H;
  if (DK > kMaxDk || DK % 32 != 0 || DK % WARPS != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, DK / 32);
  if (s_bf16)
    xm_memory_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        buf, sc, static_cast<__nv_bfloat16*>(s_st), h_att, H, di);
  else
    xm_memory_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(buf, sc, static_cast<float*>(s_st), h_att,
                                                                         H, di);
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
  xs_prep_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(x, ln, conv_w, conv_b, conv_state, xs, d, eps);
  return (int)cudaGetLastError();
}

MG_EXPORT int mg_xs_cell(const float* wif, const float* wzo, const void* r_w, const float* bias, const float* gn,
                         float* hcnm, float* x, int B, int H, int DH, float eps, void* stream) {
  if (B < 1 || H < 1 || DH < 1 || DH > kMaxDh || (4 * DH) % 32 != 0) return (int)cudaErrorInvalidValue;
  xs_cell_kernel<<<B * H, 4 * DH, 0, (cudaStream_t)stream>>>(wif, wzo, static_cast<const __nv_bfloat16*>(r_w), bias,
                                                              gn, hcnm, x, B, H, DH, eps);
  return (int)cudaGetLastError();
}
