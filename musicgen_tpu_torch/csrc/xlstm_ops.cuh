// Device code of kernel G's stages, one work item a call, shared by the
// per-stage launch chain (xlstm_decode.cu) and the one-launch step
// (xlstm_step.cu). A chain launch is a grid of one stage's items; the step
// walks the same items over its persistent blocks, each stage waiting for
// the ones it reads. Every sum that crosses items is taken in a fixed order
// (by item index, then by thread), never by atomics, so the two paths
// compute the same bits on every call. The build passes -fmad=false, so a
// multiply-add is contracted the same way wherever a function is inlined.
//
// The items, for batch B, H heads, mLSTM inner width di (head width
// DK = DV = di / H) and sLSTM width d (head width DH = d / H):
//   xm_prep_group    one (row b, 4-channel block n) of the mLSTM conv step,
//                    silu and the blocksize-4 q, k, v (one thread); the step
//                    runs it in the up-projection tile's epilogue that owns
//                    the channels;
//   xm_gate_partial  the i / f gate product of one row over one chunk of 16
//                    channels of q, k and v (one thread, 48 terms in order);
//                    the step runs it in the same epilogue;
//   xm_chunk_sum     a gate's chunk partials (B, 2H, di / 16) added in a
//                    fixed order (a warp, one 16-byte load a lane);
//   xm_gate_act      the stabilised gates from the two sums;
//   xm_norm_denom    the normalizer n of one (b, h) and max(|q.n|, e^-m) (a team);
//   xm_head_out      the step's head item: the gates, xm_norm_denom, the
//                    readout and xm_out_item's output gate in one, the
//                    same arithmetic, its loads issued first (DK <= 512);
//                    xm_head_out_wide the same at DK up to 2,048, its
//                    partials read as they are added;
//   xm_memory_rows   RC rows of one (b, h)'s matrix memory S and their
//                    readout partial q.S over those rows (a team: 8 rows a
//                    thread in flight, 16-byte vectors; past DV 1,024 each
//                    thread holds XM_CQ column quads);
//   xm_head_readout  a head's readout: the row chunks' partials in order, / denom;
//   xm_out_item      head norm, skip and the silu(z) gate of one (b, h) (a team);
//   xs_prep_item     LayerNorm (f64 row sums, as the GEMV prologue's), conv
//                    step and silu of 128 columns of one row (a team);
//   xs_cell_item     the sLSTM recurrence of XS_UNITS units of one head, all
//                    four gates, both batch rows on one read of R (a team:
//                    up to DH = XS_TILE_DH the R tile staged by cp.async,
//                    past it R read from L2; each pre-activation a
//                    sequential sum over dd as the TPU kernel's);
//   xs_gn_item       the group norm of one (b, h), the residual and the new h
//                    (DH <= 1,024);
//   gemv_list        decode_ops.cuh's GEMV over a list of tiles (a team),
//                    with a hook after each tile's epilogue.
//
// The team-wide items are __noinline__: each is compiled as a function of its
// own, with the registers it needs, apart from the persistent kernel's GEMVs
// (the call costs nanoseconds; an item takes microseconds).
#pragma once

#include "decode_ops.cuh"

namespace mg {

constexpr int XM_NJ = 8;           // rows of S a thread holds in flight
constexpr int XM_MAX_DK = 8 * TEAM;  // the widest mLSTM head: two column quads a thread
constexpr int XS_TILE_DH = TEAM;   // the widest sLSTM head whose R tile a cell item stages
constexpr int XS_MAX_DH = 4 * TEAM;  // the widest sLSTM head
constexpr int XS_UNITS = 16;       // sLSTM units of a cell item
constexpr int XS_COLS = 4 * XS_UNITS;  // R columns of a cell item (four gates)
constexpr int XS_PREP_COLS = 128;  // columns of an sLSTM prep item
constexpr int XM_CHUNK = TILE_N;   // channels of a gate chunk: one up-projection tile

// Sum over a 256-thread team in a fixed order (each warp's butterfly, then
// the warps in order); every thread gets the same bits. red holds WARPS
// floats; `bar` is the team's named barrier (0 for a 256-thread block).
__device__ __forceinline__ float team_sum(float v, float* red, int tid, int bar) {
  v = warp_sum(v);
  team_sync(bar);
  if (tid % 32 == 0) red[tid / 32] = v;
  team_sync(bar);
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// rows of S per item: XM_NJ for each of the rows a pass covers (TEAM / (DV /
// 4)); past DV = 4 TEAM a pass covers one row, XM_CQ(DV) quads a thread.
__host__ __device__ inline int xm_rows_per_item(int DV) { return XM_NJ * (DV / 4 <= TEAM ? TEAM / (DV / 4) : 1); }
__host__ __device__ inline int xm_quads_per_thread(int DV) { return DV / 4 <= TEAM ? 1 : DV / (4 * TEAM); }
// Whether the matrix memory's items take head width DK (= DV).
__host__ __device__ inline bool xm_shape_ok(int DK) {
  if (DK < 4 || DK % 4 != 0 || DK > XM_MAX_DK) return false;
  const int c4 = DK / 4;
  return (c4 <= TEAM ? TEAM % c4 == 0 : c4 % TEAM == 0) && DK % xm_rows_per_item(DK) == 0;
}

// ---------------------------------------------------------------------------
// mLSTM
// ---------------------------------------------------------------------------

// One (row b, 4-channel block n): up (B, 2 di) = [x_m | z]; the conv state
// (B, 3, di) advances in place; buf (B, 4, di) = [q | k | v | x_c].
__device__ __forceinline__ void xm_prep_group(const float* __restrict__ up, const float* __restrict__ conv_w,
                                              const float* __restrict__ conv_b, float* __restrict__ conv_state,
                                              const float* __restrict__ qkv_w, float* __restrict__ buf, int di, int b,
                                              int n) {
  const int nb = di / 4;
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

// Gate g (i gates 0..H-1, f gates H..2H-1) of row b over chunk c: the 16
// channels [16 c, 16 c + 16) of q, then of k, then of v, in order.
__device__ __forceinline__ float xm_gate_partial(const float* buf, const float* w_gate, int di, int b, int g,
                                                 int c) {
  const float* row = buf + (size_t)b * 4 * di + (size_t)c * XM_CHUNK;
  const float* w = w_gate + (size_t)g * 3 * di + (size_t)c * XM_CHUNK;
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < XM_CHUNK; ++j) acc = fmaf(row[(size_t)p * di + j], __ldg(w + (size_t)p * di + j), acc);
  return acc;
}

// A warp adds a gate's n chunk partials p[0..n) (n % 4 == 0, p 16-byte
// aligned): lane l adds chunks 4 l .. 4 l + 3 (then 4 l + 128 ..) in order,
// then the butterfly; every lane gets the same bits. p is in shared memory
// (the chain's gates kernel) or global memory (the step), so it is read with
// generic loads.
__device__ __forceinline__ float xm_chunk_sum(const float* p, int n, int lane) {
  float acc = 0.f;
  for (int c = 4 * lane; c < n; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
  return warp_sum(acc);
}

// i, f = the gate sums + bias; m = max(logsigmoid(f) + m_prev, i); f' and i'.
__device__ __forceinline__ void xm_gate_act(float si, float sf, const float* gate_b, float m_prev, int H, int h,
                                            float& m_new, float& f_act, float& i_act) {
  const float i_pre = si + __ldg(gate_b + h), f_pre = sf + __ldg(gate_b + H + h);
  const float log_f = -softplusf_(-f_pre);  // jax.nn.log_sigmoid
  m_new = fmaxf(log_f + m_prev, i_pre);
  f_act = expf(log_f + m_prev - m_new);
  i_act = expf(i_pre - m_new);
}

// One warp: the gates of head h from its i and f chunk partials (nch each),
// lane 0 writing out[0..2] = f', i', m_new.
__device__ __forceinline__ void xm_gates_warp(const float* pi, const float* pf, int nch, const float* gate_b,
                                              float m_prev, int H, int h, int lane, float* out) {
  float m_new, f_act, i_act;
  xm_gate_act(xm_chunk_sum(pi, nch, lane), xm_chunk_sum(pf, nch, lane), gate_b, m_prev, H, h, m_new, f_act, i_act);
  if (lane == 0) {
    out[0] = f_act;
    out[1] = i_act;
    out[2] = m_new;
  }
}

// n = f' n + i' k / sqrt(DK) of one (b, h), in place; returns the readout's
// denominator max(|q.n|, exp(-m_new)) to every thread of the team.
static __device__ __noinline__ float xm_norm_denom(const float* buf, float* n_st, float f_act, float i_act, float m_new,
                                                      int b, int h, int H, int di, int tid, int bar, float* red) {
  const int DK = di / H;
  const float rs = 1.0f / sqrtf((float)DK);
  float* n = n_st + ((size_t)b * H + h) * DK;
  const float* q = buf + (size_t)b * 4 * di + (size_t)h * DK;
  const float* k = q + di;
  float qn = 0.f;
  for (int kk = tid; kk < DK; kk += TEAM) {
    const float nv = f_act * n[kk] + i_act * (k[kk] * rs);
    n[kk] = nv;
    qn = fmaf(q[kk], nv, qn);
  }
  qn = team_sum(qn, red, tid, bar);
  return fmaxf(fabsf(qn), expf(-m_new));
}

__device__ __forceinline__ void load_s4(const float* s, float (&v)[4]) {
  const float4 t = ld4(s);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_s4(const __nv_bfloat16* s, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(s);
  v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
}
__device__ __forceinline__ void store_s4(float* s, const float (&v)[4]) {
  *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_s4(__nv_bfloat16* s, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(s) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

struct NoPrelude {
  __device__ void operator()(int) const {}
};

// Rows [rc RC, rc RC + RC) of (b, h)'s S (DK x DV, row-major; RC =
// xm_rows_per_item(DV)): S = f' S + (i' k / sqrt(DK)) v^T, stored in S's
// dtype in place, and the readout partial q.S (the f32 update) over those
// rows into mpart[((b H + h) nrc + rc) DV + col]. Thread (sub, c4) owns
// columns 4 c4 .. 4 c4 + 3 (and, with CQ = 2, the quad TEAM columns on) of
// rows rc RC + sub + j rpp, j < XM_NJ; it loads them, their q and k, and v
// before anything else, then runs prelude(tid) (the step's warp 0 computes
// f' and i' there), and after the team barrier reads f', i' from fi[0],
// fi[1]. Its rows are added in j order, then the rpp subs in order (red:
// rpp x DV floats of shared memory).
template <typename S, class Prelude, int CQ>
static __device__ __noinline__ void xm_memory_rows_cq(const float* buf, S* s_st, const float* fi, float* mpart,
                                                         int b, int h, int rc, int H, int di, int tid, int bar,
                                                         float* red, Prelude prelude) {
  const int DK = di / H, DV = DK, cols4 = DV / (4 * CQ), rpp = TEAM / cols4, nrc = DK / (XM_NJ * rpp);
  const int c4 = tid % cols4, sub = tid / cols4, r0 = rc * XM_NJ * rpp + sub;
  const float rs = 1.0f / sqrtf((float)DK);
  S* base = s_st + ((size_t)b * H + h) * DK * DV + 4 * c4;
  const float* q = buf + (size_t)b * 4 * di + (size_t)h * DK;
  const float* k = q + di;
  const float* v = q + 2 * (size_t)di + 4 * c4;
  float sv[XM_NJ][CQ][4], qv[XM_NJ], kv[XM_NJ], vv[CQ][4];
#pragma unroll
  for (int j = 0; j < XM_NJ; ++j) {
#pragma unroll
    for (int u = 0; u < CQ; ++u) load_s4(base + (size_t)(r0 + j * rpp) * DV + 4 * u * cols4, sv[j][u]);
    qv[j] = q[r0 + j * rpp];
    kv[j] = k[r0 + j * rpp];
  }
#pragma unroll
  for (int u = 0; u < CQ; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) vv[u][i] = v[4 * u * cols4 + i];
  prelude(tid);
  team_sync(bar);
  const float f_act = fi[0], i_act = fi[1];
  float acc[CQ][4] = {};
#pragma unroll
  for (int j = 0; j < XM_NJ; ++j) {
    const float ik = i_act * (kv[j] * rs);
#pragma unroll
    for (int u = 0; u < CQ; ++u) {
      float sn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sn[i] = sv[j][u][i] * f_act + ik * vv[u][i];
        acc[u][i] = fmaf(qv[j], sn[i], acc[u][i]);
      }
      store_s4(base + (size_t)(r0 + j * rpp) * DV + 4 * u * cols4, sn);
    }
  }
#pragma unroll
  for (int u = 0; u < CQ; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(size_t)sub * DV + 4 * (c4 + u * cols4) + i] = acc[u][i];
  team_sync(bar);
  float* out = mpart + (((size_t)b * H + h) * nrc + rc) * DV;
  for (int col = tid; col < DV; col += TEAM) {
    float s = red[col];
    for (int u = 1; u < rpp; ++u) s = s + red[(size_t)u * DV + col];
    out[col] = s;
  }
  team_sync(bar);
}

// xm_memory_rows_cq at the quads a thread holds for this head width
// (xm_shape_ok's widths).
template <typename S, class Prelude>
static __device__ __forceinline__ void xm_memory_rows(const float* buf, S* s_st, const float* fi, float* mpart, int b,
                                                      int h, int rc, int H, int di, int tid, int bar, float* red,
                                                      Prelude prelude) {
  if (xm_quads_per_thread(di / H) == 1)
    xm_memory_rows_cq<S, Prelude, 1>(buf, s_st, fi, mpart, b, h, rc, H, di, tid, bar, red, prelude);
  else
    xm_memory_rows_cq<S, Prelude, 2>(buf, s_st, fi, mpart, b, h, rc, H, di, tid, bar, red, prelude);
}

// h_att (B, di) over head (b, h): the nrc row chunks' partials of each
// column added in order, over denom. A thread loads up to 32 partials of a
// column before it adds them.
template <int NB = 32>
static __device__ __noinline__ void xm_head_readout(const float* mpart, float denom, float* h_att, int b, int h,
                                                       int H, int di, int tid) {
  const int DV = di / H, nrc = DV / xm_rows_per_item(DV);
  const float* p = mpart + ((size_t)b * H + h) * nrc * DV;
  for (int col = tid; col < DV; col += TEAM) {
    float s = 0.f;
    for (int rc0 = 0; rc0 < nrc; rc0 += NB) {
      float v[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) v[u] = rc0 + u < nrc ? __ldcg(p + (size_t)(rc0 + u) * DV + col) : 0.f;
#pragma unroll
      for (int u = 0; u < NB; ++u)
        if (rc0 + u < nrc) s += v[u];
    }
    h_att[(size_t)b * di + (size_t)h * DV + col] = s / denom;
  }
}

// y = (headnorm(h) * outnorm + skip * x_c) * silu(z) over head (b, h).
static __device__ __noinline__ void xm_out_item(const float* h_att, const float* buf, const float* up,
                                                   const float* outnorm, const float* skip, float* y, int b, int h,
                                                   int H, int di, float eps, int tid, int bar, float* red) {
  const int DV = di / H;
  const float* hr = h_att + (size_t)b * di + (size_t)h * DV;
  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < DV; e += TEAM) {
    const float v = hr[e];
    s1 += v;
    s2 += v * v;
  }
  s1 = team_sum(s1, red, tid, bar);
  s2 = team_sum(s2, red, tid, bar);
  const float mean = s1 / DV, var = s2 / DV - mean * mean;
  const float inv = 1.f / sqrtf(var + eps);
  for (int e = tid; e < DV; e += TEAM) {
    const int c = h * DV + e;
    const float hn = (hr[e] - mean) * inv * __ldg(outnorm + c) + __ldg(skip + c) * buf[((size_t)b * 4 + 3) * di + c];
    const float z = up[(size_t)b * 2 * di + di + c];
    y[(size_t)b * di + c] = hn * (z * sigmoidf_(z));
  }
}

// The one-launch step's head item (b, h): the gates from the chunk partials
// gpart (B, 2H, nch) and the normalizer and denominator (xm_gates_kernel's
// arithmetic), the readout over the row blocks' partials (xm_head_readout's)
// and the output gate (xm_out_item's), the same operations in the same
// order, with every global load issued first. m_st and n_st are the
// block's (B, H) and (B, H, DK); DK = DV <= 2 TEAM, at most 32 row blocks.
// sc: 3 floats of shared memory.
static __device__ __noinline__ void xm_head_out(const float* gpart, const float* gate_b, float* m_st, float* n_st,
                                                   const float* buf, const float* mpart, const float* up,
                                                   const float* outnorm, const float* skip, float* y, int b, int h,
                                                   int H, int di, float eps, int tid, int bar, float* red, float* sc) {
  constexpr int E = 2, NRC = 32;
  const int DK = di / H, DV = DK, nrc = DV / xm_rows_per_item(DV), nch = di / XM_CHUNK;
  const float rs = 1.0f / sqrtf((float)DK);
  float* n = n_st + ((size_t)b * H + h) * DK;
  const float* q = buf + (size_t)b * 4 * di + (size_t)h * DK;
  const float* k = q + di;
  const float* pm = mpart + ((size_t)b * H + h) * nrc * DV;
  float nv[E], kv[E], qv[E], on[E], sk[E], xc[E], zv[E], part[E][NRC];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM, c = h * DV + kk;
    const bool in = kk < DK;
    nv[e] = in ? n[kk] : 0.f;
    kv[e] = in ? k[kk] : 0.f;
    qv[e] = in ? q[kk] : 0.f;
    on[e] = in ? __ldg(outnorm + c) : 0.f;
    sk[e] = in ? __ldg(skip + c) : 0.f;
    xc[e] = in ? buf[((size_t)b * 4 + 3) * di + c] : 0.f;
    zv[e] = in ? up[(size_t)b * 2 * di + di + c] : 0.f;
#pragma unroll
    for (int rc = 0; rc < NRC; ++rc) part[e][rc] = in && rc < nrc ? __ldcg(pm + (size_t)rc * DV + kk) : 0.f;
  }
  if (tid < 32) {
    const float* pg = gpart + (size_t)b * 2 * H * nch;
    xm_gates_warp(pg + (size_t)h * nch, pg + (size_t)(H + h) * nch, nch, gate_b, m_st[(size_t)b * H + h], H, h, tid,
                  sc);
  }
  team_sync(bar);
  const float f_act = sc[0], i_act = sc[1], m_new = sc[2];
  float qn = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM;
    if (kk < DK) {
      const float nn = f_act * nv[e] + i_act * (kv[e] * rs);
      n[kk] = nn;
      qn = fmaf(qv[e], nn, qn);
    }
  }
  qn = team_sum(qn, red, tid, bar);
  const float denom = fmaxf(fabsf(qn), expf(-m_new));
  if (tid == 0) m_st[(size_t)b * H + h] = m_new;
  float hv[E], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM;
    hv[e] = 0.f;
    if (kk < DV) {
      float s = 0.f;
#pragma unroll
      for (int rc = 0; rc < NRC; ++rc)
        if (rc < nrc) s += part[e][rc];
      hv[e] = s / denom;
      s1 += hv[e];
      s2 += hv[e] * hv[e];
    }
  }
  s1 = team_sum(s1, red, tid, bar);
  s2 = team_sum(s2, red, tid, bar);
  const float mean = s1 / DV, var = s2 / DV - mean * mean;
  const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM;
    if (kk < DV) {
      const float hn = (hv[e] - mean) * inv * on[e] + sk[e] * xc[e];
      y[(size_t)b * di + (size_t)h * DV + kk] = hn * (zv[e] * sigmoidf_(zv[e]));
    }
  }
}

// xm_head_out past its register budget (DK > 2 TEAM or more than 32 row
// blocks: the 1- and 2-head models of width 1,024), up to XM_MAX_DK: the
// same operations in the same order, each thread's columns in a loop and
// the row blocks' partials read as they are added.
static __device__ __noinline__ void xm_head_out_wide(const float* gpart, const float* gate_b, float* m_st,
                                                        float* n_st, const float* buf, const float* mpart,
                                                        const float* up, const float* outnorm, const float* skip,
                                                        float* y, int b, int h, int H, int di, float eps, int tid,
                                                        int bar, float* red, float* sc) {
  constexpr int E = XM_MAX_DK / TEAM;
  const int DK = di / H, DV = DK, nrc = DV / xm_rows_per_item(DV), nch = di / XM_CHUNK;
  const float rs = 1.0f / sqrtf((float)DK);
  float* n = n_st + ((size_t)b * H + h) * DK;
  const float* q = buf + (size_t)b * 4 * di + (size_t)h * DK;
  const float* k = q + di;
  const float* pm = mpart + ((size_t)b * H + h) * nrc * DV;
  if (tid < 32) {
    const float* pg = gpart + (size_t)b * 2 * H * nch;
    xm_gates_warp(pg + (size_t)h * nch, pg + (size_t)(H + h) * nch, nch, gate_b, m_st[(size_t)b * H + h], H, h, tid,
                  sc);
  }
  team_sync(bar);
  const float f_act = sc[0], i_act = sc[1], m_new = sc[2];
  float qn = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM;
    if (kk < DK) {
      const float nn = f_act * n[kk] + i_act * (k[kk] * rs);
      n[kk] = nn;
      qn = fmaf(q[kk], nn, qn);
    }
  }
  qn = team_sum(qn, red, tid, bar);
  const float denom = fmaxf(fabsf(qn), expf(-m_new));
  if (tid == 0) m_st[(size_t)b * H + h] = m_new;
  float hv[E], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM;
    hv[e] = 0.f;
    if (kk < DV) {
      float s = 0.f;
      for (int rc = 0; rc < nrc; ++rc) s += __ldcg(pm + (size_t)rc * DV + kk);
      hv[e] = s / denom;
      s1 += hv[e];
      s2 += hv[e] * hv[e];
    }
  }
  s1 = team_sum(s1, red, tid, bar);
  s2 = team_sum(s2, red, tid, bar);
  const float mean = s1 / DV, var = s2 / DV - mean * mean;
  const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kk = tid + e * TEAM, c = h * DV + kk;
    if (kk < DV) {
      const float hn = (hv[e] - mean) * inv * __ldg(outnorm + c) + __ldg(skip + c) * buf[((size_t)b * 4 + 3) * di + c];
      const float z = up[(size_t)b * 2 * di + di + c];
      y[(size_t)b * di + c] = hn * (z * sigmoidf_(z));
    }
  }
}

// ---------------------------------------------------------------------------
// sLSTM
// ---------------------------------------------------------------------------

// Columns [128 chunk, 128 chunk + 128) of row b: xn = LN(x) with the GEMV
// prologue's statistics (f64 sums rounded once, rsqrtf), the conv step on
// xn (state (B, 3, d) in place) and silu. xs (2, B, d) = [x_c; xn].
// red64 holds 2 WARPS doubles.
static __device__ __noinline__ void xs_prep_item(const float* x, const float* ln, const float* conv_w,
                                                    const float* conv_b, float* conv_state, float* xs, int B, int d,
                                                    float eps, int b, int chunk, int tid, int bar, double* red64) {
  const float* xr = x + (size_t)b * d;
  double s1 = 0.0, s2 = 0.0;
  for (int k = tid; k < d; k += TEAM) {
    const float v = xr[k];
    s1 += (double)v;
    s2 += (double)(v * v);
  }
  s1 = warp_sum_d(s1);
  s2 = warp_sum_d(s2);
  team_sync(bar);
  if (tid % 32 == 0) {
    red64[tid / 32] = s1;
    red64[WARPS + tid / 32] = s2;
  }
  team_sync(bar);
  double t1 = 0.0, t2 = 0.0;
  for (int w = 0; w < WARPS; ++w) {
    t1 += red64[w];
    t2 += red64[WARPS + w];
  }
  const float mean = (float)(t1 / d), msq = (float)(t2 / d);
  const float mul = rsqrtf(msq - mean * mean + eps);
  const int c = chunk * XS_PREP_COLS + tid;
  if (tid < XS_PREP_COLS && c < d) {
    const float xn = (xr[c] - mean) * mul * __ldg(ln + c) + __ldg(ln + d + c);
    float* cs = conv_state + (size_t)b * 3 * d;
    const float s0 = cs[c], s1c = cs[d + c], s2c = cs[2 * d + c];
    const float y = s0 * __ldg(conv_w + c) + s1c * __ldg(conv_w + d + c) + s2c * __ldg(conv_w + 2 * d + c) +
                    xn * __ldg(conv_w + 3 * d + c) + __ldg(conv_b + c);
    cs[c] = s1c;
    cs[d + c] = s2c;
    cs[2 * d + c] = xn;
    xs[(size_t)b * d + c] = y * sigmoidf_(y);
    xs[((size_t)B + b) * d + c] = xn;
  }
}

// Shared memory of a cell item: the R tile (DH rows of XS_COLS bf16, up to
// DH = XS_TILE_DH), bf16(h) of every row (B x DH f32), the pre-activations
// and the input products (B x XS_COLS f32 each), the bias (XS_COLS) and the
// old c, n, m of the item's units (3 x B x XS_UNITS).
__host__ __device__ inline int xs_cell_smem_bytes(int B, int DH) {
  return (DH <= XS_TILE_DH ? DH * XS_COLS * 2 : 0) + (B * DH + 2 * B * XS_COLS + XS_COLS + 3 * B * XS_UNITS) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// Units [XS_UNITS ug, XS_UNITS ug + XS_UNITS) of head h, every batch row:
// pre[g][e] = (W x)[g] + bf16(h_prev) . R_h[:, g DH + e] + b[g] (the sum over
// dd sequential from dd = 0, as the TPU kernel's), then the exp-gated cell:
// c, n, m advance in place in hcnm (4, B, H, DH); the new h goes to hnew
// (B, d), for xs_gn_item (every item of the head reads the old h first).
// Every global load is issued up front, beside the R tile's copies. Past
// XS_TILE_DH the tile would not fit beside the step's other team: each
// product reads its column of R_h from L2 (the same terms in the same
// order).
static __device__ __noinline__ void xs_cell_item(const float* wif, const float* wzo, const __nv_bfloat16* r_w,
                                                    const float* bias, float* hcnm, float* hnew, int B, int H, int DH,
                                                    int h, int ug, int tid, int bar, char* smem) {
  const int d = H * DH;
  const bool tile = DH <= XS_TILE_DH;
  const size_t plane = (size_t)B * H * DH;
  __nv_bfloat16* rt = reinterpret_cast<__nv_bfloat16*>(smem);
  float* hb = reinterpret_cast<float*>(smem + (tile ? DH * XS_COLS * 2 : 0));
  float* pre = hb + B * DH;
  float* wx = pre + B * XS_COLS;
  float* bs = wx + B * XS_COLS;
  float* cnm = bs + XS_COLS;  // (3, B, XS_UNITS): c, n, m
  // The tile: row dd holds gate g's 16 units at [16 g, 16 g + 16), two
  // 16-byte copies a gate.
  const __nv_bfloat16* rh = r_w + (size_t)h * DH * 4 * DH + (size_t)ug * XS_UNITS;
  for (int i = tid; tile && i < DH * 8; i += TEAM) {
    const int dd = i / 8, g = (i % 8) / 2, half = i % 2;
    cp_async16(rt + (size_t)dd * XS_COLS + g * XS_UNITS + 8 * half, rh + (size_t)dd * 4 * DH + g * DH + 8 * half);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = tid; i < B * DH; i += TEAM)
    hb[i] = bf16_round(hcnm[((size_t)(i / DH) * H + h) * DH + i % DH]);
  for (int p = tid; p < B * XS_COLS; p += TEAM) {
    const int b = p / XS_COLS, g = (p % XS_COLS) / XS_UNITS, c = h * DH + ug * XS_UNITS + p % XS_UNITS;
    wx[p] = g < 2 ? wif[(size_t)b * 2 * d + (size_t)g * d + c] : wzo[(size_t)b * 2 * d + (size_t)(g - 2) * d + c];
  }
  for (int i = tid; i < XS_COLS; i += TEAM)
    bs[i] = __ldg(bias + (size_t)(i / XS_UNITS) * d + h * DH + ug * XS_UNITS + i % XS_UNITS);
  for (int p = tid; p < 3 * B * XS_UNITS; p += TEAM) {
    const int k = p / (B * XS_UNITS), b = (p / XS_UNITS) % B;
    cnm[p] = hcnm[(1 + k) * plane + ((size_t)b * H + h) * DH + ug * XS_UNITS + p % XS_UNITS];
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  team_sync(bar);
  for (int p = tid; p < B * XS_COLS; p += TEAM) {
    const int b = p / XS_COLS, col = p % XS_COLS;
    const float* hr = hb + (size_t)b * DH;
    float acc = 0.f;
    if (tile) {
#pragma unroll 16
      for (int dd = 0; dd < DH; ++dd) acc = fmaf(hr[dd], __bfloat162float(rt[(size_t)dd * XS_COLS + col]), acc);
    } else {
      const __nv_bfloat16* rc = rh + (size_t)(col / XS_UNITS) * DH + col % XS_UNITS;
#pragma unroll 16
      for (int dd = 0; dd < DH; ++dd) acc = fmaf(hr[dd], __bfloat162float(__ldg(rc + (size_t)dd * 4 * DH)), acc);
    }
    pre[p] = (wx[p] + acc) + bs[col];
  }
  team_sync(bar);
  for (int p = tid; p < B * XS_UNITS; p += TEAM) {
    const int b = p / XS_UNITS, u = p % XS_UNITS, e = ug * XS_UNITS + u;
    const float* pb = pre + (size_t)b * XS_COLS;
    const float ip = pb[u], fp = pb[XS_UNITS + u], zp = pb[2 * XS_UNITS + u], op = pb[3 * XS_UNITS + u];
    const float c_prev = cnm[p], n_prev = cnm[B * XS_UNITS + p], m_prev = cnm[2 * B * XS_UNITS + p];
    const float m_new = fmaxf(fp + m_prev, ip);
    const float i_act = expf(ip - m_new);
    const float f_act = expf(fp + m_prev - m_new);
    const float c = f_act * c_prev + i_act * tanhf(zp);
    const float n = f_act * n_prev + i_act;
    const float hv = sigmoidf_(op) * c / n;
    const size_t off = ((size_t)b * H + h) * DH + e;
    hcnm[plane + off] = c;
    hcnm[2 * plane + off] = n;
    hcnm[3 * plane + off] = m_new;
    hnew[(size_t)b * d + (size_t)h * DH + e] = hv;
  }
  team_sync(bar);
}

// Head (b, h): the group norm of the new h, x += gn(h) * gn_scale, and h
// into the state (hcnm plane 0). A unit a thread up to DH = TEAM; past it,
// each thread's units in a loop (DH <= XS_MAX_DH).
static __device__ __noinline__ void xs_gn_item(const float* hnew, const float* gn, float* hcnm, float* x, int H, int DH,
                                                  float eps, int b, int h, int tid, int bar, float* red) {
  const int d = H * DH;
  if (DH <= TEAM) {
    const int c = h * DH + tid;
    const float hv = tid < DH ? __ldcg(hnew + (size_t)b * d + c) : 0.f;
    const float s1 = team_sum(hv, red, tid, bar);
    const float s2 = team_sum(tid < DH ? hv * hv : 0.f, red, tid, bar);
    if (tid < DH) {
      const float mean = s1 / DH, inv = 1.f / sqrtf(s2 / DH - mean * mean + eps);
      x[(size_t)b * d + c] = x[(size_t)b * d + c] + (hv - mean) * inv * __ldg(gn + c);
      hcnm[((size_t)b * H + h) * DH + tid] = hv;
    }
    return;
  }
  constexpr int E = XS_MAX_DH / TEAM;
  float hv[E], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int u = tid + e * TEAM;
    hv[e] = u < DH ? __ldcg(hnew + (size_t)b * d + h * DH + u) : 0.f;
    s1 += hv[e];
    s2 += hv[e] * hv[e];
  }
  s1 = team_sum(s1, red, tid, bar);
  s2 = team_sum(s2, red, tid, bar);
  const float mean = s1 / DH, inv = 1.f / sqrtf(s2 / DH - mean * mean + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int u = tid + e * TEAM, c = h * DH + u;
    if (u < DH) {
      x[(size_t)b * d + c] = x[(size_t)b * d + c] + (hv[e] - mean) * inv * __ldg(gn + c);
      hcnm[((size_t)b * H + h) * DH + u] = hv[e];
    }
  }
}

// ---------------------------------------------------------------------------
// The GEMV over a list of tiles: gemv_team's arithmetic (decode_ops.cuh),
// tile by tile as listed. hook(tile) runs after each tile's epilogue (the
// team barrier before it is the hook's to take).
// ---------------------------------------------------------------------------

struct NoHook {
  __device__ void operator()(int) const {}
};

template <int PRO, int EPI, int FMT, class Hook = NoHook>
__device__ void gemv_list(const GemvArgs& a, GemvSmem& sm, const int* tiles, int n_tiles, int tid, int bar,
                          char* dyn, Hook hook = Hook()) {
  constexpr int KC = gemv_kchunk<FMT>(), WV = gemv_wv<FMT>(), ESZ = FMT == kBf16 ? 2 : 1;
  if (n_tiles <= 0) return;
  const GemvGeom q = gemv_geom<FMT>(a, tid);
  uint32_t* sums = reinterpret_cast<uint32_t*>(dyn);
  char* xs = dyn + gemv_sums_bytes(a.R, q.G);
  const char* wbytes = static_cast<const char*>(a.w);

  uint4 wa[KC][WV], wb[KC][WV];
  if (q.g0 < q.G) {
    const int na = tiles[0] * TILE_N + q.gq;
    const char* pa = wbytes + (size_t)na * a.K * ESZ + (size_t)(q.lk + q.g0 * q.gsz) * ESZ;
    gemv_load_chunk<FMT>(wa, wb, pa, pa + (size_t)8 * a.K * ESZ, FMT != kBf16 || na < a.N,
                         FMT != kBf16 || na + 8 < a.N, q.s0, q.sstep, q.SG, q.krem);
  }
  gemv_prologue<PRO, FMT>(a, sm, xs, tid, bar);

  const char* xrow = xs + (size_t)q.gq * q.ld;
  bool loaded = true;
  int buf = 0;
  for (int i = 0; i < n_tiles; ++i, buf ^= 1) {
    const int n0 = tiles[i] * TILE_N;
    const bool oka = FMT != kBf16 || n0 + q.gq < a.N, okb = FMT != kBf16 || n0 + q.gq + 8 < a.N;
    uint32_t* tsums = sums + (size_t)buf * q.slots * TILE_N * a.R;
    for (int g = q.g0; g < q.G; g += q.gstep) {
      const char* pa = wbytes + (size_t)(n0 + q.gq) * a.K * ESZ + (size_t)(q.lk + g * q.gsz) * ESZ;
      const char* pb = pa + (size_t)8 * a.K * ESZ;
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
      int ci[4] = {0, 0, 0, 0};
      for (int s = q.s0; s < q.SG; s += KC * q.sstep) {
        if (!loaded) gemv_load_chunk<FMT>(wa, wb, pa, pb, oka, okb, s, q.sstep, q.SG, q.krem);
        loaded = false;
        gemv_mma_chunk<FMT>(cf, ci, wa, wb, xrow, g, s, q, a.R);
      }
      gemv_write_sums<FMT>(tsums, cf, ci, g, q, a.R);
    }
    if (q.g0 < q.G && i + 1 < n_tiles) {
      const int na = tiles[i + 1] * TILE_N + q.gq;
      const char* pa = wbytes + (size_t)na * a.K * ESZ + (size_t)(q.lk + q.g0 * q.gsz) * ESZ;
      gemv_load_chunk<FMT>(wa, wb, pa, pa + (size_t)8 * a.K * ESZ, FMT != kBf16 || na < a.N,
                           FMT != kBf16 || na + 8 < a.N, q.s0, q.sstep, q.SG, q.krem);
      loaded = true;
    }
    team_sync(bar);
    gemv_finish_tile<EPI, FMT>(a, sm, tsums, n0, tid, q);
    hook(tiles[i]);
  }
}

}  // namespace mg
