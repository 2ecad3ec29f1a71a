"""mLSTM (matrix-memory LSTM) ops in plain PyTorch.

Port of musicgen_tpu/ops/mlstm.py. The recurrence (xLSTM paper, eq. 19-27),
per head with key/value width dh:

    m_t = max(f~_t + m_{t-1}, i~_t)                 (stabilizer, f~ = logsigmoid(f))
    S_t = exp(f~_t + m_{t-1} - m_t) S_{t-1}
          + exp(i~_t - m_t) (k_t / sqrt(dh)) v_t^T   (matrix memory)
    n_t = exp(f~_t + m_{t-1} - m_t) n_{t-1}
          + exp(i~_t - m_t) (k_t / sqrt(dh))         (normalizer)
    h_t = (q_t . S_t) / max(|q_t . n_t|, exp(-m_t))

`mlstm_parallel` is the quadratic form (training), `mlstm_chunkwise` the
chunkwise form with the exact carried state (prefill), `mlstm_step` the
O(dh^2) recurrent step (decode) and `mlstm_sequential` the step looped over T
(the oracle of the other two). Causal masks are applied with torch.where, as
the JAX code does: multiplying by a 0/1 mask would turn the exp overflow of
masked entries into NaN.

Shapes: q/k/v (B, T, H, DH); igate/fgate preactivations (B, T, H). f32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_F32 = torch.float32
MState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (S (B,H,DK,DV), n (B,H,DK), m (B,H))


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def mlstm_parallel(q, k, v, igate, fgate) -> torch.Tensor:
    """Full-sequence stabilized parallel form. Returns (B, T, H, DH)."""
    t, dh = q.shape[1], q.shape[3]
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    f_cum = torch.cumsum(F.logsigmoid(fgate.to(_F32)), dim=1)  # (B,T,H)
    # D[t, s] = f_cum[t] - f_cum[s] + i[s] for s <= t.
    d = f_cum[:, :, None, :] - f_cum[:, None, :, :] + igate.to(_F32)[:, None, :, :]
    d = torch.where(_causal(t, q.device)[None, :, :, None], d, float("-inf"))
    m = d.amax(dim=2)  # (B, T, H)
    w = torch.exp(d - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q, k) / math.sqrt(float(dh))
    cw = scores * w
    numerator = torch.einsum("btsh,bshd->bthd", cw, v)
    denom = torch.maximum(cw.sum(dim=2).abs(), torch.exp(-m))
    return numerator / denom[..., None]


def mlstm_init_state(batch: int, heads: int, dh: int, device=None) -> MState:
    return (
        torch.zeros(batch, heads, dh, dh, dtype=_F32, device=device),
        torch.zeros(batch, heads, dh, dtype=_F32, device=device),
        torch.full((batch, heads), float("-inf"), dtype=_F32, device=device),
    )


def mlstm_step(q, k, v, igate, fgate, state: MState) -> Tuple[torch.Tensor, MState]:
    """O(1) recurrent step: q/k/v (B, H, DH), gates (B, H). Returns
    (h (B, H, DH), new_state)."""
    s_prev, n_prev, m_prev = state
    dh = q.shape[-1]
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    log_f = F.logsigmoid(fgate.to(_F32))
    i_pre = igate.to(_F32)
    m_new = torch.maximum(log_f + m_prev, i_pre)
    f_act = torch.exp(log_f + m_prev - m_new)
    i_act = torch.exp(i_pre - m_new)
    k_scaled = k / math.sqrt(float(dh))
    s_new = f_act[..., None, None] * s_prev + i_act[..., None, None] * torch.einsum("bhk,bhv->bhkv", k_scaled, v)
    n_new = f_act[..., None] * n_prev + i_act[..., None] * k_scaled
    numerator = torch.einsum("bhk,bhkv->bhv", q, s_new)
    denom = torch.maximum(torch.einsum("bhk,bhk->bh", q, n_new).abs(), torch.exp(-m_new))
    return numerator / denom[..., None], (s_new, n_new, m_new)


def mlstm_sequential(q, k, v, igate, fgate) -> torch.Tensor:
    """mlstm_step over T from the zero state: the oracle of the parallel and
    chunkwise forms. Returns (B, T, H, DH)."""
    b, t, h, dh = q.shape
    state = mlstm_init_state(b, h, dh, q.device)
    hs = []
    for i in range(t):
        ht, state = mlstm_step(q[:, i], k[:, i], v[:, i], igate[:, i], fgate[:, i], state)
        hs.append(ht)
    return torch.stack(hs, dim=1)


def mlstm_chunkwise(q, k, v, igate, fgate, chunk: int = 256,
                    initial_state: Optional[MState] = None) -> Tuple[torch.Tensor, MState]:
    """Chunkwise-parallel mLSTM with the exact carry of (S, n, m) across
    chunks: O(T * chunk) memory. Returns (h (B, T, H, DH), final_state).
    T must be a multiple of `chunk`."""
    b, t, h, dh = q.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    log_f = F.logsigmoid(fgate.to(_F32)).reshape(b, nc, chunk, h)
    ig = igate.to(_F32).reshape(b, nc, chunk, h)
    qc = q.to(_F32).reshape(b, nc, chunk, h, dh)
    kc = (k.to(_F32) / math.sqrt(float(dh))).reshape(b, nc, chunk, h, dh)
    vc = v.to(_F32).reshape(b, nc, chunk, h, dh)

    bcum = torch.cumsum(log_f, dim=2)  # (B,NC,Q,H): within-chunk cumulative log-forget
    btot = bcum[:, :, -1, :]  # (B,NC,H)
    a = ig - bcum  # source weight i_s - b_s
    m_intra = torch.cummax(a, dim=2).values + bcum  # max_{s<=t}(b_t - b_s + i_s)

    if initial_state is None:
        s_in, n_in, m_in = mlstm_init_state(b, h, dh, q.device)
    else:
        s_in, n_in, m_in = (x.to(_F32) for x in initial_state)
    causal = _causal(chunk, q.device)[None, :, :, None]
    outs = []
    for c in range(nc):
        bcum_i, btot_i, a_i, m_intra_i = bcum[:, c], btot[:, c], a[:, c], m_intra[:, c]
        q_i, k_i, v_i = qc[:, c], kc[:, c], vc[:, c]
        m_t = torch.maximum(m_in[:, None, :] + bcum_i, m_intra_i)  # (B,Q,H)
        # Intra-chunk: D[t, s] = exp(b_t - b_s + i_s - m_t), s <= t.
        d = bcum_i[:, :, None, :] + a_i[:, None, :, :] - m_t[:, :, None, :]  # (B,T,S,H)
        w = torch.where(causal, torch.exp(d), 0.0)
        cw = torch.einsum("bthd,bshd->btsh", q_i, k_i) * w
        num = torch.einsum("btsh,bshd->bthd", cw, v_i)
        den = cw.sum(dim=2)
        # Inter-chunk contribution of the carried state.
        inter = torch.exp(m_in[:, None, :] + bcum_i - m_t)  # (B,T,H)
        num = num + inter[..., None] * torch.einsum("bthd,bhde->bthe", q_i, s_in)
        den = den + inter * torch.einsum("bthd,bhd->bth", q_i, n_in)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])
        # Carry to the chunk's end.
        m_out = torch.maximum(m_in + btot_i, m_intra_i[:, -1, :])
        w_end = torch.exp(btot_i[:, None, :] + a_i - m_out[:, None, :])  # (B,S,H)
        decay = torch.exp(m_in + btot_i - m_out)
        s_in = decay[:, :, None, None] * s_in + torch.einsum("bsh,bshd,bshe->bhde", w_end, k_i, v_i)
        n_in = decay[:, :, None] * n_in + torch.einsum("bsh,bshd->bhd", w_end, k_i)
        m_in = m_out
    return torch.stack(outs, dim=1).reshape(b, t, h, dh), (s_in, n_in, m_in)
