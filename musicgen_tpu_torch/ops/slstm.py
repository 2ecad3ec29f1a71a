"""sLSTM (scalar-memory LSTM with exponential gating) ops in plain PyTorch.

Port of musicgen_tpu/ops/slstm.py. The recurrence (xLSTM paper eq. 9-18),
per head with width dh and block-diagonal recurrent weights R_g:

    g~_t = W_g x_t + R_g h_{t-1} + b_g          for g in {i, f, z, o}
    m_t  = max(f~_t + m_{t-1}, i~_t)             (raw f~, no logsigmoid)
    i_t  = exp(i~_t - m_t);  f_t = exp(f~_t + m_{t-1} - m_t)
    c_t  = f_t c_{t-1} + i_t tanh(z~_t);  n_t = f_t n_{t-1} + i_t
    h_t  = sigmoid(o~_t) * c_t / n_t

`slstm_sequential` is the plain version of kernel H (ops/slstm_kernel).

Shapes: gate input preactivations wx (B, T, 4, H, DH) [order i, f, z, o],
recurrent weights R (4, H, DH, DH) (R[g, h, d_in, e_out]), bias (4, H, DH).
All f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_F32 = torch.float32
SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # h, c, n, m: (B, H, DH)


def slstm_init_state(batch: int, heads: int, dh: int, device=None) -> SState:
    z = torch.zeros(batch, heads, dh, dtype=_F32, device=device)
    return (z, z.clone(), z.clone(), torch.full((batch, heads, dh), float("-inf"), dtype=_F32, device=device))


def slstm_step(wx, r, b, state: SState) -> Tuple[torch.Tensor, SState]:
    """One step: wx (B, 4, H, DH). Returns (h (B, H, DH), new_state)."""
    h_prev, c_prev, n_prev, m_prev = state
    rec = torch.einsum("bhd,ghde->bghe", h_prev.to(_F32), r.to(_F32))
    pre = wx.to(_F32) + rec + b.to(_F32)[None]
    i_pre, f_pre, z_pre, o_pre = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    m_new = torch.maximum(f_pre + m_prev, i_pre)
    i_act = torch.exp(i_pre - m_new)
    f_act = torch.exp(f_pre + m_prev - m_new)
    c_new = f_act * c_prev + i_act * torch.tanh(z_pre)
    n_new = f_act * n_prev + i_act
    h_new = torch.sigmoid(o_pre) * c_new / n_new
    return h_new, (h_new, c_new, n_new, m_new)


def slstm_sequential(wx, r, b, initial_state: Optional[SState] = None) -> Tuple[torch.Tensor, SState]:
    """The step looped over T. Returns (h (B, T, H, DH), final_state)."""
    bsz, t, _, h, dh = wx.shape
    state = initial_state if initial_state is not None else slstm_init_state(bsz, h, dh, wx.device)
    hs = []
    for i in range(t):
        ht, state = slstm_step(wx[:, i], r, b, state)
        hs.append(ht)
    return torch.stack(hs, dim=1), state


def powerlaw_blockdependent_bias(num_heads: int, dh: int, block_idx: int, num_blocks: int) -> torch.Tensor:
    """Forget-gate bias init spreading per-head timescales (the JAX package's
    approximation of NX-AI's "powerlaw_blockdependent"): within each head a
    power-law ramp from 3 to 12 whose exponent grows with the block's depth.
    Returns (H, DH)."""
    ratio = block_idx / max(num_blocks - 1, 1)
    x = torch.linspace(0.0, 1.0, num_heads * dh, dtype=torch.float64).reshape(num_heads, dh)
    return (3.0 + 9.0 * x ** (0.3 + 1.3 * ratio)).to(_F32)
