"""Mamba-2 SSD selective-scan ops in plain PyTorch.

Port of musicgen_tpu/ops/ssm.py. These are the plain versions of kernel A
(ops/ssd_kernel.py) and of the decode step's state update:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t

Shapes (G = ngroups, H = heads, P = headdim, N = d_state):
  x: (B, T, H, P)   dt: (B, T, H)   A: (H,)   Bmat/C: (B, T, G, N), H % G == 0
All arithmetic is f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_F32 = torch.float32


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., t, s] = sum_{s < k <= t} x[..., k]; -inf above the diagonal."""
    t = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~causal, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,T,H,P), final_state (B,H,P,N)).

    T must be a multiple of `chunk` (pad upstream)."""
    b, t, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    rep = h // g

    xdt = x.to(_F32) * dt[..., None].to(_F32)
    dA = dt.to(_F32) * A.to(_F32)[None, None, :]

    xdt_c = xdt.reshape(b, nc, chunk, h, p)
    dA_c = dA.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)  # (B,NC,H,Q)
    B_c = Bmat.to(_F32).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    C_c = C.to(_F32).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)

    # Intra-chunk (diagonal blocks).
    L = torch.exp(segsum(dA_c))  # (B,NC,H,Q,Q)
    scores = torch.einsum("bcthn,bcshn->bchts", C_c, B_c) * L
    y_diag = torch.einsum("bchts,bcshp->bcthp", scores, xdt_c)

    # Chunk-final states.
    dA_cum = torch.cumsum(dA_c, dim=-1)
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)
    states = torch.einsum("bchs,bcshn,bcshp->bchpn", decay_to_end, B_c, xdt_c)

    # Inter-chunk recurrence; `entering[c]` is the state entering chunk c.
    chunk_decay = torch.exp(dA_cum[..., -1])  # (B,NC,H)
    state = (
        torch.zeros(b, h, p, n, dtype=_F32, device=x.device)
        if initial_state is None
        else initial_state.to(_F32)
    )
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (B,NC,H,P,N)

    in_decay = torch.exp(dA_cum)  # (B,NC,H,Q)
    y_off = torch.einsum("bcthn,bchpn,bcht->bcthp", C_c, entering, in_decay)

    y = (y_diag + y_off).reshape(b, t, h, p)
    return y, state


def ssd_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, G, N)
    C: torch.Tensor,  # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. Returns (y (B,H,P), new_state)."""
    h, g = x.shape[1], Bmat.shape[1]
    rep = h // g
    Bh = Bmat.to(_F32).repeat_interleave(rep, dim=1)
    Ch = C.to(_F32).repeat_interleave(rep, dim=1)
    decay = torch.exp(dt.to(_F32) * A.to(_F32)[None, :])
    update = torch.einsum("bhp,bhn->bhpn", x.to(_F32) * dt[..., None].to(_F32), Bh)
    new_state = state * decay[..., None, None] + update
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def ssd_reference(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    C: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan over T, one `ssd_step` per token: the literal oracle."""
    b, t, h, p = x.shape
    n = Bmat.shape[-1]
    state = (
        torch.zeros(b, h, p, n, dtype=_F32, device=x.device)
        if initial_state is None
        else initial_state.to(_F32)
    )
    ys = []
    for i in range(t):
        y, state = ssd_step(x[:, i], dt[:, i], A, Bmat[:, i], C[:, i], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def causal_conv1d(
    x: torch.Tensor,  # (B, T, C)
    w: torch.Tensor,  # (K, C) depthwise taps, tap K-1 multiplies x[t]
    bias: Optional[torch.Tensor] = None,  # (C,)
) -> torch.Tensor:
    """Depthwise causal conv: y[t] = sum_k w[k] * x[t - (K-1) + k] + b.

    Written out as shifted products rather than F.conv1d, which cuDNN would
    run in TF32 on the card."""
    k = w.shape[0]
    t = x.shape[1]
    y = 0
    for i in range(k):
        shift = k - 1 - i
        shifted = F.pad(x, (0, 0, shift, 0))[:, :t, :]
        y = y + shifted * w[i][None, None, :]
    if bias is not None:
        y = y + bias[None, None, :]
    return y


def causal_conv1d_step(
    x: torch.Tensor,  # (B, C) newest input
    conv_state: torch.Tensor,  # (B, K-1, C) previous K-1 inputs, oldest first
    w: torch.Tensor,  # (K, C)
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) conv step. Returns (y (B,C), new_conv_state)."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)  # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if bias is not None:
        y = y + bias[None, :]
    return y, window[:, 1:, :]
