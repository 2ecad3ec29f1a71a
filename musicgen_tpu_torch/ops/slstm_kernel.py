"""Kernel H: the sLSTM recurrence of the prefill, csrc/slstm_scan.cu.

Replaces musicgen_tpu/ops/pallas_slstm.py `slstm_pallas` (its
`_slstm_kernel`), with the contract of ops/slstm.slstm_sequential, its plain
version: (wx (B, T, 4, H, DH), r (4, H, DH, DH), b (4, H, DH)) ->
(h (B, T, H, DH), final (h, c, n, m) each (B, H, DH)), all f32, from the
zero state, R in f32 as in the TPU kernel. The kernel computes in f32 FMA, so
it agrees with the plain scan to f32 rounding (sums in another order).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_library, refuse_grad, stream_ptr
from .slstm import SState, slstm_sequential

MAX_DH = 256  # the kernel's largest head width (one thread per gate column)


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, SState]:
    """sLSTM over the whole sequence from the zero state.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    has no backward: under grad mode it refuses inputs that require grad
    (the model trains through the plain scan, as the JAX package does)."""
    if not wx.is_cuda:
        return slstm_sequential(wx, r, b)
    refuse_grad("slstm_scan (kernel H)", wx, r, b)
    bsz, t, four, h, dh = wx.shape
    if four != 4 or r.shape != (4, h, dh, dh) or b.shape != (4, h, dh):
        raise ValueError(f"slstm_scan: inconsistent shapes wx {tuple(wx.shape)}, r {tuple(r.shape)}, "
                         f"b {tuple(b.shape)}")
    if dh > MAX_DH or (4 * dh) % 32:
        raise ValueError(f"slstm_scan kernel needs DH <= {MAX_DH} and 4 DH a multiple of 32, got DH = {dh}")
    for a in (wx, r, b):
        if a.device != wx.device or a.dtype != torch.float32:
            raise ValueError("slstm_scan: all inputs must be float32 on one CUDA device")
    wx, r, b = (a.contiguous() for a in (wx, r, b))
    h_out = torch.empty(bsz, t, h, dh, dtype=torch.float32, device=wx.device)
    state = torch.empty(4, bsz, h, dh, dtype=torch.float32, device=wx.device)
    lib = load_library()
    err = lib.mg_slstm_scan(wx.data_ptr(), r.data_ptr(), b.data_ptr(), h_out.data_ptr(), state.data_ptr(),
                            bsz, t, h, dh, stream_ptr(wx))
    check(lib, err, "slstm_scan")
    slstm_scan.launches += 1
    return h_out, (state[0], state[1], state[2], state[3])


slstm_scan.launches = 0
