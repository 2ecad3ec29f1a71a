"""Kernel A: the Mamba-2 SSD chunked scan (prefill), csrc/ssd_scan.cu.

Replaces musicgen_tpu/ops/pallas_ssd.py `ssd_chunked_pallas`. The plain
version is ops/ssm.ssd_chunked. The kernel computes in f32 FMA (the TPU
kernel fed bf16 into its products), so it agrees with the plain version to
f32 rounding, whatever chunk length either uses.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_library, stream_ptr
from .ssm import ssd_chunked

# The kernel's fixed tile: headdim P and d_state N (csrc/ssd_scan.cu, D).
KERNEL_DIM = 64


def ssd_scan(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, T, G, N)
    C: torch.Tensor,  # (B, T, G, N)
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan from a zero state. Returns (y (B,T,H,P), final_state (B,H,P,N)).

    CPU tensors take the plain version (which needs T % chunk == 0); CUDA
    tensors launch the kernel, which takes any T and ignores `chunk`."""
    if not x.is_cuda:
        return ssd_chunked(x, dt, A, Bmat, C, chunk=chunk)
    b, t, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    if p != KERNEL_DIM or n != KERNEL_DIM:
        raise ValueError(f"ssd_scan kernel needs headdim = d_state = {KERNEL_DIM}, got {p}, {n}")
    if h % g:
        raise ValueError(f"ngroups {g} does not divide nheads {h}")
    if dt.shape != (b, t, h) or A.shape != (h,) or Bmat.shape != (b, t, g, n) or C.shape != Bmat.shape:
        raise ValueError("ssd_scan: inconsistent shapes")
    args = [x, dt, A, Bmat, C]
    for a in args:
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError("ssd_scan: all inputs must be float32 on one CUDA device")
    x, dt, A, Bmat, C = (a.contiguous() for a in args)
    y = torch.empty_like(x)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    lib = load_library()
    err = lib.mg_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, t, h, g, p, n, stream_ptr(x),
    )
    check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
