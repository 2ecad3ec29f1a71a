"""Kernel I: the bf16 weight-streaming probe (csrc/probe_mm.cu).

Replaces experiments/hw_characterize.py `mm_kernel` (via `pallas_mm`):
y = bf16(x) @ W with f32 accumulation, x (M <= 8, K) f32. The JAX script
holds W as (K, N); here W is (N, K), K-contiguous, as the port's decode
packs hold their matrices (the probe's entry point and the tests transpose
the JAX layout once). The probe measures how close a hand-written kernel
comes to the memory's rate when a product streams bf16 weights for a few
rows (experiments/hw_characterize.py in this package chains ten of them).

`probe_mm` takes the plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises. Each launch adds one to LAUNCHES["probe_mm"].
"""
from __future__ import annotations

import collections

import torch

from .build import check, load_library, stream_ptr

MAX_ROWS = 8  # rows of x one launch takes: the mma's 8 columns (csrc/probe_mm.cu kMaxM)
MAX_K = 4096  # K the kernel stages x for (kMaxK); K % 32 == 0
TILE_N = 16  # columns of a block (kTileN); N % 16 == 0

LAUNCHES: collections.Counter = collections.Counter()


def probe_mm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = bf16(x) @ W^T in f32: x (M, K), w (N, K) bf16 -> (M, N) f32."""
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32).t()


def probe_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = bf16(x) @ W^T: x (M, K) f32, w (N, K) bf16 -> (M, N) f32."""
    if not x.is_cuda:
        return probe_mm_plain(x, w)
    m, k = x.shape
    n, dev = w.shape[0], x.device
    if not 1 <= m <= MAX_ROWS or k % 32 or not 32 <= k <= MAX_K:
        raise ValueError(f"probe_mm takes 1..{MAX_ROWS} rows and K % 32 == 0, K <= {MAX_K}, got ({m}, {k})")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x: need a contiguous, 16-byte aligned float32 tensor, got {x.dtype} "
                         f"(contiguous={x.is_contiguous()})")
    if (w.dtype != torch.bfloat16 or w.device != dev or tuple(w.shape) != (n, k) or not w.is_contiguous()
            or n % TILE_N or w.data_ptr() % 16):
        raise ValueError(f"w: need a contiguous, 16-byte aligned bfloat16 (N % {TILE_N} == 0, {k}) tensor on "
                         f"{dev}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    y = torch.empty(m, n, dtype=torch.float32, device=dev)
    lib = load_library()
    err = lib.mg_probe_mm(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, stream_ptr(x))
    check(lib, err, "probe_mm")
    LAUNCHES["probe_mm"] += 1
    return y
