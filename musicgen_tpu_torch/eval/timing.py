"""Inference timing (port of musicgen_tpu/eval/timing.py; reference
scripts/test_inference.ipynb cell 1: time 100 forwards of a (2, 2048) batch,
memory from the device's statistics). On the card the forwards are timed
with CUDA events and the memory read from torch.cuda; on the CPU the host
clock times them and the device memory is not measured (None)."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch


@torch.no_grad()
def time_forward(fn: Callable, src: torch.Tensor, *args, iters: int = 100) -> Dict[str, float]:
    """ms a forward fn(src, *args) and tokens/s, after one warm-up call,
    over `iters` calls issued back to back."""
    fn(src, *args)
    if src.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(src.device)
        start.record()
        for _ in range(iters):
            fn(src, *args)
        end.record()
        torch.cuda.synchronize(src.device)
        per = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(src, *args)
        per = (time.perf_counter() - t0) / iters
    b, t = src.shape
    return {"ms_per_forward": per * 1e3, "tokens_per_sec": b * t / per}


def device_memory_stats(device: torch.device) -> Optional[Dict[str, int]]:
    """Bytes in use and the peak since the last reset on a CUDA device
    (torch.cuda.memory_allocated / max_memory_allocated); None elsewhere."""
    if device.type != "cuda":
        return None
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}
