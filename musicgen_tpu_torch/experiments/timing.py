"""Timing helpers of the probes: host-paced time (the host issues every
launch, as a user's loop does) and device time (the same calls captured in
one CUDA graph and replayed, without the host's launch overhead)."""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (at 700 W)


def device(name: str) -> torch.device:
    """The probes run on the card (`cuda`, which raises without one) or run
    their plain versions on the CPU (`cpu`)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes measure the GPU; pass --device cpu to run the plain "
                           "PyTorch versions on the CPU")
    return dev


def host_ms(fn: Callable, dev: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() in ms over `iters` calls issued by the host: CUDA
    events around them on the card, the host's clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, dev: torch.device, calls: int = 20, replays: int = 5) -> Optional[float]:
    """Device time of fn() in ms: `calls` calls captured in one CUDA graph
    (after a warm-up outside it), replayed `replays` times between CUDA
    events. None on the CPU, which has no such time."""
    if dev.type != "cuda":
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def fmt_us(us: Optional[float]) -> str:
    """A time in us, or "not measured"."""
    return "not measured" if us is None else f"{us:.2f} us"
