"""Profiling and observability helpers (port of musicgen_tpu/utils/profiling.py):
a torch.profiler trace, a step-time meter with tokens/s, and each card's
memory.

  with trace("logs/trace"):   # a Chrome/Perfetto trace file in logs/trace
      run_steps()
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (the host's ops, and the card's kernels where CUDA
    is available) and write its trace into `log_dir` as
    `<host>_<pid>.<ms>.pt.trace.json`, which Perfetto and TensorBoard read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling step-time / throughput meter: tick() once a step; the rates
    average the last `window` intervals between ticks (host clock)."""

    def __init__(self, tokens_per_step: int = 0, window: int = 50):
        self.tokens_per_step = tokens_per_step
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return 1.0 / (sum(self.times) / len(self.times))

    @property
    def tokens_per_sec(self) -> float:
        return self.steps_per_sec * self.tokens_per_step

    def stats(self) -> Dict[str, float]:
        return {
            "steps_per_sec": self.steps_per_sec,
            "tokens_per_sec": self.tokens_per_sec,
            "mean_step_ms": 1e3 * (np.mean(self.times) if self.times else 0.0),
        }


def device_memory() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    each visible card (torch's allocator: bytes allocated now and at their
    peak since the last reset; the card's total memory), {} without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
        }
    return out
