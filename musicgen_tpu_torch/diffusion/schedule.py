"""Diffusion noise schedules and the RePaint resampling (jump) schedule.

A numpy copy of musicgen_tpu/diffusion/schedule.py (the reference's
diffusion/gaussian_diffusion.py:33-55 `get_named_beta_schedule`, linear
and cosine, and diffusion/scheduler.py:17-147 `get_schedule_jump` /
`_check_times`), kept in step with it; tests/test_torch_diffusion_numpy.py
holds the two equal. The port imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np


def linear_betas(num_timesteps: int) -> np.ndarray:
    """Scaled-linear schedule (gaussian_diffusion.py:44-50): endpoints are
    defined for T=1000 and rescaled for other T."""
    scale = 1000.0 / num_timesteps
    betas = np.linspace(
        scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64
    )
    # Guard: for very small T the rescaled endpoint reaches 1.0, which makes
    # alpha_bar hit exactly zero and every 1/alpha_bar coefficient inf.
    return np.clip(betas, 0.0, 0.999)


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Improved-DDPM cosine schedule."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


def named_betas(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(num_timesteps)
    if name == "cosine":
        return cosine_betas(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def check_times(times: List[int], t_0: int, t_T: int) -> None:
    """Validate a resampling sequence: +/-1 steps, in range, ends below t_0
    (reference scheduler.py:4-15 `_check_times`)."""
    assert times[0] > times[1], (times[0], times[1])
    assert times[-1] == -1, times[-1]
    for t_last, t_cur in zip(times[:-1], times[1:]):
        assert abs(t_last - t_cur) == 1, (t_last, t_cur)
    for t in times:
        assert t >= t_0 - 1, (t, t_0)
        assert t <= t_T, (t, t_T)


def get_schedule_jump(
    t_T: int,
    n_sample: int,
    jump_length: int,
    jump_n_sample: int,
    jump2_length: int = 1,
    jump2_n_sample: int = 1,
    jump3_length: int = 1,
    jump3_n_sample: int = 1,
    start_resampling: int = 100_000_000,
) -> List[int]:
    """RePaint resampling time sequence (reference scheduler.py:17-147):
    descend from t_T-1; every `jump_length` steps (below start_resampling)
    re-ascend `jump_length` steps `jump_n_sample`-1 extra times, with
    optional nested jump2/jump3 ladders."""
    jumps = {}
    for j in range(0, t_T - jump_length, jump_length):
        jumps[j] = jump_n_sample - 1
    jumps2 = {}
    for j in range(0, t_T - jump2_length, jump2_length):
        jumps2[j] = jump2_n_sample - 1
    jumps3 = {}
    for j in range(0, t_T - jump3_length, jump3_length):
        jumps3[j] = jump3_n_sample - 1

    t = t_T
    ts: List[int] = []
    while t >= 1:
        t = t - 1
        ts.append(t)
        if t + 1 < t_T - 1 and t <= start_resampling:
            for _ in range(n_sample - 1):
                t = t + 1
                ts.append(t)
                if t >= 0:
                    t = t - 1
                    ts.append(t)
        if jumps3.get(t, 0) > 0 and t_T - t > jump3_length and t <= start_resampling:
            jumps3[t] -= 1
            for _ in range(jump3_length):
                t = t + 1
                ts.append(t)
        if jumps2.get(t, 0) > 0 and t_T - t > jump2_length and t <= start_resampling:
            jumps2[t] -= 1
            for _ in range(jump2_length):
                t = t + 1
                ts.append(t)
            jumps3 = {
                j: jump3_n_sample - 1
                for j in range(0, t_T - jump3_length, jump3_length)
            }
        if jumps.get(t, 0) > 0 and t_T - t > jump_length and t <= start_resampling:
            jumps[t] -= 1
            for _ in range(jump_length):
                t = t + 1
                ts.append(t)
            jumps2 = {
                j: jump2_n_sample - 1
                for j in range(0, t_T - jump2_length, jump2_length)
            }
            jumps3 = {
                j: jump3_n_sample - 1
                for j in range(0, t_T - jump3_length, jump3_length)
            }
    ts.append(-1)
    check_times(ts, -1, t_T)
    return ts
