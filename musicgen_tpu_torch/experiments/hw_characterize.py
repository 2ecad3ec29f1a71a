"""Can a hand-written kernel stream bf16 weights at the memory's rate for
the few rows of a decode step? (Port of experiments/hw_characterize.py,
kernel I.)

    python -m musicgen_tpu_torch.experiments.hw_characterize [--device cuda|cpu]

A step chains ten products y = bf16(x) @ W_i (x (8, 1024) f32, the batch in
rows 0-1; each W_i (1024, 4352) bf16, the Mamba in_proj's padded width,
seeded normal x 0.01), with x = tanh(y[:, :1024]) between them in plain
torch, as the JAX script has it outside its kernel. Ten matrices are 89 MB,
more than the H100's 50 MB L2, so the chain reads them from device memory.
The same chain runs through:

  probe_mm       kernel I (csrc/probe_mm.cu), W as (N, K);
  decode GEMV    the port's decode GEMV (mg_x_gemv, plain prologue, store;
                 the device code of kernels B, F and G), the same W;
  f32 matmul     x @ W with torch.matmul on the f32 weights in the JAX
                 layout (K, N) (178 MB a step): the script's XLA f32
                 comparison;
  library bf16   F.linear on bf16 x and the bf16 W (cuBLAS), the yardstick.

Each is timed host-paced (CUDA events around `steps` steps the host issues)
and on the device (a CUDA graph of 20 steps, replayed), and reported in us a
step and GB/s of weights against 3.35 TB/s. One launch of each kernel on one
W, whose 8.9 MB then stay in L2, is timed too, at 1, 2 and M rows of x,
and labelled so. The module
does nothing when imported; `run(...)` takes any size and device (on the CPU
every kernel takes its plain version and there is no device time).
"""
from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops import probe_kernel as pk
from ..ops import xdecode_kernel as xk
from .timing import HBM_BYTES_PER_S, device, fmt_us, graph_ms, host_ms

M, K, N, N_MATS, STEPS = 8, 1024, 4352, 10, 500  # the JAX script's sizes


def make_weights(n_mats: int, k: int, n: int, seed: int = 0) -> np.ndarray:
    """(n_mats, K, N) f32 normal x 0.01 from numpy's seeded generator, in
    the JAX script's layout; the port and the tests round them to bf16 (and
    transpose them to (N, K) for the kernels)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.01) for _ in range(n_mats)])


def chain(x: torch.Tensor, weights, mm: Callable) -> torch.Tensor:
    """One step: x = tanh(mm(x, W)[:, :K]) for each W in turn."""
    k = x.shape[1]
    for w in weights:
        x = torch.tanh(mm(x, w)[:, :k]).contiguous()
    return x


def _gemv(x, w):
    return xk.gemv(x, w, None)


def _library(x, w):
    return torch.nn.functional.linear(x.to(torch.bfloat16), w).to(torch.float32)


def run(device_name: str = "cuda", m: int = M, k: int = K, n: int = N, n_mats: int = N_MATS, steps: int = STEPS,
        seed: int = 0, verbose: bool = True) -> dict:
    """Time the four chains; returns (and prints, if verbose) the numbers.

    Keys: "device", the sizes, "bytes_step" (bf16 weights a step),
    "bound_us_step", "chain_max_abs_err" (kernel I's step against its plain
    version's, from the same x), and per chain ("probe_mm", "decode_gemv",
    "f32_matmul", "library_bf16"): "us_step" host-paced, "graph_us_step"
    and "gbs" from the CUDA graph (None on the CPU), "bytes_step"; the two
    kernels also "launch_l2_us", {rows of x: us of one launch on one W from
    a CUDA graph} at 1, 2 and m rows."""
    dev = device(device_name)
    w32 = torch.from_numpy(make_weights(n_mats, k, n, seed)).to(dev)  # (n_mats, K, N)
    wt = w32.to(torch.bfloat16).transpose(1, 2).contiguous()  # (n_mats, N, K): the kernels' layout
    x0 = torch.ones(m, k, dtype=torch.float32, device=dev)
    chains = {
        "probe_mm": (pk.probe_mm, list(wt), 2),
        "decode_gemv": (_gemv, list(wt), 2),
        "f32_matmul": (torch.matmul, list(w32), 4),
        "library_bf16": (_library, list(wt), 2),
    }
    bytes_step = n_mats * k * n * 2
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "m": m, "k": k, "n": n,
           "n_mats": n_mats, "steps": steps, "bytes_step": bytes_step,
           "bound_us_step": 1e6 * bytes_step / HBM_BYTES_PER_S}
    with torch.no_grad():
        got = chain(x0, wt, pk.probe_mm)
        want = chain(x0, wt, pk.probe_mm_plain)
        out["chain_max_abs_err"] = float((got - want).abs().max())
        for name, (mm, ws, elt) in chains.items():
            host = host_ms(lambda: chain(x0, ws, mm), dev, steps)
            dev_ms = graph_ms(lambda: chain(x0, ws, mm), dev)
            nb = n_mats * k * n * elt
            r = {"us_step": 1e3 * host, "graph_us_step": None if dev_ms is None else 1e3 * dev_ms,
                 "bytes_step": nb, "gbs": None if dev_ms is None else nb / (1e6 * dev_ms)}
            if name in ("probe_mm", "decode_gemv"):
                r["launch_l2_us"] = {}
                for rows in sorted({1, 2, m}):
                    xr = x0[:rows].contiguous()
                    one = graph_ms(lambda: mm(xr, ws[0]), dev, calls=50)
                    r["launch_l2_us"][rows] = None if one is None else 1e3 * one
            out[name] = r
    if verbose:
        report(out)
    return out


def report(out: dict) -> None:
    print(f"hw_characterize on {out['device']}: x ({out['m']}, {out['k']}) f32, {out['n_mats']} products a step "
          f"with W ({out['k']}, {out['n']}); {out['bytes_step'] / 1e6:.1f} MB of bf16 weights a step, bound "
          f"{out['bound_us_step']:.2f} us at 3.35 TB/s; kernel I's step against its plain version: max abs "
          f"{out['chain_max_abs_err']:.3e}", flush=True)
    for name in ("probe_mm", "decode_gemv", "f32_matmul", "library_bf16"):
        r = out[name]
        rate = "not measured" if r["gbs"] is None else \
            f"{r['gbs']:.1f} GB/s ({100 * r['gbs'] * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)"
        line = (f"  {name:13s} {r['bytes_step'] / 1e6:6.1f} MB/step: host-paced {r['us_step']:.2f} us/step, "
                f"device (CUDA graph) {fmt_us(r['graph_us_step'])} a step, {rate}")
        if "launch_l2_us" in r:
            line += "; one launch, W in L2: " + ", ".join(f"{fmt_us(t)} at M = {rows}"
                                                         for rows, t in r["launch_l2_us"].items())
        print(line, flush=True)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="bf16 weight-streaming probe (kernel I) at the JAX script's size")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    args = p.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
