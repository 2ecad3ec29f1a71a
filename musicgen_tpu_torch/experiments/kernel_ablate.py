"""Where does a Mamba decode step's device time go? (Port of
experiments/kernel_ablate.py, kernel J.)

    python -m musicgen_tpu_torch.experiments.kernel_ablate [--device cuda|cpu]

The full Mamba stack (MambaConfig(): d_model 1024, 10 mixers, d_inner 2048,
32 heads x 64, d_state 64; seeded random weights) at batch 2, after the
prefill of a 64-token prompt and 6 metadata tokens, runs `steps` decode
steps of four variants of kernel B's step (ops/ablate_kernel.py):

  V_dma    stream every weight byte and the states, no products;
  V_mm     + the two big products a layer;
  V_nossd  the full mixer less the selective-state (SSD) update;
  V_full   kernel B as it is (without the sampler tail).

Each variant is timed host-paced (CUDA events around `steps` steps the host
issues) and on the device (a CUDA graph of 20 steps, replayed). The device
times split a step: streaming (V_dma), the products (V_mm - V_dma), the
epilogues and the conv step (V_nossd - V_mm) and the SSD (V_full -
V_nossd). Every variant reads the same 165.8 MB of bf16 weights a step;
all but V_mm also read and write the 22 MB of f32 states (V_mm leaves them
as they are). The module does nothing when imported; `run(...)` takes any
config, size and device (on the CPU every kernel takes its plain version and
there is no device time).
"""
from __future__ import annotations

import argparse
import collections
from typing import List, Optional

import numpy as np
import torch

from ..config import NUM_META, MambaConfig
from ..models.mamba import empty_model, init_weights_
from ..ops import ablate_kernel as ak
from ..ops import decode_kernel as dk
from .timing import HBM_BYTES_PER_S, device, fmt_us, graph_ms, host_ms

BATCH, PROMPT, STEPS = 2, 64, 500  # the JAX script's sizes
MODES = ("dma", "mm", "nossd", "full")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def counts() -> collections.Counter:
    """Launch counters of kernels B and J together."""
    return collections.Counter({**dk.LAUNCHES, **ak.LAUNCHES})


def setup(dev: torch.device, cfg: MambaConfig, batch: int, prompt_len: int, seed: int) -> dict:
    """The model, its decode pack, the prefill's states and the step's
    tokens (5 and 7 at batch 2, as the JAX script's embed[[5, 7]])."""
    model = init_weights_(empty_model(cfg, dev), seed).eval()
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    meta = torch.from_numpy(rng.integers(0, cfg.metadata_vocab_size, (batch, NUM_META))).to(dev)
    with torch.no_grad():
        _, states = model.prefill(prompt, meta)
    return {"dp": dk.build_decode_params(model, batch), "dims": dk.DecodeDims.create(cfg, batch),
            "carry": dk.stack_states(states), "token": torch.arange(batch, device=dev) * 2 + 5}


def run(device_name: str = "cuda", cfg: Optional[MambaConfig] = None, batch: int = BATCH, prompt_len: int = PROMPT,
        steps: int = STEPS, seed: int = 0, verbose: bool = True) -> dict:
    """Time the four variants; returns (and prints, if verbose) the numbers.

    Keys: "device", "bytes_weights", "bytes_states" (read and written), and
    per variant: "launches" (one step's, by kernel), "us_step" host-paced,
    "plain_us_step" (its chain of plain versions, host-paced),
    "graph_us_step" (None on the CPU), "bytes_step", "bound_us_step",
    "gbs"; "split" (us of the device step, None on the CPU)."""
    cfg = cfg or MambaConfig()
    dev = device(device_name)
    ctx = setup(dev, cfg, batch, prompt_len, seed)
    dp, dims, token = ctx["dp"], ctx["dims"], ctx["token"]
    weights = nbytes(*(dp[k] for k in ("w_in", "w_out", "lm_w")))
    states = 2 * nbytes(*ctx["carry"])
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": batch, "steps": steps, "bytes_weights": weights, "bytes_states": states}
    with torch.no_grad():
        for mode in MODES:
            carry = tuple(t.clone() for t in ctx["carry"])
            plain_carry = tuple(t.clone() for t in ctx["carry"])

            def step(ops=ak.VARIANTS[mode]):
                return dk.decode_logits(dp, token, carry, dims, ops=ops)

            def plain_step(ops=ak.PLAIN_VARIANTS[mode]):
                return dk.decode_logits(dp, token, plain_carry, dims, ops=ops)

            before = counts()
            logits = step()
            launches = dict(counts() - before)
            if dev.type == "cuda" and launches != ak.step_launches(mode, cfg.n_layers):
                raise RuntimeError(f"V_{mode}: one step launched {launches}, expected "
                                   f"{ak.step_launches(mode, cfg.n_layers)}")
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"V_{mode}: non-finite logits")
            host = host_ms(step, dev, steps)
            plain = host_ms(plain_step, dev, max(3, steps // 10))
            dev_ms = graph_ms(step, dev)
            moved = weights + (0 if mode == "mm" else states)
            out[mode] = {"launches": launches, "us_step": 1e3 * host, "plain_us_step": 1e3 * plain,
                         "graph_us_step": None if dev_ms is None else 1e3 * dev_ms, "bytes_step": moved,
                         "bound_us_step": 1e6 * moved / HBM_BYTES_PER_S,
                         "gbs": None if dev_ms is None else moved / (1e6 * dev_ms)}
    g = {m: out[m]["graph_us_step"] for m in MODES}
    out["split"] = None if g["full"] is None else {
        "streaming": g["dma"], "products": g["mm"] - g["dma"], "epilogues_conv": g["nossd"] - g["mm"],
        "ssd": g["full"] - g["nossd"]}
    if verbose:
        report(out)
    return out


def report(out: dict) -> None:
    print(f"kernel_ablate on {out['device']}: Mamba, {out['n_layers']} mixers, d_model {out['d_model']}, batch "
          f"{out['batch']}; {out['bytes_weights']:,} B of bf16 weights and {out['bytes_states']:,} B of state "
          f"moves a step", flush=True)
    for mode in MODES:
        r = out[mode]
        rate = "not measured" if r["gbs"] is None else \
            f"{r['gbs']:.1f} GB/s ({100 * r['gbs'] * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)"
        print(f"  V_{mode:6s} {sum(r['launches'].values())} launches {r['launches']}: host-paced "
              f"{r['us_step']:.2f} us/step (plain {r['plain_us_step']:.2f}), device (CUDA graph) "
              f"{fmt_us(r['graph_us_step'])} a step, {rate}; bound {r['bound_us_step']:.2f} us",
              flush=True)
    if out["split"] is not None:
        s = out["split"]
        print(f"  device step split: streaming {s['streaming']:.2f} us, products {s['products']:.2f} us, epilogues "
              f"and conv {s['epilogues_conv']:.2f} us, SSD {s['ssd']:.2f} us", flush=True)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="ablation of the Mamba decode step (kernel J) at the JAX script's size")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    args = p.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
