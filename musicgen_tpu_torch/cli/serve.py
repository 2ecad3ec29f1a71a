"""Serving CLI of the PyTorch/CUDA port: continuous-batching generation over
a request list (port of musicgen_tpu/cli/serve.py).

  python -m musicgen_tpu_torch.cli.serve --model mamba --ckpt model.pth \
      --data data/np/data --metadata data/metadata.json \
      --requests '[{"composer": "Bach", "length": 2000},
                   {"composer": "Mozart", "length": 500, "seed": 3}]' \
      --output served/ [--slots 8 --chunk 32 --stats served/stats.json]

--requests takes inline JSON or a path to a JSON file: a list of
{"composer", "length", "seed"?} objects. Each request's prompt is a crop of
its composer's dataset, as in cli.generate; serve.BatchScheduler streams
them through a pool of --slots slots, --chunk tokens at a time. Each
completed request decodes to MIDI (`served_{composer}_{model}_{rid}.mid`),
and --stats writes the per-request latency accounting (queue wait, time to
first chunk, wall, tok/s) and the aggregate throughput.

--ckpt is read as cli.generate reads it (a `.pth` state dict in the
reference's or the port's layout, or a `cli.train` checkpoint directory).
The weights stay f32 for the plain steps, and the kernels take their bf16
or int8 packs (--quant); the JAX CLI casts its params to bf16 on an
accelerator instead. Runs on the GPU (--device cuda, the default; it raises
without one): a Mamba model's chunk through kernel B's logits step (B' for
--quant int8 / int8w), an xLSTM's through kernel G's, a Transformer's
through its plain step; each admission prefills through kernel A, D or H.
--device cpu runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

from ..config import DEFAULT_CONFIG
from ..data.dataset import TokenDataset
from ..interop import family, load_checkpoint, load_model
from ..midi import decode, note_to_midi
from ..serve import BatchScheduler
from .generate import _device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Continuous-batching serving (PyTorch/CUDA)")
    p.add_argument("--model", choices=["mamba", "xlstm", "transformer"], required=True)
    p.add_argument("--ckpt", required=True, help=".pth state dict, or a checkpoint directory")
    p.add_argument("--data", required=True, help="corpus root of band dirs")
    p.add_argument("--metadata", required=True)
    p.add_argument("--requests", required=True, help="inline JSON list or a path to a JSON file")
    p.add_argument("--output", default="served")
    p.add_argument("--stats", default=None, help="write latency JSON here")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=None)
    p.add_argument("--block-len", type=int, default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--quant", choices=["bf16", "int8w", "int8", "bf16-sb16", "int8w-sb16"], default="bf16",
                   help="decode numerics of the kernels; '-sb16' (xlstm) also stores the mLSTM matrix memory "
                        "in bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the CLI; returns the --stats object, plus each request's tokens
    ("tokens": {rid: np.ndarray}), its composer ("bands": {rid: name}) and
    the scheduler ("scheduler")."""
    args = parse_args(argv)
    if os.path.exists(args.requests):
        with open(args.requests) as fh:
            reqs = json.load(fh)
    else:
        reqs = json.loads(args.requests)
    if not isinstance(reqs, list) or not reqs:
        raise SystemExit("--requests must be a non-empty JSON list")
    device = _device(args.device)
    model = load_model(load_checkpoint(args.ckpt), device)
    held = family(model.cfg)
    if held != args.model:
        raise ValueError(f"--ckpt holds a {held} model, not a --model {args.model}")
    block_len = args.block_len or DEFAULT_CONFIG.values.block_len
    prompt_len = args.prompt_len or block_len
    sched = BatchScheduler(model, args.model, prompt_len=prompt_len, slots=args.slots, chunk=args.chunk,
                           block_len=block_len, greedy=args.greedy, quant=args.quant)

    # Each request's prompt is a random crop of its composer's dataset, as in
    # cli.generate; everything is submitted up front.
    ds_cache, rid_band = {}, {}
    for i, r in enumerate(reqs):
        band = r["composer"]
        if band not in ds_cache:
            band_dir = os.path.join(args.data, band)
            if not os.path.isdir(band_dir):
                raise SystemExit(f"no such composer directory: {band_dir}")
            ds_cache[band] = TokenDataset.from_directory(band_dir, args.metadata, block_len=prompt_len,
                                                         crop="random", seed=args.seed + i)
        ds = ds_cache[band]
        src, _, meta = ds[i % len(ds)]
        rid = sched.submit(np.asarray(src[:prompt_len]), np.asarray(meta), int(r["length"]),
                           seed=int(r.get("seed", args.seed + i)))
        rid_band[rid] = band

    t0 = time.perf_counter()
    results = sched.run()
    wall = time.perf_counter() - t0
    total = sum(int(r["length"]) for r in reqs)

    os.makedirs(args.output, exist_ok=True)
    for rid, toks in results.items():
        band = rid_band[rid]
        notes = decode([int(t) for t in toks])
        path = os.path.join(args.output, f"served_{band}_{args.model}_{rid}.mid")
        note_to_midi(notes, path)
        print(f"  wrote {path} ({len(notes)} notes)", flush=True)

    agg = {
        "requests": len(reqs),
        "total_tokens": total,
        "wall_s": wall,
        "aggregate_tok_per_s": total / wall,
        "per_request": {str(k): v for k, v in sched.stats().items()},
    }
    print(f"served {len(reqs)} requests / {total} tokens in {wall:.1f}s = {total / wall:,.0f} tok/s aggregate",
          flush=True)
    if args.stats:
        with open(args.stats, "w") as fh:
            json.dump(agg, fh, indent=2)
    return {**agg, "tokens": results, "bands": rid_band, "scheduler": sched}


if __name__ == "__main__":
    main()
