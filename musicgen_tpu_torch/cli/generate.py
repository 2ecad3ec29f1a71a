"""Generation CLI of the PyTorch/CUDA port (reference
scripts/generate_midi_combined.py; port of musicgen_tpu/cli/generate.py).

  python -m musicgen_tpu_torch.cli.generate --model mamba --length 2000 \
      --ckpt model.pth --data data/np/data --metadata data/metadata.json \
      --composers "Mozart, Chopin" --output out/

--ckpt is a `.pth` state dict in the reference's mamba_ssm layout; the model's
width and depth are read off its shapes. Per composer directory: seed the
sampler with dataset crops and the composer's 6 metadata tokens, generate
--length tokens with the grammar + penalty sampler, decode the last
length+300 tokens and write generated_{band}_{model}_{i}.mid.
--no-metadata zeroes the conditioning; --retain decodes the whole stream;
--decode-skip N decodes stream[N:]; --greedy is deterministic.

Runs on the GPU when there is one (decode kernels unless --fused-decode off),
else on the CPU with the plain versions. --fused-decode int8 / int8w run the
decode kernels on an int8 pack (W8A8 / W8A16); resident / resident-int8w
run the whole token loop in one kernel launch (bf16 / W8A16).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..data.dataset import TokenDataset
from ..interop import load_checkpoint, load_model
from ..midi import decode, note_to_midi
from ..sample.sampler import generate

_MODELS = ["mamba", "xlstm", "transformer"]
# --fused-decode value -> (fused, quant, resident), as musicgen_tpu/cli/generate.py maps them.
_FUSED = {
    "auto": (None, "bf16", False),
    "on": (True, "bf16", False),
    "off": (False, "bf16", False),
    "int8": (True, "int8", False),
    "int8w": (True, "int8w", False),
    "resident": (True, "bf16", True),
    "resident-int8w": (True, "int8w", True),
}
# The JAX CLI's other values, and what they wait for.
_FUSED_NOT_PORTED = {
    "int8w-gptq": "GPTQ calibration (ops/gptq.collect_hessians, ROADMAP queue 1 item 12)",
    "sb16": "bf16 storage of the xLSTM matrix memory (the xLSTM family)",
    "int8w-sb16": "bf16 storage of the xLSTM matrix memory (the xLSTM family)",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Composer-conditioned generation (PyTorch/CUDA)")
    p.add_argument("--length", type=int, default=1000)
    p.add_argument("--model", choices=_MODELS, required=True)
    p.add_argument("--ckpt", required=True, help=".pth state dict in reference layout")
    p.add_argument("--data", required=True, help="corpus root of band dirs")
    p.add_argument("--metadata", required=True)
    p.add_argument("--output", default="output")
    p.add_argument("--composers", default="", help="comma-separated band names")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--no-metadata", action="store_true")
    p.add_argument("--retain", action="store_true")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--block-len", type=int, default=None,
                   help="prompt crop length (default: the training block, 2048)")
    p.add_argument("--decode-skip", type=int, default=None,
                   help="decode stream[skip:] instead of the last length+300 tokens")
    p.add_argument("--fused-decode", choices=list(_FUSED) + list(_FUSED_NOT_PORTED), default="auto",
                   help="auto: decode kernels on the GPU, plain PyTorch on the CPU; "
                        "on/off force either; int8 (W8A8) and int8w (W8A16) run them on "
                        "an int8 pack; resident and resident-int8w run the whole loop "
                        "in one kernel; int8w-gptq, sb16 and int8w-sb16 are not yet ported")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Runs the CLI; returns {band: (batch, prompt + length) token streams}."""
    args = parse_args(argv)
    if args.model != "mamba":
        raise NotImplementedError(f"--model {args.model} is not yet ported to musicgen_tpu_torch")
    if args.fused_decode in _FUSED_NOT_PORTED:
        raise NotImplementedError(
            f"--fused-decode {args.fused_decode} is not yet ported to musicgen_tpu_torch: "
            f"it needs {_FUSED_NOT_PORTED[args.fused_decode]}"
        )
    fused, quant, resident = _FUSED[args.fused_decode]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    model = load_model(load_checkpoint(args.ckpt), device)

    if args.composers:
        bands = [b.strip() for b in args.composers.split(",")]
    else:
        bands = sorted(d for d in os.listdir(args.data) if os.path.isdir(os.path.join(args.data, d)))
    block_len = args.block_len or DEFAULT_CONFIG.values.block_len

    suffix = "_no_meta" if args.no_metadata else ""
    results: Dict[str, np.ndarray] = {}
    for band in bands:
        band_dir = os.path.join(args.data, band)
        if not os.path.isdir(band_dir):
            print(f"skipping {band}: no such directory")
            continue
        ds = TokenDataset.from_directory(band_dir, args.metadata, block_len=block_len, seed=args.seed)
        if len(ds) < 2:
            print(f"Skipping {band} (not enough files: {len(ds)})")
            continue
        out_dir = os.path.join(args.output, f"{args.model}{suffix}", band)
        os.makedirs(out_dir, exist_ok=True)

        items = [ds[i % len(ds)] for i in range(args.batch)]
        src = torch.from_numpy(np.stack([s for s, _, _ in items]).astype(np.int64)).to(device)
        meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(device)
        if args.no_metadata:
            meta = torch.zeros_like(meta)

        print(f"Processing band: {band}")
        generator = torch.Generator(device=device).manual_seed(args.seed)
        streams = generate(
            model, args.model, src, meta, args.length, block_len, generator,
            greedy=args.greedy, fused=fused, quant=quant, resident=resident,
        ).cpu().numpy()
        results[band] = streams
        for i in range(streams.shape[0]):
            if args.decode_skip is not None:
                toks = streams[i][args.decode_skip:]
            elif args.retain:
                toks = streams[i]
            else:
                toks = streams[i][-(args.length + 300):]
            notes = decode([int(t) for t in toks])
            path = os.path.join(out_dir, f"generated_{band}_{args.model}_{i}.mid")
            note_to_midi(notes, path)
            print(f"  wrote {path} ({len(notes)} notes)")
    return results


if __name__ == "__main__":
    main()
