"""Generation CLI of the PyTorch/CUDA port (reference
scripts/generate_midi_combined.py; port of musicgen_tpu/cli/generate.py).

  python -m musicgen_tpu_torch.cli.generate --model mamba --length 2000 \
      --ckpt model.pth --data data/np/data --metadata data/metadata.json \
      --composers "Mozart, Chopin" --output out/

--ckpt is a `.pth` state dict in the reference's layout (mamba_ssm's for
--model mamba, the reference Transformer's for --model transformer, NX-AI
xLSTMBlockStack's for --model xlstm, or the port's own), or a checkpoint
directory of `cli.train` (its `model.pth`); the model's width and depth are
read off its shapes. Per composer directory: seed
the sampler with dataset crops and the composer's 6 metadata tokens, generate
--length tokens with the grammar + penalty sampler, decode the last
length+300 tokens and write generated_{band}_{model}_{i}.mid.
--no-metadata zeroes the conditioning; --retain decodes the whole stream;
--decode-skip N decodes stream[N:]; --greedy is deterministic. --sampler
combined|many|top5 picks the sampler mode (sample/sampler.py).
--prompt-len crops the prompts (default: --block-len), and --block-len is
the sampling window (default: the training block, 2048).
--reference-windowing re-forwards the slid window for every token
(sample/sampler.reference_windowed_generate; validation only).

Runs on the GPU (--device cuda, the default; it raises without one) through
the kernels unless --fused-decode off; --device cpu runs the plain versions.
A Transformer's prefill runs kernel D and each token kernel F when the prompt
fills the model's window; an xLSTM's prefill runs kernel H and each token
kernel G. --fused-decode int8 / int8w run the decode kernels on an int8 pack
(W8A8 / W8A16; a Transformer and an xLSTM run W8A16 for both); resident /
resident-int8w run a Mamba model's whole token loop in one kernel launch
(bf16 / W8A16) and the other families' per-token path; sb16 / int8w-sb16
(xLSTM only) store the mLSTM matrix memory in bf16 (bf16 / W8A16 weights).
--sampler many|top5 runs the same kernels' logits step without the sampler
tail, and resident runs the per-token kernels there. A Transformer whose
prompt does not fill its window (--prompt-len below --block-len, or a
--block-len other than its own) runs the plain step after kernel D's
prefill. --reference-windowing runs the model's forward for every token: D
for a Transformer, H for an xLSTM, plain PyTorch for Mamba.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..data.dataset import TokenDataset
from ..interop import family, load_checkpoint, load_model
from ..midi import decode, note_to_midi
from ..sample.sampler import generate, reference_windowed_generate

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
    "sb16": (True, "bf16-sb16", False),
    "int8w-sb16": (True, "int8w-sb16", False),
}
# The JAX CLI's other values, and what they wait for.
_FUSED_NOT_PORTED = {
    "int8w-gptq": "GPTQ calibration (ops/gptq.collect_hessians, ROADMAP queue 1 item 7)",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Composer-conditioned generation (PyTorch/CUDA)")
    p.add_argument("--length", type=int, default=1000)
    p.add_argument("--model", choices=_MODELS, required=True)
    p.add_argument("--ckpt", required=True, help=".pth state dict, or a checkpoint directory")
    p.add_argument("--data", required=True, help="corpus root of band dirs")
    p.add_argument("--metadata", required=True)
    p.add_argument("--output", default="output")
    p.add_argument("--composers", default="", help="comma-separated band names")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--no-metadata", action="store_true")
    p.add_argument("--retain", action="store_true")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--sampler", choices=["combined", "many", "top5"], default="combined",
                   help="combined: tick-window penalty + per-field top-k (scripts/generate.py); many: "
                        "100-token count-penalty argmax (generate_midi_many.py); top5: plain top-5 "
                        "multinomial (generate_midi.py)")
    p.add_argument("--block-len", type=int, default=None,
                   help="the sampling window (default: the training block, 2048)")
    p.add_argument("--prompt-len", type=int, default=None, help="prompt crop length (default: --block-len)")
    p.add_argument("--decode-skip", type=int, default=None,
                   help="decode stream[skip:] instead of the last length+300 tokens")
    p.add_argument("--fused-decode", choices=list(_FUSED) + list(_FUSED_NOT_PORTED), default="auto",
                   help="auto: on the GPU the decode kernels (Mamba without residuals: kernels "
                        "B; Transformer, when the prompt fills its window: kernel F; xLSTM: "
                        "kernel G), else the plain step, and plain PyTorch on the CPU; "
                        "on/off force either; int8 (W8A8; W8A16 for a Transformer or an "
                        "xLSTM) and int8w (W8A16) run them on an int8 pack; resident and "
                        "resident-int8w run a Mamba model's whole loop in one kernel; sb16 "
                        "and int8w-sb16 (xLSTM only) store the mLSTM matrix memory in bf16; "
                        "int8w-gptq is not yet ported")
    p.add_argument("--reference-windowing", action="store_true",
                   help="the reference's semantics: re-forward the slid window for every token "
                        "(O(window) a token; validation only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port generates on the GPU; pass --device cpu to run "
                           "the plain PyTorch versions on the CPU")
    return device


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Runs the CLI; returns {band: (batch, prompt + length) token streams}."""
    args = parse_args(argv)
    if args.fused_decode in _FUSED_NOT_PORTED:
        raise NotImplementedError(
            f"--fused-decode {args.fused_decode} is not yet ported to musicgen_tpu_torch: "
            f"it needs {_FUSED_NOT_PORTED[args.fused_decode]}"
        )
    fused, quant, resident = _FUSED[args.fused_decode]
    device = _device(args.device)
    if quant.endswith("-sb16") and args.model != "xlstm":
        raise ValueError(f"--fused-decode {args.fused_decode} stores the mLSTM matrix memory: --model xlstm only")
    model = load_model(load_checkpoint(args.ckpt), device)
    held = family(model.cfg)
    if held != args.model:
        raise ValueError(f"--ckpt holds a {held} model, not a --model {args.model}")

    if args.composers:
        bands = [b.strip() for b in args.composers.split(",")]
    else:
        bands = sorted(d for d in os.listdir(args.data) if os.path.isdir(os.path.join(args.data, d)))
    block_len = args.block_len or DEFAULT_CONFIG.values.block_len
    prompt_len = args.prompt_len or block_len

    suffix = "_no_meta" if args.no_metadata else ""
    results: Dict[str, np.ndarray] = {}
    for band in bands:
        band_dir = os.path.join(args.data, band)
        if not os.path.isdir(band_dir):
            print(f"skipping {band}: no such directory")
            continue
        ds = TokenDataset.from_directory(band_dir, args.metadata, block_len=prompt_len, seed=args.seed)
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
        if args.reference_windowing:
            streams = reference_windowed_generate(model, src, meta, args.length, block_len, generator,
                                                  greedy=args.greedy, mode=args.sampler)
        else:
            if args.model == "transformer" and src.shape[1] > block_len:
                src = src[:, -block_len:]  # the ring holds block_len positions
            streams = generate(model, args.model, src, meta, args.length, block_len, generator, greedy=args.greedy,
                               mode=args.sampler, fused=fused, quant=quant, resident=resident)
        streams = streams.cpu().numpy()
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
