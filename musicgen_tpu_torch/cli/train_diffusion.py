"""Diffusion training CLI of the PyTorch/CUDA port (port of
musicgen_tpu/cli/train_diffusion.py: the workload the reference cannot
train, its gaussian_diffusion.py lacking training_losses).

  python -m musicgen_tpu_torch.cli.train_diffusion --data data/np \
      --steps 10000 --width 128 [--ckpt DIR] [--device cpu]

Canvases are built from the token corpus (the first 4,000 tokens of each of
--max-files files, decoded to a piano roll, diffusion/canvas.py),
normalised to [-1, 1] and cropped at random to --width columns. The UNet is
DEFAULTS (the JAX CLI's DiffusionDefaults(image_size=128), 95.0M
parameters), initialised from --seed, and computes in bf16 (--bf16 is on
whatever is passed, as the JAX CLI's store_true flag with default True);
its parameters, Adam state and loss stay f32. Training runs on the GPU
(--device cuda, the default; it raises without one); --device cpu runs the
same plain PyTorch on the CPU. --ckpt DIR writes DIR/diffusion.pth,
{"params": state_dict, "ema": state_dict}, which cli.inpaint reads.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from ..data.dataset import find_token_files
from ..diffusion import (
    DiffusionDefaults,
    RandomSnippet,
    create_canvas,
    create_model_and_diffusion,
    normalize_canvas,
    train_diffusion,
)
from ..interop import DIFFUSION_FILE
from ..midi import decode
from .train import cli_device

DEFAULTS = DiffusionDefaults(image_size=128)  # the UNet this CLI trains


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the diffusion UNet (PyTorch/CUDA)")
    p.add_argument("--data", required=True, help=".npy token corpus root")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--width", type=int, default=128, help="canvas time width")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-files", type=int, default=200)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--ckpt", default=None, help="directory to save {params, ema} (diffusion.pth)")
    p.add_argument("--ema-rate", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the same plain PyTorch)")
    return p.parse_args(argv)


def build_canvases(data: str, max_files: int) -> list:
    """The normalised canvases of the corpus's first max_files token files."""
    canvases = []
    for path in find_token_files(data)[:max_files]:
        tokens = np.load(path)
        notes = decode([int(t) for t in tokens[:4000]])
        if notes:
            canvases.append(normalize_canvas(create_canvas(notes)))
    return canvases


def main(argv: Optional[List[str]] = None):
    """Runs the CLI; returns (params, ema), the final state dicts."""
    args = parse_args(argv)
    device = cli_device(args.device)
    canvases = build_canvases(args.data, args.max_files)
    print(f"built {len(canvases)} canvases")

    model, diffusion = create_model_and_diffusion(DEFAULTS, torch.bfloat16 if args.bf16 else torch.float32,
                                                  device, args.seed)
    snippets = RandomSnippet(canvases, width=args.width, seed=args.seed)

    def batches():
        while True:
            yield snippets.sample(args.batch)

    params, ema = train_diffusion(model, diffusion, batches(), num_steps=args.steps, learning_rate=args.lr,
                                  seed=args.seed, ema_rate=args.ema_rate, return_ema=True)
    if args.ckpt:
        path = os.path.abspath(args.ckpt)
        os.makedirs(path, exist_ok=True)
        torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                    "ema": {k: v.detach().cpu() for k, v in ema.items()}}, os.path.join(path, DIFFUSION_FILE))
        print(f"saved params + EMA to {path}")
    return params, ema


if __name__ == "__main__":
    main()
