"""RePaint inpainting CLI of the PyTorch/CUDA port (port of
musicgen_tpu/cli/inpaint.py): MIDI -> canvas -> masked RePaint -> MIDI.

  python -m musicgen_tpu_torch.cli.inpaint --ckpt ckpt_dir --midi in.mid \
      --out inpainted.mid [--mask-start 32 --mask-end 96] [--ema] \
      [--respacing ddim25] [--jumps] [--device cpu]

Pipeline: extract_midi -> create_canvas -> normalize -> pad with -1 and crop
to --width columns from --offset -> a keep mask that zeroes the columns
[--mask-start, --mask-end) -> RePaint over the --respacing chain (with
--jumps the jump ladder: jump length 10, 10 samples) -> denormalize ->
canvas_to_notes -> note_to_midi. The UNet is DEFAULTS with --respacing, in
bf16 as in the JAX CLI, with the weights in --ckpt's diffusion.pth (the
directory cli.train_diffusion --ckpt writes): "params", or "ema" with
--ema. The draws
come from one torch.Generator seeded with --seed. Runs on the GPU
(--device cuda, the default; it raises without one); --device cpu runs the
same plain PyTorch on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..diffusion import (
    DiffusionDefaults,
    RePaintConf,
    canvas_to_notes,
    create_canvas,
    create_model_and_diffusion,
    denormalize_canvas,
    normalize_canvas,
)
from ..interop import DIFFUSION_FILE
from ..midi import extract_midi, note_to_midi
from .train import cli_device

DEFAULTS = DiffusionDefaults()  # the UNet this CLI samples (cli.train_diffusion's)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RePaint MIDI inpainting (PyTorch/CUDA)")
    p.add_argument("--ckpt", required=True, help="train_diffusion --ckpt dir")
    p.add_argument("--midi", required=True, help="input MIDI file")
    p.add_argument("--out", required=True, help="output MIDI path")
    p.add_argument("--width", type=int, default=128, help="canvas time width")
    p.add_argument("--offset", type=int, default=0, help="crop start column")
    p.add_argument("--mask-start", type=int, default=None,
                   help="first masked (regenerated) time column; default W/4")
    p.add_argument("--mask-end", type=int, default=None,
                   help="one past the last masked column; default 3W/4")
    p.add_argument("--respacing", default="ddim25", help="timestep respacing ('' = all 1000 steps)")
    p.add_argument("--jumps", action="store_true",
                   help="full RePaint jump schedule (jump length 10, 10 samples) instead of a plain reverse pass")
    p.add_argument("--ema", action="store_true", help="sample with the EMA parameters")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the same plain PyTorch)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    """Runs the CLI; returns the notes written to --out."""
    args = parse_args(argv)
    device = cli_device(args.device)
    notes = extract_midi(args.midi)
    if not notes:
        raise SystemExit(f"no notes extracted from {args.midi}")
    canvas = normalize_canvas(create_canvas(notes))
    w = args.width
    if canvas.shape[-1] < w:
        canvas = np.pad(canvas, ((0, 0), (0, 0), (0, w - canvas.shape[-1])), constant_values=-1.0)
    gt = canvas[None, :, :, args.offset: args.offset + w].astype(np.float32)

    m0 = args.mask_start if args.mask_start is not None else w // 4
    m1 = args.mask_end if args.mask_end is not None else 3 * w // 4
    keep = np.ones_like(gt)
    keep[:, :, :, m0:m1] = 0.0  # regenerate these time columns

    model, diffusion = create_model_and_diffusion(dataclasses.replace(DEFAULTS, timestep_respacing=args.respacing),
                                                  torch.bfloat16, device)
    raw = torch.load(os.path.join(args.ckpt, DIFFUSION_FILE), map_location="cpu", weights_only=True)
    model.load_state_dict(raw["ema"] if args.ema else raw["params"], strict=True)
    model.eval()

    times = None
    if args.jumps:
        conf = RePaintConf(schedule_jump_params=dict(
            t_T=diffusion.num_timesteps, n_sample=1, jump_length=10, jump_n_sample=10,
        ))
        times = conf.jump_times()

    generator = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        out = diffusion.p_sample_loop_scan(model, gt.shape, generator, gt=torch.from_numpy(gt).to(device),
                                           gt_keep_mask=torch.from_numpy(keep).to(device), times=times)
    out_notes = canvas_to_notes(denormalize_canvas(out[0].cpu().numpy()))
    note_to_midi(out_notes, args.out)
    print(f"inpainted columns [{m0}, {m1}) -> {args.out} ({len(out_notes)} notes)")
    return out_notes


if __name__ == "__main__":
    main()
