"""Training CLI of the PyTorch/CUDA port (reference train.py; port of
musicgen_tpu/cli/train.py, single device).

  python -m musicgen_tpu_torch.cli.train --model transformer --data data/np \
      --metadata data/metadata.json [--resume CKPT] [--epochs N] [--block-len N]

Without --resume the family's full-width default config is built and
initialised from --seed (init_weights_); --resume takes a checkpoint
directory written by this CLI (its `model.pth`) or a bare `.pth` in the
reference layout, whose shapes give the model's config. Resuming restores
the weights only: Adam starts fresh at step 0, as the JAX CLI does
(musicgen_tpu/cli/train.py keeps only the restored params). The directory's
`optimizer.pth` is written but not read back.
Training runs on the GPU (--device cuda, the default; it raises without one):
a Transformer's attention through kernels D (with its LSE output) and E with
--attention auto or flash, the plain f32 attention with xla; a Mamba model
and an xLSTM through their plain scans (an xLSTM's validation forward, under
no_grad, through kernel H). --device cpu runs the plain versions. Dropout and
augmentation are seeded from --seed. Each run ends with a checkpoint
directory in --ckpt-dir that `cli.generate --ckpt <dir>/model.pth` reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch

from ..config import MambaConfig, TrainValues, TransformerConfig, XLSTMConfig
from ..data.dataset import TokenDataset, make_loaders
from ..interop import config_from_state_dict, family, load_checkpoint, xlstm_state_dict
from ..models import mamba, transformer, xlstm
from ..train import trainer as T

# The JAX CLI's options that the port does not have yet, and what they wait for.
_NOT_PORTED = {
    "bf16": "bf16 compute",
    "parallel": "mesh-sharded data/tensor parallel training",
    "tp": "tensor parallelism",
    "sp": "sequence-parallel training",
    "pp": "pipeline-parallel training",
    "pp_microbatches": "pipeline-parallel training",
    "multihost": "multi-host training",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a music generator (PyTorch/CUDA)")
    p.add_argument("--model", choices=["mamba", "xlstm", "transformer"], default="mamba")
    p.add_argument("--data", required=True, help=".npy token corpus root")
    p.add_argument("--metadata", required=True, help="metadata.json path")
    p.add_argument("--tokenizations", default=None, help="write the metadata tokenization here")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log", default=None)
    p.add_argument("--resume", default=None, help="checkpoint directory, or a reference-layout .pth")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--block-len", type=int, default=None)
    p.add_argument("--augmentation", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing: recompute each layer in the backward pass")
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="grammar-filtered CE in time chunks of this size (the (B, T, V) logits never exist "
                        "whole; the same loss and gradients)")
    p.add_argument("--attention", choices=["auto", "xla", "flash"], default="auto",
                   help="transformer attention: flash = kernels D and E (their plain versions on the CPU), "
                        "xla = the plain f32 attention; auto = flash on the GPU, xla on the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    for flag in ("bf16", "parallel", "multihost"):
        p.add_argument(f"--{flag}", action="store_true", help="not yet ported")
    for flag in ("tp", "sp", "pp", "pp-microbatches"):
        p.add_argument(f"--{flag}", type=int, default=None, help="not yet ported")
    return p.parse_args(argv)


def cli_device(name: str) -> torch.device:
    """--device of the training and evaluation CLIs: `cuda` raises without a
    card (nothing falls back to the CPU), `cpu` runs the plain versions."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass --device cpu to run "
                           "the plain PyTorch versions on the CPU")
    return device


DEFAULT_CONFIGS = {"mamba": MambaConfig, "transformer": TransformerConfig, "xlstm": XLSTMConfig}
MODULES = {"mamba": mamba, "transformer": transformer, "xlstm": xlstm}


def build_model(args: argparse.Namespace, device: torch.device):
    """The model, with --resume's weights (a checkpoint directory's
    model.pth, or a bare .pth) or initialised from --seed. The config comes
    from --resume's shapes, else the family's default; --attention and
    --remat apply to either."""
    sd = None
    if args.resume:
        sd = load_checkpoint(args.resume)
        cfg = config_from_state_dict(sd)
        held = family(cfg)
        if held != args.model:
            raise ValueError(f"--resume holds a {held} model, not a --model {args.model}")
        if isinstance(cfg, XLSTMConfig):
            sd = xlstm_state_dict(sd, cfg)  # NX-AI's head-wise sLSTM gates as the full ones the model trains
    else:
        cfg = DEFAULT_CONFIGS[args.model]()
    if isinstance(cfg, TransformerConfig):
        cfg = dataclasses.replace(cfg, attention_impl=args.attention)
    cfg = dataclasses.replace(cfg, remat=args.remat)
    module = MODULES[args.model]
    model = module.empty_model(cfg, device)
    if sd is None:
        module.init_weights_(model, args.seed)
    else:
        model.load_state_dict(sd, strict=True)
    return model


def main(argv: Optional[List[str]] = None) -> T.TrainState:
    """Runs the CLI; returns the final TrainState."""
    args = parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not yet ported to musicgen_tpu_torch ({what})")
    device = cli_device(args.device)
    torch.manual_seed(args.seed)  # nn.Dropout's draws, on every device
    model = build_model(args, device)

    defaults = TrainValues()
    values = dataclasses.replace(  # a Transformer's block defaults to its own (its rel table's rows)
        defaults, block_len=args.block_len or getattr(model.cfg, "block_len", defaults.block_len),
        batch_size=args.batch_size or defaults.batch_size, epochs=args.epochs or defaults.epochs,
        augmentation=args.augmentation,
    )
    dataset = TokenDataset.from_directory(args.data, args.metadata, args.tokenizations, block_len=values.block_len,
                                          seed=args.seed)
    train_iter, test_iter = make_loaders(dataset, values, seed=args.seed)

    state = T.TrainState(model, T.make_optimizer(model, values))  # fresh Adam at step 0, resumed or not
    generator = torch.Generator(device=device).manual_seed(args.seed)  # augmentation's draws
    return T.train_lm(
        state, train_iter, test_iter, values,
        ckpt_dir=args.ckpt_dir or os.path.join("checkpoints", args.model),
        log_path=args.log or os.path.join("logs", f"training_log_{args.model}.json"),
        generator=generator, loss_chunk=args.loss_chunk,
    )


if __name__ == "__main__":
    main()
