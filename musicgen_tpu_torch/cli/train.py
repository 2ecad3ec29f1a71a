"""Training CLI of the PyTorch/CUDA port (reference train.py; port of
musicgen_tpu/cli/train.py, single device).

  python -m musicgen_tpu_torch.cli.train --model transformer --data data/np \
      --metadata data/metadata.json [--resume CKPT] [--epochs N] [--block-len N] [--bf16]
  torchrun --nproc_per_node N -m musicgen_tpu_torch.cli.train --parallel ...

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

--bf16 computes in bf16 with f32 parameters, Adam state, loss and lm_head
(models/compute.py, the JAX CLI's --bf16); its checkpoints are the same f32
`model.pth`. --parallel trains data-parallel (train/distributed.py) under a
launcher such as torchrun: every rank draws the same global batches of
--batch-size rows and trains on its share, DDP averages the gradients over
NCCL (--device cuda, one card a rank) or gloo (--device cpu), the step runs
without dropout or augmentation as the JAX step does, and rank 0 alone logs
and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config import MambaConfig, TrainValues, TransformerConfig, XLSTMConfig
from ..data.dataset import TokenDataset, make_loaders
from ..interop import config_from_state_dict, family, load_checkpoint, xlstm_state_dict
from ..models import mamba, transformer, xlstm
from ..train import distributed
from ..train import trainer as T

# The JAX CLI's options that the port does not have yet, and what they wait
# for (--tp is ported at 1, the JAX default, and refused above it).
_NOT_PORTED = {
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
    p.add_argument("--log", "--log-json", dest="log", default=None,
                   help="the JSON step log (--log-json under torchrun, whose own --log-dir and --logs-specs "
                        "make --log ambiguous there)")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute with f32 parameters, Adam state, loss and lm_head")
    p.add_argument("--parallel", action="store_true",
                   help="data-parallel training over the ranks of a launcher (torchrun): NCCL with --device "
                        "cuda, gloo with cpu")
    p.add_argument("--tp", type=int, default=1, help="model-axis size with --parallel: 1 (tensor "
                                                     "parallelism is not yet ported)")
    p.add_argument("--multihost", action="store_true", help="not yet ported")
    for flag in ("sp", "pp", "pp-microbatches"):
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
    from --resume's shapes, else the family's default; --attention, --remat
    and --bf16 (the compute dtype) apply to either."""
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
    model = module.empty_model(cfg, device, torch.bfloat16 if args.bf16 else torch.float32)
    if sd is None:
        module.init_weights_(model, args.seed)
    else:
        model.load_state_dict(sd, strict=True)
    return model


def main(argv: Optional[List[str]] = None) -> T.TrainState:
    """Runs the CLI; returns the final TrainState (of this rank, with
    --parallel)."""
    args = parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not yet ported to musicgen_tpu_torch ({what})")
    if args.tp != 1:
        raise NotImplementedError("--tp above 1 is not yet ported to musicgen_tpu_torch (tensor parallelism)")
    if args.parallel:
        if args.augmentation:
            raise ValueError("--parallel trains without augmentation, as the JAX package's distributed step")
        rank, world, device = distributed.init_from_env(args.device)
        try:
            return _train(args, device, rank, world)
        finally:
            dist.destroy_process_group()
    device = cli_device(args.device)
    torch.manual_seed(args.seed)  # nn.Dropout's draws, on every device
    return _train(args, device)


def _train(args: argparse.Namespace, device: torch.device, rank: int = 0, world: int = 0) -> T.TrainState:
    """The run on one device; `world` > 0 makes it rank `rank` of a
    data-parallel group."""
    model = build_model(args, device)

    defaults = TrainValues()
    values = dataclasses.replace(  # a Transformer's block defaults to its own (its rel table's rows)
        defaults, block_len=args.block_len or getattr(model.cfg, "block_len", defaults.block_len),
        batch_size=args.batch_size or defaults.batch_size, epochs=args.epochs or defaults.epochs,
        augmentation=args.augmentation,
    )
    dataset = TokenDataset.from_directory(args.data, args.metadata, args.tokenizations if rank == 0 else None,
                                          block_len=values.block_len, seed=args.seed)
    train_iter, test_iter = make_loaders(dataset, values, seed=args.seed)  # the same batches on every rank
    ckpt_dir = args.ckpt_dir or os.path.join("checkpoints", args.model)
    log_path = args.log or os.path.join("logs", f"training_log_{args.model}.json")

    if world:
        optimizer, step = distributed.build_distributed_training(model, values, loss_chunk=args.loss_chunk)
        return T.run_epochs(T.TrainState(model, optimizer), step, T.make_lm_eval_step(model), train_iter,
                            test_iter, values, ckpt_dir, log_path,
                            started=f"Training started! mesh={{'data': {world}, 'model': 1}}", main=rank == 0)
    state = T.TrainState(model, T.make_optimizer(model, values))  # fresh Adam at step 0, resumed or not
    generator = torch.Generator(device=device).manual_seed(args.seed)  # augmentation's draws
    return T.train_lm(state, train_iter, test_iter, values, ckpt_dir=ckpt_dir, log_path=log_path,
                      generator=generator, loss_chunk=args.loss_chunk)


if __name__ == "__main__":
    main()
