"""Training CLI of the PyTorch/CUDA port (reference train.py / train_parallel.py;
port of musicgen_tpu/cli/train.py).

  python -m musicgen_tpu_torch.cli.train --model transformer --data data/np \
      --metadata data/metadata.json [--resume CKPT] [--epochs N] [--block-len N] [--bf16]
  torchrun --nproc_per_node N -m musicgen_tpu_torch.cli.train --parallel [--tp K] ...
  torchrun --nproc_per_node N -m musicgen_tpu_torch.cli.train --pp N [--pp-microbatches M] ...
  torchrun --nproc_per_node N -m musicgen_tpu_torch.cli.train --sp N ...

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
`model.pth`.

The multi-rank strategies run one process a rank under a launcher such as
torchrun (NCCL with --device cuda, one card a rank; gloo with --device cpu),
and the launcher's group must have the size the flags need. Every rank draws
the same global batches of --batch-size rows; the steps run without dropout
or augmentation, as the JAX steps do; rank 0 alone logs, and writes each
checkpoint in the one-process layout (the model and its Adam state gathered
over the ranks), which `cli.generate` and the one-process loader read.
  --parallel [--tp K]: data-parallel over world / K ranks (DDP), each data
      share's K ranks splitting the vocabulary-sized token table and head
      (train/distributed.py, parallel/mesh.py); the world must divide by K.
  --pp N [--pp-microbatches M]: GPipe over N ranks, Mamba or the
      Transformer (parallel/pipeline.py; M defaults to the largest divisor
      of the batch up to 4N).
  --sp N: the time axis of a Mamba step over N ranks (parallel/sp_train.py;
      --block-len + 6 must divide by N).
--pp and --sp compute in f32 whatever --bf16 says, as the JAX paths do
(their stream is the f32 tables'). --pp 1 and --sp 1 are the one-process
step. --multihost joins a multi-node launcher's group (torchrun --nnodes) for
one of these strategies; the port's groups then span the nodes.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig, TrainValues, TransformerConfig, XLSTMConfig
from ..data.dataset import TokenDataset, make_loaders
from ..interop import config_from_state_dict, family, load_checkpoint, xlstm_state_dict
from ..models.registry import CONFIGS, KINDS, init_model, new_model
from ..parallel.mesh import full_optimizer_state, full_state_dict, make_grid
from ..parallel.pipeline import PipelineStage, make_pipe_grid, make_pp_eval_step, make_pp_train_step, pp_full_state
from ..parallel.sp_train import make_sp_train_step, sp_loss_value
from ..train import distributed
from ..train import trainer as T

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a music generator (PyTorch/CUDA)")
    p.add_argument("--model", choices=list(KINDS), default="mamba")
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
    p.add_argument("--tp", type=int, default=1,
                   help="model-axis size with --parallel: the vocabulary-sized token table and head split over "
                        "this many ranks of each data share (tensor parallelism)")
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel Mamba training: the time axis over this many ranks (block_len + 6 "
                        "must divide by it; f32 compute; parallel/sp_train.py)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline-parallel training of Mamba or the Transformer: the layers over this many ranks "
                        "(GPipe; each rank holds its stage and its Adam moments; f32 compute; parallel/pipeline.py)")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="GPipe microbatch count (default: the largest batch divisor <= 4 * pp)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-node launcher's group (torchrun --nnodes) for --parallel, --pp or --sp")
    return p.parse_args(argv)


def cli_device(name: str) -> torch.device:
    """--device of the training and evaluation CLIs: `cuda` raises without a
    card (nothing falls back to the CPU), `cpu` runs the plain versions."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass --device cpu to run "
                           "the plain PyTorch versions on the CPU")
    return device


# Each family's default config (a patch point of the tests and chip_smoke.py).
DEFAULT_CONFIGS = {kind: CONFIGS[kind] for kind in KINDS}


def build_model(args: argparse.Namespace, device: torch.device, dtype: Optional[torch.dtype] = None):
    """The model, with --resume's weights (a checkpoint directory's
    model.pth, or a bare .pth) or initialised from --seed. The config comes
    from --resume's shapes, else the family's default; --attention, --remat
    and the compute dtype (`dtype`, else --bf16's) apply to either."""
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
    model = new_model(args.model, cfg, device, dtype or (torch.bfloat16 if args.bf16 else torch.float32))
    if sd is None:
        init_model(model, args.model, args.seed)
    else:
        model.load_state_dict(sd, strict=True)
    return model


def strategy(args: argparse.Namespace) -> Optional[str]:
    """The multi-rank strategy the flags ask for, in the JAX CLI's order
    ('pp', 'sp', 'parallel'), or None for the one-process step. Raises on
    what the JAX CLI refuses (--pp for an xLSTM, --sp but for Mamba) and on
    flags that would quietly train one process: --tp without --parallel,
    --pp-microbatches without --pp, --multihost without a strategy."""
    if args.pp > 1:
        if args.model not in ("mamba", "transformer"):
            raise SystemExit("--pp implements the mamba and transformer steps only (an xLSTM has no stage forward "
                             "for its mLSTM/sLSTM mix yet)")
        chosen = "pp"
    elif args.sp > 1:
        if args.model != "mamba":
            raise SystemExit("--sp implements the mamba step only")
        chosen = "sp"
    else:
        chosen = "parallel" if args.parallel else None
    if args.tp != 1 and not (args.parallel and args.tp > 1):
        raise ValueError("--tp splits the vocabulary over the ranks of --parallel: pass --parallel with --tp above 1")
    if args.pp_microbatches and chosen != "pp":
        raise ValueError("--pp-microbatches sets the microbatches of --pp above 1: pass --pp")
    if args.multihost and chosen is None:
        raise ValueError("--multihost joins a launcher's group for --parallel, --pp or --sp: none is given")
    if chosen and args.augmentation:
        raise ValueError(f"--{chosen} trains without augmentation, as the JAX package's multi-device steps")
    return chosen


def main(argv: Optional[List[str]] = None) -> T.TrainState:
    """Runs the CLI; returns the final TrainState (of this rank, whose model
    is its shard or stage, with a multi-rank strategy)."""
    args = parse_args(argv)
    chosen = strategy(args)
    if chosen:
        rank, world, device = distributed.init_from_env(args.device)
        try:
            return _train(args, device, rank, world, chosen)
        finally:
            dist.destroy_process_group()
    device = cli_device(args.device)
    torch.manual_seed(args.seed)  # nn.Dropout's draws, on every device
    return _train(args, device)


def _group_of(world: int, n: int, flag: str) -> None:
    if world != n:
        raise ValueError(f"--{flag} {n} needs a group of {n} ranks, the launcher's has {world}: "
                         f"torchrun --nproc_per_node {n}")


def _train(args: argparse.Namespace, device: torch.device, rank: int = 0, world: int = 0,
           chosen: Optional[str] = None) -> T.TrainState:
    """The run of this process: one device, or rank `rank` of a group of
    `world` under strategy `chosen`."""
    if chosen in ("pp", "sp"):
        _group_of(world, args.pp if chosen == "pp" else args.sp, chosen)
    model = build_model(args, torch.device("cpu") if chosen == "pp" else device,
                        torch.float32 if chosen in ("pp", "sp") else None)

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
    f32_note = " (f32 compute, as the JAX path)" if args.bf16 else ""

    if chosen is None:
        state = T.TrainState(model, T.make_optimizer(model, values))  # fresh Adam at step 0, resumed or not
        generator = torch.Generator(device=device).manual_seed(args.seed)  # augmentation's draws
        return T.train_lm(state, train_iter, test_iter, values, ckpt_dir=ckpt_dir, log_path=log_path,
                          generator=generator, loss_chunk=args.loss_chunk)

    def gathered(full):
        """run_epochs' save: full() (a collective) on every rank, rank 0 writes."""
        def save(loss: float) -> None:
            sd, opt = full()
            if rank == 0:
                T.save_checkpoint(ckpt_dir, state, loss, model_state=sd, optimizer_state=opt)
        return save

    if chosen == "pp":
        grid = make_pipe_grid(args.pp)
        stage = PipelineStage(model, grid.stages, grid.index).to(device)
        del model
        optimizer = T.make_optimizer(stage, values)
        state = T.TrainState(stage, optimizer)
        micro = args.pp_microbatches or None
        return T.run_epochs(state, make_pp_train_step(stage, optimizer, grid, micro),
                            make_pp_eval_step(stage, grid, micro), train_iter, test_iter, values, ckpt_dir,
                            log_path, started=f"Training started! pp={args.pp} (layer-sharded GPipe){f32_note}",
                            main=rank == 0, save=gathered(lambda: pp_full_state(stage, optimizer, grid)))
    if chosen == "sp":
        optimizer = T.make_optimizer(model, values)
        state = T.TrainState(model, optimizer)
        return T.run_epochs(state, make_sp_train_step(model, optimizer), lambda s, t, m: sp_loss_value(model, s, t, m),
                            train_iter, test_iter, values, ckpt_dir, log_path,
                            started=f"Training started! sp={args.sp} (time-sharded){f32_note}", main=rank == 0)
    grid = make_grid(MeshConfig(model=args.tp))
    optimizer, step = distributed.build_distributed_training(model, values, loss_chunk=args.loss_chunk, grid=grid)
    state = T.TrainState(model, optimizer)
    save = gathered(lambda: (full_state_dict(model), full_optimizer_state(model, optimizer))) if grid.model > 1 else None
    return T.run_epochs(state, step, T.make_lm_eval_step(model), train_iter, test_iter, values, ckpt_dir, log_path,
                        started=f"Training started! mesh={{'data': {grid.data}, 'model': {grid.model}}}",
                        main=rank == 0, save=save)


if __name__ == "__main__":
    main()
