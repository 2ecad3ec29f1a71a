"""Data-parallel training of the port: DistributedDataParallel over a process
group, NCCL between cards and gloo on the CPU.

Port of musicgen_tpu/train/distributed.py (reference train_parallel.py:
143-235, which trains under torchrun + DDP + NCCL). The JAX step shards each
global batch of the loader over the mesh's 'data' axis and lets XLA insert
the gradient all-reduce; here every rank draws the same global batches (the
loaders are seeded alike), takes its contiguous share of batch_size /
world_size rows, and DDP averages the gradients over the ranks. Each rank's
loss is a mean over equally many positions, so that average is the
gradient of the global batch's mean loss, the JAX step's.

The step is deterministic, as the JAX one: the model runs with its dropout
off (eval() mode, under grad) and without augmentation. Parameters stay
replicated: DDP broadcasts rank 0's parameters when it wraps the model, and
every rank applies the same averaged gradients with its own Adam.

Tensor parallelism (`grid`, the JAX mesh's 'model' axis above 1): the ranks
form a (data, model) grid (parallel/mesh.py). Each model group takes one data
share of the batch, splits the vocabulary-sized token table and head over
its ranks (VocabParallelEmbedding, VocabParallelHead) and computes the rest
replicated; DDP runs over the data group, so each model rank's shards and
its replicated parameters are averaged over the ranks of its model index.
This covers kind 'lm' for every family, with and without loss_chunk, and
kind 'classifier', whose token table splits as JAX's param_shardings splits
it. `parallel.mesh.full_state_dict` gathers the unsharded state dict.

`init_from_env` joins the group a launcher (torchrun,
`python -m torch.distributed.run`) describes in RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..config import TrainValues
from ..parallel.mesh import Grid, VocabParallelHead, shard_vocab_
from .loss import chunked_filtered_cross_entropy, classifier_bce, filtered_cross_entropy
from .trainer import lm_head, make_optimizer

KINDS = ("lm", "classifier")


def init_from_env(device: str) -> Tuple[int, int, torch.device]:
    """Joins the process group of a launcher's environment: NCCL for
    --device cuda (each rank on card LOCAL_RANK), gloo for cpu. Returns
    (rank, world_size, device). Raises without WORLD_SIZE: a data-parallel
    run never falls back to one process quietly."""
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--parallel runs under a launcher that sets WORLD_SIZE, RANK and LOCAL_RANK: "
                           "torchrun --nproc_per_node N -m musicgen_tpu_torch.cli.train --parallel ...")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train data-parallel over gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dist.get_rank(), dist.get_world_size(), dev


def rank_share(x: torch.Tensor, rank: int, world_size: int) -> torch.Tensor:
    """Rows [rank * n, (rank + 1) * n) of a global batch, n = B / world_size;
    raises where world_size does not divide B (the JAX step's batch
    sharding needs the same)."""
    b = x.shape[0]
    if b % world_size:
        raise ValueError(f"a global batch of {b} rows does not split over {world_size} ranks")
    n = b // world_size
    return x[rank * n:(rank + 1) * n]


class _Objective(nn.Module):
    """The model and its loss as one module, so that the whole forward,
    the chunked CE's head included, runs inside DDP's forward."""

    def __init__(self, model: nn.Module, kind: str, loss_chunk: int):
        super().__init__()
        self.model, self.kind, self.loss_chunk = model, kind, loss_chunk

    def forward(self, src, trg, meta):
        if self.kind == "classifier":
            return classifier_bce(self.model(src), meta)
        if self.loss_chunk:
            head = lm_head(self.model)
            return chunked_filtered_cross_entropy(src, self.model.hidden(src, meta), head.weight, head.bias, trg,
                                                  chunk=self.loss_chunk,
                                                  project=head if isinstance(head, VocabParallelHead) else None)
        return filtered_cross_entropy(src, self.model(src, meta), trg)


def make_distributed_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    kind: str = "lm",
    loss_chunk: int = 0,
    grid: Optional[Grid] = None,
) -> Callable:
    """Returns step(src, trg, meta) -> loss over the initialised process
    group: each rank passes the same global batch and trains on its data
    index's share (`grid`, parallel/mesh.make_grid; None is data-parallel
    over every rank).

    kind='lm': the grammar-filtered CE of the three generators; loss_chunk
    > 0 takes the chunked CE from the final hidden states (the same loss and
    gradients without the (B, T, V) logits). kind='classifier': the
    composer classifier's BCE against meta's multi-hot targets; trg is
    ignored. The returned loss is the global batch's mean, the same on every
    rank. `step.module` is the DDP module."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    grid = grid or Grid(dist.get_world_size(), 1, dist.get_rank())
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(_Objective(model, kind, loss_chunk), process_group=grid.data_group,
                                  device_ids=[device.index] if device.type == "cuda" else None)

    @torch.enable_grad()
    def step(src, trg, meta):
        model.eval()  # no dropout: the JAX step applies the model deterministically
        optimizer.zero_grad(set_to_none=True)
        loss = ddp(*(rank_share(x, grid.data_index, grid.data) for x in (src, trg, meta)))
        loss.backward()
        optimizer.step()
        total = loss.detach().clone()
        dist.all_reduce(total, group=grid.data_group)
        return total / grid.data

    step.module = ddp
    return step


def build_distributed_training(
    model: nn.Module,
    values: TrainValues = TrainValues(),
    kind: str = "lm",
    loss_chunk: int = 0,
    grid: Optional[Grid] = None,
) -> Tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, step): Adam as trainer.make_optimizer and
    make_distributed_train_step's step. With a grid whose model axis is
    above 1 the model's vocabulary table and head are first replaced IN
    PLACE by this rank's shards (parallel/mesh.shard_vocab_; every rank
    holds the same whole model before). Wrapping the model in DDP broadcasts
    the first data rank's parameters over each data group, as the JAX
    version places one copy of the parameters on every device."""
    if grid is not None and grid.model > 1:
        shard_vocab_(model, grid.model_group, grid.model, grid.model_index)
    optimizer = make_optimizer(model, values)
    return optimizer, make_distributed_train_step(model, optimizer, kind, loss_chunk, grid)
