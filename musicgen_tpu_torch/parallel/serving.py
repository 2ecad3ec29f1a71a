"""Data-parallel generation and classification over ranks.

Port of musicgen_tpu/parallel/serving.py. The JAX package commits the
prompt and meta to the mesh's 'data' axis (`shard_for_generation`) and runs
the ordinary jitted `sampler.generate`: each device decodes its share of
the rows against its own copy of the weights, and the replicated key gives
every device the same draws. The classifier's forward shards over 'data'
the same way. The port runs one process a rank under a launcher (torchrun;
train/distributed.init_from_env joins its group, parallel/mesh.make_grid
places the rank): each rank generates its contiguous share of the rows
(`share_rows`, train/distributed.rank_share's) through
`sample.sampler.generate`, with the kernels on the card, and the streams are
all-gathered over the data group, so every rank returns the one-process
result.

The draws: by the sampler's draw rule a generation's randomness is one
(num_tokens, B, 2) tensor of uniforms, row i's tokens a function of u[:, i]
alone. Every rank draws the whole batch's tensor from its generator, which
the caller seeds alike on every rank (as JAX replicates the key), and hands
`generate` its share's columns: the streams equal one process's on the same
weights, bit for bit wherever a row's arithmetic does not depend on the
rows beside it.

A grid whose 'model' axis is above 1 splits the vocabulary table and head
over each model group (`shard_vocab`: a copy of the model holding this
rank's shards, as JAX's param_shardings splits them); the rows then run the
family's plain step, whose logits VocabParallelHead gathers. The decode
kernels generate data-parallel only, as the JAX package's fused paths do:
such a grid takes fused=False, and refuses the kernels' options.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..sample.sampler import SamplerConfig, draw_uniforms, generate
from .mesh import Grid, vocab_parallel, vocab_sharded


def _grid(grid: Optional[Grid]) -> Grid:
    """`grid`, or data-parallel over every rank of the initialised group."""
    return grid if grid is not None else Grid(dist.get_world_size(), 1, dist.get_rank())


def share_rows(batch: int, grid: Grid) -> slice:
    """The rows of this rank's data index in a batch of `batch`: its
    contiguous share, train/distributed.rank_share's. Raises where the data
    axis does not divide the batch, with the JAX package's message."""
    if batch % grid.data:
        raise ValueError(f"batch {batch} does not divide data axis {grid.data}")
    n = batch // grid.data
    return slice(grid.data_index * n, (grid.data_index + 1) * n)


def shard_vocab(model: nn.Module, grid: Grid) -> nn.Module:
    """The model with its vocabulary tensors split over its model group
    (parallel/mesh.vocab_sharded: a copy, the caller's model stays whole);
    the model itself where they are split already or the grid's model axis
    is 1."""
    if grid.model > 1 and vocab_parallel(model):
        return vocab_sharded(model, grid.model_group, grid.model, grid.model_index)
    return model


def gather_rows(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The data group's shares of x, concatenated in data-index order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(grid.data)]
    dist.all_gather(parts, x, group=grid.data_group)
    return torch.cat(parts)


@torch.no_grad()
def generate_data_parallel(model, kind: str, prompt: torch.Tensor, meta: torch.Tensor, num_tokens: int,
                           block_len: int, generator: torch.Generator, grid: Optional[Grid] = None,
                           greedy: bool = False, mode: str = "combined", fused: Optional[bool] = None,
                           **generate_kwargs) -> torch.Tensor:
    """`sampler.generate` over the data group: every rank passes the whole
    (B, P) prompt and (B, 6) meta and a generator seeded alike, generates
    the rows of its data index, and returns the whole (B, P + num_tokens)
    streams. `grid` (parallel/mesh.make_grid) defaults to data parallelism
    over every rank. generate_kwargs: quant, resident, decode_pack.

    Raises where the data axis does not divide B, as the JAX package does.
    With grid.model > 1 the rows take the plain step of `shard_vocab`'s
    copy of the model, and the caller passes fused=False: fused=True or
    None, resident or a decode_pack raise."""
    grid = _grid(grid)
    batch = prompt.shape[0]
    rows = share_rows(batch, grid)
    if grid.model > 1:
        if fused is not False or generate_kwargs.get("resident") or generate_kwargs.get("decode_pack") is not None:
            raise ValueError("the decode kernels generate data-parallel only: use a grid with model axis 1 "
                             "(or fused=False for a vocabulary-parallel model)")
        model = shard_vocab(model, grid)
    u = draw_uniforms(SamplerConfig(num_tokens=num_tokens, greedy=greedy, mode=mode), batch, generator,
                      prompt.device)
    out = generate(model, kind, prompt[rows], meta[rows], num_tokens, block_len, generator, greedy=greedy,
                   mode=mode, fused=fused, uniforms=None if u is None else u[:, rows], **generate_kwargs)
    return gather_rows(out, grid)


@torch.no_grad()
def classify_data_parallel(model: nn.Module, src: torch.Tensor, grid: Optional[Grid] = None) -> torch.Tensor:
    """The classifier's no-grad forward over the data group (JAX: its apply
    on a batch sharded over 'data'): every rank passes the whole (B, T)
    tokens, runs its data index's rows (kernel H on the card,
    models/xlstm.runs_kernel_h) in eval() mode, and returns the whole (B,
    meta vocab) logits. With grid.model > 1 the rows run `shard_vocab`'s
    copy of the model, its token table split over the model group as JAX's
    param_shardings splits it."""
    grid = _grid(grid)
    rows = share_rows(src.shape[0], grid)
    model = shard_vocab(model, grid).eval()
    return gather_rows(model(src[rows]), grid)
