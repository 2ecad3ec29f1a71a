"""The process grid of multi-rank training and the vocabulary split.

Port of musicgen_tpu/parallel/mesh.py. JAX runs one controller over a
('data', 'model') mesh of devices and lets GSPMD insert the collectives; the
port runs one process a rank under a launcher (torchrun) and calls the
collectives itself. Rank r sits at (data r // model, model r % model), as
JAX reshapes its device list to (data, model). `make_grid` builds, with
dist.new_group, the model group (the ranks of one data index: they train on
one share of the batch and split the vocabulary) and the data group (the
ranks of one model index: DDP averages their gradients).

Tensor parallelism splits the vocabulary-sized tensors over the model group
(`vocab_parallel`, the counterpart of JAX's `_param_spec`): the head's rows
and bias and the token embedding's rows. The metadata table and every other
tensor stay replicated. The port's tables have the reference `.pth`'s
17,914 rows, which 4 does not divide (JAX's have the padded 17,920): model
rank m holds rows [m * ceil(V / tp), min((m + 1) * ceil(V / tp), V)), so
only the last shard is short, and the head pads its logits to ceil(V / tp)
columns for the all-gather alone. The model's width and its `.pth` layout
never change: `full_state_dict` gathers the shards back.

  * VocabParallelEmbedding: a masked lookup in the local rows, summed over
    the model group. Its backward passes the cotangent through unchanged.
  * VocabParallelHead: the local rows' logits, all-gathered over the model
    group. Its backward keeps its own columns of the cotangent, and sums
    the hidden state's gradient over the group (each rank's product gives
    its rows' part of it).

Those backwards rest on one fact: every rank of a model group computes the
same loss from the same activations, so each already holds the whole
cotangent of a replicated tensor (summing it over the group would count it
tp times). The replicated parameters' gradients are then equal over the
model group, the shards' gradients are their own, and DDP averages both
over the data group: the unsharded step's numbers up to the order of the
sums, as GSPMD's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import MeshConfig

def axis_groups(outer: int, inner: int, rank: int) -> Tuple[Any, Any]:
    """(the group of rank's outer index, the group of its inner index) on a
    grid where rank r sits at (r // inner, r % inner). Every rank must call
    it, in the same order (dist.new_group)."""
    inner_group = outer_group = None
    for o in range(outer):
        g = dist.new_group([o * inner + i for i in range(inner)])
        if o == rank // inner:
            inner_group = g
    for i in range(inner):
        g = dist.new_group([o * inner + i for o in range(outer)])
        if i == rank % inner:
            outer_group = g
    return inner_group, outer_group


@dataclasses.dataclass
class Grid:
    """This rank's place on the (data, model) grid and its two groups. A
    group of None is the default (whole-world) group."""

    data: int
    model: int
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_grid(cfg: MeshConfig = MeshConfig()) -> Grid:
    """The grid of the initialised process group (musicgen_tpu make_mesh).
    Raises where data x model does not cover the group. With model 1 the
    data group is the whole world and no group is created."""
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = cfg.axis_sizes(world)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover {world} ranks: launch data x model ranks "
                         f"(torchrun --nproc_per_node {max(data, 1) * model})")
    if model == 1:
        return Grid(data, 1, rank)
    model_group, data_group = axis_groups(data, model, rank)
    return Grid(data, model, rank, data_group, model_group)


def vocab_range(vocab: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of the vocabulary that part `index` of `parts` holds:
    ceil(vocab / parts) each, the last part short. Raises where a part would
    hold nothing."""
    per = -(-vocab // parts)
    if per * (parts - 1) >= vocab:
        raise ValueError(f"a vocabulary of {vocab} rows does not split over {parts} ranks")
    lo = index * per
    return lo, min(lo + per, vocab)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (SUM) forward; the cotangent passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the cotangent is all-reduced (SUM): the input of a
    product whose output columns are split over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """(..., per) on each of `parts` ranks -> (..., parts * per), rank i's
    columns at [i * per, (i + 1) * per); the backward keeps this rank's."""

    @staticmethod
    def forward(ctx, x, group, parts, index):
        ctx.index, ctx.per = index, x.shape[-1]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(parts)]
        dist.all_gather(out, x, group=group)
        return torch.cat(out, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.index * ctx.per:(ctx.index + 1) * ctx.per], None, None, None


class _VocabShard(nn.Module):
    """Rows [lo, hi) of a vocabulary-sized tensor, on part `index` of
    `parts` ranks of `group`."""

    def __init__(self, vocab: int, group: Any, parts: int, index: int):
        super().__init__()
        self.vocab, self.group, self.parts, self.index = vocab, group, parts, index
        self.lo, self.hi = vocab_range(vocab, parts, index)
        self.per = -(-vocab // parts)


class VocabParallelEmbedding(_VocabShard):
    """An nn.Embedding's rows split over a model group; forward(ids) is the
    whole table's lookup on every rank of the group."""

    def __init__(self, table: nn.Embedding, group: Any, parts: int, index: int):
        super().__init__(table.num_embeddings, group, parts, index)
        self.weight = nn.Parameter(table.weight.detach()[self.lo:self.hi].clone())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.lo
        outside = (local < 0) | (local >= self.hi - self.lo)
        rows = F.embedding(local.masked_fill(outside, 0), self.weight).masked_fill(outside[..., None], 0.0)
        return _SumOverGroup.apply(rows, self.group)


class VocabParallelHead(_VocabShard):
    """An nn.Linear to the vocabulary with its rows and bias split over a
    model group; forward(h) is the whole head's logits on every rank."""

    def __init__(self, head: nn.Linear, group: Any, parts: int, index: int):
        super().__init__(head.out_features, group, parts, index)
        self.weight = nn.Parameter(head.weight.detach()[self.lo:self.hi].clone())
        self.bias = nn.Parameter(head.bias.detach()[self.lo:self.hi].clone())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        logits = F.linear(_SumGradOverGroup.apply(h, self.group), self.weight, self.bias)
        pad = self.per - (self.hi - self.lo)
        if pad:
            logits = F.pad(logits, (0, pad))
        return _GatherColumns.apply(logits, self.group, self.parts, self.index)[..., :self.vocab]


# The rule (JAX's _param_spec): the token table's rows and the vocabulary
# head's rows and bias split over 'model'. MambaLM, XLSTMLM and
# XLSTMClassifier name them token_embedding / output_layer, TransformerLM
# token_embedding_table / lm_head; a classifier's output_layer is a dead
# head of buffers (no nn.Linear) and stays whole.
VOCAB_TABLES = ("token_embedding", "token_embedding_table")
VOCAB_HEADS = ("output_layer", "lm_head")


def vocab_parallel(model: nn.Module) -> Dict[str, type]:
    """{attribute name: shard class} of the unsharded model's modules whose
    tensors split over the model group."""
    out = {}
    for name in VOCAB_TABLES:
        if isinstance(getattr(model, name, None), nn.Embedding):
            out[name] = VocabParallelEmbedding
    for name in VOCAB_HEADS:
        if isinstance(getattr(model, name, None), nn.Linear):
            out[name] = VocabParallelHead
    return out


def shard_vocab_(model: nn.Module, group: Any, parts: int, index: int) -> nn.Module:
    """Replaces the model's vocabulary table and head IN PLACE by this
    rank's shards (part `index` of `parts` over `group`; None is the default
    group). The parameters' order and names stay the model's."""
    for name, cls in vocab_parallel(model).items():
        setattr(model, name, cls(getattr(model, name), group, parts, index))
    return model


def _gather_rows(t: torch.Tensor, shard: _VocabShard) -> torch.Tensor:
    pad = shard.per - t.shape[0]
    t = F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) if pad else t.contiguous()
    out = [torch.empty_like(t) for _ in range(shard.parts)]
    dist.all_gather(out, t, group=shard.group)
    return torch.cat(out)[:shard.vocab]


def gather_vocab(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`tensors` (named as the model's parameters or state) with every
    shard of a vocabulary-parallel module gathered to its whole rows, in
    order. A collective over each such module's group: every rank calls it."""
    out = {}
    for name, t in tensors.items():
        owner = name.rpartition(".")[0]
        module = model.get_submodule(owner) if owner else model
        out[name] = _gather_rows(t, module) if isinstance(module, _VocabShard) and t is not None else t
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the unsharded (reference `.pth`) layout."""
    return gather_vocab(model, model.state_dict())


def named_adam_state(optimizer: torch.optim.Optimizer, names: Iterable[str]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's per-parameter state keyed by the names of its
    parameters (given in the order of its one param group)."""
    sd = optimizer.state_dict()
    return {name: sd["state"][i] for i, name in enumerate(names) if i in sd["state"]}


def adam_state_dict(optimizer: torch.optim.Optimizer, named: Dict[str, Dict[str, torch.Tensor]],
                    names: List[str]) -> Dict[str, Any]:
    """An optimizer state dict over parameters `names` (in order, one param
    group with the hyperparameters of `optimizer`'s) from per-name state: the
    layout a one-process Adam over the whole model loads."""
    group = {k: v for k, v in optimizer.state_dict()["param_groups"][0].items() if k != "params"}
    return {"state": {i: named[n] for i, n in enumerate(names) if n in named},
            "param_groups": [{**group, "params": list(range(len(names)))}]}


def full_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The Adam state of a vocabulary-sharded model in the unsharded layout
    (its moments gathered as full_state_dict gathers the parameters). A
    collective: every rank calls it."""
    names = [n for n, _ in model.named_parameters()]
    named = named_adam_state(optimizer, names)
    for name, st in named.items():
        owner = name.rpartition(".")[0]
        module = model.get_submodule(owner) if owner else model
        if isinstance(module, _VocabShard):
            named[name] = {k: _gather_rows(v, module) if k != "step" else v for k, v in st.items()}
    return adam_state_dict(optimizer, named, names)


def sum_gradients(params: Iterable[nn.Parameter], group: Any = None, divide: int = 1) -> None:
    """All-reduces (SUM) the parameters' gradients over `group` in one
    flat buffer, then divides by `divide` (a gradient that is None counts
    as zeros, so that every rank sends the same buffer)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat /= divide
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))
