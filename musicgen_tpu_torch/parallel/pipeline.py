"""Pipeline-parallel training of Mamba and the Transformer: the layer stack
split over a pipe group with a GPipe microbatch schedule.

Port of musicgen_tpu/parallel/pipeline.py. Ranks sit on a (data, pipe) grid,
rank r at (r // S, r % S) for S stages. Stage s (`PipelineStage`) holds the
contiguous layers [s * L / S, (s + 1) * L / S) of the port's own model (its
Mamba2Mixer or Block modules, not copies of raw parameters) and only their
Adam moments. The vocabulary tables live whole on one stage each: stage 0
holds the token and metadata embeddings, the last stage the final norm and
the head (JAX shards the two vocabulary-sized matrices over the stages and
gathers them each step). A stage's state dict keeps the whole model's names,
so `pp_split` / `pp_join` (the counterparts of pp_format / pp_unformat)
split and join the one-process state dict, and rank 0 writes the reference
`.pth` layout.

The schedule is an explicit GPipe (`pp_loss`). Forward: microbatches 0..M-1
in turn, stage 0 embedding each, every stage sending its activations right,
the last stage running the final norm, the f32 head and the grammar-filtered
CE. Backward: the microbatches in reverse, each stage backpropagating the
cotangent it receives from the right and sending its input's gradient left.
Every rank posts its sends and receives in the same order, so they pair.
The numbers are JAX's tick scan's: the loss is the masked NLL sum over B * T
(the global batch), the position mask keeps the first NUM_META positions
out, and with a data axis each replica takes its share of every microbatch
and the gradients are summed over the data group. The stream travels in the
embedding table's dtype (f32), as JAX builds it; JAX's raw-parameter stages
then compute in f32 whatever --bf16 says, so cli.train --pp builds its model
in f32. The Transformer's blocks attend through flash_relpos_attention_train
on CUDA (kernel D with its LSE output, kernel E backward); the stages run
without dropout, as JAX's. cfg.remat recomputes a stage's layers in the
backward (torch.utils.checkpoint).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import NUM_META, VOCAB, MambaConfig, TransformerConfig, VocabLayout
from ..models.compute import embed, layer_norm
from ..ops.grammar import filtered_logits
from .mesh import adam_state_dict, axis_groups, named_adam_state, sum_gradients

PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class _Names:
    """The family's attribute names: the layer list, the two tables, the
    final norm, the head."""

    layers: str
    tok: str
    meta: str
    norm: str
    head: str


_MAMBA = _Names("layers", "token_embedding", "metadata_embedding", "norm", "output_layer")
_TRANSFORMER = _Names("blocks", "token_embedding_table", "metadata_embedding_table", "ln_f", "lm_head")


def _names(cfg) -> _Names:
    if isinstance(cfg, TransformerConfig):
        return _TRANSFORMER
    if isinstance(cfg, MambaConfig):
        return _MAMBA
    raise ValueError("pipeline parallelism implements Mamba and the Transformer only (an xLSTM has no stage "
                     "forward yet)")


def n_layers(cfg) -> int:
    return cfg.n_layer if isinstance(cfg, TransformerConfig) else cfg.n_layers


def default_microbatches(batch: int, n_stages: int) -> int:
    """Largest divisor of `batch` <= 4 * n_stages (JAX's): M = 4S brings the
    bubble (S - 1) / (M + S - 1) under about 20%; a batch smaller than 4S
    becomes per-example microbatches."""
    best = 1
    for m in range(1, min(batch, 4 * n_stages) + 1):
        if batch % m == 0:
            best = m
    return best


def stage_range(cfg, n_stages: int, index: int) -> range:
    """The layers of stage `index`; raises for a family without a stage
    forward and where n_stages does not divide the layers."""
    _names(cfg)
    total = n_layers(cfg)
    if total % n_stages:
        raise ValueError(f"n_layers {total} must divide over the '{PIPE_AXIS}' axis size {n_stages}")
    per = total // n_stages
    return range(index * per, (index + 1) * per)


def _owner(key: str, cfg, n_stages: int) -> int:
    """The stage that holds state-dict key `key`."""
    names = _names(cfg)
    head, _, rest = key.partition(".")
    if head == names.layers:
        return int(rest.partition(".")[0]) // (n_layers(cfg) // n_stages)
    return 0 if head in (names.tok, names.meta) else n_stages - 1


def pp_split(sd: Dict[str, torch.Tensor], cfg, n_stages: int) -> List[Dict[str, torch.Tensor]]:
    """The one-process state dict -> each stage's (the same keys and
    tensors, in the model's order)."""
    stage_range(cfg, n_stages, 0)
    parts: List[Dict[str, torch.Tensor]] = [{} for _ in range(n_stages)]
    for key, value in sd.items():
        parts[_owner(key, cfg, n_stages)][key] = value
    return parts


def pp_join(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Inverse of pp_split: the stages' state dicts in stage order, whose
    concatenation is the model's order."""
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        out.update(part)
    return out


class PipelineStage(nn.Module):
    """Stage `index` of `n_stages` of a MambaLM or TransformerLM: its
    contiguous layers (the model's own modules, under the model's names),
    with the embeddings on stage 0 and the final norm and head on the last
    stage. The rest of the model is not referenced: the caller drops it."""

    def __init__(self, model: nn.Module, n_stages: int, index: int):
        super().__init__()
        cfg = model.cfg
        self.cfg, self.dtype, self.names = cfg, model.dtype, _names(cfg)
        self.n_stages, self.index = n_stages, index
        self.first, self.last = index == 0, index == n_stages - 1
        self.width = cfg.n_embd if isinstance(cfg, TransformerConfig) else cfg.d_model
        n = self.names
        if self.first:  # registered in the model's order, so stage state dicts join in it
            setattr(self, n.tok, getattr(model, n.tok))
            setattr(self, n.meta, getattr(model, n.meta))
        layers = getattr(model, n.layers)
        setattr(self, n.layers, nn.ModuleDict({str(i): layers[i] for i in stage_range(cfg, n_stages, index)}))
        if self.last:
            setattr(self, n.norm, getattr(model, n.norm))
            setattr(self, n.head, getattr(model, n.head))
        self.stream_dtype = getattr(model, n.tok).weight.dtype

    def embed(self, src: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """Stage 0: the (mb, NUM_META + T, width) stream in the tables' dtype."""
        n = self.names
        return torch.cat([embed(getattr(self, n.meta), meta, self.stream_dtype),
                          embed(getattr(self, n.tok), src, self.stream_dtype)], dim=1)

    def run_layers(self, x: torch.Tensor) -> torch.Tensor:
        for layer in getattr(self, self.names.layers).values():
            if isinstance(self.cfg, TransformerConfig):
                x = layer(x)  # residuals inside the block
            else:
                y = layer(x)
                x = x + y if self.cfg.residual else y
        return x.to(self.stream_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(self.run_layers, x, use_reentrant=False)
        return self.run_layers(x)

    def head_loss(self, out: torch.Tensor, src: torch.Tensor, trg: torch.Tensor,
                  layout: VocabLayout = VOCAB) -> torch.Tensor:
        """The last stage: the masked NLL sum of a microbatch's stream."""
        n = self.names
        prev, tg = F.pad(src, (NUM_META, 0)), F.pad(trg, (NUM_META, 0))
        h = layer_norm(getattr(self, n.norm), out, self.dtype)
        logits = getattr(self, n.head)(h.to(torch.float32))
        log_probs = torch.log_softmax(filtered_logits(prev, logits, layout), dim=-1)
        nll = -torch.gather(log_probs, -1, tg[..., None].long())[..., 0]
        mask = (torch.arange(out.shape[1], device=out.device) >= NUM_META).to(torch.float32)[None, :]
        return torch.sum(nll * mask)


@dataclasses.dataclass
class PipeGrid:
    """This rank's place on the (data, pipe) grid over the whole group."""

    stages: int
    data: int
    rank: int
    pipe_group: Any = None
    data_group: Any = None

    @property
    def index(self) -> int:
        return self.rank % self.stages

    @property
    def data_index(self) -> int:
        return self.rank // self.stages

    def peer(self, stage: int) -> int:
        """The global rank of `stage` in this rank's pipe."""
        return self.data_index * self.stages + stage


def make_pipe_grid(stages: int, data: int = 1) -> PipeGrid:
    """The grid of the initialised process group: `data` pipes of `stages`
    ranks each (JAX's ('data', 'pipe') mesh); raises where they do not cover
    the group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if stages * data != world:
        raise ValueError(f"{data} x {stages} pipeline ranks do not cover a group of {world}: launch "
                         f"torchrun --nproc_per_node {stages * data}")
    if world == 1:
        return PipeGrid(1, 1, 0)
    pipe_group, data_group = axis_groups(data, stages, rank)
    return PipeGrid(stages, data, rank, pipe_group, data_group)


def _rows(k: int, mb: int, grid: PipeGrid) -> slice:
    """This data replica's rows of microbatch k (JAX shards each microbatch
    over 'data')."""
    loc = mb // grid.data
    lo = k * mb + grid.data_index * loc
    return slice(lo, lo + loc)


def pp_loss(
    stage: PipelineStage,
    src: torch.Tensor,  # (B, T) input tokens, the whole global batch on every rank
    trg: torch.Tensor,  # (B, T)
    meta: torch.Tensor,  # (B, NUM_META)
    grid: PipeGrid,
    microbatches: Optional[int] = None,
    layout: VocabLayout = VOCAB,
    backward: bool = False,
) -> torch.Tensor:
    """The grammar-filtered CE of the whole batch through the GPipe
    schedule, the same on every rank (JAX's pp_loss). With backward=True
    (under grad mode) the backward schedule follows and leaves this stage's
    gradients of its data replica's share in .grad (the caller sums them
    over the data group). Raises as JAX's: layers that do not divide over
    the stages, a batch that does not divide into the microbatches, a
    microbatch that does not divide over the data axis (the layers'
    refusal is PipelineStage's)."""
    if (stage.n_stages, stage.index) != (grid.stages, grid.index):
        raise ValueError(f"stage {stage.index} of {stage.n_stages} on rank {grid.index} of a {grid.stages}-stage pipe")
    b, t = src.shape
    m = microbatches or default_microbatches(b, grid.stages)
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    mb = b // m
    if mb % grid.data:
        raise ValueError(f"microbatch {mb} must divide the 'data' axis size {grid.data}")
    denom = float(b * t)
    shape = (mb // grid.data, t + NUM_META, stage.width)
    device = src.device

    ins, outs, sums = [], [], []
    for k in range(m):
        rows = _rows(k, mb, grid)
        if stage.first:
            x = stage.embed(src[rows], meta[rows])
        else:
            x = torch.empty(shape, dtype=stage.stream_dtype, device=device)
            dist.recv(x, grid.peer(stage.index - 1))
            x.requires_grad_(backward)
        out = stage(x)
        if stage.last:
            sums.append(stage.head_loss(out, src[rows], trg[rows], layout))
        else:
            dist.send(out.detach().contiguous(), grid.peer(stage.index + 1))
        ins.append(x)
        outs.append(out)

    if backward:
        for k in reversed(range(m)):
            if stage.last:
                (sums[k] / denom).backward()
            else:
                g = torch.empty(shape, dtype=stage.stream_dtype, device=device)
                dist.recv(g, grid.peer(stage.index + 1))
                outs[k].backward(g)
            if not stage.first:
                dist.send(ins[k].grad.contiguous(), grid.peer(stage.index - 1))

    total = torch.stack(sums).sum().detach() if stage.last else torch.zeros((), device=device)
    dist.all_reduce(total)
    return total / denom


def make_pp_train_step(stage: PipelineStage, optimizer: torch.optim.Optimizer, grid: PipeGrid,
                       microbatches: Optional[int] = None) -> Callable:
    """Returns step(src, trg, meta) -> loss: one GPipe forward and backward
    and this stage's Adam step (every rank passes the same global batch; the
    loss is the whole batch's, the same on every rank). With a data axis the
    stage's gradients are summed over its data group first."""

    @torch.enable_grad()
    def step(src, trg, meta):
        stage.eval()  # no dropout: JAX's stage forward has none
        optimizer.zero_grad(set_to_none=True)
        loss = pp_loss(stage, src, trg, meta, grid, microbatches, backward=True)
        if grid.data > 1:
            sum_gradients(stage.parameters(), grid.data_group)
        optimizer.step()
        return loss

    return step


def make_pp_eval_step(stage: PipelineStage, grid: PipeGrid, microbatches: Optional[int] = None) -> Callable:
    """Returns step(src, trg, meta) -> loss through the forward schedule
    alone, under no_grad."""

    @torch.no_grad()
    def step(src, trg, meta):
        stage.eval()
        return pp_loss(stage, src, trg, meta, grid, microbatches)

    return step


def pp_full_state(stage: PipelineStage, optimizer: torch.optim.Optimizer, grid: PipeGrid):
    """(state dict, Adam state dict) of the whole model in the one-process
    layout, gathered over this rank's pipe group (on the CPU). A
    collective: every rank calls it."""
    names = [n for n, _ in stage.named_parameters()]
    mine = ({k: v.cpu() for k, v in stage.state_dict().items()}, names,
            {n: {k: v.cpu() for k, v in st.items()} for n, st in named_adam_state(optimizer, names).items()})
    parts = [None] * grid.stages
    if grid.stages == 1:
        parts = [mine]
    else:
        dist.all_gather_object(parts, mine, group=grid.pipe_group)
    sd = pp_join([p[0] for p in parts])
    all_names = [n for p in parts for n in p[1]]
    named = {n: st for p in parts for n, st in p[2].items()}
    return sd, adam_state_dict(optimizer, named, all_names)
