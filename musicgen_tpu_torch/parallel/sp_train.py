"""Sequence-parallel Mamba training: the train step with the TIME axis split
over a process group (long-context mode).

Port of musicgen_tpu/parallel/sp_train.py. Each rank of the group holds the
whole model and the whole global batch, and runs the Mamba stack, the final
norm, the head and the grammar-filtered CE on its contiguous 1/S slice of
the stream (the 6 metadata positions, then the tokens), so activation memory
scales as T/S. Two seams cross the ranks in every mixer:

  * the causal conv's (K-1)-step halo: each rank sends its last K-1 raw conv
    inputs to its right neighbour and receives its left neighbour's; rank 0
    keeps the zero left pad, the whole-sequence conv's (`_Halo`, an autograd
    Function over send/recv: right in the forward, left in the backward);
  * the SSD scan: the affine state composition of parallel/sequence.py (an
    all-gather of (decay_total, contrib) a layer).

The embedding is looked up for the whole stream on every rank (its slice
taken after), so the tables get a gradient on every rank (zeros where the
slice misses them) and every rank reduces the same set of gradients. The
loss: a position mask keeps the first NUM_META positions out, as the
standard forward's [:, 6:] slice does; each rank's share is its masked NLL
sum over the global count B * T, the shares sum to the loss, and the
gradient is each rank's local backward summed over the group (SUM: every
parameter is replicated). Computes in the model's dtype; cli.train --sp
builds f32, the JAX path's (its stream is the f32 tables'). The scan is the
plain one (kernel A has no backward), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import NUM_META, VOCAB, VocabLayout
from ..models.compute import dense, layer_norm
from ..models.mamba import Mamba2Mixer, MambaLM
from ..ops.grammar import filtered_logits
from ..ops.ssm import causal_conv1d
from .mesh import sum_gradients
from .sequence import ssd_sequence_parallel


def _peer(group: Any, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def exchange(sends: list, recvs: list, group: Any) -> None:
    """Posts every (tensor, group rank) send and receive at once and waits
    for all of them."""
    ops = [dist.P2POp(dist.isend, t, _peer(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, _peer(group, r), group) for t, r in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _Halo(torch.autograd.Function):
    """tail (B, K-1, C), this rank's last K-1 conv inputs -> the left
    neighbour's tail (zeros on rank 0). Backward: the halo's cotangent goes
    back to the left neighbour; the tail's comes from the right one (zeros
    on the last rank)."""

    @staticmethod
    def forward(ctx, tail, group, rank, n):
        ctx.group, ctx.rank, ctx.n = group, rank, n
        tail = tail.contiguous()
        halo = torch.zeros_like(tail)
        exchange([(tail, rank + 1)] if rank + 1 < n else [], [(halo, rank - 1)] if rank > 0 else [], group)
        return halo

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        grad_tail = torch.zeros_like(g)
        exchange([(g, ctx.rank - 1)] if ctx.rank > 0 else [],
                 [(grad_tail, ctx.rank + 1)] if ctx.rank + 1 < ctx.n else [], ctx.group)
        return grad_tail, None, None, None


def mixer_local(layer: Mamba2Mixer, u: torch.Tensor, group: Any, chunk: int) -> torch.Tensor:
    """One Mamba2Mixer on this rank's time slice u (B, T_loc, d_model):
    Mamba2Mixer._scan with the conv halo and the sequence-parallel scan."""
    c = layer.cfg
    b, t_loc, _ = u.shape
    z, x, Bm, Cm, dt = layer._split_in_proj(dense(layer.in_proj, u, layer.dtype))
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    k = c.d_conv
    halo = _Halo.apply(xbc[:, t_loc - (k - 1):], group, dist.get_rank(group), dist.get_world_size(group))
    conv = causal_conv1d(torch.cat([halo, xbc], dim=1), layer.conv_w, layer.conv1d.bias)[:, k - 1:]
    x, Bm, Cm = layer._split_xbc(F.silu(conv))
    dt = F.softplus(dt.to(torch.float32) + layer.dt_bias)
    A = -torch.exp(layer.A_log)
    xh = x.reshape(b, t_loc, c.nheads, c.headdim)
    y, _ = ssd_sequence_parallel(xh, dt.reshape(b, t_loc, c.nheads), A, Bm.reshape(b, t_loc, c.ngroups, c.d_state),
                                 Cm.reshape(b, t_loc, c.ngroups, c.d_state), group, chunk)
    y = y + xh.to(y.dtype) * layer.D[None, None, :, None]
    y = layer.norm(y.reshape(b, t_loc, c.d_inner).to(u.dtype), z)
    return dense(layer.out_proj, y, layer.dtype)


def sp_loss(
    model: MambaLM,
    src: torch.Tensor,  # (B, T) input tokens, the whole batch on every rank
    trg: torch.Tensor,  # (B, T) targets
    meta: torch.Tensor,  # (B, NUM_META)
    group: Any = None,
    chunk: int = 64,
    layout: VocabLayout = VOCAB,
) -> torch.Tensor:
    """This rank's share of the grammar-filtered CE of the Mamba LM with time
    split over `group` (None: the whole world): its slice's masked NLL sum
    over B * T. The shares over the group sum to the standard forward's
    filtered_cross_entropy (JAX's sp_loss). Requires T + NUM_META divisible
    by the group's size; `chunk` shrinks to the largest divisor of the
    slice's length that is at most `chunk`."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, t = src.shape
    stream = t + NUM_META
    if stream % n:
        raise ValueError(f"stream length {stream} (= T + {NUM_META}) must divide the 'sp' axis size {n}")
    t_loc = stream // n
    if t_loc % chunk:
        chunk = max(g for g in range(1, min(chunk, t_loc) + 1) if t_loc % g == 0)
    part = slice(r * t_loc, (r + 1) * t_loc)

    x = model._embed(src, meta)[:, part]
    prev = F.pad(src, (NUM_META, 0))[:, part]
    tg = F.pad(trg, (NUM_META, 0))[:, part]
    for layer in model.layers:
        x = model._stack(x, mixer_local(layer, x, group, chunk))
    logits = model.output_layer(layer_norm(model.norm, x, model.dtype).to(torch.float32))
    log_probs = torch.log_softmax(filtered_logits(prev, logits, layout), dim=-1)
    nll = -torch.gather(log_probs, -1, tg[..., None].long())[..., 0]
    pos = r * t_loc + torch.arange(t_loc, device=src.device)
    mask = (pos >= NUM_META).to(torch.float32)[None, :]
    return torch.sum(nll * mask) / (b * t)


def sp_loss_value(model: MambaLM, src, trg, meta, group: Any = None, chunk: int = 64) -> torch.Tensor:
    """The whole loss (the shares summed over the group), without
    gradients: the same on every rank."""
    with torch.no_grad():
        total = sp_loss(model, src, trg, meta, group, chunk)
        dist.all_reduce(total, group=group)
    return total


def make_sp_train_step(model: MambaLM, optimizer: torch.optim.Optimizer, group: Any = None,
                       chunk: int = 64) -> Callable:
    """Returns step(src, trg, meta) -> loss: the sequence-parallel Adam step
    (every rank passes the same global batch; the loss is the whole batch's,
    the same on every rank)."""

    @torch.enable_grad()
    def step(src, trg, meta):
        optimizer.zero_grad(set_to_none=True)
        share = sp_loss(model, src, trg, meta, group, chunk)
        share.backward()
        sum_gradients(model.parameters(), group)
        optimizer.step()
        total = share.detach().clone()
        dist.all_reduce(total, group=group)
        return total

    return step
