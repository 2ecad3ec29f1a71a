"""The time-sharded SSD scan over a process group.

Port of musicgen_tpu/parallel/sequence.py. The SSD state transform over any
span of time is affine in the incoming state,

    state_out = decay_total * state_in + contrib,
    decay_total = exp(sum dA),   contrib = the local scan from a zero state,

and affine maps compose associatively. So each rank of the group, holding
the r-th contiguous slice of time:
  1. runs the local chunked scan (ops/ssm.ssd_chunked, the plain scan:
     kernel A has no backward) from a zero state,
  2. all-gathers every rank's (decay_total, contrib),
  3. composes the maps of the ranks before it into its incoming state (and
     all of them into the sequence's final state, the same on every rank),
  4. adds the linear correction  y_t += exp(cumsum dA)_t * C_t . state_in.

Gradients: each rank backpropagates its own share of a loss. The
all-gather's backward sums the cotangents of every rank's copy (a
reduce-scatter, written as an all-reduce and a slice: gloo has no
reduce-scatter), which is shard_map's transpose; the replicated inputs'
gradients (A) are then partial sums that the caller sums over the group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..ops.ssm import ssd_chunked

_F32 = torch.float32


class _AllGather(torch.autograd.Function):
    """x on each of the group's ranks -> (n, *x.shape), rank i's x at i; the
    backward sums the cotangent over the group and keeps this rank's row."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index = group, index
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


def all_gather(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Differentiable all-gather over `group` (None: the whole world):
    (group size, *x.shape)."""
    return _AllGather.apply(x, group, dist.get_world_size(group), dist.get_rank(group))


def ssd_sequence_parallel(x, dt, A, Bmat, C, group: Any = None, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded SSD scan over `group` (None: the whole world). Every
    argument but A is this rank's contiguous slice of time, rank r holding
    slice r: x (B, T_loc, H, P), dt (B, T_loc, H), A (H,), Bmat / C (B,
    T_loc, G, N), T_loc a multiple of `chunk`. Returns (this rank's y (B,
    T_loc, H, P) f32, the whole sequence's final state (B, H, P, N), the same
    on every rank)."""
    h, g = x.shape[2], Bmat.shape[2]
    y_local, contrib = ssd_chunked(x, dt, A, Bmat, C, chunk=chunk)

    da = dt.to(_F32) * A.to(_F32)[None, None, :]  # (B, T_loc, H)
    decay_total = torch.exp(torch.sum(da, dim=1))  # (B, H)
    decays = all_gather(decay_total, group)  # (S, B, H)
    contribs = all_gather(contrib, group)  # (S, B, H, P, N)

    # Every rank's state_in selects from the composed maps (JAX's masked
    # loop), so the gathers sit on every rank's path to its y and each
    # rank runs their backwards (an all-reduce each) even where it only
    # selects zeros.
    idx = torch.tensor(dist.get_rank(group), device=x.device)
    state_in = torch.zeros_like(contrib)
    full_state = torch.zeros_like(contrib)
    for j in range(decays.shape[0]):
        state_in = torch.where(j < idx, decays[j][..., None, None] * state_in + contribs[j], state_in)
        full_state = decays[j][..., None, None] * full_state + contribs[j]

    Ch = C.to(_F32).repeat_interleave(h // g, dim=2)  # (B, T_loc, H, N)
    in_decay = torch.exp(torch.cumsum(da, dim=1))  # (B, T_loc, H)
    y_corr = torch.einsum("bthn,bhpn,bth->bthp", Ch, state_in, in_decay)
    return y_local + y_corr.to(y_local.dtype), full_state
