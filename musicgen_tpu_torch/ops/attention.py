"""Causal relative-position attention with an always-visible metadata prefix,
in plain PyTorch (f32).

Port of musicgen_tpu/ops/attention.py (reference
models/transformer/model_transformer.py:54-90 `HeadRelPos`, :8-16
`generate_matrix`): Transformer-XL AC+BD scores with a learnable per-head
relative-position embedding and the shift trick, masked causally except that
the first `n_meta` key columns (the metadata prefix) are visible to every
query. Quirks kept: the softmax scale is n_embd**-0.5 (the model width, not
head_dim), and score[t, s] uses rel_emb[T - 1 - (t - s)] as torch's
pad+reshape `_rel_shift` gives it.

Kernel D (ops/attention_kernel.py) computes `relpos_attention` fused; this
module is its truth oracle.
"""
from __future__ import annotations

import torch

from ..config import NUM_META

NEG_INF = float("-inf")


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift, torch's view trick: x (..., T, T) with
    x[..., t, s] = q_t . rel_s gives y[..., t, s] = x[..., t, s - t + T - 1]
    (wrapped next-row values above the diagonal band)."""
    *lead, t, s = x.shape
    padded = torch.cat([x.new_zeros(*lead, t, 1), x], dim=-1)  # (..., T, T+1)
    return padded.reshape(*lead, s + 1, t)[..., 1:, :].reshape(*lead, t, s)


def meta_causal_mask(t: int, n_meta: int = NUM_META, dtype=torch.float32, device=None) -> torch.Tensor:
    """(T, T) additive mask: causal, with the first n_meta columns always
    visible (reference generate_matrix(n, 1) with matrix[:, :6] = 1)."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    visible = (j <= i) | (j < n_meta)
    return torch.where(visible, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))


def relpos_attention(
    q: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    rel_emb: torch.Tensor,  # (H, >= T, D)
    scale: float,
    n_meta: int = NUM_META,
    torch_exact_bd: bool = False,
) -> torch.Tensor:
    """Full-sequence attention, (B, H, T, D). BD above the diagonal is 0
    (as kernel D and the cached step define it) unless torch_exact_bd keeps
    rel_shift's wrapped values, which the mask leaves visible only in the
    metadata columns of rows < n_meta."""
    t = q.shape[2]
    ac = torch.einsum("bhtd,bhsd->bhts", q, k)
    bd = rel_shift(torch.einsum("bhtd,hsd->bhts", q, rel_emb[:, :t, :]))
    if not torch_exact_bd:
        ti = torch.arange(t, device=q.device)
        bd = torch.where((ti[None, :] <= ti[:, None])[None, None], bd, 0.0)
    scores = (ac + bd) * scale
    scores = scores + meta_causal_mask(t, n_meta, scores.dtype, q.device)[None, None]
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


def relpos_attention_step(
    q: torch.Tensor,  # (B, H, D) single query
    k_cache: torch.Tensor,  # (B, H, S, D) cached keys (any slot order)
    v_cache: torch.Tensor,  # (B, H, S, D)
    rel_emb: torch.Tensor,  # (H, T, D) with T >= S
    scale: float,
    key_ages: torch.Tensor,  # (S,) or (B, S) int: query_pos - key_pos; < 0 masked
    rel_base: int | torch.Tensor,  # the query's row index in the window
) -> torch.Tensor:
    """One cached attention step over a (possibly ring-ordered) KV cache,
    (B, H, D). The BD term of a key `age` steps behind the query reads
    rel_emb[rel_base - age]; slots with age < 0 or age > rel_base are masked.
    (B, S) ages give each batch row its own offsets (continuous batching).

    The JAX package picks between two XLA lowerings of the (B, S) gather
    with MUSICGEN_RELPOS_BD; both compute this same math, so the port has
    the one gather form only."""
    t = rel_emb.shape[1]
    ac = torch.einsum("bhd,bhsd->bhs", q, k_cache)
    rel_idx = torch.clamp(rel_base - key_ages, 0, t - 1)
    vis = (key_ages >= 0) & (key_ages <= rel_base)
    if key_ages.dim() == 2:
        rel = rel_emb[:, rel_idx, :]  # (H, B, S, D)
        bd = torch.einsum("bhd,hbsd->bhs", q, rel)
        visible = vis[:, None, :]
    else:
        rel = rel_emb[:, rel_idx, :]  # (H, S, D)
        bd = torch.einsum("bhd,hsd->bhs", q, rel)
        visible = vis[None, None, :]
    scores = torch.where(visible, (ac + bd) * scale, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(v_cache.dtype)
    return torch.einsum("bhs,bhsd->bhd", probs, v_cache)
