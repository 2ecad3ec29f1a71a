"""Grammar / loss-shaping ops ("filtered logits"), in PyTorch.

Port of musicgen_tpu/ops/grammar.py; the semantics (including the reference's
off-by-one field ranges) are documented there. The filtered value is
-log_softmax(logits) * mask: the sampler treats it as an unnormalised
probability vector.

The length row takes the live 'linspace' weighting by default, or the
frozen corpus-measured tensor of ops/length_distribution.py
(length_weights="empirical"), which no sampler or trainer path passes.
"""
from __future__ import annotations

import torch

from ..config import VOCAB, VocabLayout


LENGTH_WEIGHTS = ("linspace", "empirical")


def grammar_mask(
    layout: VocabLayout = VOCAB, device: torch.device | str | None = None, length_weights: str = "linspace"
) -> torch.Tensor:
    """(5, vocab) float32 allowed-next-token weights, one row per field of
    the previous token (0 pitch, 1 dyn, 2 length, 3 time, 4 tempo).
    length_weights: 'linspace' (the reference's live path, train.py:18) or
    'empirical' (ops/length_distribution.py's frozen tensor)."""
    if length_weights not in LENGTH_WEIGHTS:
        raise ValueError(f"length_weights must be one of {LENGTH_WEIGHTS}, got {length_weights!r}")
    d = layout.disc
    v = layout.vocab_size
    ids = torch.arange(v, device=device)

    def in_range(lo, hi):
        return ((ids >= lo) & (ids < hi)).to(torch.float32)

    row0 = in_range(layout.dyn_start, layout.length_start - 1)
    if length_weights == "empirical":
        from .length_distribution import empirical_length_weights

        emp = empirical_length_weights(d.length - 1, device)
        lin = emp[torch.clamp(ids - layout.length_start, 0, d.length - 2)]
    else:
        lin = 1.0 + 2.0 * (ids - layout.length_start).to(torch.float32) / float(d.length - 2)
    row1 = in_range(layout.length_start, layout.time_start - 1) * lin
    row2 = in_range(layout.time_start, layout.tempo_start - 1) + in_range(layout.tempo_start, v)
    row3 = in_range(layout.tempo_start, v)
    row4 = in_range(layout.pitch_start, layout.dyn_start - 1) * 10.0
    return torch.stack([row0, row1, row2, row3, row4])


def field_bucket(tokens: torch.Tensor, layout: VocabLayout = VOCAB) -> torch.Tensor:
    """Token -> field bucket in {0..4}; boundary values bucket LOW
    (searchsorted side='left', as torch.bucketize(right=False))."""
    boundaries = torch.tensor(layout.field_boundaries, dtype=tokens.dtype, device=tokens.device)
    return torch.bucketize(tokens.contiguous(), boundaries, right=False)


def pick_weights_by_prev_token(
    prev_tokens: torch.Tensor, layout: VocabLayout = VOCAB
) -> torch.Tensor:
    """(...,) int tokens -> (..., vocab) mask rows."""
    mask = grammar_mask(layout, device=prev_tokens.device)
    return mask[field_bucket(prev_tokens, layout)]


def filtered_logits(
    prev_tokens: torch.Tensor, logits: torch.Tensor, layout: VocabLayout = VOCAB
) -> torch.Tensor:
    """-log_softmax(logits) * grammar_weights(prev_tokens)."""
    weights = pick_weights_by_prev_token(prev_tokens, layout)
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -log_probs * weights
