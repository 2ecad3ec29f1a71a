"""Training losses, in PyTorch.

Port of musicgen_tpu/train/loss.py. `filtered_cross_entropy` is the
reference's objective (train.py:161-165): the grammar-filtered values
-log_softmax(logits) * mask are fed to the cross entropy AS IF they were
logits,

    loss = mean_t [ -log_softmax( filtered(prev_t, logits_t) )[target_t] ]

`chunked_filtered_cross_entropy` computes the same loss from the final
hidden states one time chunk at a time, each chunk under
torch.utils.checkpoint, so the (B, T, V) logits and their backward buffers
never exist whole. `classifier_bce` is the composer classifier's
multi-label objective (reference train_classifier.py:16-26): BCE-with-logits
against the multi-hot set of the sample's 6 meta tokens, the mean over every
element.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import VOCAB, VocabLayout
from ..ops.grammar import filtered_logits


def _nll_sum(prev_tokens, logits, targets, layout: VocabLayout) -> torch.Tensor:
    log_probs = torch.log_softmax(filtered_logits(prev_tokens, logits, layout), dim=-1)
    return -torch.gather(log_probs, -1, targets[..., None].long()).sum()


def filtered_cross_entropy(
    prev_tokens: torch.Tensor,  # (B, T) the model INPUT tokens
    logits: torch.Tensor,  # (B, T, V)
    targets: torch.Tensor,  # (B, T)
    layout: VocabLayout = VOCAB,
) -> torch.Tensor:
    return _nll_sum(prev_tokens, logits, targets, layout) / targets.numel()


def _chunk_nll(hc, pc, tc, weight, bias, layout: VocabLayout, project=None) -> torch.Tensor:
    hc = hc.to(torch.float32)
    logits = project(hc) if project is not None else torch.nn.functional.linear(hc, weight, bias)
    return _nll_sum(pc, logits, tc, layout)


def chunked_filtered_cross_entropy(
    prev_tokens: torch.Tensor,  # (B, T) the model INPUT tokens
    hidden: torch.Tensor,  # (B, meta+T, D) final-norm hidden (model.hidden())
    head_weight: torch.Tensor,  # (V, D), the lm_head / output_layer weight
    head_bias: torch.Tensor,  # (V,)
    targets: torch.Tensor,  # (B, T)
    chunk: int = 256,
    layout: VocabLayout = VOCAB,
    project=None,
) -> torch.Tensor:
    """filtered_cross_entropy(prev_tokens, head(hidden)[:, -T:], targets)
    without the whole (B, T, V) logits: the head, the grammar filter and the
    CE run per time chunk under checkpoint, so the backward recomputes each
    chunk's logits (one extra head product) and the vocab-sized memory is
    O(chunk), not O(T). The last chunk may be short. `project` (f32 hidden
    chunk -> logits) replaces the product with head_weight and head_bias: a
    vocabulary-parallel head (parallel/mesh.py) gathers its shards' logits,
    again in the backward's recomputation."""
    b, t = prev_tokens.shape
    h = hidden[:, hidden.shape[1] - t:, :]
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        total = total + checkpoint(_chunk_nll, h[:, lo:hi], prev_tokens[:, lo:hi], targets[:, lo:hi],
                                   head_weight, head_bias, layout, project, use_reentrant=False)
    return total / (b * t)


def make_meta_multihot(meta: torch.Tensor, metadata_vocab_size: int) -> torch.Tensor:
    """(B, 6) meta tokens -> (B, meta_vocab) multi-hot f32 targets. An id
    outside [0, metadata_vocab_size) sets nothing, as jax.nn.one_hot drops
    it; a padded genre slot (its null id) counts as a target, as in the JAX
    package."""
    ids = torch.arange(metadata_vocab_size, device=meta.device)
    return (meta[..., None] == ids).any(dim=-2).to(torch.float32)


def classifier_bce(logits: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits of (B, meta_vocab) logits against
    make_meta_multihot(meta), the mean over all elements (torch's default
    reduction, as the JAX package's)."""
    targets = make_meta_multihot(meta, logits.shape[-1])
    return torch.nn.functional.binary_cross_entropy_with_logits(logits.to(torch.float32), targets)
