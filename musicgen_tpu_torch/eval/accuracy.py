"""Per-field next-token accuracy harness.

Port of musicgen_tpu/eval/accuracy.py (the reference's Test Accuracy
notebook, scripts/Test Accuracy.ipynb cells 0-5): predictions are
argmax(filtered_logit) at the LAST position of each window, bucketed into
{pitch, dynamics, length, time, tempo} by the TARGET token's field, and
accumulated into per-field hit rates. The forward runs under no_grad, so on
the card a Transformer's attention takes kernel D and an xLSTM's sLSTM
kernel H.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from ..config import VOCAB, VocabLayout
from ..ops.grammar import field_bucket, filtered_logits

FIELDS = ("pitch", "dynamics", "length", "time", "tempo")


@torch.no_grad()
def last_position_prediction(model: nn.Module, src: torch.Tensor, meta: torch.Tensor,
                             layout: VocabLayout = VOCAB) -> torch.Tensor:
    """argmax over the grammar-filtered logits at the final position."""
    logits = model(src, meta)
    return torch.argmax(filtered_logits(src[:, -1], logits[:, -1, :], layout), dim=-1)


def accuracy_counts(predictions: np.ndarray, targets: np.ndarray,
                    layout: VocabLayout = VOCAB) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (hits[5], totals[5]) bucketed by the target token's field."""
    buckets = field_bucket(torch.as_tensor(np.asarray(targets, dtype=np.int64)), layout).numpy()
    hits = np.zeros(5, dtype=np.int64)
    totals = np.zeros(5, dtype=np.int64)
    for f in range(5):
        mask = buckets == f
        totals[f] += int(mask.sum())
        hits[f] += int((predictions[mask] == targets[mask]).sum())
    return hits, totals


def evaluate_accuracy(model: nn.Module, batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                      layout: VocabLayout = VOCAB) -> Dict[str, float]:
    """Full-dataset per-field accuracy (last-position protocol), the model
    in eval() mode on its own device."""
    device = next(model.parameters()).device
    model.eval()
    hits = np.zeros(5, dtype=np.int64)
    totals = np.zeros(5, dtype=np.int64)
    for src, trg, meta in batches:
        s, m = (torch.as_tensor(np.asarray(x, dtype=np.int64), device=device) for x in (src, meta))
        preds = last_position_prediction(model, s, m, layout).cpu().numpy()
        h, t = accuracy_counts(preds, np.asarray(trg)[:, -1], layout)
        hits += h
        totals += t
    return {FIELDS[f]: (hits[f] / totals[f] if totals[f] else float("nan")) for f in range(5)}
