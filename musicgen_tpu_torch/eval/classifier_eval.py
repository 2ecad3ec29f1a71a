"""Composer-conditioning fidelity: the classifier's success-rate harness.

Port of musicgen_tpu/eval/classifier_eval.py (the reference's
test_classifier notebook, scripts/test_classifier.ipynb cells 0-8): the
classifier's logits are restricted to the band-token slice of the metadata
vocabulary, the argmax band is compared with the conditioning band token,
and success rates are accumulated per band. The forward runs under no_grad:
on the card the classifier's sLSTM blocks take kernel H.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def band_predictions(model: nn.Module, tokens: torch.Tensor, band_start: int) -> torch.Tensor:
    """argmax over the band slice (reference: guesses =
    model(src)[:, band_start:].argmax(-1) + band_start)."""
    return torch.argmax(model(tokens)[:, band_start:], dim=-1) + band_start


def evaluate_success_rates(model: nn.Module, batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                           band_start: int) -> Dict[int, float]:
    """Per-band success rate {band_token: fraction correctly recovered} over
    (tokens, meta) batches, the model in eval() mode on its own device."""
    device = next(model.parameters()).device
    model.eval()
    hits: Dict[int, int] = {}
    totals: Dict[int, int] = {}
    for tokens, meta in batches:
        t = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=device)
        preds = band_predictions(model, t, band_start).cpu().numpy()
        for band, pred in zip(np.asarray(meta)[:, 0], preds):
            totals[int(band)] = totals.get(int(band), 0) + 1
            hits[int(band)] = hits.get(int(band), 0) + int(pred == band)
    return {b: hits.get(b, 0) / t for b, t in totals.items()}
