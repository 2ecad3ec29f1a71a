"""Token-distribution analysis (reference: scripts/dataset_testing.ipynb:
histograms of each vocabulary field over the train split).

Port of musicgen_tpu/eval/distributions.py: numpy over the token streams,
as there."""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from ..config import VOCAB, VocabLayout

FIELDS = ("pitch", "dynamics", "length", "time", "tempo")


def field_histograms(
    token_arrays: Iterable[np.ndarray], layout: VocabLayout = VOCAB
) -> Dict[str, np.ndarray]:
    """Per-field histograms over raw token streams.

    Returns {field: counts} where counts is indexed by the in-field offset
    (pitch combines pitch+channel; use `pitch_channel_marginals` to split).
    """
    edges = [
        layout.pitch_start, layout.dyn_start, layout.length_start,
        layout.time_start, layout.tempo_start, layout.vocab_size,
    ]
    hists = {
        f: np.zeros(edges[i + 1] - edges[i], dtype=np.int64)
        for i, f in enumerate(FIELDS)
    }
    for arr in token_arrays:
        arr = np.asarray(arr)
        for i, f in enumerate(FIELDS):
            sel = arr[(arr >= edges[i]) & (arr < edges[i + 1])] - edges[i]
            np.add.at(hists[f], sel, 1)
    return hists


def pitch_channel_marginals(
    pitch_hist: np.ndarray, layout: VocabLayout = VOCAB
) -> Dict[str, np.ndarray]:
    """Split the combined pitch+channel histogram into marginals."""
    d = layout.disc
    grid = pitch_hist.reshape(d.channel, d.pitch)
    return {"channel": grid.sum(axis=1), "pitch": grid.sum(axis=0)}


def summarize(hists: Dict[str, np.ndarray]) -> Dict[str, dict]:
    out = {}
    for f, h in hists.items():
        total = int(h.sum())
        if total == 0:
            out[f] = {"total": 0}
            continue
        idx = np.arange(len(h))
        mean = float((idx * h).sum() / total)
        out[f] = {
            "total": total,
            "mean": mean,
            "mode": int(h.argmax()),
            "p95": int(idx[np.searchsorted(np.cumsum(h), 0.95 * total)]),
        }
    return out
