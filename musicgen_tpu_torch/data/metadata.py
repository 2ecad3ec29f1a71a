"""Metadata tokenization: band / genres / decade -> 6 conditioning tokens.

Port of musicgen_tpu/data/metadata.py (numpy only), which the port cannot
import: `musicgen_tpu/data/__init__.py` pulls in jax. Decades, genres and
band names each get a contiguous token range with a reserved "null" token
just below it; every band maps to [band, genre x4 (padded with the genre
null token), decade]. The tokenization follows the reference's
tokenization.json schema.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

NUM_GENRE_SLOTS = 4


def floor_to_nearest_10(number: int) -> int:
    return (number // 10) * 10


def build_tokenization(metadata: dict) -> Tuple[dict, Dict[str, np.ndarray]]:
    """metadata: {"artists": [{"name", "year_started", "genres"}, ...]}.

    Returns (tokenizations_json_dict, {band: int32[6] meta tokens})."""
    genre_list: List[str] = []
    min_time, max_time = int(1e9), 0
    bands: Dict[str, dict] = {}
    for data in metadata["artists"]:
        decade = floor_to_nearest_10(int(data["year_started"]))
        min_time = min(min_time, decade)
        max_time = max(max_time, decade)
        for genre in data["genres"]:
            if genre not in genre_list:
                genre_list.append(genre)
        bands[data["name"]] = {"decade": decade, "genres": list(data["genres"])}

    num_decades = (max_time - min_time) // 10 + 1
    start_decade = 1
    start_genre = start_decade + num_decades + 1
    start_band = start_genre + len(genre_list) + 1

    time_tok = {str(t): i + start_decade for i, t in enumerate(range(min_time, max_time + 1, 10))}
    genre_tok = {g: i + start_genre for i, g in enumerate(genre_list)}
    band_tok = {b: i + start_band for i, b in enumerate(bands)}
    time_tok["null"] = start_decade - 1
    genre_tok["null"] = start_genre - 1
    band_tok["null"] = start_band - 1

    tokenizations = {
        "time_tokenized": time_tok,
        "genre_tokenized": genre_tok,
        "band_tokenized": band_tok,
        "VOCAB_SIZE": len(time_tok) + len(genre_tok) + len(band_tok),
    }
    band_vectors: Dict[str, np.ndarray] = {}
    for band, info in bands.items():
        genres = [genre_tok[g] for g in info["genres"]][:NUM_GENRE_SLOTS]
        genres += [start_genre - 1] * (NUM_GENRE_SLOTS - len(genres))
        vec = [band_tok[band]] + genres + [time_tok[str(info["decade"])]]
        band_vectors[band] = np.asarray(vec, dtype=np.int32)
    return tokenizations, band_vectors


def load_band_vectors(metadata_path: str | Path) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load metadata.json and build its tokenization."""
    with open(metadata_path, "r", encoding="utf-8") as f:
        return build_tokenization(json.load(f))
