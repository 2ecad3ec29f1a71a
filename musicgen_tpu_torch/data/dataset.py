"""Token corpus: band directories of .npy event streams -> prompt crops.

Port of the part of musicgen_tpu/data/dataset.py that generation uses
(numpy only; the JAX package's data/__init__ imports jax). An item is
(src, trg, meta) = (seq[:-1], seq[1:], the 6 metadata tokens of the file's
parent directory), seq cropped at random or zero-padded to block_len + 1
tokens. The crop draws from the dataset's own seeded `random.Random`.
"""
from __future__ import annotations

import dataclasses
import os
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..config import NUM_META
from .metadata import load_band_vectors


def find_token_files(directory: str | Path) -> List[str]:
    out = []
    for root, _, files in os.walk(directory):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".npy"))
    return sorted(out)


@dataclasses.dataclass
class TokenDataset:
    """Index of a token corpus (band dirs of .npy files)."""

    file_paths: List[str]
    band_vectors: Dict[str, np.ndarray]
    block_len: int = 2048
    rng: random.Random = dataclasses.field(default_factory=lambda: random.Random(0))

    @classmethod
    def from_directory(
        cls,
        directory: str | Path,
        metadata_path: str | Path,
        block_len: int = 2048,
        seed: int = 0,
    ) -> "TokenDataset":
        paths = find_token_files(directory)
        random.Random(seed).shuffle(paths)
        _, band_vectors = load_band_vectors(metadata_path)
        return cls(paths, band_vectors, block_len, random.Random(seed))

    def __len__(self) -> int:
        return len(self.file_paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        path = self.file_paths[idx]
        seq = np.load(path)
        need = self.block_len + 1
        if len(seq) < need:
            seq = np.concatenate([seq, np.zeros(need - len(seq), dtype=np.int64)])
        elif len(seq) > need:
            ix = self.rng.randint(0, len(seq) - need)
            seq = seq[ix:ix + need]
        band = Path(path).parts[-2]
        meta = self.band_vectors.get(band, np.zeros(NUM_META, dtype=np.int32))
        return seq[:-1].astype(np.int32), seq[1:].astype(np.int32), meta
