"""Token corpus: band directories of .npy event streams -> training batches.

Port of musicgen_tpu/data/dataset.py (numpy only; the JAX package's
data/__init__ imports jax; reference processing/dataset.py:57-346). An item
is (src, trg, meta) = (seq[:-1], seq[1:], the 6 metadata tokens of the
file's parent directory), seq cropped to block_len + 1 tokens ('random',
'start' or 'end', the reference's off-by-one of 'end' kept) or zero-padded at
the end. Batches are drawn with replacement, weighted by file length
(WeightedRandomSampler), after an 80/20 split. Random crops draw from the
dataset's own seeded `random.Random` (the JAX package uses the module-level
`random`); the batch index streams are the JAX package's, draw for draw.
Augmentation runs on the device inside the train step (data/augment.py).
"""
from __future__ import annotations

import dataclasses
import os
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import NUM_META, TrainValues
from .metadata import load_band_vectors

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


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
    crop: str = "random"  # 'random' | 'start' | 'end'
    lengths: Optional[np.ndarray] = None
    rng: random.Random = dataclasses.field(default_factory=lambda: random.Random(0))

    @classmethod
    def from_directory(
        cls,
        directory: str | Path,
        metadata_path: str | Path,
        tokenizations_path: str | Path | None = None,
        block_len: int = 2048,
        crop: str = "random",
        seed: int = 0,
    ) -> "TokenDataset":
        paths = find_token_files(directory)
        random.Random(seed).shuffle(paths)
        _, band_vectors = load_band_vectors(metadata_path, tokenizations_path)
        return cls(paths, band_vectors, block_len, crop, rng=random.Random(seed))

    @classmethod
    def from_file_list(
        cls,
        file_paths: list,
        metadata_path: str | Path,
        block_len: int = 2048,
        crop: str = "random",
        seed: int = 0,
    ) -> "TokenDataset":
        """Explicit file list (reference train_classifier.py:52-57 loads
        train/test lists from data_distribution.json)."""
        _, band_vectors = load_band_vectors(metadata_path)
        return cls(list(file_paths), band_vectors, block_len, crop, rng=random.Random(seed))

    def __len__(self) -> int:
        return len(self.file_paths)

    def _load_lengths(self) -> np.ndarray:
        if self.lengths is None:
            self.lengths = np.asarray([np.load(p, mmap_mode="r").shape[0] for p in self.file_paths], dtype=np.int64)
        return self.lengths

    def file_prob(self) -> np.ndarray:
        """Length-proportional sampling weights (dataset.py:197-200)."""
        lengths = self._load_lengths().astype(np.float64)
        return lengths / lengths.sum()

    def __getitem__(self, idx: int) -> Batch:
        path = self.file_paths[idx]
        seq = np.load(path)
        need = self.block_len + 1
        if len(seq) < need:
            seq = np.concatenate([seq, np.zeros(need - len(seq), dtype=np.int64)])
        elif len(seq) > need:
            if self.crop == "end":
                ix = len(seq) - need - 1
            elif self.crop == "start":
                ix = 0
            else:
                ix = self.rng.randint(0, len(seq) - need)
            seq = seq[ix:ix + need]
        band = Path(path).parts[-2]
        meta = self.band_vectors.get(band, np.zeros(NUM_META, dtype=np.int32))
        return seq[:-1].astype(np.int32), seq[1:].astype(np.int32), meta


@dataclasses.dataclass
class Split:
    train_indices: np.ndarray
    test_indices: np.ndarray


def split_dataset(n: int, test_ratio: float = 0.2, seed: int = 0) -> Split:
    perm = np.random.default_rng(seed).permutation(n)
    test_size = int(n * test_ratio)
    return Split(train_indices=perm[test_size:], test_indices=perm[:test_size])


def _stack(dataset: TokenDataset, chosen) -> Batch:
    src, trg, meta = zip(*(dataset[int(i)] for i in chosen))
    return np.stack(src), np.stack(trg), np.stack(meta)


class BatchIterator:
    """Length-weighted, optionally rank-sharded batch stream: sampling with
    replacement (WeightedRandomSampler); each rank draws its own stream
    (common seed + rank offset), as DistributedSampler shards
    (dataset.py:291-297)."""

    def __init__(self, dataset: TokenDataset, indices: np.ndarray, batch_size: int, seed: int = 0, rank: int = 0,
                 world_size: int = 1, weighted: bool = True):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed * 100003 + rank)
        self.prob = None
        if weighted:
            prob = dataset.file_prob()[self.indices]
            self.prob = prob / prob.sum()
        self.steps_per_epoch = max(1, len(self.indices) // (batch_size * world_size))

    def sample_indices(self) -> np.ndarray:
        return self.rng.choice(self.indices, size=self.batch_size, replace=True, p=self.prob)

    def sample_batch(self) -> Batch:
        return _stack(self.dataset, self.sample_indices())

    def __iter__(self) -> Iterator[Batch]:
        for _ in range(self.steps_per_epoch):
            yield self.sample_batch()


def full_batches(dataset: TokenDataset, batch_size: int, indices: np.ndarray | None = None) -> Iterator[Batch]:
    """Deterministic sequential pass over the dataset (or the given index
    subset) in batch chunks, the short last chunk dropped (reference
    `get_dataloader_full(shuffle=False)`, dataset.py:324-332)."""
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    for lo in range(0, len(idx) - batch_size + 1, batch_size):
        yield _stack(dataset, idx[lo:lo + batch_size])


def make_loaders(dataset: TokenDataset, values: TrainValues = TrainValues(), seed: int = 0, rank: int = 0,
                 world_size: int = 1) -> Tuple[BatchIterator, BatchIterator]:
    """(train, test) iterators with the reference's 80/20 split."""
    split = split_dataset(len(dataset), values.test_ratio, seed)
    train = BatchIterator(dataset, split.train_indices, values.batch_size, seed, rank, world_size)
    test = BatchIterator(dataset, split.test_indices, values.batch_size, seed + 1, rank, world_size)
    return train, test
