"""Corpus preprocessing: walk a MIDI tree, tokenize, save .npy streams.

Port of musicgen_tpu/data/preprocess.py (reference processing/processing.py
:24-55): mirrors the <model>/<band>/<song> directory layout under the output
folder, skips files whose output already exists or whose name ends in a
numeric suffix, drops pieces with fewer than `min_notes` notes, and reports
(rather than silently drops) per-file codec errors. Tokens come from the
port's Python codec (midi/codec `extract_midi`, `encode`) alone: the port
does not load the JAX package's C++ tokenizer (native/), whose output the
JAX package's tests hold equal to the same codec's.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterable, List

import numpy as np

from ..midi import codec


def find_files_by_extensions(root: str, exts: Iterable[str]) -> List[str]:
    """Every file under `root` whose name ends in one of `exts` (any case), sorted."""
    out = []
    for path, _, files in os.walk(root):
        for name in files:
            if any(name.lower().endswith(e) for e in exts):
                out.append(os.path.join(path, name))
    return sorted(out)


def preprocess_midi_files(midi_folder: str, preprocess_folder: str, min_notes: int = 200,
                          verbose: bool = True) -> int:
    """Tokenizes every .mid / .midi file under `midi_folder` into
    `preprocess_folder/<model>/<band>/<song>.npy` (int64); returns the number
    of files written."""
    midi_paths = find_files_by_extensions(midi_folder, [".mid", ".midi"])
    os.makedirs(preprocess_folder, exist_ok=True)
    count = 0
    for path in midi_paths:
        parts = Path(path).parts
        model_name = parts[-3] if len(parts) >= 3 else "data"
        band_name = parts[-2] if len(parts) >= 2 else "unknown"
        out_dir = os.path.join(preprocess_folder, model_name, band_name)
        os.makedirs(out_dir, exist_ok=True)
        new_path = os.path.join(out_dir, Path(path).stem)
        if os.path.exists(new_path + ".npy") or re.search(r"\.\d+$", new_path):
            continue
        try:
            notes = codec.extract_midi(path)
            if len(notes) < min_notes:
                continue
            np.save(new_path + ".npy", np.asarray(codec.encode(notes), dtype=np.int64))
            count += 1
        except Exception as e:  # noqa: BLE001 - a broken file is reported and skipped, as the reference skips it
            if verbose:
                print(f"[preprocess] skipping {path}: {type(e).__name__}: {e}")
    return count


def remove_short_npy_files(root: str, min_length: int = 1030, dry_run: bool = False) -> int:
    """Delete token files shorter than `min_length` (reference
    scripts/fix_dataset.ipynb `remove_short_npy_files`); returns how many
    were (or, with dry_run, would be) removed. Unreadable files are left."""
    removed = 0
    for path in find_files_by_extensions(root, [".npy"]):
        try:
            n = np.load(path, mmap_mode="r").shape[0]
        except (OSError, ValueError):
            continue
        if n < min_length:
            if not dry_run:
                os.remove(path)
            removed += 1
    return removed
