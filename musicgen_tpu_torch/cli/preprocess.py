"""Corpus preprocessing CLI of the port (port of musicgen_tpu/cli/
preprocess.py; reference processing.preprocess_midi_files): MIDI tree ->
.npy token streams, on the host: the C++ tokenizer (midi/native, built
from native/midi_tokenizer.cc at first use) where a compiler builds it, the
port's Python codec otherwise, as in the JAX package.

  python -m musicgen_tpu_torch.cli.preprocess --midi data/midi --out data/np

The output mirrors the input as <out>/<basename of --midi>/<band>/<song>.npy:
pass that directory to `cli.train --data`.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..data.preprocess import preprocess_midi_files


def main(argv: Optional[List[str]] = None) -> int:
    """Runs the CLI; returns the number of files tokenized."""
    p = argparse.ArgumentParser(description="Tokenize a MIDI corpus to .npy")
    p.add_argument("--midi", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min-notes", type=int, default=200)
    args = p.parse_args(argv)
    n = preprocess_midi_files(args.midi, args.out, args.min_notes)
    print(f"tokenized {n} files")
    return n


if __name__ == "__main__":
    main()
