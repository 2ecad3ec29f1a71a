"""ctypes binding of the C++ MIDI tokenizer (native/midi_tokenizer.cc).

Port of musicgen_tpu/midi/native.py, with a loader of the port's own. The
JAX package loads native/libmiditok.so, which `make -C native` writes and
git does not keep. The port builds the same source with the host C++
compiler (CXX, default g++, the Makefile's flags) at first use into
build/musicgen_tpu_torch/miditok-<hash of the source and flags>/, and never
writes into native/. `available()` is False where the source or a compiler
is missing or the build fails (`build_error()` says why); data/preprocess
then tokenizes with the Python codec, as the JAX package does. The
tokenizer's output equals the Python codec's (tests/test_torch_leftovers.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parents[2] / "native" / "midi_tokenizer.cc"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile's, and -shared
LIB_NAME = "libmiditok.so"
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"miditok-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compiles the tokenizer if it is not built yet; returns the library's
    path. Concurrent builds each write a file of their own and rename it
    into place."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX', 'g++')}) to build {SOURCE.name}")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        if not SOURCE.exists():
            raise RuntimeError(f"{SOURCE} is missing")
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _error = str(e)
        return None
    lib.midi_tokenize.restype = ctypes.c_int64
    lib.midi_tokenize.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the tokenizer is built (building it at the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the tokenizer is not available, after `available()` said so."""
    return _error


def tokenize_bytes(data: bytes, min_notes: int = 0) -> Optional[np.ndarray]:
    """MIDI file bytes -> int64 tokens through the native tokenizer. None
    where it is unavailable; raises on a parse error; an empty array where
    the file has fewer than min_notes notes."""
    lib = _load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    for cap in (max(64, len(data) * 2), len(data) * 8):  # tokens <= 5 notes <= about the bytes
        out = np.empty(cap, dtype=np.int64)
        n = lib.midi_tokenize(buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap, min_notes)
        if n != -6:  # -6: the buffer is too small (pathological); retry once, bigger
            break
    if n < 0:
        raise ValueError(f"native MIDI tokenizer error {n}")
    return out[:n].copy()


def tokenize_file(path: str, min_notes: int = 0) -> Optional[np.ndarray]:
    with open(path, "rb") as f:
        return tokenize_bytes(f.read(), min_notes)
