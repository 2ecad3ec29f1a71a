"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `*.cu` file under `musicgen_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into one shared library with a plain C interface, in
`build/musicgen_tpu_torch/<hash>/` at the root of the checkout. The hash
covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Nothing is compiled at import time: the
first call of a kernel wrapper on a CUDA tensor builds and loads the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "musicgen_tpu_torch"
LIB_NAME = "libmusicgen_tpu_torch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes; every entry point returns the cudaError_t of its launch.
SIGNATURES = {
    "mg_ssd_scan": [_P] * 7 + [_I] * 6 + [_P],
    "mg_in_proj_conv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "mg_mixer_state": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "mg_out_proj_rms": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "mg_lm_head_ln": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "mg_sample_tail": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "musicgen_tpu_torch are built from source at first use"
        )
    return found


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.

    The compiler's output (ptxas register and shared-memory counts) is kept
    beside the library as `build.log`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out.parent / "build.log").write_text(
        log + f"\nexit {proc.returncode} after {time.perf_counter() - t0:.2f} s\n"
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mg_error_string.argtypes = [ctypes.c_int]
    lib.mg_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.mg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream on `t`'s device, as a pointer for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
