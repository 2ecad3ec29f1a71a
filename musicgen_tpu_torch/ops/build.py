"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `*.cu` file under `musicgen_tpu_torch/csrc/` is compiled by its own
`nvcc` for `sm_90a` (all started together), and the objects are linked into
one shared library with a plain C interface, in
`build/musicgen_tpu_torch/<hash>/` at the root of the checkout. The hash
covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Nothing is compiled at import time: the
first call of a kernel wrapper on a CUDA tensor builds and loads the library.

`-fmad=false`: no multiply and add is contracted by the compiler (explicit
`fmaf` still is), so a device function shared by two kernels computes the
same bits in both (csrc/decode_ops.cuh). Cooperative launches need no
`-rdc` on CUDA 11 and later.
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> argtypes; every entry point returns the cudaError_t of its launch.
SIGNATURES = {
    "mg_ssd_scan": [_P] * 7 + [_I] * 6 + [_P],
    "mg_in_proj_conv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "mg_mixer_state": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "mg_out_proj_rms": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "mg_lm_head_ln": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "mg_sample_tail": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
    "mg_flash_relpos": [_P, _P, _P, _L, _L, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "mg_flash_bwd_dq": [_P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _P, _P, _P, _P, _L] + [_I] * 5 + [_F, _P],
    "mg_flash_bwd_dkv": [_P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _P, _P, _P, _P] + [_I] * 5 + [_F, _P],
    "mg_t_qkv_ln": [_P] * 6 + [_I, _I, _I, _F, _P, _P, _I, _I, _I, _P],
    "mg_t_fc_relu": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    "mg_t_res": [_P] * 5 + [_I, _I, _I, _I, _P],
    "mg_tdecode_attn_split": [_P, _I] + [_P] * 6 + [_I] * 6 + [_F, _I, _P, _P, _P, _P],
    "mg_tdecode_attn_combine": [_P] * 4 + [_I] * 4 + [_P],
    "mg_slstm_scan": [_P] * 5 + [_I] * 4 + [_P],
    "mg_x_gemv": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    "mg_xm_prep": [_P] * 6 + [_I] * 2 + [_P],
    "mg_xm_gates": [_P] * 6 + [_I] * 3 + [_P],
    "mg_xm_memory": [_P] * 4 + [_I] * 4 + [_P],
    "mg_xm_out": [_P] * 6 + [_I] * 3 + [_F, _P],
    "mg_xs_prep": [_P] * 6 + [_I] * 2 + [_F, _P],
    "mg_xs_cell": [_P] * 7 + [_I] * 3 + [_F, _P],
    "mg_probe_mm": [_P] * 3 + [_I] * 3 + [_P],
    "mg_ablate_gemv": [_P] * 4 + [_I] * 4 + [_P],
    "mg_ablate_stream": [_P] * 6 + [_I] * 6 + [_F, _P, _P],
    "mg_ablate_nossd": [_P] * 4 + [_I] * 5 + [_F, _P],
    # (pointer array, its length, int array, its length, grid size out, stream)
    **{f"mg_generate_resident_{fmt}": [_P, _I, _P, _I, _P, _P] for fmt in ("bf16", "w8a16", "w8a8")},
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

    One nvcc per source, run in parallel, then one link. The compilers'
    output (ptxas register and shared-memory counts) is kept beside the
    library as `build.log`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{text}exit {proc.returncode}\n")
        failed |= proc.returncode != 0
    if not failed:
        tmp = out.with_suffix(f".{tag}")
        cmd = [nvcc(), "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}exit {proc.returncode}\n")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "".join(log)
    (out.parent / "build.log").write_text(text + f"\nbuilt in {time.perf_counter() - t0:.2f} s\n")
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text[-6000:]}")
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: its
    output, written through a raw pointer, would silently leave the graph."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: call it under torch.no_grad(), or take the differentiable "
                           "path (the plain version, or flash_relpos_attention_train for attention)")


def stream_ptr(t) -> int:
    """The current CUDA stream on `t`'s device, as a pointer for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
