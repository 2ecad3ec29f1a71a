"""Kernel A's wrapper (musicgen_tpu_torch.ops.ssd_kernel) on the CPU, and the
kernel build's behaviour where there is no CUDA toolkit.

On CPU tensors `ssd_scan` runs its plain version; the CUDA kernel itself is
held to that plain version by chip_smoke.py on the GPU."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops.pallas_ssd import ssd_chunked_pallas
from musicgen_tpu.ops.ssm import ssd_reference
from musicgen_tpu_torch.ops import build
from musicgen_tpu_torch.ops.ssd_kernel import ssd_scan
from musicgen_tpu_torch.ops.ssm import ssd_chunked


def _inputs(seed, b=2, t=64, h=4, p=64, g=1, n=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (b, t, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk,g", [(16, 1), (32, 1), (16, 2)])
def test_ssd_scan_matches_pallas_kernel_in_interpret_mode(chunk, g):
    """The port's scan vs the TPU kernel run in interpret mode. The TPU kernel
    feeds bf16 into its products, so the tolerance is bf16-scale (as in
    tests/test_pallas_ssd.py); against the f32 sequential oracle the port
    agrees to f32 rounding."""
    arrays = _inputs(chunk + g, g=g)
    y_t, s_t = ssd_scan(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    y_p, s_p = ssd_chunked_pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_p), rtol=3e-2, atol=1e-1)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=3e-2, atol=1e-1)
    y_r, s_r = ssd_reference(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-4)


def test_ssd_scan_on_cpu_is_the_plain_version_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs(0, t=32)]
    before = ssd_scan.launches
    y, s = ssd_scan(*arrays, chunk=16)
    y_c, s_c = ssd_chunked(*arrays, chunk=16)
    assert torch.equal(y, y_c) and torch.equal(s, s_c)
    assert ssd_scan.launches == before
    assert build.load_library.cache_info().currsize == 0  # nothing was built


def test_ssd_scan_on_cpu_rejects_ragged_length():
    arrays = [torch.from_numpy(a) for a in _inputs(1, t=40)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(*arrays, chunk=16)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No CUDA toolkit: building the kernels fails loudly, naming nvcc."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_build_is_keyed_by_the_sources():
    sources = [p.name for p in build.sources()]
    assert {"ssd_scan.cu", "decode_gemv.cu", "decode_mixer.cu", "decode_tail.cu", "common.cuh"} <= set(sources)
    assert build.library_path().parent.name == build.source_hash()
    assert build.library_path().is_relative_to(build.BUILD_ROOT)
    # Every C entry point has a ctypes signature with as many arguments.
    text = "".join(p.read_text() for p in build.sources())
    exported = dict(re.findall(r"MG_EXPORT int (mg_\w+)\(([^)]*)\)", text))
    assert set(exported) == set(build.SIGNATURES)
    for name, params in exported.items():
        assert params.count(",") + 1 == len(build.SIGNATURES[name]), name
