"""Kernel A's plan on the CPU (musicgen_tpu_torch.ops.ssd_kernel): the
chunk-parallel decomposition written out in plain PyTorch (`scan_partitioned`:
chunks of 64, each chunk's end state, the states passed in chunk order, the
inter-chunk term, the products in emulated 3xTF32) and the launch geometry,
held to the JAX package on the same numpy inputs.

Against the f32 sequential oracle `ssd_reference`: f32 rounding (the
tolerance of tests/test_torch_ssd_kernel.py). Against the TPU kernel in
interpret mode, which feeds bf16 into its products: bf16-scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops.pallas_ssd import ssd_chunked_pallas
from musicgen_tpu.ops.ssm import ssd_reference
from musicgen_tpu_torch.ops import ssd_kernel as sk
from musicgen_tpu_torch.ops.ssm import ssd_chunked


def _inputs(seed, b=2, t=64, h=4, g=1, p=64, n=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (b, t, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    return x, dt, A, B, C


class _OnCard(torch.Tensor):
    """A CPU tensor that answers is_cuda = True: it sends the wrapper down
    its kernel path without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("t,g", [(64, 1), (200, 1), (257, 1), (64, 2), (200, 2), (257, 2)])
def test_plan_matches_the_sequential_oracle(t, g):
    """T = 64 is one chunk, 200 a ragged last chunk, 257 one step past four."""
    arrays = _inputs(t + g, b=2, t=t, h=4, g=g)
    y, s = sk.scan_partitioned(*(torch.from_numpy(a) for a in arrays))
    y_r, s_r = ssd_reference(*(jnp.asarray(a) for a in arrays))
    assert y.shape == (2, t, 4, 64) and s.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("g", [1, 2])
def test_plan_matches_the_tpu_kernel_in_interpret_mode(g):
    arrays = _inputs(7 + g, b=1, t=128, h=2, g=g)
    y, s = sk.scan_partitioned(*(torch.from_numpy(a) for a in arrays))
    y_p, s_p = ssd_chunked_pallas(*(jnp.asarray(a) for a in arrays), chunk=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_p), rtol=3e-2, atol=1e-1)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_p), rtol=3e-2, atol=1e-1)


def test_plan_at_a_ragged_t_matches_the_zero_padded_chunked_scan():
    """The kernel zero-fills the last chunk; the model pads T to a chunk
    multiple with zeros (dt = 0 steps leave the state exact)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(11, b=3, t=150, h=2, g=1))
    y, s = sk.scan_partitioned(x, dt, A, B, C)
    pad = 192 - 150

    def padded(v):
        return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))

    y_c, s_c = ssd_chunked(padded(x), padded(dt), A, padded(B), padded(C), chunk=64)
    torch.testing.assert_close(y, y_c[:, :150], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s, s_c, rtol=1e-5, atol=1e-4)


def test_tf32_split_recombines_to_f32():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 1e3)
    hi = sk.tf32(v)
    lo = sk.tf32(v - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # TF32: the low 13 mantissa bits are clear
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2.0 ** -21
    assert float(((hi - v).abs() / v.abs()).max()) > 2.0 ** -14  # one TF32 pass alone loses more
    a, b = (torch.from_numpy(np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)) for _ in range(2))
    exact = (a.double() @ b.double())
    assert float((sk.mm3(a, b).double() - exact).abs().max()) < 1e-4 * float(exact.abs().max())


@pytest.mark.parametrize("b,t,h,g", [(3, 200, 4, 2), (1, 38, 2, 1), (2, 257, 3, 3)])
def test_launch_geometry_covers_every_block_once(b, t, h, g):
    geo = sk.scan_geometry(b, t, h, g)
    nc = -(-t // 64)
    assert geo.chunks == nc and geo.chunk_grid == (nc, h, b) and geo.pass_grid == (64 // sk.PASS_ROWS, h, b)
    items = [sk.chunk_block(x, y, z) for z in range(geo.chunk_grid[2]) for y in range(geo.chunk_grid[1])
             for x in range(geo.chunk_grid[0])]
    assert sorted(items) == [(i, j, c) for i in range(b) for j in range(h) for c in range(nc)]
    rows = [(bi, hi, p) for z in range(geo.pass_grid[2]) for y in range(geo.pass_grid[1])
            for x in range(geo.pass_grid[0]) for bi, hi, ps in [sk.pass_block(x, y, z)] for p in ps]
    assert sorted(rows) == [(i, j, p) for i in range(b) for j in range(h) for p in range(64)]
    # Shared memory: launch 1 four blocks a SM, launch 2 two (232,448 B a SM, 1 KB reserved a block).
    assert geo.threads == 128 and 4 * (geo.chunk_smem + 1024) <= 232448 and 2 * (geo.pass_smem + 1024) <= 232448


def test_launch_geometry_at_the_prefill_shape():
    """The Mamba prefill's scan: (B, T, H, G) = (2, 2048 + 6 padded to 2304,
    32, 1): 2,304 chunk blocks, 256 pass blocks, and 37.7 MB of end states."""
    geo = sk.scan_geometry(2, 2304, 32, 1)
    assert geo.chunks == 36 and geo.chunk_grid == (36, 32, 2) and geo.pass_grid == (4, 32, 2)
    assert geo.states == (2, 36, 32, 64, 64) and geo.cum == (2, 32, 2304)
    assert geo.scratch_bytes == 4 * 2 * 36 * 32 * 64 * 64 + 4 * 2 * 32 * 2304 == 38_338_560
    assert sk.scan_geometry(2, 2054, 32, 1).chunks == 33


def test_kernel_path_refuses_what_the_kernel_does_not_take():
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(5, b=1, t=8, h=4, g=2))
    sk.ssd_scan.launches = 0
    with pytest.raises(ValueError, match="headdim"):
        sk.ssd_scan(x[..., :32].as_subclass(_OnCard), dt, A, B, C)
    with pytest.raises(ValueError, match="headdim"):
        sk.ssd_scan(x.as_subclass(_OnCard), dt, A, B[..., :32], C[..., :32])
    x3, dt3, A3, B3, C3 = (torch.from_numpy(a) for a in _inputs(6, b=1, t=8, h=3, g=2))
    with pytest.raises(ValueError, match="does not divide"):
        sk.ssd_scan(x3.as_subclass(_OnCard), dt3, A3, B3, C3)
    with pytest.raises(ValueError, match="float32"):
        sk.ssd_scan(x.as_subclass(_OnCard), dt.double(), A, B, C)
    assert sk.ssd_scan.launches == 0
