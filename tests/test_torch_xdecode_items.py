"""Kernel G's item split in plain form (musicgen_tpu_torch.ops.xdecode_kernel
ITEM_OPS): the gate products as partials over 16-channel chunks (the
up-projection tiles' epilogues in the one-launch step) added in chunk order,
and the readout q.S as partials over blocks of rows of S added in row order,
as csrc/xlstm_ops.cuh splits them.

At width 256 (4 heads: DK = 128, two row blocks of 64 a head; 32 gate
chunks) the split chain agrees with the TPU kernel
(musicgen_tpu/ops/pallas_xlstm_decode.py in interpret mode) to 1e-3 of the
largest logit and state entry, step by step from its carry, as the plain
chain does (tests/test_torch_xdecode.py); and with the unsplit plain
versions to f32 rounding (1e-5): the split only reorders f32 sums. A matrix
memory stored in bf16 is held to one bf16 rounding (2^-8 of its largest
entry): an f32 difference in the last bit of f' or i' can move a stored
entry across a bf16 rounding boundary.
"""
import pytest
import torch

from musicgen_tpu_torch.config import XLSTMConfig
from musicgen_tpu_torch.ops import xdecode_kernel as xk

from test_torch_xdecode import check_logits_steps, make_setup

SPLIT_REL = 1e-5
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def setup():
    return make_setup("bf16", embedding_dim=256)


def test_item_split_steps_match_pallas_kernel(setup):
    dims = setup["dims"]
    assert dims.m_dh // xk.mem_rows_per_item(dims.m_dh) == 2 and dims.m_inner // xk.XM_CHUNK == 32
    check_logits_steps(setup, ops=xk.ITEM_OPS)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["f32", "sb16"])
def test_item_split_matches_the_plain_versions_at_the_reference_size(state_dtype):
    """The gates and the matrix memory at the reference widths (DK = 512:
    32 row blocks of 16 rows a head; 128 gate chunks), batch 2, from seeded
    inputs: sc, n, m, h and S against the unsplit plain versions."""
    dims = xk.XDims.create(XLSTMConfig(), 2)
    g = torch.Generator().manual_seed(0)
    b, H, DK, di = 2, dims.heads, dims.m_dh, dims.m_inner
    buf = torch.randn(b, 4, di, generator=g)
    w_gate = torch.randn(2 * H, 3 * di, generator=g) / di ** 0.5
    gate_b = torch.randn(2 * H, generator=g)
    n0, m0 = torch.randn(b, H, DK, generator=g), torch.randn(b, H, generator=g)
    s0 = torch.randn(b, H, DK, DK, generator=g).to(state_dtype)
    outs = []
    for gates, memory in ((xk.xm_gates_plain, xk.xm_memory_plain),
                          (xk.xm_gates_items_plain, xk.xm_memory_items_plain)):
        n, m, s = n0.clone(), m0.clone(), s0.clone()
        sc = gates(buf, w_gate, gate_b, n, m, dims)
        outs.append((sc, n, m, memory(buf, sc, s, dims), s.float()))
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        assert _rel(got, want) < (BF16_ULP if i == 4 and state_dtype == torch.bfloat16 else SPLIT_REL), i
    parts = xk.gate_partials_plain(buf, w_gate, dims)
    assert parts.shape == (b, 2 * H, di // xk.XM_CHUNK)


@pytest.mark.parametrize("heads", [2, 1])
def test_item_split_matches_the_plain_versions_at_wide_heads(heads):
    """The matrix memory at the wide heads of width 1024 (2 heads: DK 1024,
    128 row blocks of 8 rows; 1 head: DK 2048, 256 row blocks of 8 rows, two
    column quads a thread in the kernel), batch 1: sc, n, m, h and S of the
    split against the unsplit plain versions."""
    dims = xk.XDims.create(XLSTMConfig(num_heads=heads), 1)
    assert xk.mem_rows_per_item(dims.m_dh) == xk.XM_NJ and dims.m_dh == 2048 // heads
    g = torch.Generator().manual_seed(heads)
    b, H, DK, di = 1, dims.heads, dims.m_dh, dims.m_inner
    buf = torch.randn(b, 4, di, generator=g)
    w_gate = torch.randn(2 * H, 3 * di, generator=g) / di ** 0.5
    gate_b = torch.randn(2 * H, generator=g)
    n0, m0 = torch.randn(b, H, DK, generator=g), torch.randn(b, H, generator=g)
    s0 = torch.randn(b, H, DK, DK, generator=g)
    outs = []
    for gates, memory in ((xk.xm_gates_plain, xk.xm_memory_plain),
                          (xk.xm_gates_items_plain, xk.xm_memory_items_plain)):
        n, m, s = n0.clone(), m0.clone(), s0.clone()
        sc = gates(buf, w_gate, gate_b, n, m, dims)
        outs.append((sc, n, m, memory(buf, sc, s, dims), s))
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        assert _rel(got, want) < SPLIT_REL, i
