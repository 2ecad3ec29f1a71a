"""The mixer's items. Kernel B's mixer launches a block, and kernel C deals a
team, per item (batch row, head, quarter of the head's state rows):
decode_kernel.mixer_state_items runs mixer_state_plain item by item and must
equal it bit for bit; the items cover every state row once; a layer through
the items matches the TPU kernel's `_mixer_math`."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import pallas_decode as jd
from musicgen_tpu_torch.config import MambaConfig as PortMambaConfig
from musicgen_tpu_torch.ops import decode_kernel as dk
from tests.torch_rows_common import BLOCK, _inputs, make_mamba


@pytest.fixture(scope="module")
def mamba():
    return make_mamba()


def _mixer_inputs(cfg, batch, seed=0):
    dims = dk.DecodeDims.create(cfg, batch)
    g = torch.Generator().manual_seed(seed)
    zx = torch.randn(batch, dims.d_in_proj, generator=g)
    zx[:, dims.d_inner + dims.conv_dim:] = torch.nn.functional.softplus(zx[:, dims.d_inner + dims.conv_dim:])
    a_h = -torch.rand(dims.nheads, generator=g) * 4 - 0.1
    d_h = torch.randn(dims.nheads, generator=g)
    ssm = torch.randn(dims.d_inner, batch * dims.d_state, generator=g)
    return dims, zx, a_h, d_h, ssm


@pytest.mark.parametrize("cfg,batch", [(PortMambaConfig(), 2), (PortMambaConfig(), 8),
                                       (PortMambaConfig(d_model=128, n_layers=2), 1)],
                         ids=["full-b2", "full-b8", "small-b1"])
def test_mixer_items_equal_the_plain_mixer_bit_for_bit(cfg, batch):
    dims, zx, a_h, d_h, ssm = _mixer_inputs(cfg, batch)
    s_plain, s_items = ssm.clone(), ssm.clone()
    g_plain = dk.mixer_state_plain(zx, a_h, d_h, s_plain, dims)
    g_items = dk.mixer_state_items(zx, a_h, d_h, s_items, dims)
    assert torch.equal(g_items, g_plain)
    assert torch.equal(s_items, s_plain)
    assert not torch.equal(s_plain, ssm)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_mixer_items_cover_every_state_row_once(batch):
    dims = dk.DecodeDims.create(PortMambaConfig(), batch)
    seen = []
    for item in range(batch * dims.nheads * dk.MIXER_SPLIT):
        b, h, rows = dk.mixer_item(item, dims)
        assert rows.stop - rows.start == dims.headdim // dk.MIXER_SPLIT == 16
        seen += [(b, h * dims.headdim + p) for p in range(rows.start, rows.stop)]
    assert sorted(seen) == [(b, c) for b in range(batch) for c in range(dims.d_inner)]


def test_mixer_items_through_a_layer_match_pallas_body(mamba):
    """in_proj, the items and out_proj over the JAX package's mixer layer
    (`_mixer_math`, called as jnp), at the tolerances of
    tests/test_torch_decode.py."""
    cfg, _, params, port = mamba
    b = 2
    prompt, meta = _inputs(cfg, b, BLOCK)
    with torch.no_grad():
        _, states = port.prefill(torch.from_numpy(prompt).long(), torch.from_numpy(meta).long())
    jdims = jd.DecodeDims.create(cfg, b)
    jdp = jd.build_decode_params(params, cfg, b)
    dims = dk.DecodeDims.create(port.cfg, b)
    dp = dk.build_decode_params(port, b)
    conv, ssm = dk.stack_states(states)
    x = np.random.default_rng(1).standard_normal((b, cfg.d_model)).astype(np.float32)
    x_rows = np.zeros((jdims.rows, cfg.d_model), np.float32)
    x_rows[:b] = x
    # Copies: JAX may alias a host array's memory and read it after the
    # port's step below has advanced the states in place.
    jx, _, js_new = jd._mixer_math(
        jnp.asarray(x_rows), jdp["w_in"][0], None, jdp["w_out"][0], None, jdp["conv_w"][0], jdp["conv_b"][0],
        jdp["dt_bias"][0], jdp["a_e"][0], jdp["d_e"][0], jdp["e_mat"], jdp["norm_w"][0],
        jnp.asarray(conv[0].numpy().copy()), jnp.asarray(ssm[0].numpy().copy()), jdims, "none")
    zx = dk.in_proj_conv_plain(torch.from_numpy(x), dp["w_in"][0], dp["conv_w"][0], dp["conv_b"][0],
                               dp["dt_bias"][0], conv[0], dims)
    g = dk.mixer_state_items(zx, dp["a_h"][0], dp["d_h"][0], ssm[0], dims)
    out = dk.out_proj_rms_plain(g, dp["norm_w"][0], dp["w_out"][0], dims)
    rel = lambda a, w: float(np.abs(np.asarray(a) - np.asarray(w)).max() / np.abs(np.asarray(w)).max())  # noqa: E731
    assert rel(ssm[0], js_new) < 1e-5
    assert rel(out, np.asarray(jx)[:b]) < 1e-2


def test_only_the_chain_launches_dependents():
    """Kernel B's chain (KERNEL_OPS) launches the mixer and out_proj as
    programmatic dependents of the launch ahead; their wrappers launch
    plainly unless asked, and SERIAL_OPS are the chain without the edges."""
    assert [getattr(op, "keywords", {}) for op in dk.KERNEL_OPS] == [{}, {"dependent": True}, {"dependent": True},
                                                                      {}, {}]
    assert [getattr(op, "func", op) for op in dk.KERNEL_OPS] == list(dk.SERIAL_OPS)
    for fn in (dk.mixer_state, dk.out_proj_rms):
        assert inspect.signature(fn).parameters["dependent"].default is False
