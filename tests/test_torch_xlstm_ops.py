"""The port's mLSTM and sLSTM ops (musicgen_tpu_torch.ops.mlstm / .slstm) vs
the JAX package's on the same numpy inputs, and kernel H's plain path
(ops/slstm_kernel.slstm_scan on CPU tensors) vs the TPU kernel
`slstm_pallas(interpret=True)` at a ragged T.

f32 throughout: the ops agree to 1e-5 relative (sums in another order);
kernel H's plain path is held to the TPU kernel at the 2e-4 of
tests/test_pallas_slstm.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import mlstm as jm
from musicgen_tpu.ops import slstm as js
from musicgen_tpu.ops.pallas_slstm import slstm_pallas
from musicgen_tpu_torch.ops import mlstm as pm
from musicgen_tpu_torch.ops import slstm as ps
from musicgen_tpu_torch.ops.slstm_kernel import slstm_scan

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _mlstm_inputs(seed, b=2, t=32, h=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((b, t, h)).astype(np.float32)
    fg = (rng.standard_normal((b, t, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_mlstm_parallel_and_sequential_match_jax():
    q, k, v, ig, fg = _mlstm_inputs(0)
    want_par = jax.jit(jm.mlstm_parallel)(q, k, v, ig, fg)
    want_seq = jax.jit(jm.mlstm_sequential)(q, k, v, ig, fg)
    assert _rel(pm.mlstm_parallel(*_t(q, k, v, ig, fg)), want_par) < REL
    assert _rel(pm.mlstm_sequential(*_t(q, k, v, ig, fg)), want_seq) < REL
    # The two forms agree with each other too (the oracle relation).
    assert _rel(pm.mlstm_parallel(*_t(q, k, v, ig, fg)), pm.mlstm_sequential(*_t(q, k, v, ig, fg))) < 1e-4


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunkwise_matches_jax_with_its_state(chunk):
    q, k, v, ig, fg = _mlstm_inputs(1)
    rng = np.random.default_rng(2)
    s0 = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    n0 = rng.standard_normal((2, 2, 16)).astype(np.float32)
    m0 = rng.standard_normal((2, 2)).astype(np.float32)
    fn = jax.jit(jm.mlstm_chunkwise, static_argnames="chunk")
    for init in (None, (s0, n0, m0)):
        want_h, want_s = fn(q, k, v, ig, fg, chunk=chunk, initial_state=init)
        got_h, got_s = pm.mlstm_chunkwise(*_t(q, k, v, ig, fg), chunk=chunk,
                                          initial_state=None if init is None else _t(*init))
        assert _rel(got_h, want_h) < REL
        for a, b in zip(got_s, want_s):
            assert _rel(a, b) < REL


def test_mlstm_step_matches_jax():
    q, k, v, ig, fg = _mlstm_inputs(3, t=1)
    q, k, v, ig, fg = q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]
    rng = np.random.default_rng(4)
    state = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32),
             rng.standard_normal((2, 2, 16)).astype(np.float32), rng.standard_normal((2, 2)).astype(np.float32))
    want_h, want_s = jax.jit(jm.mlstm_step)(q, k, v, ig, fg, state)
    got_h, got_s = pm.mlstm_step(*_t(q, k, v, ig, fg), tuple(_t(*state)))
    assert _rel(got_h, want_h) < REL
    for a, b in zip(got_s, want_s):
        assert _rel(a, b) < REL
    for a, b in zip(pm.mlstm_init_state(2, 3, 4), jm.mlstm_init_state(2, 3, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _slstm_inputs(seed, b=2, t=24, h=2, dh=16):
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((b, t, 4, h, dh)).astype(np.float32)
    r = (rng.standard_normal((4, h, dh, dh)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((4, h, dh)).astype(np.float32)
    return wx, r, bias


def test_slstm_step_and_sequential_match_jax():
    wx, r, bias = _slstm_inputs(5)
    want_h, want_s = jax.jit(js.slstm_sequential)(wx, r, bias)
    got_h, got_s = ps.slstm_sequential(*_t(wx, r, bias))
    assert _rel(got_h, want_h) < REL
    for a, b in zip(got_s, want_s):
        assert _rel(a, b) < REL
    state = tuple(np.asarray(x) for x in want_s)
    want_h1, want_s1 = jax.jit(js.slstm_step)(wx[:, 0], r, bias, state)
    got_h1, got_s1 = ps.slstm_step(*_t(wx[:, 0], r, bias), tuple(_t(*state)))
    assert _rel(got_h1, want_h1) < REL
    for a, b in zip(got_s1, want_s1):
        assert _rel(a, b) < REL


def test_slstm_init_state_and_powerlaw_bias_match_jax():
    for a, b in zip(ps.slstm_init_state(2, 3, 4), js.slstm_init_state(2, 3, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for block in (0, 4, 10):
        got = ps.powerlaw_blockdependent_bias(4, 8, block, 11)
        want = js.powerlaw_blockdependent_bias(4, 8, block, 11)
        assert got.shape == (4, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_kernel_h_plain_path_matches_the_tpu_kernel_at_a_ragged_t():
    """slstm_scan on CPU tensors is kernel H's plain version; the TPU kernel
    pads T = 38 to its 16-step chunks and masks the pad steps out of the
    final state."""
    wx, r, bias = _slstm_inputs(6, t=38, dh=32)
    want_h, want_s = slstm_pallas(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(bias), chunk=16, interpret=True)
    slstm_scan.launches = 0
    got_h, got_s = slstm_scan(*_t(wx, r, bias))
    assert slstm_scan.launches == 0  # the plain path launches nothing
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-4)
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
