"""Port SSM plain ops (musicgen_tpu_torch.ops.ssm) vs musicgen_tpu.ops.ssm.

Both sides compute in f32 from the same numpy inputs; the tolerance (atol
1e-5 on values of order 1) covers the different order of f32 sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.ops import ssm as js
from musicgen_tpu_torch.ops import ssm as ts

ATOL = 1e-5


def _inputs(seed, b=2, t=64, h=4, p=16, g=1, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, t, h)).astype(np.float32)  # the model's dt init range
    A = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 12)).astype(np.float32)
    np.testing.assert_allclose(ts.segsum(torch.from_numpy(x)).numpy(), np.asarray(js.segsum(jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("chunk,g", [(16, 1), (32, 1), (16, 2), (64, 1)])
def test_ssd_chunked_matches_jax(chunk, g):
    x, dt, A, B, C = _inputs(chunk + g, g=g)
    y_t, s_t = ts.ssd_chunked(*_t(x, dt, A, B, C), chunk=chunk)
    y_j, s_j = js.ssd_chunked(*_j(x, dt, A, B, C), chunk=chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)


def test_ssd_chunked_initial_state_matches_jax():
    x, dt, A, B, C = _inputs(7)
    h0 = np.random.default_rng(8).standard_normal((2, 4, 16, 16)).astype(np.float32)
    y_t, s_t = ts.ssd_chunked(*_t(x, dt, A, B, C), chunk=16, initial_state=torch.from_numpy(h0))
    y_j, s_j = js.ssd_chunked(*_j(x, dt, A, B, C), chunk=16, initial_state=jnp.asarray(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)


def test_ssd_reference_and_step_match_jax():
    x, dt, A, B, C = _inputs(3, t=24)
    y_t, s_t = ts.ssd_reference(*_t(x, dt, A, B, C))
    y_j, s_j = js.ssd_reference(*_j(x, dt, A, B, C))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    # The chunked form is the same function as the sequential one.
    y_c, s_c = ts.ssd_chunked(*_t(x, dt, A, B, C), chunk=8)
    np.testing.assert_allclose(y_c.numpy(), y_t.numpy(), atol=ATOL)
    np.testing.assert_allclose(s_c.numpy(), s_t.numpy(), atol=ATOL)


def test_ssd_chunked_rejects_ragged_length():
    x, dt, A, B, C = _inputs(4, t=20)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ts.ssd_chunked(*_t(x, dt, A, B, C), chunk=16)


@pytest.mark.parametrize("bias", [False, True])
def test_causal_conv1d_matches_jax(bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32) if bias else None
    got = ts.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    want = js.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_causal_conv1d_step_matches_jax_and_full_conv():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    full = ts.causal_conv1d(*_t(x, w, b)).numpy()
    state_t = torch.zeros(2, 3, 6)
    state_j = jnp.zeros((2, 3, 6))
    for i in range(x.shape[1]):
        y_t, state_t = ts.causal_conv1d_step(torch.from_numpy(x[:, i]), state_t, *_t(w, b))
        y_j, state_j = js.causal_conv1d_step(jnp.asarray(x[:, i]), state_j, *_j(w, b))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
        np.testing.assert_allclose(y_t.numpy(), full[:, i], atol=ATOL)
    np.testing.assert_allclose(state_t.numpy(), np.asarray(state_j), atol=ATOL)
