"""Kernel C's plain version on the int8 pack in W8A16 vs the TPU kernel
(musicgen_tpu/ops/pallas_generate.py `fused_generate`, quant_mode='w8a16',
interpret mode), stochastic, fed JAX's own uniforms: the same stream, and
final states at the tolerance of tests/test_torch_generate.py."""
import numpy as np
import pytest

from tests.test_torch_generate import STATE_RTOL, _rel, compare_with_jax, make_setup


@pytest.fixture(scope="module")
def setup():
    return make_setup("int8")


def test_resident_plain_w8a16_matches_pallas_generate(setup):
    (jt, jc, jsm), (toks, conv, ssm) = compare_with_jax(setup, False, "w8a16", seed=11)
    np.testing.assert_array_equal(toks, jt)
    assert _rel(conv, jc) < STATE_RTOL and _rel(ssm, jsm) < STATE_RTOL
