"""Kernel F's plain twins on the W8A16 pack (int8 weights, K-grouped scales)
vs the TPU kernel's quant='int8w' path in interpret mode: the checks of
tests/test_torch_tdecode.py, with the ring wrap held to 0.12 of the largest
logit as tests/test_pallas_transformer_decode.py holds W8A16."""
import pytest

from tests.test_torch_tdecode import check_logits_steps, check_pack, check_ring_wrap, check_sample_step, make_setup


@pytest.fixture(scope="module")
def setup():
    return make_setup("int8w")


def test_pack_matches_jax(setup):
    check_pack(setup)


def test_logits_steps_match_pallas_kernel(setup):
    check_logits_steps(setup)


def test_sample_step_matches_pallas_kernel(setup):
    check_sample_step(setup)


def test_ring_wrap_matches_plain_step():
    check_ring_wrap("int8w")
