"""Kernel G's plain versions with the mLSTM matrix memory stored in bf16
(`-sb16`; f32 math, rounded at the store only) vs the TPU kernel with
stack_xlstm_states(state_dtype=bf16) in interpret mode: the checks of
tests/test_torch_xdecode.py on a bf16-stored carry, and the stack/unstack
round trip rounding the matrix memory once."""
import pytest

from tests.test_torch_xdecode import (check_logits_steps, check_sample_step, check_state_roundtrip,
                                      check_steps_match_f32_step, make_setup)


@pytest.fixture(scope="module")
def setup():
    return make_setup("bf16", sb16=True)


def test_state_stack_roundtrip(setup):
    check_state_roundtrip(setup)


def test_logits_steps_match_pallas_kernel(setup):
    check_logits_steps(setup)


def test_sample_step_matches_pallas_kernel(setup):
    check_sample_step(setup)


def test_steps_match_f32_step(setup):
    check_steps_match_f32_step(setup)
