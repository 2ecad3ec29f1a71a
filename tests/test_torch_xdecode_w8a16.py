"""Kernel G's plain versions on the W8A16 pack (int8 weights, K-grouped
scales; the FFN's down-projection, K = 128 here and 1408 at the reference
size, has one group) vs the TPU kernel's quant='int8w' path in interpret
mode: the checks of tests/test_torch_xdecode.py, with the teacher-forced
steps held to 0.12 of the largest logit as tests/test_pallas_xlstm_decode.py
holds W8A16."""
import pytest

from tests.test_torch_xdecode import (check_logits_steps, check_pack, check_sample_step, check_steps_match_f32_step,
                                      make_setup)


@pytest.fixture(scope="module")
def setup():
    return make_setup("int8w")


def test_pack_matches_jax(setup):
    check_pack(setup)


def test_logits_steps_match_pallas_kernel(setup):
    check_logits_steps(setup)


def test_sample_step_matches_pallas_kernel(setup):
    check_sample_step(setup)


def test_steps_match_f32_step(setup):
    check_steps_match_f32_step(setup, n_steps=3)
