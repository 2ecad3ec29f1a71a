"""Generation at more batch rows than one decode launch carries, for the
xLSTM (kernel G's plain versions in groups of 8 rows): the checks of
tests/test_torch_rows.py (shared in tests/torch_rows_common.py). The JAX
xLSTM kernel path refuses 9 rows ("Incompatible shapes for broadcasting"),
so the xLSTM is held to the JAX plain path instead."""
import jax
import jax.numpy as jnp
import pytest
import torch

from musicgen_tpu.sample import sampler as js
from tests.torch_rows_common import (
    BLOCK,
    N,
    _assert_equal_up_to_near_ties,
    _assert_plain_step_agrees,
    _generate,
    _grammatical,
    _inputs,
    _rows_alone,
)
from tests.torch_rows_common import make_xlstm


@pytest.fixture(scope="module")
def xlstm():
    return make_xlstm()


def test_xlstm_rows_in_groups_match_each_row_alone_and_the_plain_step(xlstm):
    jcfg, jm, params, port = xlstm
    prompt, meta = _inputs(jcfg, 9, 24, seed=9)
    fused = _generate(port, "xlstm", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (9, 24 + N)
    assert torch.equal(fused, _rows_alone(port, "xlstm", prompt, meta, greedy=True, fused=True))
    _assert_plain_step_agrees(port, "xlstm", prompt, meta, fused)
    # The plain path takes any batch on both sides: the same streams, up to
    # a near-tie of the two f32 steps.
    plain = _generate(port, "xlstm", prompt, meta, greedy=True, fused=False)
    near = _assert_plain_step_agrees(port, "xlstm", prompt, meta, plain)
    want = js.generate(jm, params, "xlstm", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(7), greedy=True, fused=False)
    _assert_equal_up_to_near_ties(plain, want, near, 24)


@pytest.mark.parametrize("kind,opts", [("xlstm", dict(fused=True))], ids=["xlstm"])
def test_stochastic_rows_in_groups_are_grammatical(xlstm, kind, opts):
    cfg, _, _, port = xlstm
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=3)
    streams = _generate(port, kind, prompt, meta, seed=3, **opts)
    assert streams.shape == (9, BLOCK + N)
    assert torch.equal(streams[:, :BLOCK], torch.from_numpy(prompt).long())
    assert _grammatical(streams, BLOCK)
