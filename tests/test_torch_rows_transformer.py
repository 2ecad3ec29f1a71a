"""Generation at more batch rows than one decode launch carries, for the
Transformer (kernel F's plain twins in groups of 8 rows): the checks of
tests/test_torch_rows.py (shared in tests/torch_rows_common.py)."""
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
from tests.torch_rows_common import make_transformer


@pytest.fixture(scope="module")
def transformer():
    return make_transformer()


def test_transformer_rows_in_groups_match_jax_and_each_row_alone(transformer):
    jcfg, jm, params, port = transformer
    prompt, meta = _inputs(jcfg, 9, BLOCK, seed=9)
    fused = _generate(port, "transformer", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (9, BLOCK + N)
    assert torch.equal(fused, _rows_alone(port, "transformer", prompt, meta, greedy=True, fused=True))
    near = _assert_plain_step_agrees(port, "transformer", prompt, meta, fused)
    want = js.generate(jm, params, "transformer", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(7), greedy=True, fused=True)
    _assert_equal_up_to_near_ties(fused, want, near, BLOCK)


@pytest.mark.parametrize("kind,opts", [("transformer", dict(fused=True))], ids=["transformer"])
def test_stochastic_rows_in_groups_are_grammatical(transformer, kind, opts):
    cfg, _, _, port = transformer
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=3)
    streams = _generate(port, kind, prompt, meta, seed=3, **opts)
    assert streams.shape == (9, BLOCK + N)
    assert torch.equal(streams[:, :BLOCK], torch.from_numpy(prompt).long())
    assert _grammatical(streams, BLOCK)
