"""Generation at more batch rows than one decode launch carries: Mamba here,
the Transformer and the xLSTM in tests/test_torch_rows_{transformer,xlstm}.py
(the shared pieces in tests/torch_rows_common.py); the mixer's item
partition in tests/test_torch_rows_mixer.py.

Rows. A decode launch carries at most MAX_ROWS = 8 rows (csrc/decode_ops.cuh
MAXR), where the JAX package's decode kernels pad any batch. So
sample/sampler.generate runs a kernel path of more rows in groups of 8, each
group's whole generation in turn. Held here on the CPU (the wrappers' plain
twins), greedy, at 9 and 16 rows:
  * the streams equal each row's own batch-1 run from its group's prefill
    bit for bit (a row's GEMV, mixer and tail arithmetic does not depend on
    the other rows; the prefill itself may round a row otherwise at another
    batch size, so the batch-1 run takes the row's slice of its group's);
  * against the plain step (fused=False, the model's f32 step, which rounds
    nothing to bf16): stepped over the kernel path's stream, every picked
    token is among the plain top-3, and is the plain top-1 wherever that one
    leads the second by more than SEPARATED (relative). The streams
    themselves need not be equal: the bf16 products flip near-ties, at any
    batch;
  * a Mamba or Transformer stream equals the JAX package's generate(fused=
    True) at the same batch (its kernel in interpret mode, 9 rows padded to
    16; the same rounding points, the f32 sums in another order) up to a
    near-tie: a row's first token that differs, if any, is one where the
    plain step's two best are within SEPARATED. The JAX xLSTM kernel path
    refuses 9 rows ("Incompatible shapes for broadcasting"), so the xLSTM is
    held to the JAX plain path instead.
Stochastic runs at 9 rows give the right shape and grammatical tokens. On a
tree whose generate does not group the rows every case here raises
("decode batch must be in 1..8").
"""
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
from tests.torch_rows_common import make_mamba


@pytest.fixture(scope="module")
def mamba():
    return make_mamba()


@pytest.mark.parametrize("batch", [9, 16])
def test_mamba_rows_in_groups_match_jax_and_each_row_alone(mamba, batch):
    cfg, jm, params, port = mamba
    prompt, meta = _inputs(cfg, batch, BLOCK, seed=batch)
    fused = _generate(port, "mamba", prompt, meta, greedy=True, fused=True)
    assert fused.shape == (batch, BLOCK + N)
    assert torch.equal(fused, _rows_alone(port, "mamba", prompt, meta, greedy=True, fused=True))
    near = _assert_plain_step_agrees(port, "mamba", prompt, meta, fused)
    want = js.generate(jm, params, "mamba", jnp.asarray(prompt), jnp.asarray(meta), N, block_len=BLOCK,
                       rng=jax.random.PRNGKey(0), greedy=True, fused=True)
    _assert_equal_up_to_near_ties(fused, want, near, BLOCK)


def test_mamba_resident_rows_in_groups_match_the_per_token_kernels(mamba):
    cfg, _, _, port = mamba
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=9)
    resident = _generate(port, "mamba", prompt, meta, greedy=True, resident=True)
    assert torch.equal(resident, _generate(port, "mamba", prompt, meta, greedy=True, fused=True))
    assert torch.equal(resident, _rows_alone(port, "mamba", prompt, meta, greedy=True, resident=True))


@pytest.mark.parametrize("kind,opts", [("mamba", dict(fused=True)), ("mamba", dict(resident=True))],
                         ids=["mamba", "mamba-resident"])
def test_stochastic_rows_in_groups_are_grammatical(mamba, kind, opts):
    cfg, _, _, port = mamba
    prompt, meta = _inputs(cfg, 9, BLOCK, seed=3)
    streams = _generate(port, kind, prompt, meta, seed=3, **opts)
    assert streams.shape == (9, BLOCK + N)
    assert torch.equal(streams[:, :BLOCK], torch.from_numpy(prompt).long())
    assert _grammatical(streams, BLOCK)
