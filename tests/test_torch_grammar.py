"""Port grammar ops (musicgen_tpu_torch.ops.grammar) vs the JAX package."""
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.config import VOCAB
from musicgen_tpu.ops import grammar as jg
from musicgen_tpu_torch.ops import grammar as tg


def _tokens(rng, n=400):
    """Random ids plus every field boundary and its neighbours."""
    edges = []
    for b in VOCAB.field_boundaries:
        edges += [b - 1, b, b + 1]
    ids = np.concatenate([rng.integers(0, VOCAB.vocab_size, n), edges, [0, VOCAB.vocab_size - 1]])
    return ids.astype(np.int64)


def test_grammar_mask_matches_jax_exactly():
    np.testing.assert_array_equal(tg.grammar_mask().numpy(), np.asarray(jg.grammar_mask()))


def test_field_bucket_matches_jax_exactly():
    ids = _tokens(np.random.default_rng(0))
    want = np.asarray(jg.field_bucket(jnp.asarray(ids, jnp.int32)))
    np.testing.assert_array_equal(tg.field_bucket(torch.from_numpy(ids)).numpy(), want)


def test_pick_weights_matches_jax_exactly():
    ids = _tokens(np.random.default_rng(1), n=16)
    want = np.asarray(jg.pick_weights_by_prev_token(jnp.asarray(ids, jnp.int32)))
    np.testing.assert_array_equal(tg.pick_weights_by_prev_token(torch.from_numpy(ids)).numpy(), want)


def test_filtered_logits_matches_jax():
    rng = np.random.default_rng(2)
    prev = _tokens(rng, n=4)[:8]
    logits = (3.0 * rng.standard_normal((prev.shape[0], VOCAB.vocab_size))).astype(np.float32)
    want = np.asarray(jg.filtered_logits(jnp.asarray(prev, jnp.int32), jnp.asarray(logits)))
    got = tg.filtered_logits(torch.from_numpy(prev), torch.from_numpy(logits)).numpy()
    # f32 log_softmax in two libraries: a few ulps of the largest value.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
