"""The port's evaluation harnesses (eval/accuracy.py, eval/classifier_eval.py)
against the JAX package's (musicgen_tpu/eval/), on the same seeded tiny
models (weights moved across by interop.from_jax_params) and the same numpy
batches: the last-position predictions, the per-field hit counts, the
accuracy rates and the per-band success rates are equal. Some targets are
set to the JAX prediction, so that the rates are not all zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import ClassifierConfig as JaxClassifierConfig
from musicgen_tpu.config import MambaConfig as JaxMambaConfig
from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.eval import accuracy as jacc
from musicgen_tpu.eval import classifier_eval as jcls
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu.models.xlstm import XLSTMClassifier as JaxXLSTMClassifier
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch import config as pconfig
from musicgen_tpu_torch.config import VOCAB
from musicgen_tpu_torch.eval.accuracy import FIELDS, accuracy_counts, evaluate_accuracy, last_position_prediction
from musicgen_tpu_torch.eval.classifier_eval import evaluate_success_rates
from musicgen_tpu_torch.interop import from_jax_params, load_model

B, L, META_VOCAB, N_BATCHES = 4, 16, 16, 3
FAMILIES = {
    "mamba": (JaxMambaLM, JaxMambaConfig, pconfig.MambaConfig,
              dict(d_model=32, n_layers=2, d_state=8, headdim=8, chunk_size=8, metadata_vocab_size=META_VOCAB)),
    "transformer": (JaxTransformerLM, JaxTransformerConfig, pconfig.TransformerConfig,
                    dict(n_embd=32, n_heads=4, n_layer=2, block_len=L, dropout=0.0, metadata_vocab_size=META_VOCAB,
                         attention_impl="xla")),
    "xlstm": (JaxXLSTMLM, JaxXLSTMConfig, pconfig.XLSTMConfig,
              dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB)),
}


def random_params(jm, *inputs, seed: int = 0):
    """Seeded numpy weights in the flax tree of `jm` (eval_shape compiles
    nothing): matrices of std 1/sqrt(fan_in), unit scales, biases and
    vectors of std 0.1, the mLSTM forget-gate bias 3.0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs))

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if name in ("scale", "outnorm_scale", "learnable_skip", "gn_scale"):
            return np.ones(leaf.shape, np.float32)
        if parent == "fgate" and name == "bias":
            return np.full(leaf.shape, 3.0, np.float32)
        std = 0.1 if name == "bias" or leaf.ndim < 2 else leaf.shape[-2] ** -0.5
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_accuracy_counts_match_jax():
    """Targets in every field and at the fields' boundary ids, predictions
    right on about half."""
    rng = np.random.default_rng(1)
    starts = list(VOCAB.start_idx.values()) + [VOCAB.vocab_size]
    targets = np.concatenate([rng.integers(0, VOCAB.vocab_size, 200), np.asarray(starts[:-1]),
                              np.asarray(starts[1:]) - 1])
    preds = np.where(rng.random(targets.shape) < 0.5, targets, rng.integers(0, VOCAB.vocab_size, targets.shape))
    hits, totals = accuracy_counts(preds, targets)
    jhits, jtotals = jacc.accuracy_counts(preds, targets)
    np.testing.assert_array_equal(hits, jhits)
    np.testing.assert_array_equal(totals, jtotals)
    assert totals.sum() == targets.size and 0 < hits.sum() < targets.size


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_evaluate_accuracy_matches_jax(kind):
    jcls_, jcfg_cls, pcfg_cls, kw = FAMILIES[kind]
    jm = jcls_(jcfg_cls(**kw))
    rng = np.random.default_rng(2)
    batches = [(rng.integers(0, VOCAB.vocab_size, (B, L)), rng.integers(0, VOCAB.vocab_size, (B, L)),
                rng.integers(0, META_VOCAB, (B, 6))) for _ in range(N_BATCHES)]
    params = random_params(jm, batches[0][0][:, :8], batches[0][2])
    apply = jax.jit(jm.apply)
    for src, trg, meta in batches:  # every other row's last target is JAX's own pick
        pick = np.asarray(jacc.last_position_prediction(apply, params, jnp.asarray(src), jnp.asarray(meta)))
        trg[::2, -1] = pick[::2]
    model = load_model(from_jax_params(params, pcfg_cls(**kw)), "cpu")
    for src, _, meta in batches:
        want = np.asarray(jacc.last_position_prediction(apply, params, jnp.asarray(src), jnp.asarray(meta)))
        got = last_position_prediction(model, torch.from_numpy(src), torch.from_numpy(meta)).numpy()
        np.testing.assert_array_equal(got, want)
    got = evaluate_accuracy(model, batches)
    want = jacc.evaluate_accuracy(jm.apply, params, batches)
    assert list(got) == list(FIELDS) == list(want)
    for f in FIELDS:
        assert got[f] == want[f] or (np.isnan(got[f]) and np.isnan(want[f])), f
    assert any(v > 0 for v in got.values() if not np.isnan(v))


def test_evaluate_success_rates_matches_jax():
    kw = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB)
    jm = JaxXLSTMClassifier(JaxClassifierConfig(**kw))
    params = random_params(jm, np.zeros((1, 8), np.int32))
    band_start = 9
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, VOCAB.vocab_size, (B, L)), rng.integers(band_start, META_VOCAB, (B, 6)))
               for _ in range(N_BATCHES)]
    apply = jax.jit(jm.apply)
    for tokens, meta in batches:  # every other row's band is the classifier's own guess
        meta[::2, 0] = np.asarray(jcls.band_predictions(apply, params, jnp.asarray(tokens), band_start))[::2]
    model = load_model(from_jax_params(params, pconfig.ClassifierConfig(**kw)), "cpu")
    got = evaluate_success_rates(model, batches, band_start)
    want = jcls.evaluate_success_rates(jm.apply, params, batches, band_start)
    assert got == want
    assert sum(got.values()) > 0
