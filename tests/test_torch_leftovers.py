"""The port's copies of the JAX modules that no user path runs, held to the
JAX package's on the same inputs: the frozen empirical length weights and
grammar_mask(length_weights="empirical") exactly; eval/distributions
(field_histograms, pitch_channel_marginals, summarize) exactly; eval/curves
(parse_log, summarize) on a log the port's trainer loop wrote; the
vectorized codec (midi/vectorized) against the JAX one on seeded grid notes
(exact integers), against the host codec, and round trip; and the C++
tokenizer, built by midi/native from native/midi_tokenizer.cc into build/,
token for token with the port's Python codec on synthesized MIDI."""
import random
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from musicgen_tpu.eval import curves as jcurves
from musicgen_tpu.eval import distributions as jdist
from musicgen_tpu.midi import vectorized as jvec
from musicgen_tpu.ops import grammar as jgrammar
from musicgen_tpu.ops import length_distribution as jlen
from musicgen_tpu_torch.config import VOCAB, TrainValues
from musicgen_tpu_torch.eval import curves, distributions
from musicgen_tpu_torch.midi import MidiNote, adjust_note_time, decode, encode, extract_midi, native, note_to_midi
from musicgen_tpu_torch.midi import vectorized as vec
from musicgen_tpu_torch.ops import grammar, length_distribution
from musicgen_tpu_torch.ops.build import BUILD_ROOT
from musicgen_tpu_torch.train import trainer
from tests.test_tokenizer import _random_notes

FIELDS = ("pitch", "channel", "dynamic", "start", "end", "tempo", "valid")


@pytest.mark.parametrize("n", [511, 499, 300])
def test_empirical_length_weights_equal_jax(n):
    assert length_distribution.EMPIRICAL_LENGTH_TENSOR == jlen.EMPIRICAL_LENGTH_TENSOR
    np.testing.assert_array_equal(length_distribution.empirical_length_weights(n).numpy(),
                                  np.asarray(jlen.empirical_length_weights(n)))


@pytest.mark.parametrize("weights", ["empirical", "linspace"])
def test_grammar_mask_length_weights_equal_jax(weights):
    np.testing.assert_array_equal(grammar.grammar_mask(length_weights=weights).numpy(),
                                  np.asarray(jgrammar.grammar_mask(length_weights=weights)))
    with pytest.raises(ValueError, match="length_weights"):
        grammar.grammar_mask(length_weights="flat")


def test_distributions_equal_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, VOCAB.vocab_size, n) for n in (500, 1, 2048)] + [np.zeros(0, np.int64)]
    got, want = distributions.field_histograms(arrays), jdist.field_histograms(arrays)
    assert list(got) == list(want) == list(distributions.FIELDS)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
    for k, v in jdist.pitch_channel_marginals(want["pitch"]).items():
        np.testing.assert_array_equal(distributions.pitch_channel_marginals(got["pitch"])[k], v)
    empty = {**got, "tempo": np.zeros_like(got["tempo"])}
    assert distributions.summarize(empty) == jdist.summarize(empty)


def test_curves_parse_the_port_trainers_log(tmp_path):
    """The port's run_epochs over 3 epochs of 4 steps (a stub model and
    steps, eval_interval 2) writes the reference's log schema; parse_log and
    summarize read it as the JAX package's do."""
    model = nn.Linear(2, 2)
    state = trainer.TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    losses = iter(torch.linspace(3.0, 1.0, 12))
    batch = [(torch.zeros(1, 2, dtype=torch.int64),) * 3] * 4
    path = str(tmp_path / "training_log_port.json")
    trainer.run_epochs(state, lambda *b: next(losses), lambda *b: torch.tensor(1.5), batch, batch[:1],
                       replace(TrainValues(), eval_interval=2), str(tmp_path), path, num_epochs=3,
                       save=lambda loss: None)
    data = curves.parse_log(path)
    assert data == jcurves.parse_log(path)
    assert data["steps"] == [2, 4, 6, 8, 10, 12] and data["val_losses"] == [1.5] * 3
    got = curves.summarize(path)
    assert got == jcurves.summarize(path) and got["num_steps"] == 12


def _grid(notes):
    """GridNotes of the port and of JAX from `notes` (seconds)."""
    g = [MidiNote(**vars(n)) for n in notes]
    adjust_note_time(g)
    cols = {"pitch": [x.pitch for x in g], "channel": [x.channel for x in g], "dynamic": [x.dynamic for x in g],
            "start": [x.time_start for x in g], "end": [x.time_end for x in g], "tempo": [int(x.tempo) for x in g]}
    valid = [True] * len(g)
    port = vec.GridNotes(**{k: torch.tensor(v) for k, v in cols.items()}, valid=torch.tensor(valid))
    jax_ = jvec.GridNotes(**{k: jnp.asarray(v, jnp.int32) for k, v in cols.items()}, valid=jnp.asarray(valid))
    return port, jax_


@pytest.mark.parametrize("seed,n,channels", [(0, 100, 3), (3, 80, 2), (7, 40, 1)])
def test_vectorized_codec_equals_jax(seed, n, channels):
    notes = _random_notes(random.Random(seed), n=n, n_channels=channels)
    port, jax_ = _grid(notes)
    tokens, count = vec.encode_notes_grid(port)
    jtokens, jcount = jvec.encode_notes_grid(jax_)
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    assert tokens[:int(count)].tolist() == encode([MidiNote(**vars(x)) for x in notes])
    decoded, jdecoded = vec.decode_tokens(tokens), jvec.decode_tokens(jtokens)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(decoded, f).numpy(), np.asarray(getattr(jdecoded, f)), err_msg=f)
    k = int(decoded.valid.sum())
    assert k == n
    for f in ("pitch", "channel", "dynamic", "tempo", "start"):
        assert torch.equal(getattr(decoded, f)[:k], getattr(port, f)), f
    assert torch.equal(decoded.end[:k], port.start + torch.clamp(port.end - port.start, max=511))


def test_vectorized_padding():
    grid = vec.GridNotes(*(torch.tensor(v) for v in ([60, 0], [0, 0], [64, 0], [0, 0], [4, 0], [120, 0])),
                         valid=torch.tensor([True, False]))
    tokens, count = vec.encode_notes_grid(grid)
    assert int(count) == 5  # pitch, dyn, length, the first delta time, tempo
    assert tokens[5:].tolist() == [vec.PAD_TOKEN] * 5


def _midi(tmp_path, seed, n=200, channels=3):
    path = str(tmp_path / f"m{seed}_{n}.mid")
    notes = _random_notes(random.Random(seed), n=n, n_channels=channels)
    note_to_midi(decode(encode([MidiNote(**vars(x)) for x in notes])), path)
    return path


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_native_tokenizer_equals_the_python_codec(tmp_path, seed):
    assert native.available(), native.build_error()
    assert native.library_path().is_relative_to(BUILD_ROOT) and native.library_path().exists()
    path = _midi(tmp_path, seed)
    np.testing.assert_array_equal(native.tokenize_file(path), np.asarray(encode(extract_midi(path)), np.int64))


def test_native_tokenizer_filters_and_refuses(tmp_path):
    assert native.tokenize_file(_midi(tmp_path, 2, n=50, channels=1), min_notes=200).size == 0
    with pytest.raises(ValueError):
        native.tokenize_bytes(b"not a midi file at all........")
