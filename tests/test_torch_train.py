"""The port's training layer (musicgen_tpu_torch.train, .data) vs the JAX
package's on the same numpy-seeded inputs: losses, augmentation, the data
pipeline's index streams, and checkpoints (tests/test_torch_train_step.py
holds the train steps themselves)."""
import json
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.config import TrainValues as JaxTrainValues
from musicgen_tpu.data.augment import multiply_range, shift_pitch_preserving_channel, shift_range
from musicgen_tpu.data import dataset as jds
from musicgen_tpu.train import loss as jloss
from musicgen_tpu_torch.config import VOCAB, MambaConfig, TrainValues, TransformerConfig
from musicgen_tpu_torch.data import augment as taug
from musicgen_tpu_torch.data import dataset as tds
from musicgen_tpu_torch.train import loss as tloss
from musicgen_tpu_torch.train import trainer as T

V = VOCAB.vocab_size
B, L = 2, 16


def _batch(seed, meta_vocab=9, t=L):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, t)), rng.integers(0, V, (B, t)), rng.integers(0, meta_vocab, (B, 6)))


def test_train_values_match_jax():
    import dataclasses

    assert dataclasses.asdict(TrainValues()) == dataclasses.asdict(JaxTrainValues())


def test_filtered_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    src, trg, _ = _batch(0)
    logits = (3 * rng.standard_normal((B, L, V))).astype(np.float32)
    want = float(jloss.filtered_cross_entropy(jnp.asarray(src), jnp.asarray(logits), jnp.asarray(trg)))
    got = float(tloss.filtered_cross_entropy(torch.from_numpy(src), torch.from_numpy(logits), torch.from_numpy(trg)))
    assert abs(got - want) <= 1e-6 * abs(want)


def _small(kind):
    if kind == "mamba":
        return MambaConfig(d_model=32, n_layers=2, d_state=8, headdim=8, chunk_size=8, metadata_vocab_size=9)
    return TransformerConfig(n_embd=32, n_heads=4, n_layer=2, block_len=24, dropout=0.0, metadata_vocab_size=9,
                             attention_impl="xla")


@pytest.mark.parametrize("kind", ["mamba", "transformer"])
@pytest.mark.parametrize("chunk", [7, 24])
def test_chunked_loss_matches_unchunked(kind, chunk):
    """Value and every gradient, as tests/test_chunked_loss.py holds the JAX
    pair (T = 24, not a multiple of 7)."""
    cfg = _small(kind)
    mod = __import__(f"musicgen_tpu_torch.models.{kind}", fromlist=["x"])
    model = mod.init_weights_(mod.empty_model(cfg, "cpu"), 0)
    src, trg, meta = (torch.from_numpy(x) for x in _batch(1, t=24))
    ref = tloss.filtered_cross_entropy(src, model(src, meta), trg)
    g_ref = torch.autograd.grad(ref, list(model.parameters()))
    head = T.lm_head(model)
    chk = tloss.chunked_filtered_cross_entropy(src, model.hidden(src, meta), head.weight, head.bias, trg, chunk=chunk)
    g_chk = torch.autograd.grad(chk, list(model.parameters()))
    assert abs(float(chk.detach()) - float(ref.detach())) <= 1e-6 * abs(float(ref.detach()))
    for (name, _), a, b in zip(model.named_parameters(), g_chk, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_augment_transforms_match_jax():
    rng = np.random.default_rng(2)
    seq = rng.integers(0, V, (3, 400)).astype(np.int32)
    lay = VOCAB
    for amount in (-12, -3, 0, 7, 12):
        np.testing.assert_array_equal(
            taug.shift_pitch_preserving_channel(torch.from_numpy(seq), amount).numpy(),
            np.asarray(shift_pitch_preserving_channel(jnp.asarray(seq), amount)))
        np.testing.assert_array_equal(
            taug.shift_range(torch.from_numpy(seq), 2 * amount, lay.dyn_start, lay.dyn_start + 127).numpy(),
            np.asarray(shift_range(jnp.asarray(seq), 2 * amount, lay.dyn_start, lay.dyn_start + 127)))
    for k in range(1, 9):
        for lo, n in ((lay.time_start, 512), (lay.length_start, 512), (lay.tempo_start, 250)):
            np.testing.assert_array_equal(
                taug.multiply_range(torch.from_numpy(seq), torch.tensor(k / 2.0), lo, lo + n - 1).numpy(),
                np.asarray(multiply_range(jnp.asarray(seq), jnp.float32(k / 2.0), lo, lo + n - 1)))


def test_augment_keeps_field_ranges():
    rng = np.random.default_rng(3)
    seq = torch.from_numpy(rng.integers(0, V, (2, 2000)))
    gen = torch.Generator().manual_seed(0)
    bounds = [0, VOCAB.dyn_start, VOCAB.length_start, VOCAB.time_start, VOCAB.tempo_start, V]
    field = lambda x: torch.bucketize(x, torch.tensor(bounds[1:-1]), right=True)  # noqa: E731
    outs = [taug.augment(seq, gen) for _ in range(5)]
    for out in outs:
        assert out.shape == seq.shape and out.dtype == seq.dtype
        assert bool(((out >= 0) & (out < V)).all())
        assert torch.equal(field(out), field(seq))
    assert any(not torch.equal(o, seq) for o in outs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(4)
    for band in ("Mozart", "Bach", "Ravel"):
        (root / "np" / band).mkdir(parents=True)
        for i in range(4):
            np.save(root / "np" / band / f"{band}_{i}.npy", rng.integers(0, V, int(rng.integers(20, 90))))
    (root / "metadata.json").write_text(json.dumps({"artists": [
        {"name": b, "year_started": 1700 + 60 * i, "genres": ["classical", "opera"][: 1 + i % 2]}
        for i, b in enumerate(("Mozart", "Bach", "Ravel"))]}))
    return root


def test_data_pipeline_matches_jax(corpus):
    """split_dataset, the BatchIterator index streams and full_batches, with
    crop 'start' (and 'end', the reference's off-by-one kept)."""
    for n, ratio, seed in ((12, 0.2, 0), (100, 0.25, 3)):
        a, b = tds.split_dataset(n, ratio, seed), jds.split_dataset(n, ratio, seed)
        np.testing.assert_array_equal(a.train_indices, b.train_indices)
        np.testing.assert_array_equal(a.test_indices, b.test_indices)
    for crop in ("start", "end"):
        td = tds.TokenDataset.from_directory(corpus / "np", corpus / "metadata.json", block_len=32, crop=crop)
        jd = jds.TokenDataset.from_directory(corpus / "np", corpus / "metadata.json", block_len=32, crop=crop)
        assert td.file_paths == jd.file_paths
        np.testing.assert_allclose(td.file_prob(), jd.file_prob())
        values = TrainValues(batch_size=2)
        for (ti, tt), (ji, jt) in zip(zip(*tds.make_loaders(td, values, seed=5)), zip(*jds.make_loaders(jd, values, seed=5))):
            for x, y in zip(ti, ji):
                np.testing.assert_array_equal(x, y)
        it_t, it_j = tds.BatchIterator(td, np.arange(len(td)), 3, seed=2, rank=1), jds.BatchIterator(
            jd, np.arange(len(jd)), 3, seed=2, rank=1)
        for _ in range(4):
            np.testing.assert_array_equal(it_t.sample_indices(), it_j.rng.choice(
                it_j.indices, size=3, replace=True, p=it_j.prob))
        for x, y in zip(tds.full_batches(td, 5), jds.full_batches(jd, 5)):
            for a, b in zip(x, y):
                np.testing.assert_array_equal(a, b)


def test_tokenizations_file(corpus, tmp_path):
    from musicgen_tpu_torch.data.metadata import band_vectors_from_tokenization, load_band_vectors

    path = tmp_path / "tok.json"
    _, vectors = load_band_vectors(corpus / "metadata.json", path)
    again = band_vectors_from_tokenization(path, corpus / "metadata.json")
    assert sorted(again) == sorted(vectors)
    for band, vec in vectors.items():
        np.testing.assert_array_equal(again[band], vec)


def test_checkpoint_naming_and_pruning(tmp_path):
    assert T.checkpoint_name(1.234).startswith("loss_1.23_time_")
    assert T.checkpoint_name(float("nan")).startswith("loss_inf_time_")
    model = torch.nn.Linear(3, 2)
    state = T.TrainState(model, T.make_optimizer(model), 7)
    paths, base = [], time.time() - 100
    for i, loss in enumerate((0.5, 2.0, 3.0, 4.0, float("nan"))):
        paths.append(T.save_checkpoint(str(tmp_path), state, loss, keep=2))
        os.utime(paths[-1], (base + i, base + i))  # in save order, older than the next save
    left = sorted(os.listdir(tmp_path))
    assert os.path.basename(paths[0]) in left  # the best survives any pruning
    assert len(left) == 3 and os.path.basename(paths[-1]) in left
    for d in left:
        assert sorted(os.listdir(tmp_path / d)) == ["model.pth", "optimizer.pth"]
    restored = T.TrainState(torch.nn.Linear(3, 2), T.make_optimizer(torch.nn.Linear(3, 2)))
    T.load_checkpoint(paths[0], restored)
    assert restored.step == 7 and torch.equal(restored.model.weight, model.weight)


def test_crash_before_validation_saves_loss_inf(tmp_path):
    model = torch.nn.Linear(3, 2)

    def boom():
        raise RuntimeError("data source failed")
        yield  # noqa: unreachable

    with pytest.raises(RuntimeError, match="data source failed"):
        T.train_lm(T.TrainState(model, T.make_optimizer(model)), boom(), [], ckpt_dir=str(tmp_path),
                   log_path=str(tmp_path / "log.json"), num_epochs=1)
    (name,) = [d for d in os.listdir(tmp_path) if d.startswith("loss_")]
    assert name.startswith("loss_inf_time_")
    assert json.loads((tmp_path / "log.json").read_text())[0]["message"] == "Training started!"
    assert math.isinf(T._parsed_loss(name))
