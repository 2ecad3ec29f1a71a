"""The port's research CLIs on the CPU (--device cpu) at a small size:
`cli.train --model xlstm` with --remat and --loss-chunk, `cli.train_classifier`
with and without --distribution, and `cli.evaluate accuracy | classifier |
timing` on the checkpoints they write; with the default --device cuda and no
card each raises rather than run on the CPU."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from musicgen_tpu_torch.cli import evaluate as eval_cli
from musicgen_tpu_torch.cli import train as train_cli
from musicgen_tpu_torch.cli import train_classifier as cls_cli
from musicgen_tpu_torch.config import ClassifierConfig, MambaConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.data.metadata import load_band_vectors
from musicgen_tpu_torch.eval.accuracy import FIELDS
from musicgen_tpu_torch.midi import MidiNote, encode
from musicgen_tpu_torch.models import mamba, transformer, xlstm
from musicgen_tpu_torch.train import trainer as T

BLOCK, META_VOCAB = 32, 24
BANDS = ("Mozart", "Bach", "Haydn")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three band dirs of two token files each (seed 0), a metadata.json,
    a data_distribution.json, and a small .pth of each family and of the
    classifier."""
    root = tmp_path_factory.mktemp("research")
    rng = np.random.default_rng(0)
    files = []
    for band in BANDS:
        (root / "np" / band).mkdir(parents=True)
        for i in range(2):
            t, notes = 0.0, []
            for _ in range(30):
                t += float(rng.choice([0, 1, 2, 4, 8])) / 128
                notes.append(MidiNote(pitch=int(rng.integers(40, 90)), time_start=t,
                                      time_end=t + float(rng.choice([8, 16, 32])) / 128,
                                      dynamic=int(rng.integers(20, 120)), channel=0, tempo=120))
            path = root / "np" / band / f"{band}_{i}.npy"
            np.save(path, np.asarray(encode(notes), np.int64))
            files.append(str(path))
    (root / "metadata.json").write_text(json.dumps({"artists": [
        {"name": b, "year_started": 1700 + 40 * i, "genres": ["classical", "baroque"][: i % 2 + 1]}
        for i, b in enumerate(BANDS)]}))
    (root / "dist.json").write_text(json.dumps({"train": files[:4], "test": files[4:]}))
    models = {
        "mamba": mamba.init_weights_(mamba.empty_model(MambaConfig(d_model=32, n_layers=2, d_state=8, headdim=8,
                                                                   metadata_vocab_size=META_VOCAB), "cpu"), 0),
        "transformer": transformer.init_weights_(transformer.empty_model(
            TransformerConfig(n_embd=32, n_heads=2, n_layer=2, block_len=BLOCK, metadata_vocab_size=META_VOCAB),
            "cpu"), 0),
        "xlstm": xlstm.init_weights_(xlstm.empty_model(XLSTMConfig(embedding_dim=32, num_blocks=2, slstm_at=(1,),
                                                                   num_heads=2, metadata_vocab_size=META_VOCAB),
                                                       "cpu"), 0),
        "classifier": xlstm.init_weights_(xlstm.empty_model(ClassifierConfig(
            embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB), "cpu"), 0),
    }
    for name, model in models.items():
        torch.save(model.state_dict(), root / f"{name}.pth")
    return root


def _common(root, tmp_path, block=True):
    return ["--data", str(root / "np"), "--metadata", str(root / "metadata.json"), "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--log", str(tmp_path / "log.json")] + (
        ["--block-len", str(BLOCK)] if block else [])


def _small_classifier(metadata_vocab_size=META_VOCAB):
    """The classifier's default config, shrunk to 2 blocks of width 32 and a
    context of BLOCK tokens: what the patched ClassifierConfig returns."""
    return lambda: ClassifierConfig(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2,
                                    metadata_vocab_size=metadata_vocab_size, context_length=BLOCK)


def _saved(tmp_path):
    (saved,) = sorted((tmp_path / "ckpt").iterdir())
    assert sorted(os.listdir(saved)) == ["model.pth", "optimizer.pth"]
    return saved


def test_xlstm_remat_and_loss_chunk_keep_the_step():
    """The xLSTM train step with --remat (each block under checkpoint) and
    with --loss-chunk (the chunked CE from model.hidden) gives the plain
    step's loss and gradients, as for the other families."""
    cfg = XLSTMConfig(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB)
    rng = np.random.default_rng(1)
    src, trg = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, BLOCK))) for _ in range(2))
    meta = torch.from_numpy(rng.integers(0, META_VOCAB, (2, 6)))
    results = []
    for remat, chunk in ((False, 0), (True, 0), (False, 8), (True, 8)):
        model = xlstm.init_weights_(xlstm.empty_model(dataclasses.replace(cfg, remat=remat), "cpu"), 0)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        loss = T.make_lm_train_step(model, opt, loss_chunk=chunk)(src, trg, meta)
        results.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}))
    loss0, g0 = results[0]
    for loss, g in results[1:]:
        assert abs(loss - loss0) <= 1e-6 * abs(loss0)
        for n in g0:
            assert float((g[n] - g0[n]).abs().max()) <= 1e-5 * max(float(g0[n].abs().max()), 1e-30), n


def test_cli_train_xlstm_from_seed_with_remat_and_loss_chunk(corpus, tmp_path, monkeypatch):
    """--model xlstm without --resume builds XLSTMConfig(): the full-size
    default, here shrunk to 2 blocks of width 32 by the patched default."""
    small = XLSTMConfig(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META_VOCAB)
    monkeypatch.setitem(train_cli.DEFAULT_CONFIGS, "xlstm", lambda: small)
    state = train_cli.main(["--model", "xlstm", "--epochs", "1", "--remat", "--loss-chunk", "8", "--seed", "3",
                            *_common(corpus, tmp_path)])
    assert state.step == 2 and state.model.cfg.remat and isinstance(state.model, xlstm.XLSTMLM)
    saved = _saved(tmp_path)
    again = train_cli.main(["--model", "xlstm", "--epochs", "1", "--resume", str(saved), *_common(corpus, tmp_path)])
    assert again.step == 2


@pytest.mark.parametrize("distribution", [False, True], ids=["split", "distribution"])
def test_cli_train_classifier(corpus, tmp_path, distribution, monkeypatch):
    """Two epochs of the default classifier (shrunk by the patched config)
    from --seed: a checkpoint directory that cli.evaluate classifier reads;
    --distribution takes the train and test lists from the file (4 train
    files: 2 steps an epoch at batch 2)."""
    monkeypatch.setattr(cls_cli, "ClassifierConfig", _small_classifier())
    monkeypatch.setattr(eval_cli, "ClassifierConfig", _small_classifier())
    argv = ["--epochs", "2", "--seed", "1", *_common(corpus, tmp_path, block=False)]
    if distribution:
        argv += ["--distribution", str(corpus / "dist.json")]
    state = cls_cli.main(argv)
    assert state.step == 4 and isinstance(state.model, xlstm.XLSTMClassifier)
    log = json.loads((tmp_path / "log.json").read_text())
    vals = [e["message"] for e in log if "Validation" in e.get("message", "")]
    assert len(vals) == 2 and np.isfinite(float(vals[-1].split(": ")[1]))
    saved = _saved(tmp_path)
    _, bands = load_band_vectors(corpus / "metadata.json")
    band_start = min(int(v[0]) for v in bands.values())
    out = tmp_path / "rates.json"
    result = eval_cli.main(["classifier", "--ckpt", str(saved), "--data", str(corpus / "np"), "--metadata",
                            str(corpus / "metadata.json"), "--band-start", str(band_start), "--device", "cpu",
                            "--out", str(out)])
    assert sorted(result["per_band"]) == sorted(int(v[0]) for v in bands.values())
    assert all(0.0 <= r <= 1.0 for r in result["per_band"].values())
    assert json.loads(out.read_text())["mean"] == pytest.approx(result["mean"])


def test_cli_train_classifier_checks_the_meta_vocab(corpus, tmp_path, monkeypatch):
    """A metadata tokenization beyond the classifier's metadata_vocab_size
    raises before training."""
    monkeypatch.setattr(cls_cli, "ClassifierConfig", _small_classifier(metadata_vocab_size=4))
    with pytest.raises(ValueError, match="metadata_vocab_size 4"):
        cls_cli.main(["--epochs", "1", *_common(corpus, tmp_path, block=False)])


@pytest.mark.parametrize("model", ["mamba", "transformer", "xlstm"])
def test_cli_evaluate_accuracy_and_timing(corpus, tmp_path, model, monkeypatch):
    monkeypatch.setattr(eval_cli, "TIMING_SHAPE", (2, BLOCK))
    common = ["--ckpt", str(corpus / f"{model}.pth"), "--device", "cpu"]
    data = ["--data", str(corpus / "np"), "--metadata", str(corpus / "metadata.json"), "--block-len", str(BLOCK)]
    full = eval_cli.main(["accuracy", "--model", model, *common, *data, "--crop", "end", "--repeats", "2"])
    assert list(full) == list(FIELDS)
    assert all(np.isnan(v) or 0.0 <= v <= 1.0 for v in full.values())
    again = eval_cli.main(["accuracy", "--model", model, *common, *data, "--crop", "end"])
    assert all(full[f] == again[f] or (np.isnan(full[f]) and np.isnan(again[f])) for f in FIELDS)
    sampled = eval_cli.main(["accuracy", "--model", model, *common, *data, "--batches", "2"])
    assert list(sampled) == list(FIELDS)
    timing = eval_cli.main(["timing", "--model", model, *common, "--iters", "2", "--out", str(tmp_path / "t.json")])
    assert timing["ms_per_forward"] > 0 and timing["tokens_per_sec"] > 0
    assert timing["device"] == "cpu" and timing["memory"] is None
    assert json.loads((tmp_path / "t.json").read_text())["ms_per_forward"] == timing["ms_per_forward"]
    with pytest.raises(ValueError, match="not a classifier"):
        eval_cli.main(["classifier", "--ckpt", str(corpus / f"{model}.pth"), *data[:4], "--band-start", "1",
                       "--device", "cpu"])
    other = "xlstm" if model != "xlstm" else "mamba"
    with pytest.raises(ValueError, match=f"not a {other}"):
        eval_cli.main(["accuracy", "--model", other, *common, *data])


def test_research_clis_raise_without_a_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = ["--data", str(corpus / "np"), "--metadata", str(corpus / "metadata.json")]
    runs = [
        lambda: train_cli.main(["--model", "xlstm", *data]),
        lambda: cls_cli.main(data),
        lambda: eval_cli.main(["accuracy", "--model", "xlstm", "--ckpt", str(corpus / "xlstm.pth"), *data]),
        lambda: eval_cli.main(["classifier", "--ckpt", str(corpus / "classifier.pth"), *data, "--band-start", "1"]),
        lambda: eval_cli.main(["timing", "--model", "mamba"]),
    ]
    for run in runs:
        with pytest.raises(RuntimeError, match="--device cpu"):
            run()
