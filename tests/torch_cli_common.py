"""Shared pieces of the port's CLI tests (tests/test_torch_cli*.py): a
small random model of each family saved as a .pth, two band directories of
token files with a metadata.json, and the checks on what cli.generate
writes. Not a test module: the test files import it."""
import json

import numpy as np
import torch

from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.midi import MidiNote, encode, extract_midi
from musicgen_tpu_torch.models import transformer, xlstm
from musicgen_tpu_torch.models.mamba import empty_model, init_weights_
from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask

# The gate runs the suite in several pytest-xdist workers on one host. torch's
# default of one intra-op thread per core in every worker oversubscribes the
# cores, and its OpenMP threads spin while they wait: a CLI case that takes
# 0.5 s alone took 28-71 s there. Every worker imports this module when it
# collects the suite, so its torch ops run on one thread.
torch.set_num_threads(1)

BLOCK, LENGTH, BATCH = 64, 24, 2


def make_workdir(root):
    """A .pth of a small random model, two band dirs of token files, and a
    metadata.json."""
    rng = np.random.default_rng(0)
    bands = ["Mozart", "Bach"]
    for band in bands:
        (root / "np" / band).mkdir(parents=True)
        for i in range(2):
            t, notes = 0.0, []
            for _ in range(40):
                t += float(rng.choice([0, 1, 2, 4, 8])) / 128
                notes.append(MidiNote(pitch=int(rng.integers(40, 90)), time_start=t,
                                      time_end=t + float(rng.choice([8, 16, 32])) / 128,
                                      dynamic=int(rng.integers(20, 120)), channel=0, tempo=120))
            np.save(root / "np" / band / f"{band}_{i}.npy", np.asarray(encode(notes), np.int64))
    (root / "metadata.json").write_text(json.dumps({"artists": [
        {"name": b, "year_started": 1700 + 50 * i, "genres": ["classical", "baroque"][: i + 1]}
        for i, b in enumerate(bands)
    ]}))
    model = init_weights_(empty_model(MambaConfig(d_model=128, n_layers=2, metadata_vocab_size=16), "cpu"), 0)
    torch.save(model.state_dict(), root / "model.pth")
    tcfg = TransformerConfig(n_embd=64, n_heads=2, n_layer=2, block_len=BLOCK, metadata_vocab_size=16)
    tmodel = transformer.init_weights_(transformer.empty_model(tcfg, "cpu"), 0)
    torch.save(tmodel.state_dict(), root / "transformer.pth")
    xcfg = XLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
    torch.save(xlstm.init_weights_(xlstm.empty_model(xcfg, "cpu"), 0).state_dict(), root / "xlstm.pth")
    return root


def argv(root, out, *extra, model="mamba", device="cpu"):
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    return ["--model", model, "--ckpt", str(root / ckpt), "--data", str(root / "np"),
            "--metadata", str(root / "metadata.json"), "--output", str(out), "--batch", str(BATCH),
            "--block-len", str(BLOCK), "--length", str(LENGTH), "--device", device, *extra]


def check_streams(streams, out, model, suffix="", prompt_len=BLOCK, length=LENGTH):
    assert sorted(streams) == ["Bach", "Mozart"]
    mask = grammar_mask()
    for band, s in streams.items():
        assert s.shape == (BATCH, prompt_len + length)
        s = torch.from_numpy(s)
        assert bool((mask[field_bucket(s[:, prompt_len - 1:-1]), s[:, prompt_len:]] > 0).all())
        for i in range(BATCH):
            path = out / f"{model}{suffix}" / band / f"generated_{band}_{model}_{i}.mid"
            assert path.exists()
            assert len(extract_midi(str(path))) > 0


def make_train_corpus(workdir, root):
    """Three token files a band (the 80/20 split then holds one test file),
    beside the small models of `workdir`."""
    for band in ("Mozart", "Bach"):
        (root / band).mkdir()
        for i in range(3):
            src = workdir / "np" / band / f"{band}_{i % 2}.npy"
            np.save(root / band / f"{band}_{i}.npy", np.load(src)[i:])
    return root
