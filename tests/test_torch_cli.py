"""The port's generation CLI on the CPU at a small size, and the guard that
no module of musicgen_tpu_torch imports jax (the GPU machine has none)."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import musicgen_tpu_torch
from musicgen_tpu_torch.cli import generate as cli
from musicgen_tpu_torch.config import MambaConfig
from musicgen_tpu_torch.midi import MidiNote, encode, extract_midi
from musicgen_tpu_torch.models.mamba import empty_model, init_weights_
from musicgen_tpu_torch.ops.grammar import field_bucket, grammar_mask

REPO = Path(__file__).resolve().parents[1]
BLOCK, LENGTH, BATCH = 64, 24, 2


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A .pth of a small random model, two band dirs of token files, and a
    metadata.json."""
    root = tmp_path_factory.mktemp("cli")
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
    return root


def _argv(root, out, *extra):
    return ["--model", "mamba", "--ckpt", str(root / "model.pth"), "--data", str(root / "np"),
            "--metadata", str(root / "metadata.json"), "--output", str(out), "--batch", str(BATCH),
            "--block-len", str(BLOCK), "--length", str(LENGTH), *extra]


@pytest.mark.parametrize("extra", [["--greedy"], ["--seed", "5", "--retain"], ["--no-metadata", "--decode-skip", "10"],
                                   ["--fused-decode", "resident"], ["--fused-decode", "resident-int8w", "--greedy"],
                                   ["--fused-decode", "int8"], ["--fused-decode", "int8w"]],
                         ids=["greedy", "sampled_retain", "no_metadata_skip", "resident", "resident_int8w",
                              "int8", "int8w"])
def test_cli_writes_grammatical_midi(workdir, tmp_path, extra):
    streams = cli.main(_argv(workdir, tmp_path, *extra))
    assert sorted(streams) == ["Bach", "Mozart"]
    mask = grammar_mask()
    suffix = "_no_meta" if "--no-metadata" in extra else ""
    for band, s in streams.items():
        assert s.shape == (BATCH, BLOCK + LENGTH)
        s = torch.from_numpy(s)
        assert bool((mask[field_bucket(s[:, BLOCK - 1:-1]), s[:, BLOCK:]] > 0).all())
        for i in range(BATCH):
            path = tmp_path / f"mamba{suffix}" / band / f"generated_{band}_mamba_{i}.mid"
            assert path.exists()
            assert len(extract_midi(str(path))) > 0


def test_cli_greedy_is_deterministic(workdir, tmp_path):
    a = cli.main(_argv(workdir, tmp_path / "a", "--greedy", "--composers", "Bach"))
    b = cli.main(_argv(workdir, tmp_path / "b", "--greedy", "--composers", "Bach"))
    assert list(a) == ["Bach"]
    np.testing.assert_array_equal(a["Bach"], b["Bach"])


@pytest.mark.parametrize("extra", [["--model", "xlstm"], ["--fused-decode", "int8w-gptq"], ["--fused-decode", "sb16"]])
def test_cli_unported_options_raise(workdir, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(_argv(workdir, tmp_path) + extra)


def test_package_never_imports_jax():
    """Import every module of the port (and run nothing) in a fresh
    interpreter: no jax, flax, optax or orbax may be loaded."""
    modules = [m.name for m in pkgutil.walk_packages(musicgen_tpu_torch.__path__, "musicgen_tpu_torch.")]
    assert "musicgen_tpu_torch.ops.decode_kernel" in modules and "musicgen_tpu_torch.cli.generate" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
