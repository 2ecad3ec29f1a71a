"""The port's generation and training CLIs on the CPU (--device cpu) at a
small size, and the guards that no module of musicgen_tpu_torch imports jax
(the GPU machine has none) or anything of the JAX package."""
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
from musicgen_tpu_torch.cli import train as train_cli
from musicgen_tpu_torch.config import MambaConfig, TransformerConfig, XLSTMConfig
from musicgen_tpu_torch.midi import MidiNote, encode, extract_midi
from musicgen_tpu_torch.models import transformer, xlstm
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
    tcfg = TransformerConfig(n_embd=64, n_heads=2, n_layer=2, block_len=BLOCK, metadata_vocab_size=16)
    tmodel = transformer.init_weights_(transformer.empty_model(tcfg, "cpu"), 0)
    torch.save(tmodel.state_dict(), root / "transformer.pth")
    xcfg = XLSTMConfig(embedding_dim=64, num_blocks=3, slstm_at=(1,), metadata_vocab_size=16)
    torch.save(xlstm.init_weights_(xlstm.empty_model(xcfg, "cpu"), 0).state_dict(), root / "xlstm.pth")
    return root


def _argv(root, out, *extra, model="mamba", device="cpu"):
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    return ["--model", model, "--ckpt", str(root / ckpt), "--data", str(root / "np"),
            "--metadata", str(root / "metadata.json"), "--output", str(out), "--batch", str(BATCH),
            "--block-len", str(BLOCK), "--length", str(LENGTH), "--device", device, *extra]


def _check_streams(streams, out, model, suffix=""):
    assert sorted(streams) == ["Bach", "Mozart"]
    mask = grammar_mask()
    for band, s in streams.items():
        assert s.shape == (BATCH, BLOCK + LENGTH)
        s = torch.from_numpy(s)
        assert bool((mask[field_bucket(s[:, BLOCK - 1:-1]), s[:, BLOCK:]] > 0).all())
        for i in range(BATCH):
            path = out / f"{model}{suffix}" / band / f"generated_{band}_{model}_{i}.mid"
            assert path.exists()
            assert len(extract_midi(str(path))) > 0


@pytest.mark.parametrize("extra", [["--greedy"], ["--seed", "5", "--retain"], ["--no-metadata", "--decode-skip", "10"],
                                   ["--fused-decode", "resident"], ["--fused-decode", "resident-int8w", "--greedy"],
                                   ["--fused-decode", "int8"], ["--fused-decode", "int8w"]],
                         ids=["greedy", "sampled_retain", "no_metadata_skip", "resident", "resident_int8w",
                              "int8", "int8w"])
def test_cli_writes_grammatical_midi(workdir, tmp_path, extra):
    streams = cli.main(_argv(workdir, tmp_path, *extra))
    _check_streams(streams, tmp_path, "mamba", "_no_meta" if "--no-metadata" in extra else "")


@pytest.mark.parametrize("extra", [["--fused-decode", "auto"], ["--fused-decode", "off", "--greedy"],
                                   ["--fused-decode", "int8w"]], ids=["auto", "off_greedy", "int8w"])
def test_cli_transformer_writes_grammatical_midi(workdir, tmp_path, extra):
    """--model transformer: the plain ring-KV step (auto and off on the CPU)
    or kernel F's plain twins on the W8A16 pack (int8w: the prompt fills the
    model's 64-token window)."""
    streams = cli.main(_argv(workdir, tmp_path, *extra, model="transformer"))
    _check_streams(streams, tmp_path, "transformer")


@pytest.mark.parametrize("extra", [["--fused-decode", "auto"], ["--fused-decode", "off", "--greedy"],
                                   ["--fused-decode", "sb16"], ["--fused-decode", "int8w-sb16", "--greedy"],
                                   ["--fused-decode", "int8"]], ids=["auto", "off_greedy", "sb16", "int8w_sb16", "int8"])
def test_cli_xlstm_writes_grammatical_midi(workdir, tmp_path, extra):
    """--model xlstm: the plain XLSTMLM.step (auto and off on the CPU), or
    kernel G's plain versions with the matrix memory stored in bf16 (sb16,
    int8w-sb16) or on the W8A16 pack (int8)."""
    streams = cli.main(_argv(workdir, tmp_path, *extra, model="xlstm"))
    _check_streams(streams, tmp_path, "xlstm")


def test_cli_sb16_is_xlstm_only(workdir, tmp_path):
    with pytest.raises(ValueError, match="--model xlstm only"):
        cli.main(_argv(workdir, tmp_path, "--fused-decode", "sb16"))
    with pytest.raises(ValueError, match="not a --model xlstm"):
        cli.main(_argv(workdir, tmp_path, "--ckpt", str(workdir / "model.pth"), model="xlstm"))


def test_cli_device_cuda_without_a_card_raises(workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_argv(workdir, tmp_path, device="cuda"))
    with pytest.raises(ValueError, match="not a --model transformer"):
        cli.main(_argv(workdir, tmp_path, "--ckpt", str(workdir / "model.pth"), model="transformer"))


def test_cli_greedy_is_deterministic(workdir, tmp_path):
    a = cli.main(_argv(workdir, tmp_path / "a", "--greedy", "--composers", "Bach"))
    b = cli.main(_argv(workdir, tmp_path / "b", "--greedy", "--composers", "Bach"))
    assert list(a) == ["Bach"]
    np.testing.assert_array_equal(a["Bach"], b["Bach"])


@pytest.mark.parametrize("extra", [["--fused-decode", "int8w-gptq", "--model", "xlstm"],
                                   ["--fused-decode", "int8w-gptq"],
                                   ["--fused-decode", "int8w-gptq", "--model", "transformer"]])
def test_cli_unported_options_raise(workdir, tmp_path, extra):
    """GPTQ calibration is not ported, for any family."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(_argv(workdir, tmp_path) + extra)


@pytest.fixture(scope="module")
def train_corpus(workdir, tmp_path_factory):
    """Three token files a band (the 80/20 split then holds one test file),
    beside the small models of `workdir`."""
    root = tmp_path_factory.mktemp("train")
    for band in ("Mozart", "Bach"):
        (root / band).mkdir()
        for i in range(3):
            src = workdir / "np" / band / f"{band}_{i % 2}.npy"
            np.save(root / band / f"{band}_{i}.npy", np.load(src)[i:])
    return root


@pytest.mark.parametrize("model", ["mamba", "transformer", "xlstm"])
def test_cli_train_then_generate(workdir, train_corpus, tmp_path, model):
    """--resume a reference-layout .pth, train 2 epochs, then generate from
    the checkpoint directory's model.pth; resuming from the directory
    restores the weights only (Adam restarts at step 0, as in the JAX CLI).
    An xLSTM's sLSTM input gates train dense, so its model.pth is the port's
    layout, which cli.generate reads back."""
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    argv = ["--model", model, "--data", str(train_corpus), "--metadata", str(workdir / "metadata.json"),
            "--block-len", str(BLOCK), "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log", str(tmp_path / "log.json")]
    state = train_cli.main(argv + ["--resume", str(workdir / ckpt), "--epochs", "2"])
    assert state.step == 4  # 2 epochs of 4 train files // batch 2
    (saved,) = sorted((tmp_path / "ckpt").iterdir())
    assert saved.name.startswith("loss_") and sorted(os.listdir(saved)) == ["model.pth", "optimizer.pth"]
    log = json.loads((tmp_path / "log.json").read_text())
    assert [e["message"] for e in log if "Validation" in e.get("message", "")][-1].startswith("Epoch [2/2]")
    streams = cli.main(_argv(workdir, tmp_path / "gen", "--greedy", "--ckpt", str(saved / "model.pth"), model=model))
    _check_streams(streams, tmp_path / "gen", model)
    again = train_cli.main(argv + ["--resume", str(saved), "--epochs", "1"])
    assert again.step == 2  # one epoch of 2 steps from a fresh step 0


def test_cli_train_resume_restores_weights_only(workdir, train_corpus, tmp_path, monkeypatch):
    """`--resume <dir>` loads <dir>/model.pth and nothing else: the state
    handed to the training loop holds the saved weights, an optimizer with
    no state and step 0, and the first logged step is 1
    (musicgen_tpu/cli/train.py keeps only the restored params)."""
    from musicgen_tpu_torch.config import TrainValues
    from musicgen_tpu_torch.train import trainer as T

    argv = ["--model", "mamba", "--data", str(train_corpus), "--metadata", str(workdir / "metadata.json"),
            "--block-len", str(BLOCK), "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log", str(tmp_path / "log.json")]
    trained = train_cli.main(argv + ["--resume", str(workdir / "model.pth"), "--epochs", "1"])
    assert trained.step == 2 and trained.optimizer.state
    (saved,) = sorted((tmp_path / "ckpt").iterdir())
    assert (saved / "optimizer.pth").exists()
    want = torch.load(saved / "model.pth", weights_only=True)

    seen = {}
    real_train_lm = T.train_lm

    def spy(state, *args, **kwargs):
        sd = state.model.state_dict()
        seen.update(step=state.step, opt_state=dict(state.optimizer.state),
                    equal=sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in want))
        return real_train_lm(state, *args, **kwargs)

    monkeypatch.setattr(train_cli.T, "train_lm", spy)
    monkeypatch.setattr(train_cli, "TrainValues", lambda: TrainValues(eval_interval=1))
    log = tmp_path / "again.json"
    again = train_cli.main(argv[:-1] + [str(log), "--resume", str(saved), "--epochs", "1"])
    assert seen == {"step": 0, "opt_state": {}, "equal": True}
    steps = [e["Step"] for e in json.loads(log.read_text()) if "Step" in e]
    assert steps == [1, 2] and again.step == 2


@pytest.mark.parametrize("extra", [["--model", "xlstm", "--bf16"], ["--bf16"], ["--parallel"], ["--tp", "2"], ["--sp", "2"],
                                   ["--pp", "2"], ["--pp-microbatches", "4"], ["--multihost"]])
def test_cli_train_unported_options_raise(workdir, train_corpus, extra):
    argv = ["--data", str(train_corpus), "--metadata", str(workdir / "metadata.json"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_cli.main(argv + extra)


def test_cli_train_device_cuda_without_a_card_raises(workdir, train_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--data", str(train_corpus), "--metadata", str(workdir / "metadata.json")])
    with pytest.raises(ValueError, match="not a --model transformer"):
        train_cli.main(["--model", "transformer", "--data", str(train_corpus), "--metadata",
                        str(workdir / "metadata.json"), "--resume", str(workdir / "model.pth"), "--device", "cpu"])


def test_package_never_imports_jax():
    """Import every module of the port (and run nothing) in a fresh
    interpreter: no jax, flax, optax or orbax may be loaded."""
    modules = [m.name for m in pkgutil.walk_packages(musicgen_tpu_torch.__path__, "musicgen_tpu_torch.")]
    assert "musicgen_tpu_torch.ops.decode_kernel" in modules and "musicgen_tpu_torch.cli.generate" in modules
    assert "musicgen_tpu_torch.train.trainer" in modules and "musicgen_tpu_torch.cli.train" in modules
    assert "musicgen_tpu_torch.ops.xdecode_kernel" in modules and "musicgen_tpu_torch.ops.slstm_kernel" in modules
    assert "musicgen_tpu_torch.experiments.hw_characterize" in modules and "musicgen_tpu_torch.ops.probe_kernel" in modules
    assert "musicgen_tpu_torch.cli.evaluate" in modules and "musicgen_tpu_torch.cli.train_classifier" in modules
    assert "musicgen_tpu_torch.cli.preprocess" in modules and "musicgen_tpu_torch.eval.timing" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_package_never_imports_the_jax_package():
    """Import every module of the port and chip_smoke.py in a fresh
    interpreter: no module named musicgen_tpu or musicgen_tpu.* may be
    loaded (the port keeps its own copies of config, midi and interop), nor
    the JAX package's probe scripts under experiments/."""
    modules = [m.name for m in pkgutil.walk_packages(musicgen_tpu_torch.__path__, "musicgen_tpu_torch.")]
    assert "musicgen_tpu_torch.midi.codec" in modules and "musicgen_tpu_torch.ops.tdecode_kernel" in modules
    assert "musicgen_tpu_torch.data.augment" in modules and "musicgen_tpu_torch.train.loss" in modules
    assert "musicgen_tpu_torch.models.xlstm" in modules and "musicgen_tpu_torch.ops.mlstm" in modules
    assert "musicgen_tpu_torch.experiments.kernel_ablate" in modules and "musicgen_tpu_torch.ops.ablate_kernel" in modules
    assert "musicgen_tpu_torch.eval.accuracy" in modules and "musicgen_tpu_torch.eval.classifier_eval" in modules
    assert "musicgen_tpu_torch.data.preprocess" in modules
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('musicgen_tpu', 'experiments'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
