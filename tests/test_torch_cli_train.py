"""The port's training CLI on the CPU (--device cpu) at a small size:
train each family, generate from its checkpoint, resume, and the refusals."""
import json
import os

import pytest
import torch

from musicgen_tpu_torch.cli import generate as cli
from musicgen_tpu_torch.cli import train as train_cli
from tests.torch_cli_common import BLOCK, make_train_corpus, make_workdir
from tests.torch_cli_common import argv as _argv
from tests.torch_cli_common import check_streams as _check_streams


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def train_corpus(workdir, tmp_path_factory):
    return make_train_corpus(workdir, tmp_path_factory.mktemp("train"))


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


# Since the multi-rank strategies were ported, what each of these flag sets
# does outside a launcher: a strategy raises without the launcher's group
# (no quiet fallback to one process), and a flag without the strategy it
# belongs to raises.
WITHOUT_A_LAUNCHER = {
    ("--model", "xlstm", "--bf16", "--parallel", "--tp", "2"): (RuntimeError, "launcher"),
    ("--bf16", "--sp", "2"): (RuntimeError, "launcher"),
    ("--parallel", "--multihost"): (RuntimeError, "launcher"),
    ("--tp", "2"): (ValueError, "--tp splits the vocabulary over the ranks of --parallel"),
    ("--sp", "2"): (RuntimeError, "launcher"),
    ("--pp", "2"): (RuntimeError, "launcher"),
    ("--pp-microbatches", "4"): (ValueError, "--pp-microbatches sets the microbatches of --pp"),
    ("--multihost",): (ValueError, "--multihost joins a launcher's group"),
}


@pytest.mark.parametrize("extra", [["--model", "xlstm", "--bf16", "--parallel", "--tp", "2"], ["--bf16", "--sp", "2"],
                                   ["--parallel", "--multihost"], ["--tp", "2"], ["--sp", "2"],
                                   ["--pp", "2"], ["--pp-microbatches", "4"], ["--multihost"]])
def test_cli_train_unported_options_raise(workdir, train_corpus, extra, monkeypatch):
    """The multi-rank options, alone and beside --bf16 and --parallel,
    raise outside a launcher (WITHOUT_A_LAUNCHER); they are ported, and
    tests/test_torch_parallel_*.py run them in gloo groups."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--data", str(train_corpus), "--metadata", str(workdir / "metadata.json"), "--device", "cpu"]
    exc, match = WITHOUT_A_LAUNCHER[tuple(extra)]
    with pytest.raises(exc, match=match):
        train_cli.main(argv + extra)


def test_cli_train_device_cuda_without_a_card_raises(workdir, train_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--data", str(train_corpus), "--metadata", str(workdir / "metadata.json")])
    with pytest.raises(ValueError, match="not a --model transformer"):
        train_cli.main(["--model", "transformer", "--data", str(train_corpus), "--metadata",
                        str(workdir / "metadata.json"), "--resume", str(workdir / "model.pth"), "--device", "cpu"])
