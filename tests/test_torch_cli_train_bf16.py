"""cli.train --bf16 on the CPU (--device cpu) at a small size, one run per
family beside other options (--remat, --loss-chunk, --attention flash):
the model computes in bf16, its checkpoint is the f32 model.pth of the
f32 run's keys, and cli.generate reads it back."""
import os

import pytest
import torch

from musicgen_tpu_torch.cli import generate as cli
from musicgen_tpu_torch.cli import train as train_cli
from musicgen_tpu_torch.models.registry import new_model
from tests.torch_cli_common import BLOCK, make_train_corpus, make_workdir
from tests.torch_cli_common import argv as _argv
from tests.torch_cli_common import check_streams as _check_streams


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def train_corpus(workdir, tmp_path_factory):
    return make_train_corpus(workdir, tmp_path_factory.mktemp("train"))


OPTIONS = {"mamba": ["--remat"], "transformer": ["--loss-chunk", "16", "--attention", "flash"], "xlstm": []}


@pytest.mark.parametrize("model", list(OPTIONS))
def test_cli_train_bf16_then_generate(workdir, train_corpus, tmp_path, model):
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    state = train_cli.main(["--model", model, "--data", str(train_corpus), "--metadata",
                            str(workdir / "metadata.json"), "--block-len", str(BLOCK), "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ckpt"), "--log", str(tmp_path / "log.json"),
                            "--resume", str(workdir / ckpt), "--epochs", "1", "--bf16", *OPTIONS[model]])
    assert state.step == 2 and state.model.dtype == torch.bfloat16
    (saved,) = sorted((tmp_path / "ckpt").iterdir())
    assert sorted(os.listdir(saved)) == ["model.pth", "optimizer.pth"]
    sd = torch.load(saved / "model.pth", weights_only=True)
    f32 = new_model(model, state.model.cfg, "cpu").state_dict()
    assert {k: v.dtype for k, v in sd.items()} == {k: v.dtype for k, v in f32.items()}
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    opt = torch.load(saved / "optimizer.pth", weights_only=True)["optimizer"]["state"]
    assert all(v.dtype == torch.float32 for st in opt.values() for v in st.values())
    streams = cli.main(_argv(workdir, tmp_path / "gen", "--greedy", "--ckpt", str(saved / "model.pth"), model=model))
    _check_streams(streams, tmp_path / "gen", model)
