"""cli.train --pp 2 (the Transformer) and --sp 2 --multihost (Mamba; the
flag joins the launcher's group as a multi-node launcher's) with --device
cpu under two spawned gloo ranks (a launcher's environment, under a time limit),
one epoch of the small models and corpus of tests/torch_cli_common.py: each
run exits normally, rank 0 logs its strategy and writes one checkpoint whose
model.pth has the one-process layout (the resumed .pth's keys, f32), loads
into the one-process model, and equals the ranks' own parameters gathered
(the two stages' state dicts joined; sequence-parallel ranks hold the same
whole model). tests/test_torch_parallel_cli_tp.py runs --parallel --tp 2."""
import pytest
import torch

from musicgen_tpu_torch.interop import load_model
from musicgen_tpu_torch.parallel.pipeline import pp_join
from tests import torch_parallel_common as P


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    workdir, held = P.strategy_cli_runs(root, {"pp": ("transformer", ["--pp", "2"]),
                                               "sp": ("mamba", ["--sp", "2", "--multihost"])})
    return root, workdir, held


def check_saved(sd, resumed, gathered):
    assert list(sd) == list(resumed)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sorted(gathered) == sorted(sd)
    assert all(torch.equal(gathered[k], v) for k, v in sd.items())
    load_model(sd, "cpu")


def test_cli_train_pp(trained):
    root, workdir, held = trained
    sd, messages = P.saved_checkpoint(root, "pp")
    assert messages[0] == "Training started! pp=2 (layer-sharded GPipe)"
    check_saved(sd, torch.load(workdir / "transformer.pth", weights_only=True), pp_join([held[0][0], held[1][0]]))
    assert "blocks.0.ln1.weight" not in held[1][0] and "lm_head.weight" not in held[0][0]


def test_cli_train_sp(trained):
    root, workdir, held = trained
    sd, messages = P.saved_checkpoint(root, "sp")
    assert messages[0] == "Training started! sp=2 (time-sharded)"
    check_saved(sd, torch.load(workdir / "model.pth", weights_only=True), held[0][1])
    assert all(torch.equal(held[1][1][k], v) for k, v in held[0][1].items())
