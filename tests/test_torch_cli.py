"""The port's generation CLI on the CPU (--device cpu) at a small size:
a Mamba model through every --fused-decode value, and the CLI's refusals.
The other families are in tests/test_torch_cli_families.py, training in
tests/test_torch_cli_train.py, the new sampler options in
tests/test_torch_sampler_modes.py and tests/test_torch_windowed.py, and
the guards that no module imports jax in tests/test_torch_import_guards.py
(the shared pieces in tests/torch_cli_common.py)."""
import numpy as np
import pytest
import torch

from musicgen_tpu_torch.cli import generate as cli
from tests.torch_cli_common import argv as _argv
from tests.torch_cli_common import check_streams as _check_streams
from tests.torch_cli_common import make_workdir


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("cli"))


@pytest.mark.parametrize("extra", [["--greedy"], ["--seed", "5", "--retain"], ["--no-metadata", "--decode-skip", "10"],
                                   ["--fused-decode", "resident"], ["--fused-decode", "resident-int8w", "--greedy"],
                                   ["--fused-decode", "int8"], ["--fused-decode", "int8w"]],
                         ids=["greedy", "sampled_retain", "no_metadata_skip", "resident", "resident_int8w",
                              "int8", "int8w"])
def test_cli_writes_grammatical_midi(workdir, tmp_path, extra):
    streams = cli.main(_argv(workdir, tmp_path, *extra))
    _check_streams(streams, tmp_path, "mamba", "_no_meta" if "--no-metadata" in extra else "")


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
