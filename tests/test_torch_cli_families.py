"""The port's generation CLI on the CPU (--device cpu) at a small size for
the Transformer and the xLSTM, through their --fused-decode values."""
import pytest

from musicgen_tpu_torch.cli import generate as cli
from tests.torch_cli_common import argv as _argv
from tests.torch_cli_common import check_streams as _check_streams
from tests.torch_cli_common import make_workdir


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("cli"))


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
