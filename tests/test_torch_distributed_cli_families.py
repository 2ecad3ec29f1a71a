"""cli.train --parallel --device cpu under two gloo ranks for Mamba and the
xLSTM (whose log is named by --log-json), as tests/
test_torch_distributed_cli.py runs the Transformer: one checkpoint without
a 'module.' prefix from rank 0, which cli.generate reads back."""
import pytest

from tests import torch_ddp_common as ddp

FAMILIES = ("mamba", "xlstm")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ddp.parallel_cli_runs(tmp_path_factory.mktemp("cli"), dict.fromkeys(FAMILIES, []))


@pytest.mark.parametrize("model", FAMILIES)
def test_cli_train_parallel_then_generate(trained, tmp_path, model):
    ddp.check_parallel_run(*trained, model, tmp_path / "gen")
