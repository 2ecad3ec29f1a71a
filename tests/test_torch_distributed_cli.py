"""cli.train --parallel --device cpu under two gloo ranks (spawned with a
launcher's environment, under a time limit) for the Transformer with
--bf16: rank 0 alone logs ("Training started!" with the mesh's data axis
of 2) and writes the checkpoint, whose keys carry no DDP 'module.' prefix,
and cli.generate reads it back; and the CLI's refusals.
tests/test_torch_distributed_cli_families.py runs Mamba and the xLSTM."""
import pytest

from musicgen_tpu_torch.cli import train as train_cli
from tests import torch_ddp_common as ddp


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return ddp.parallel_cli_runs(tmp_path_factory.mktemp("cli"), {"transformer": ["--bf16"]})


def test_cli_train_parallel_then_generate(trained, tmp_path):
    ddp.check_parallel_run(*trained, "transformer", tmp_path / "gen")


def test_cli_train_parallel_refusals(trained, monkeypatch):
    """--parallel without a launcher's environment raises, as does
    augmentation (the distributed step has none, as JAX's)."""
    workdir, root = trained
    argv = ["--data", str(root / "train"), "--metadata", str(workdir / "metadata.json"), "--device", "cpu",
            "--parallel"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        train_cli.main(argv)
    with pytest.raises(ValueError, match="augmentation"):
        train_cli.main(argv + ["--augmentation"])
