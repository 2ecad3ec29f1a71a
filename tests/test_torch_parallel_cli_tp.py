"""cli.train --parallel --tp 2 --device cpu (the Transformer) under two
spawned gloo ranks, one epoch of the small models and corpus of
tests/torch_cli_common.py: rank 0 logs the (data 1, model 2) mesh and writes
one checkpoint in the one-process layout (the token table and head gathered
from the two ranks' rows) that loads into the one-process model and equals
the ranks' shards joined, with the replicated tensors equal on both ranks."""
import pytest
import torch

from musicgen_tpu_torch.interop import load_model
from tests import torch_parallel_common as P

SHARDED = ("token_embedding_table.weight", "lm_head.weight", "lm_head.bias")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    workdir, held = P.strategy_cli_runs(root, {"tp": ("transformer", ["--parallel", "--tp", "2"])})
    return root, workdir, held


def test_cli_train_tp(trained):
    root, workdir, held = trained
    sd, messages = P.saved_checkpoint(root, "tp")
    assert messages[0] == "Training started! mesh={'data': 1, 'model': 2}"
    resumed = torch.load(workdir / "transformer.pth", weights_only=True)
    assert list(sd) == list(resumed) and all(sd[k].shape == v.shape for k, v in resumed.items())
    a, b = held[0][0], held[1][0]
    for k, v in sd.items():
        if k in SHARDED:
            assert a[k].shape[0] == 8957 and torch.equal(torch.cat([a[k], b[k]]), v), k
        else:
            assert torch.equal(a[k], v) and torch.equal(b[k], v), k
    load_model(sd, "cpu")
