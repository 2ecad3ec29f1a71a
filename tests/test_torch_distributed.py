"""Data-parallel training of the port (train/distributed.py) for kind='lm'
against its one-process step and against the JAX package's
make_distributed_train_step on a 2-device 'data' mesh of the suite's
virtual CPU devices (tests/torch_jax_common.py); and its refusals.

Two gloo ranks (torch.multiprocessing, under a time limit) each take their
half of every global batch of 4 rows; the same steps run in this process in
a 1-rank group on the whole batch, and JAX's jitted SPMD step shards the
same batch over 2 devices. Two Adam steps of a Transformer with dropout 0.1
from the same weights: each of those steps is deterministic (no dropout).
Tolerances (f32 sums in another order, see assert_steps_close): the loss to
1e-6 relative between the port's two runs and 1e-5 against JAX, the
gradients to 1e-4 of each tensor's largest value, the parameters after each
step to 1e-6. tests/test_torch_distributed_chunk.py holds the step with
loss_chunk, tests/test_torch_distributed_classifier.py kind='classifier'."""
import pytest
import torch

from musicgen_tpu_torch.train import distributed
from tests import torch_jax_common as J


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return J.lm_ddp_runs("lm", 0, tmp_path_factory.mktemp("ddp"))


def test_two_ranks_match_one_process(run):
    """Two gloo ranks on halves of each global batch take the one-process
    step's steps on the whole batch."""
    J.assert_steps_close(run[0], run[1], 1e-6, 1e-4)


def test_two_ranks_match_jax_mesh(run):
    """...and JAX's make_distributed_train_step's on a 2-device data mesh."""
    J.assert_steps_close(run[0], run[2], 1e-5, 1e-4)


def test_rank_share_and_refusals(monkeypatch):
    x = torch.arange(12).reshape(6, 2)
    assert [distributed.rank_share(x, r, 3)[:, 0].tolist() for r in range(3)] == [[0, 2], [4, 6], [8, 10]]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        distributed.rank_share(x, 0, 4)
    with pytest.raises(ValueError, match="kind"):
        distributed.make_distributed_train_step(None, None, kind="mlm")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        distributed.init_from_env("cpu")
