"""Data-parallel training of the port for kind='lm' with loss_chunk (the
chunked grammar CE from the final hidden states, inside DDP's forward)
against its one-process step and JAX's make_distributed_train_step with the
same loss_chunk on a 2-device 'data' mesh, as tests/test_torch_distributed.py
holds the step without it (the same model and tolerances)."""
import pytest

from tests import torch_jax_common as J


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return J.lm_ddp_runs("lm_chunk", 6, tmp_path_factory.mktemp("ddp"))


def test_two_ranks_match_one_process(run):
    J.assert_steps_close(run[0], run[1], 1e-6, 1e-4)


def test_two_ranks_match_jax_mesh(run):
    J.assert_steps_close(run[0], run[2], 1e-5, 1e-4)
