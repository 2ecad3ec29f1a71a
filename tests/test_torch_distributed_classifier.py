"""Data-parallel training of the port's composer classifier
(train/distributed.py, kind='classifier') against its one-process step and
against the JAX package's make_distributed_train_step on a 2-device 'data'
mesh, as tests/test_torch_distributed.py holds the LM step (the same
tolerances, tests/torch_jax_common.py)."""
import pytest

from musicgen_tpu.config import ClassifierConfig as JaxClassifierConfig
from musicgen_tpu.models.xlstm import XLSTMClassifier as JaxXLSTMClassifier
from musicgen_tpu_torch.config import ClassifierConfig
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J

META = 12
KW = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, cfg = JaxXLSTMClassifier(JaxClassifierConfig(**KW)), ClassifierConfig(**KW)
    src, _, _ = ddp.batch(0, "classifier", cfg.vocab_size, META)
    params = J.random_params(jm, src[:, :8])
    return J.ddp_runs([("classifier", jm, params, cfg, "classifier", 0, META)],
                      tmp_path_factory.mktemp("ddp"))["classifier"]


def test_two_ranks_match_one_process(run):
    J.assert_steps_close(run[0], run[1], 1e-6, 1e-4)


def test_two_ranks_match_jax_mesh(run):
    J.assert_steps_close(run[0], run[2], 1e-5, 1e-4)
