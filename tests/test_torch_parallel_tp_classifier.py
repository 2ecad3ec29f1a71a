"""Tensor parallelism of the port for the composer classifier (kind
'classifier': its token table splits over 'model', as JAX's param_shardings
splits the padded table; its dead head of buffers and its meta head stay
whole) on a (data 2, model 2) grid of gloo ranks against the JAX package's
make_distributed_train_step on a (2, 2) mesh, as
tests/test_torch_parallel_tp.py holds the LM: 2 Adam steps, the same
tolerances."""
import pytest

from musicgen_tpu.config import ClassifierConfig as JaxClassifierConfig
from musicgen_tpu.models.xlstm import XLSTMClassifier as JaxXLSTMClassifier
from musicgen_tpu_torch.config import ClassifierConfig
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_jax as PJ

META = 12
KW = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=META)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, cfg = JaxXLSTMClassifier(JaxClassifierConfig(**KW)), ClassifierConfig(**KW)
    src, _, _ = ddp.batch(0, "classifier", cfg.vocab_size, META)
    params = J.random_params(jm, src[:, :8])
    return PJ.tp_runs(tmp_path_factory.mktemp("tp"), jm, params, cfg, "classifier", 0, META)


def test_tp_classifier_steps_match_jax_mesh(run):
    got, want = run
    for r in got:
        J.assert_steps_close(r["steps"], want, 1e-5, 1e-4)
        assert sorted(r["shards"]) == ["token_embedding.weight"]
