"""Tensor parallelism of the port for the xLSTM LM (its token table and
output layer split over 'model') on a (data 2, model 2) grid of gloo ranks
against the JAX package's make_distributed_train_step on a (2, 2) ('data',
'model') mesh, as tests/test_torch_parallel_tp.py holds the Transformer: an
xLSTM of 2 blocks at width 32 (the sLSTM at block 1, the plain scan), 2 Adam
steps, the same tolerances."""
import pytest

from musicgen_tpu.config import XLSTMConfig as JaxXLSTMConfig
from musicgen_tpu.models.xlstm import XLSTMLM as JaxXLSTMLM
from musicgen_tpu_torch.config import XLSTMConfig
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_jax as PJ

KW = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=2, metadata_vocab_size=PJ.META)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, cfg = JaxXLSTMLM(JaxXLSTMConfig(**KW)), XLSTMConfig(**KW)
    src, _, meta = ddp.batch(0, "lm", cfg.vocab_size, PJ.META)
    params = J.random_params(jm, src[:, :8], meta)
    return PJ.tp_runs(tmp_path_factory.mktemp("tp"), jm, params, cfg, "lm", 0, PJ.META)


def test_tp_xlstm_steps_match_jax_mesh(run):
    got, want = run
    for r in got:
        J.assert_steps_close(r["steps"], want, 1e-5, 1e-4)
        assert sorted(r["shards"]) == ["output_layer.bias", "output_layer.weight", "token_embedding.weight"]
