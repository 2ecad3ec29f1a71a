"""Tensor parallelism of the port (parallel/mesh.py, train/distributed.py
with a grid) in a gloo group of 4 ranks on a (data 2, model 2) grid against
the JAX package's make_distributed_train_step on a (2, 2) ('data', 'model')
mesh of the suite's virtual CPU devices, where GSPMD splits the padded
17,920-row token table and head over 'model' (the port splits its 17,914
rows 8,957 / 8,957): 2 Adam steps of the data-parallel tests' Transformer
(tests/torch_jax_common.LM_KW) on batches of 4 rows. The losses to 1e-5
relative, the gathered gradients to 1e-4 of each tensor's largest value,
the gathered parameters to 1e-6 (assert_steps_close), the same on every
rank; each rank holds its own rows of the vocabulary-sized tensors.
tests/test_torch_parallel_tp_chunk.py holds Mamba with loss_chunk,
tests/test_torch_parallel_tp_xlstm.py the xLSTM LM and
tests/test_torch_parallel_tp_classifier.py the classifier."""
import pytest
import torch

from musicgen_tpu.config import TransformerConfig as JaxTransformerConfig
from musicgen_tpu.models.transformer import TransformerLM as JaxTransformerLM
from musicgen_tpu_torch.config import TransformerConfig
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_jax as PJ


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, cfg = JaxTransformerLM(JaxTransformerConfig(**J.LM_KW)), TransformerConfig(**J.LM_KW)
    src, _, meta = ddp.batch(0, "lm", cfg.vocab_size, J.LM_META)
    params = J.random_params(jm, src[:, :8], meta)
    return PJ.tp_runs(tmp_path_factory.mktemp("tp"), jm, params, cfg, "lm", 0, J.LM_META)


def test_tp_steps_match_jax_mesh(run):
    got, want = run
    for r in got:
        J.assert_steps_close(r["steps"], want, 1e-5, 1e-4)


def test_tp_ranks_hold_their_rows(run):
    got, _ = run
    for rank, r in enumerate(got):
        lo = (rank % 2) * 8957
        assert sorted(r["shards"]) == ["lm_head.bias", "lm_head.weight", "token_embedding_table.weight"]
        for name, shard in r["shards"].items():
            assert shard.shape[0] == 8957
            assert torch.equal(shard, r["steps"][2][name][lo:lo + 8957])
