"""The classifier's forward over ranks (parallel/serving.py
classify_data_parallel), the counterpart of the JAX package's
tests/test_distributed_generate.py::test_data_sharded_classifier_forward_matches:
a small classifier of seeded weights at batch 8 in a gloo group of 4 ranks,
in its two pairs (data grids of 4 and 2 ranks) and on a (data 2, model 2)
grid that splits the token table over each model group; every rank's
logits of the whole batch within 1e-6 of the JAX package's apply on the
batch committed to a 4-device 'data' mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicgen_tpu.config import ClassifierConfig as JaxClassifierConfig
from musicgen_tpu.config import MeshConfig
from musicgen_tpu.models.xlstm import XLSTMClassifier as JaxXLSTMClassifier
from musicgen_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings
from musicgen_tpu_torch.config import ClassifierConfig
from musicgen_tpu_torch.interop import from_jax_params
from tests import torch_dp_common as D
from tests import torch_jax_common as J

KW = dict(embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=4, context_length=16, metadata_vocab_size=17)
TOL = 1e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm, cfg = JaxXLSTMClassifier(JaxClassifierConfig(**KW)), ClassifierConfig(**KW)
    src = np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 16))
    params = J.random_params(jm, src[:, :8])
    results = D.run_ranks(D.classify_rank, tmp_path_factory.mktemp("dp"),
                          {"sd": from_jax_params(params, cfg), "src": src})
    m = make_mesh(MeshConfig(data=D.WORLD, model=1), jax.devices()[:D.WORLD])
    spar = jax.device_put(params, param_shardings(params, m))
    want = np.asarray(jax.jit(jm.apply)(spar, jax.device_put(jnp.asarray(src, jnp.int32), batch_sharding(m))))
    return results(), want


@pytest.mark.parametrize("grid", ["4", "2", "2x2"])
def test_classifier_logits_over_ranks_match_jax(run, grid):
    got, want = run
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res[grid].numpy(), want, rtol=TOL, atol=TOL, err_msg=f"rank {rank}")
