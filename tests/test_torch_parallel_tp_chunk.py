"""Tensor parallelism of the port for Mamba with loss_chunk (the chunked
grammar CE through the vocabulary-parallel head, its logits gathered again
in the backward's recomputation) on a (data 2, model 2) grid of gloo ranks
against the JAX package's make_distributed_train_step with the same
loss_chunk on a (2, 2) ('data', 'model') mesh, as
tests/test_torch_parallel_tp.py holds the Transformer: a Mamba of 2 layers at
width 32, 2 Adam steps, the same tolerances."""
import pytest

from musicgen_tpu.config import MambaConfig as JaxMambaConfig
from musicgen_tpu.models.mamba import MambaLM as JaxMambaLM
from musicgen_tpu_torch.config import MambaConfig
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_jax as PJ


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    kw = PJ.mamba_kw(2)
    jm, cfg = JaxMambaLM(JaxMambaConfig(**kw)), MambaConfig(**kw)
    src, _, meta = ddp.batch(0, "lm", cfg.vocab_size, PJ.META)
    params = J.random_params(jm, src[:, :8], meta)
    return PJ.tp_runs(tmp_path_factory.mktemp("tp"), jm, params, cfg, "lm", 6, PJ.META)


def test_tp_chunked_steps_match_jax_mesh(run):
    got, want = run
    for r in got:
        J.assert_steps_close(r["steps"], want, 1e-5, 1e-4)
