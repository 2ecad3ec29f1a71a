"""Pipeline-parallel Transformer of the port (parallel/pipeline.py) in a
gloo group of 2 stages against the JAX package's pp_loss on a 2-device
'pipe' mesh (tests/torch_parallel_pp.py): 4 blocks at width 32 (2 a stage,
4 heads, the plain attention on the CPU), batch 4 x 26 tokens, M = 2 (M = 4
in tests/test_torch_parallel_pp_transformer_m4.py); the loss to 1e-5 relative on every rank and every gradient to 1e-4 of its
tensor's largest value."""
import pytest

from tests import torch_parallel_pp as PP


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.pp_run(tmp_path_factory.mktemp("pp"), "transformer", 2, 1, 4, (2,))


def test_pp_transformer_matches_jax_mesh(run):
    got, want, _ = run
    PP.check_pp(got, want, 2)
