"""Pipeline-parallel Mamba of the port at M = 4 microbatches (one example
each) over 2 stages, as tests/test_torch_parallel_pp_mamba.py holds it at
M = 2: the loss to 1e-5 relative on every rank and every gradient to 1e-4
of its tensor's largest value against the JAX package's pp_loss on a
2-device 'pipe' mesh."""
import pytest

from tests import torch_parallel_pp as PP


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.pp_run(tmp_path_factory.mktemp("pp"), "mamba", 2, 1, 4, (4,))


def test_pp_mamba_matches_jax_mesh_m4(run):
    got, want, _ = run
    PP.check_pp(got, want, 4)
