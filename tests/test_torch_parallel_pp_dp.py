"""Data x pipeline parallelism of the port (parallel/pipeline.py) in a gloo
group of 4 ranks, 2 data replicas of 2 stages, against the JAX package's
pp_loss on a (2, 2) ('data', 'pipe') mesh (tests/torch_parallel_pp.py): the
Mamba of 4 layers at width 32, batch 8 x 26 tokens, M = 2 microbatches of 4
rows, each replica taking 2 rows of each; the loss to 1e-5 relative on every
rank and every gradient (summed over the data group) to 1e-4 of its
tensor's largest value, equal on both replicas."""
import pytest
import torch

from tests import torch_parallel_pp as PP


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.pp_run(tmp_path_factory.mktemp("pp"), "mamba", 2, 2, 8, (2,))


def test_pp_dp_matches_jax_mesh(run):
    got, want, _ = run
    PP.check_pp(got, want, 2)


def test_pp_dp_replicas_agree(run):
    got, _, _ = run
    for a, b in ((got[0], got[2]), (got[1], got[3])):  # rank r at (data r // 2, stage r % 2)
        for name, g in a["results"][2][1].items():
            assert torch.allclose(g, b["results"][2][1][name], rtol=0, atol=0), name
