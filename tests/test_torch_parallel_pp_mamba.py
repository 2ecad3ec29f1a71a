"""Pipeline-parallel Mamba of the port (parallel/pipeline.py) in a gloo
group of 2 stages against the JAX package's pp_loss on a 2-device 'pipe'
mesh (tests/torch_parallel_pp.py): a Mamba of 4 layers at width 32 (2 a
stage), batch 4 x 26 tokens, M = 2 microbatches (M = 4 in
tests/test_torch_parallel_pp_mamba_m4.py); the loss to 1e-5 relative on
every rank and every gradient to 1e-4 of its tensor's largest value. Each
stage holds only its layers (and stage 0 the tables, the last stage the norm
and head): its state dict is its pp_split part."""
import pytest
import torch

from musicgen_tpu_torch.config import MambaConfig
from musicgen_tpu_torch.parallel.pipeline import pp_split
from tests import torch_parallel_jax as PJ
from tests import torch_parallel_pp as PP


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return PP.pp_run(tmp_path_factory.mktemp("pp"), "mamba", 2, 1, 4, (2,))


def test_pp_mamba_matches_jax_mesh(run):
    got, want, _ = run
    PP.check_pp(got, want, 2)


def test_pp_mamba_stages_hold_their_part(run):
    got, _, path = run
    parts = pp_split(torch.load(path, weights_only=True), MambaConfig(**PJ.mamba_kw(4)), 2)
    for r, part in zip(got, parts):
        assert sorted(r["state"]) == sorted(part)
        assert all(torch.equal(r["state"][k], v) for k, v in part.items())
