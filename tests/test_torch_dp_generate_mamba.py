"""Data-parallel generation of the port (parallel/serving.py
generate_data_parallel) for the small Mamba of tests/torch_families.py,
batch 8, in a gloo group of 4 ranks and in its two pairs (data grids of 4
and 2 ranks), case by case (tests/torch_dp_jax.check_case): greedy streams
bit for bit with the JAX package's sampler.generate after
shard_for_generation on a 4-device 'data' mesh; stochastic 'combined'
streams of the plain step bit for bit with the port's one-process
generate; on the kernels' plain versions ('combined', 'top5') and the resident
loop (kernel C's plain version), each
share bit for bit with its rows generated alone on their columns of the
batch's uniforms."""
import pytest

from tests import torch_dp_common as D
from tests import torch_dp_jax as DJ


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return DJ.generation_run(tmp_path_factory.mktemp("dp"), "mamba", D.MAMBA_CASES)


@pytest.mark.parametrize("case", list(D.MAMBA_CASES))
def test_mamba_streams_over_ranks(run, case):
    DJ.check_case(run, case)
