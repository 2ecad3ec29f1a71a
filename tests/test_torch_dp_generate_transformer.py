"""Data-parallel generation of the port (parallel/serving.py
generate_data_parallel) for the small Transformer of tests/torch_families.py,
batch 8, in a gloo group of 4 ranks and in its two pairs (data grids of 4
and 2 ranks), case by case (tests/torch_dp_jax.check_case): greedy streams
bit for bit with the JAX package's sampler.generate after
shard_for_generation on a 4-device 'data' mesh; stochastic 'combined'
streams of the plain step bit for bit with the port's one-process
generate; on the kernels' plain versions ('combined', 'top5'), each
share bit for bit with its rows generated alone on their columns of the
batch's uniforms."""
import pytest
import torch

from tests import torch_dp_common as D
from tests import torch_dp_jax as DJ


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return DJ.generation_run(tmp_path_factory.mktemp("dp"), "transformer", D.GEN_CASES)


@pytest.mark.parametrize("case", list(D.GEN_CASES))
def test_transformer_streams_over_ranks(run, case):
    DJ.check_case(run, case)


def test_vocab_parallel_grid_streams(run):
    """On the (data 2, model 2) grid with fused=False the token table and
    head split over each model group (8,957 rows a rank) in a copy of the
    model, the caller's model staying whole, and the rows take the plain
    step through the split head: greedy and stochastic streams bit for bit
    with the one-process run. fused=True and fused=None (which would take
    kernel F on the card) are refused there."""
    for rank, res in enumerate(run["ranks"]):
        assert res["shards"] == []
        assert res["head_calls"] >= 2 * D.N, f"rank {rank}: the split head ran {res['head_calls']} times"
        assert len(res["refused"]) == 2 and all("data-parallel only" in e for e in res["refused"])
        for case in ("greedy", "combined"):
            assert torch.equal(res[("2x2", case)], run["one"][case]), f"rank {rank}, {case}"
