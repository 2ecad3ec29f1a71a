"""Serving over ranks (serve.BatchScheduler(mesh=grid)), the counterparts of
the JAX package's tests/test_serve.py mesh cases, in a gloo group of 4
ranks and in its two pairs (data grids of 4 and 2 ranks), 8 slots, chunks
of 4: 5 stochastic requests of mixed lengths through Mamba's plain step bit
for bit with a one-process pool of 2 slots; greedy requests through the
kernel chunk (the kernels' plain versions) bit for bit with the one-process
kernel pool and with sampler.generate at batch 1; the Transformer's greedy
requests at per-slot offsets of its ring against sampler.generate at batch
1 (its oracle), also on a (data 2, model 2) grid through the plain
vocabulary-parallel step of a copy of the model (the caller's stays
whole); and the refusals of 6 slots over 4 ranks and, with a model axis of
2, of fused=True and of Mamba's fused=None. Every rank's run() returns
every request's stream."""
import numpy as np
import pytest

from musicgen_tpu_torch.interop import from_jax_params
from musicgen_tpu_torch.serve import BatchScheduler
from tests import torch_dp_common as D
from tests.torch_families import family, metas, port_generate, prompts

P = 16  # Mamba's prompt length; the Transformer's fills its window (BLOCK)
SEEDS = [50 + i for i in range(len(D.SERVE_LENGTHS))]


def _oneshot(kind, prompt, meta, n, **opts):
    return port_generate(kind, prompt[None], meta[None], n, greedy=True, **opts)[0, prompt.shape[0]:].numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    p, m = prompts(len(D.SERVE_LENGTHS), P, seed=1), metas(len(D.SERVE_LENGTHS), seed=1)
    tp, tm = prompts(len(D.T_LENGTHS), D.BLOCK, seed=2), metas(len(D.T_LENGTHS), seed=2)
    mamba, trans = family("mamba"), family("transformer")
    results = D.run_ranks(D.serve_rank, tmp_path_factory.mktemp("dp"),
                          {"mamba": from_jax_params(mamba[1], mamba[2].cfg),
                           "transformer": from_jax_params(trans[1], trans[2].cfg), "prompt": p, "meta": m,
                           "t_prompt": tp, "t_meta": tm, "seeds": SEEDS})

    def solo(lengths, seeds=None, **opts):
        sched = BatchScheduler(mamba[2], "mamba", prompt_len=P, slots=2, chunk=D.CHUNK, block_len=D.BLOCK, **opts)
        rids = [sched.submit(p[i], m[i], n, 0 if seeds is None else seeds[i]) for i, n in enumerate(lengths)]
        got = sched.run()
        return {i: got[rid] for i, rid in enumerate(rids)}

    want = {"stochastic": solo(D.SERVE_LENGTHS, SEEDS, fused=False),
            "kernel chunk": solo(D.FUSED_LENGTHS, greedy=True, fused=True),
            "kernel oneshot": {i: _oneshot("mamba", p[i], m[i], n, fused=True) for i, n in enumerate(D.FUSED_LENGTHS)},
            "transformer": {i: _oneshot("transformer", tp[i], tm[i], n, fused=False)
                            for i, n in enumerate(D.T_LENGTHS)}}
    return results(), want


def _same(got: dict, want: dict, where: str) -> None:
    assert sorted(got) == sorted(want), where
    for i in want:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{where}, request {i}")


@pytest.mark.parametrize("grid", ["4", "2"])
def test_stochastic_pool_over_ranks_matches_one_process(run, grid):
    got, want = run
    for rank, res in enumerate(got):
        _same(res[(grid, "stochastic")], want["stochastic"], f"rank {rank}")


@pytest.mark.parametrize("grid", ["4", "2"])
def test_kernel_chunk_over_ranks_matches_one_process_and_generate(run, grid):
    got, want = run
    for rank, res in enumerate(got):
        _same(res[(grid, "kernel chunk")], want["kernel chunk"], f"rank {rank}")
        _same(res[(grid, "kernel chunk")], want["kernel oneshot"], f"rank {rank} against generate")


@pytest.mark.parametrize("grid", ["4", "2", "2x2"])
def test_transformer_ring_geometry_over_ranks_matches_oracle(run, grid):
    got, want = run
    for rank, res in enumerate(got):
        _same(res[(grid, "transformer")], want["transformer"], f"rank {rank}")


def test_refusals_over_ranks(run):
    got, _ = run
    for res in got:
        divide, tp, tp_auto = res["refused"]
        assert "divide" in divide and "data-parallel" in tp and "data-parallel" in tp_auto
        assert res["shards"] == []
