"""The main-process side of the port's data-parallel generation tests
(tests/test_torch_dp_generate_*.py): the 4 gloo ranks of
tests/torch_dp_common.generate_rank started on the small models of
tests/torch_families.py, the JAX package's sampler.generate after
shard_for_generation on a 4-device 'data' mesh of the suite's virtual CPU
devices (compiled while the ranks run), and the port's one-process streams.
Not a test module."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.config import MeshConfig
from musicgen_tpu.parallel.mesh import make_mesh
from musicgen_tpu.parallel.serving import shard_for_generation
from musicgen_tpu.sample import sampler as js
from musicgen_tpu_torch.interop import from_jax_params
from musicgen_tpu_torch.sample import sampler as ts
from tests import torch_dp_common as D
from tests.torch_families import family, grammatical, metas, prompts

B = 8
PLAIN = ("greedy", "combined")  # the cases that take the plain step on the CPU


def inputs(seed: int = 9):
    return prompts(B, D.BLOCK, seed=seed), metas(B, seed=seed)


def jax_sharded_greedy(kind: str, prompt: np.ndarray, meta: np.ndarray, data: int = D.WORLD) -> np.ndarray:
    """JAX's greedy 'combined' streams with the batch committed to a
    `data`-device mesh (tests/test_distributed_generate.py's recipe)."""
    jm, params, _ = family(kind)
    m = make_mesh(MeshConfig(data=data, model=1), jax.devices()[:data])
    sp, sm, spar = shard_for_generation(m, jnp.asarray(prompt), jnp.asarray(meta), params)
    return np.asarray(js.generate(jm, spar, kind, sp, sm, D.N, D.BLOCK, jax.random.PRNGKey(0), greedy=True))


def one_process(kind: str, prompt: np.ndarray, meta: np.ndarray, opts: dict) -> torch.Tensor:
    """The port's sampler.generate of the whole batch in this process."""
    return ts.generate(family(kind)[2], kind, torch.from_numpy(prompt).long(), torch.from_numpy(meta).long(), D.N,
                       D.BLOCK, torch.Generator().manual_seed(D.SEED), **opts)


def per_share(kind: str, prompt: np.ndarray, meta: np.ndarray, opts: dict, world: int) -> torch.Tensor:
    """Each data index's rows generated alone in this process on its
    columns of the batch's uniforms (the draw rule), concatenated."""
    u = ts.draw_uniforms(ts.SamplerConfig(num_tokens=D.N, greedy=opts.get("greedy", False),
                                          mode=opts.get("mode", "combined")), B, torch.Generator().manual_seed(D.SEED),
                         "cpu")
    n, out = B // world, []
    for i in range(world):
        rows = slice(i * n, (i + 1) * n)
        out.append(ts.generate(family(kind)[2], kind, torch.from_numpy(prompt[rows]).long(),
                               torch.from_numpy(meta[rows]).long(), D.N, D.BLOCK, torch.Generator(),
                               uniforms=None if u is None else u[:, rows], **opts))
    return torch.cat(out)


def generation_run(tmp, kind: str, cases: dict) -> dict:
    """The ranks' results, JAX's sharded greedy streams and the port's
    one-process and per-share streams of every case."""
    jm, params, port = family(kind)
    prompt, meta = inputs()
    results = D.run_ranks(D.generate_rank, tmp, {"sd": from_jax_params(params, port.cfg), "prompt": prompt,
                                                 "meta": meta}, kind, cases)
    return {"jax": jax_sharded_greedy(kind, prompt, meta), "prompt": prompt,
            "one": {case: one_process(kind, prompt, meta, opts) for case, opts in cases.items()},
            "shares": {(str(w), case): per_share(kind, prompt, meta, opts, w) for case, opts in cases.items()
                       for w in (2, D.WORLD)},
            "ranks": results()}


def check_case(run: dict, case: str) -> None:
    """Every rank of both data grids returns the whole batch's streams of
    `case`: greedy ones equal JAX's sharded generate; on the plain step
    (PLAIN) every stream equals the port's one-process run of the batch bit
    for bit; on every route each equals its shares generated alone on their
    columns of the uniforms (on the CPU the kernels' plain versions round a
    row differently at another batch size: MKL's sgemm is not
    batch-invariant, and their bf16 roundings carry a 1e-6 difference into
    the logits). Every stream is grammatical."""
    for rank, res in enumerate(run["ranks"]):
        for grid in ("4", "2"):
            got = res[(grid, case)]
            where = f"rank {rank}, grid {grid}, case {case}"
            assert got.shape == (B, D.BLOCK + D.N) and grammatical(got, D.BLOCK), where
            assert torch.equal(got, run["shares"][(grid, case)]), where
            if case in PLAIN:
                assert torch.equal(got, run["one"][case]), where
            if case == "greedy":
                np.testing.assert_array_equal(got.numpy(), run["jax"], err_msg=where)
