"""Rank functions of the port's data-parallel generation, classification and
serving tests (tests/test_torch_dp_*.py), run in a gloo group of 4 ranks
spawned by tests/torch_ddp_common.start_ranks. One group serves every case
of a file: the whole group is a data grid of 4 ranks, its two pairs (ranks
0-1 and 2-3, each a gloo group of its own) two data grids of 2 ranks that
compute the same run side by side, and parallel/mesh.make_grid(model=2) a
(data 2, model 2) grid. Each rank saves {case: result} to `{out}.{rank}`.
Imports no JAX, so that a spawned rank starts on torch alone. Not a test
module."""
import torch
import torch.distributed as dist

from musicgen_tpu_torch.config import MeshConfig
from musicgen_tpu_torch.interop import load_model
from musicgen_tpu_torch.parallel import mesh
from musicgen_tpu_torch.parallel.serving import classify_data_parallel, generate_data_parallel
from musicgen_tpu_torch.serve import BatchScheduler
from tests import torch_ddp_common as ddp

WORLD = 4
BLOCK = 32  # tests/torch_families.BLOCK: the window, and every prompt's length here
N = 12  # tokens a generation
SEED = 21
# Every case of a generation file: sampler.generate's options. fused=None
# takes the plain step on the CPU; fused=True the kernels' plain versions.
GEN_CASES = {"greedy": dict(greedy=True), "combined": dict(), "combined kernels": dict(fused=True),
             "top5 kernels": dict(mode="top5", fused=True)}
MAMBA_CASES = {**GEN_CASES, "resident": dict(resident=True)}
# Serving: 5 stochastic requests of mixed lengths over 8 slots (the JAX
# package's tests/test_serve.py mesh case), a greedy kernel chunk, and the
# Transformer's ring geometry at per-slot offsets.
SLOTS, CHUNK = 8, 4
SERVE_LENGTHS = (6, 11, 3, 8, 5)
FUSED_LENGTHS = (6, 9, 3)
T_LENGTHS = (5, 5, 5)


def data_grids(rank: int) -> dict:
    """{'4': the whole group, '2': this rank's pair} as data grids. Every
    rank creates both pairs' groups, in the same order."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return {"4": mesh.Grid(WORLD, 1, rank), "2": mesh.Grid(2, 1, rank % 2, pairs[rank // 2])}


def _join(rank: int, world: int, port: int) -> None:
    ddp.set_rank_env(rank, world, port)
    dist.init_process_group("gloo", init_method="env://")


def generate_rank(rank: int, world: int, port: int, path: str, kind: str, cases: dict, out: str) -> None:
    """generate_data_parallel of the model saved at `path` (with the batch
    "prompt", "meta") for each case of `cases` on both data grids; for the
    Transformer also on the (data 2, model 2) grid through the plain
    vocabulary-parallel step (fused=False), greedy and stochastic, the
    calls of its VocabParallelHead, the caller's model left whole, and the
    refusals of fused=True and of fused=None there."""
    _join(rank, world, port)
    try:
        held = torch.load(path, weights_only=False)
        model = load_model(held["sd"], "cpu").eval()
        prompt, meta = torch.from_numpy(held["prompt"]).long(), torch.from_numpy(held["meta"]).long()
        res = {}
        for name, grid in data_grids(rank).items():
            for case, opts in cases.items():
                res[(name, case)] = generate_data_parallel(model, kind, prompt, meta, N, BLOCK,
                                                           torch.Generator().manual_seed(SEED), grid, **opts)
        if kind == "transformer":
            grid = mesh.make_grid(MeshConfig(model=2))
            res["refused"] = []
            for opts in (dict(fused=True), {}):
                try:
                    generate_data_parallel(model, kind, prompt, meta, N, BLOCK, torch.Generator(), grid, **opts)
                except ValueError as e:
                    res["refused"].append(str(e))
            head_calls, forward = [], mesh.VocabParallelHead.forward
            mesh.VocabParallelHead.forward = lambda self, h: head_calls.append(h.shape[0]) or forward(self, h)
            try:
                for case in ("greedy", "combined"):
                    res[("2x2", case)] = generate_data_parallel(model, kind, prompt, meta, N, BLOCK,
                                                                torch.Generator().manual_seed(SEED), grid,
                                                                **GEN_CASES[case], fused=False)
            finally:
                mesh.VocabParallelHead.forward = forward
            res["head_calls"] = len(head_calls)
            res["shards"] = sorted(n for n, m in model.named_modules() if isinstance(m, mesh._VocabShard))
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def classify_rank(rank: int, world: int, port: int, path: str, out: str) -> None:
    """classify_data_parallel of the classifier saved at `path` on "src" over
    both data grids and the (data 2, model 2) grid."""
    _join(rank, world, port)
    try:
        held = torch.load(path, weights_only=False)
        model = load_model(held["sd"], "cpu")
        src = torch.from_numpy(held["src"]).long()
        res = {name: classify_data_parallel(model, src, grid) for name, grid in data_grids(rank).items()}
        res["2x2"] = classify_data_parallel(model, src, mesh.make_grid(MeshConfig(model=2)))
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def serve(model, kind: str, prompt, meta, lengths, seeds=None, grid=None, **opts) -> dict:
    """BatchScheduler(mesh=grid) over SLOTS slots, chunks of CHUNK, with
    requests i of (prompt[i], meta[i], lengths[i], seeds[i]): {i: tokens}."""
    sched = BatchScheduler(model, kind, prompt_len=prompt.shape[1], slots=SLOTS, chunk=CHUNK, block_len=BLOCK,
                           mesh=grid, **opts)
    rids = [sched.submit(prompt[i], meta[i], n, 0 if seeds is None else seeds[i]) for i, n in enumerate(lengths)]
    got = sched.run()
    return {i: got[rid] for i, rid in enumerate(rids)}


def serve_rank(rank: int, world: int, port: int, path: str, out: str) -> None:
    """The serving cases on both data grids: Mamba's stochastic requests
    through the plain step, its greedy kernel chunk (the plain versions),
    the Transformer's greedy requests at per-slot offsets; the Transformer
    on the (data 2, model 2) grid, the caller's model left whole; the
    three refusals."""
    _join(rank, world, port)
    try:
        held = torch.load(path, weights_only=False)
        mamba = load_model(held["mamba"], "cpu").eval()
        trans = load_model(held["transformer"], "cpu").eval()
        p, m, tp, tm = held["prompt"], held["meta"], held["t_prompt"], held["t_meta"]
        res = {}
        for name, grid in data_grids(rank).items():
            res[(name, "stochastic")] = serve(mamba, "mamba", p, m, SERVE_LENGTHS, held["seeds"], grid,
                                              fused=False)
            res[(name, "kernel chunk")] = serve(mamba, "mamba", p, m, FUSED_LENGTHS, None, grid, greedy=True,
                                                fused=True)
            res[(name, "transformer")] = serve(trans, "transformer", tp, tm, T_LENGTHS, None, grid, greedy=True)
        refused = []
        for grid, opts in ((data_grids(rank)["4"], dict(slots=6)),
                           (mesh.make_grid(MeshConfig(model=2)), dict(slots=SLOTS, fused=True)),
                           (mesh.make_grid(MeshConfig(model=2)), dict(slots=SLOTS))):
            try:
                BatchScheduler(mamba, "mamba", prompt_len=p.shape[1], mesh=grid, **opts)
            except ValueError as e:
                refused.append(str(e))
        res["refused"] = refused
        grid = mesh.make_grid(MeshConfig(model=2))
        res[("2x2", "transformer")] = serve(trans, "transformer", tp, tm, T_LENGTHS, None, grid, greedy=True)
        res["shards"] = sorted(n for n, m in trans.named_modules() if isinstance(m, mesh._VocabShard))
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp, held: dict, *args, timeout: float = 60.0):
    """Saves `held` for the ranks, starts fn over WORLD ranks; returns a
    function that waits for them and reads their results."""
    path = str(tmp / "held.pt")
    torch.save(held, path)
    ctx = ddp.start_ranks(fn, WORLD, path, *args, str(tmp / "out"))

    def results() -> list:
        ddp.wait_ranks(ctx, timeout=timeout)
        return [torch.load(f"{tmp / 'out'}.{r}", weights_only=False) for r in range(WORLD)]

    return results
