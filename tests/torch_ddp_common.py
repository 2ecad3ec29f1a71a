"""Shared pieces of the port's data-parallel tests (tests/test_torch_
distributed*.py): starting gloo ranks with torch.multiprocessing under a
time limit, and the rank functions they run. Imports no JAX, so that a
spawned rank starts on torch alone. Not a test module: the test files
import it."""
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from musicgen_tpu_torch.interop import load_model
from musicgen_tpu_torch.train import distributed
from musicgen_tpu_torch.train import trainer as T

torch.set_num_threads(1)  # several xdist workers and their ranks share the host's cores

B, L, STEPS = 4, 16, 2  # a global batch of 4 rows, 2 a rank at world size 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def set_rank_env(rank: int, world: int, port: int) -> None:
    """The environment a launcher (torchrun) gives rank `rank`."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


def start_ranks(fn, world: int, *args):
    """fn(rank, world, port, *args) in `world` spawned processes, not yet
    joined: the caller may work while they run, then calls wait_ranks."""
    return mp.start_processes(fn, args=(world, free_port(), *args), nprocs=world, join=False, start_method="spawn")


def wait_ranks(ctx, timeout: float = 60.0) -> None:
    """Joins start_ranks' processes; raises if a rank failed or they outlive
    `timeout` seconds from now (they are killed)."""
    try:
        for _ in range(int(timeout * 10)):
            if ctx.join(timeout=0.1):
                return
        raise TimeoutError(f"the ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def batch(seed: int, kind: str, vocab: int, meta_vocab: int):
    """A seeded global batch (src, trg, meta) of B rows."""
    rng = np.random.default_rng(seed)
    src, trg = rng.integers(0, vocab, (B, L)), rng.integers(0, vocab, (B, L))
    return src, trg, rng.integers(0, meta_vocab, (B, 6))


def ddp_steps(sd, kind: str, loss_chunk: int, meta_vocab: int):
    """STEPS steps of distributed.make_distributed_train_step in the group
    this process belongs to, from state dict `sd`, on the global batches of
    seeds 10, 11, ...: (losses, [grads a step], params)."""
    model = load_model(sd, "cpu")
    optimizer, step = distributed.build_distributed_training(model, kind=kind, loss_chunk=loss_chunk)
    losses, grads = [], []
    for i in range(STEPS):
        src, trg, meta = (torch.from_numpy(x) for x in batch(10 + i, kind, model.cfg.vocab_size, meta_vocab))
        losses.append(float(step(src, trg, meta)))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    return losses, grads, {n: p.detach().clone() for n, p in model.named_parameters()}


def ddp_rank(rank: int, world: int, port: int, cases, out: str) -> None:
    """Rank function: ddp_steps for each (name, state dict path, kind,
    loss_chunk, meta_vocab) case; rank 0 saves {name: result} to `out`."""
    set_rank_env(rank, world, port)
    dist.init_process_group("gloo", init_method="env://")
    try:
        results = {name: ddp_steps(torch.load(path, weights_only=True), kind, chunk, meta_vocab)
                   for name, path, kind, chunk, meta_vocab in cases}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(results, out)


def one_rank(cases):
    """ddp_steps for each case of ddp_rank in a 1-rank gloo group of this
    process, on the whole global batches: {name: result}."""
    set_rank_env(0, 1, free_port())
    dist.init_process_group("gloo", init_method="env://")
    try:
        return {name: ddp_steps(torch.load(path, weights_only=True), kind, chunk, meta_vocab)
                for name, path, kind, chunk, meta_vocab in cases}
    finally:
        dist.destroy_process_group()


def cli_rank(rank: int, world: int, port: int, runs, ports, out: str = "") -> None:
    """Rank function: cli.train.main(argv) for each argv of `runs` in turn,
    each in the group of a launcher's environment on its own port of
    `ports` (the first run on `port`). With `out`, saves {run index: this
    rank's final model state dict} to `{out}.{rank}`."""
    from musicgen_tpu_torch.cli import train as train_cli

    held = {}
    for i, (argv, p) in enumerate(zip(runs, [port, *ports])):
        set_rank_env(rank, world, p)
        state = train_cli.main(argv)
        assert not dist.is_initialized(), "cli.train destroys its process group"
        assert state.step > 0
        held[i] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    if out:
        torch.save(held, f"{out}.{rank}")


def parallel_cli_runs(root, families: dict) -> tuple:
    """cli.train --parallel --device cpu for each family of `families`
    ({model: extra argv}) under two spawned gloo ranks, one epoch each from
    the small models and corpus of tests/torch_cli_common.py, under `root`:
    (workdir, root). The xLSTM names its log with --log-json, the alias
    torchrun does not take for a prefix of its own options."""
    from tests.torch_cli_common import BLOCK, make_train_corpus, make_workdir

    (root / "work").mkdir()
    (root / "train").mkdir()
    workdir = make_workdir(root / "work")
    corpus = make_train_corpus(workdir, root / "train")
    runs = []
    for model, extra in families.items():
        ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
        runs.append(["--model", model, "--data", str(corpus), "--metadata", str(workdir / "metadata.json"),
                     "--block-len", str(BLOCK), "--device", "cpu", "--ckpt-dir", str(root / model / "ckpt"),
                     "--log-json" if model == "xlstm" else "--log", str(root / model / "log.json"),
                     "--resume", str(workdir / ckpt), "--epochs", "1", "--parallel", *extra])
    wait_ranks(start_ranks(cli_rank, 2, runs, [free_port() for _ in runs[1:]]), timeout=90)
    return workdir, root


def check_parallel_run(workdir, root, model: str, out) -> None:
    """What parallel_cli_runs left for `model`: one checkpoint whose keys
    carry no DDP 'module.' prefix and are the resumed .pth's, all f32; rank
    0's log, its first line the mesh's; cli.generate --device cpu reads the
    checkpoint back (into `out`)."""
    from musicgen_tpu_torch.cli import generate as cli
    from tests.torch_cli_common import argv, check_streams

    (saved,) = sorted((root / model / "ckpt").iterdir())
    sd = torch.load(saved / "model.pth", weights_only=True)
    assert not any(k.startswith("module.") for k in sd)
    ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
    assert sorted(sd) == sorted(torch.load(workdir / ckpt, weights_only=True))
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    log = json.loads((root / model / "log.json").read_text())
    messages = [e["message"] for e in log if "message" in e]
    assert messages[0] == "Training started! mesh={'data': 2, 'model': 1}"
    assert sum("Validation" in m for m in messages) == 1
    check_streams(cli.main(argv(workdir, out, "--greedy", "--ckpt", str(saved / "model.pth"), model=model)), out,
                  model)
