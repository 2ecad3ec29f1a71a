"""Rank functions of the port's multi-rank strategy tests
(tests/test_torch_parallel_*.py), run in gloo groups spawned by
tests/torch_ddp_common.start_ranks: the time-sharded SSD scan, sequence-
parallel Mamba, the GPipe pipeline and the vocabulary-parallel step; and
the CLI runs of the strategies. Each
rank saves what it holds to `{out}.{rank}`; `read_ranks` loads them. Imports
no JAX, so that a spawned rank starts on torch alone. Not a test module."""
import numpy as np
import torch
import torch.distributed as dist

from musicgen_tpu_torch.config import MeshConfig
from musicgen_tpu_torch.interop import load_model
from musicgen_tpu_torch.parallel import mesh, pipeline, sequence, sp_train
from musicgen_tpu_torch.train import distributed
from tests import torch_ddp_common as ddp

T = 26  # + NUM_META = 32, the stream of the SP and PP tests
SP_CHUNK = 8


def lm_batch(seed: int, b: int, meta_vocab: int, t: int = T):
    """A seeded (src, trg, meta) batch of b rows of t tokens, int64 numpy."""
    rng = np.random.default_rng(seed)
    v = 17914
    return rng.integers(0, v, (b, t)), rng.integers(0, v, (b, t)), rng.integers(0, meta_vocab, (b, 6))


def _join(rank: int, world: int, port: int) -> None:
    ddp.set_rank_env(rank, world, port)
    dist.init_process_group("gloo", init_method="env://")


def read_ranks(out: str, world: int) -> list:
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def seq_rank(rank: int, world: int, port: int, path: str, chunk: int, out: str) -> None:
    """ssd_sequence_parallel on this rank's time slice of the inputs saved
    at `path` (numpy x, dt, A, B, C, wy, ws, np.savez; a spawned rank's
    arguments go through a pipe that its start-up drains, so large ones
    would start the ranks one after another): its y, the final state and
    the gradients of its share of sum(y * wy) + sum(state * ws) (the state
    term on rank 0 only), A's summed over the group."""
    _join(rank, world, port)
    try:
        inputs = dict(np.load(path))
        t = inputs["x"].shape[1] // world
        part = slice(rank * t, (rank + 1) * t)
        loc = {k: torch.from_numpy(inputs[k][:, part]).requires_grad_() for k in ("x", "dt", "B", "C")}
        A = torch.from_numpy(inputs["A"]).requires_grad_()
        y, s = sequence.ssd_sequence_parallel(loc["x"], loc["dt"], A, loc["B"], loc["C"], chunk=chunk)
        loss = torch.sum(y * torch.from_numpy(inputs["wy"][:, part]))
        if rank == 0:
            loss = loss + torch.sum(s * torch.from_numpy(inputs["ws"]))
        loss.backward()
        mesh.sum_gradients([A])
        torch.save({"y": y.detach(), "state": s.detach(), "A": A.grad,
                    **{k: v.grad for k, v in loc.items()}}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def sp_rank(rank: int, world: int, port: int, sd_path: str, out: str, steps: int) -> None:
    """Sequence-parallel Mamba from the state dict at sd_path on lm_batch(0,
    2, 9): the summed loss and its gradients (summed over the group), then
    `steps` Adam steps of make_sp_train_step on lm_batch(1 + i, 2, 9) with
    their losses and the parameters after; and whether a stream that does
    not split raises."""
    _join(rank, world, port)
    try:
        src, trg, meta = (torch.from_numpy(a) for a in lm_batch(0, 2, 9))
        model = load_model(torch.load(sd_path, weights_only=True), "cpu")
        share = sp_train.sp_loss(model, src, trg, meta, chunk=SP_CHUNK)
        share.backward()
        mesh.sum_gradients(model.parameters())
        loss = sp_train.sp_loss_value(model, src, trg, meta, chunk=SP_CHUNK)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        try:
            sp_train.sp_loss(model, src[:, :-1], trg[:, :-1], meta)
            refused = ""
        except ValueError as e:
            refused = str(e)
        model = load_model(torch.load(sd_path, weights_only=True), "cpu")
        from musicgen_tpu_torch.train.trainer import make_optimizer

        step = sp_train.make_sp_train_step(model, make_optimizer(model), chunk=SP_CHUNK)
        losses, step_grads = [], []
        for i in range(steps):
            losses.append(float(step(*(torch.from_numpy(a) for a in lm_batch(1 + i, 2, 9)))))
            step_grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.save({"loss": float(loss), "grads": grads, "refused": refused,
                    "steps": (losses, step_grads, params)}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def pp_rank(rank: int, world: int, port: int, sd_path: str, stages: int, batch: int, micro: tuple,
            out: str) -> None:
    """pp_loss with backward on lm_batch(0, batch, 9) for each microbatch
    count of `micro`, on a (world // stages, stages) grid from the state dict
    at sd_path: {M: (loss, this stage's gradients summed over its data
    group)}, and the stage's state dict."""
    _join(rank, world, port)
    try:
        grid = pipeline.make_pipe_grid(stages, world // stages)
        src, trg, meta = (torch.from_numpy(a) for a in lm_batch(0, batch, 9))
        results = {}
        for m in micro:
            stage = pipeline.PipelineStage(load_model(torch.load(sd_path, weights_only=True), "cpu"), stages,
                                           grid.index)
            stage.eval()
            with torch.enable_grad():
                loss = pipeline.pp_loss(stage, src, trg, meta, grid, m, backward=True)
            if grid.data > 1:
                mesh.sum_gradients(stage.parameters(), grid.data_group)
            results[m] = (float(loss), {n: p.grad.clone() for n, p in stage.named_parameters()})
        torch.save({"results": results, "state": stage.state_dict()}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def tp_rank(rank: int, world: int, port: int, sd_path: str, tp: int, kind: str, loss_chunk: int,
            meta_vocab: int, out: str) -> None:
    """ddp.STEPS steps of the distributed step on a (world // tp, tp) grid
    from the state dict at sd_path, on the global batches of ddp.batch:
    (losses, the gathered gradients a step, the gathered parameters), and
    this rank's own vocabulary shards."""
    _join(rank, world, port)
    try:
        model = load_model(torch.load(sd_path, weights_only=True), "cpu")
        grid = mesh.make_grid(MeshConfig(model=tp))
        _, step = distributed.build_distributed_training(model, kind=kind, loss_chunk=loss_chunk, grid=grid)
        losses, grads = [], []
        for i in range(ddp.STEPS):
            src, trg, meta = (torch.from_numpy(x) for x in ddp.batch(10 + i, kind, model.cfg.vocab_size, meta_vocab))
            losses.append(float(step(src, trg, meta)))
            grads.append(mesh.gather_vocab(model, {n: p.grad.clone() for n, p in model.named_parameters()}))
        params = mesh.gather_vocab(model, {n: p.detach().clone() for n, p in model.named_parameters()})
        shards = {n: p.detach().clone() for n, p in model.named_parameters() if p.shape[0] != params[n].shape[0]}
        torch.save({"steps": (losses, grads, params), "shards": shards}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def strategy_cli_runs(root, runs: dict) -> tuple:
    """cli.train --device cpu with each {name: (model, extra argv)} of
    `runs` under two spawned gloo ranks, one epoch each from the small
    models and corpus of tests/torch_cli_common.py, under `root`:
    (workdir, the ranks' torch_ddp_common.cli_rank results)."""
    from tests.torch_cli_common import BLOCK, make_train_corpus, make_workdir

    (root / "work").mkdir()
    (root / "train").mkdir()
    workdir = make_workdir(root / "work")
    corpus = make_train_corpus(workdir, root / "train")
    argvs = []
    for name, (model, extra) in runs.items():
        ckpt = "model.pth" if model == "mamba" else f"{model}.pth"
        argvs.append(["--model", model, "--data", str(corpus), "--metadata", str(workdir / "metadata.json"),
                      "--block-len", str(BLOCK), "--device", "cpu", "--ckpt-dir", str(root / name / "ckpt"),
                      "--log-json", str(root / name / "log.json"), "--resume", str(workdir / ckpt), "--epochs",
                      "1", *extra])
    ddp.wait_ranks(ddp.start_ranks(ddp.cli_rank, 2, argvs, [ddp.free_port() for _ in argvs[1:]], str(root / "held")),
                   timeout=90)
    return workdir, read_ranks(str(root / "held"), 2)


def saved_checkpoint(root, name: str) -> dict:
    """The one checkpoint directory's model.pth of run `name`, and its
    log's messages."""
    import json

    (saved,) = sorted((root / name / "ckpt").iterdir())
    log = json.loads((root / name / "log.json").read_text())
    return torch.load(saved / "model.pth", weights_only=True), [e["message"] for e in log if "message" in e]
