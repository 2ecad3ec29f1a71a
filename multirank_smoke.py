"""cli.train's multi-rank strategies, and data-parallel generation and
serving, over 4 ranks of one host, end to end:

    python3 multirank_smoke.py        # on a machine with 4 CUDA cards (NCCL)
    python3 multirank_smoke.py cpu    # a rehearsal: gloo ranks, tiny models
    python3 multirank_smoke.py dp     # the data-parallel runs alone (with cpu too)

`python -m torch.distributed.run --standalone --nproc_per_node 4 -m
musicgen_tpu_torch.cli.train` with --pp 4 (the Transformer, batch 4, M = 4),
--sp 4 (Mamba, --block-len 2042: a stream of 2,048), --parallel --tp 2 (the
Transformer on a (data 2, model 2) grid) and --parallel --tp 4
--loss-chunk 256 (Mamba), one epoch each on chip_smoke.py's synthesized
corpus from the seeded full-width models: each must exit 0 and leave one
checkpoint whose model.pth loads into the one-process model with a finite
forward. The rehearsal resumes the tiny models of tests/torch_cli_common.py
(its pipeline over 2 ranks: their 2 blocks do not split over 4). Prints a
line a run and ALL OK, or FAILED with the runs' output, and exits non-zero
on a failure. chip_smoke.py checks the strategies in a group of one; this
drive checks their NCCL collectives and send/recv across cards.

Then two runs of this file's own rank entry (`python3 multirank_smoke.py
rank generate|serve ...`) under `torch.distributed.run --nproc_per_node 4`
on the seeded full-width Mamba (the tiny one in the rehearsal), batch 8:
parallel/serving.generate_data_parallel of DP_TOKENS stochastic tokens
after a PROMPT-token prompt, and serve.BatchScheduler(mesh=) over 8 slots
of 8 seeded requests. Each must exit 0; rank 0 also runs the same batch in
one process, and the line prints how many of the 8 rows (requests) equal
it bit for bit (the card's prefill is not batch-invariant in its bits, so
a share of 2 rows may round a row otherwise: a count, not a check)."""
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RUN_TIMEOUT = 400  # seconds a torchrun may take (its ranks are killed after)
DP_ROWS = 8  # the batch (and the served requests) of the data-parallel runs
DP_TOKENS = 64
PROMPT = {"cpu": 64, "cuda": 2048}
SERVE_LENGTHS = (64, 40, 96, 32, 64, 48, 80, 56)


def runs(cpu: bool) -> dict:
    """{name: (model, number of ranks, cli.train flags)}."""
    if cpu:
        return {"pp4": ("transformer", 2, ["--pp", "2", "--batch-size", "4", "--pp-microbatches", "4"]),
                "sp4": ("mamba", 4, ["--sp", "4", "--block-len", "58"]),
                "tp2x2": ("transformer", 4, ["--parallel", "--tp", "2", "--batch-size", "4", "--block-len", "64"]),
                "tp4": ("mamba", 4, ["--parallel", "--tp", "4", "--loss-chunk", "256", "--block-len", "64"])}
    return {"pp4": ("transformer", 4, ["--pp", "4", "--batch-size", "4", "--pp-microbatches", "4"]),
            "sp4": ("mamba", 4, ["--sp", "4", "--block-len", "2042"]),
            "tp2x2": ("transformer", 4, ["--parallel", "--tp", "2", "--batch-size", "4"]),
            "tp4": ("mamba", 4, ["--parallel", "--tp", "4", "--loss-chunk", "256"])}


def check_checkpoint(torch, ckpt_dir: Path, device: str) -> str:
    """The run's one checkpoint loads into the one-process model; its
    forward on a seeded batch is finite."""
    from musicgen_tpu_torch.interop import load_model

    (saved,) = sorted(ckpt_dir.iterdir())
    sd = torch.load(saved / "model.pth", map_location="cpu", weights_only=True)
    model = load_model(sd, device)
    gen = torch.Generator().manual_seed(0)
    src = torch.randint(0, model.cfg.vocab_size, (1, 64), generator=gen).to(device)
    with torch.no_grad():
        finite = bool(torch.isfinite(model(src, torch.zeros(1, 6, dtype=torch.long, device=device))).all())
    if not finite:
        raise RuntimeError(f"{saved.name}/model.pth gives a non-finite forward")
    return f"{saved.name}/model.pth ({len(sd)} tensors) loads, its forward finite"


def rank_main(what: str, corpus: str, meta_path: str, out: str, device: str, ckpt: str = "") -> int:
    """One rank of a data-parallel run (`what`: generate or serve) in the
    group of the launcher's environment; rank 0 writes the result to `out`."""
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    from musicgen_tpu_torch.data.dataset import TokenDataset
    from musicgen_tpu_torch.interop import load_model
    from musicgen_tpu_torch.parallel import mesh, serving
    from musicgen_tpu_torch.sample.sampler import generate
    from musicgen_tpu_torch.serve import BatchScheduler
    from musicgen_tpu_torch.train import distributed

    rank, world, dev = distributed.init_from_env(device)
    try:
        torch.set_grad_enabled(False)
        if ckpt:
            model = load_model(torch.load(ckpt, map_location="cpu", weights_only=True), dev)
        else:
            from musicgen_tpu_torch.config import MambaConfig
            from musicgen_tpu_torch.models import mamba

            model = mamba.init_weights_(mamba.empty_model(MambaConfig(), dev), 0).eval()
        p = PROMPT[dev.type]
        ds = TokenDataset.from_directory(Path(corpus) / "Mozart", meta_path, block_len=p, seed=0)
        items = [ds[i % len(ds)] for i in range(DP_ROWS)]
        src = torch.from_numpy(np.stack([x for x, _, _ in items]).astype(np.int64)).to(dev)
        meta = torch.from_numpy(np.stack([m for _, _, m in items]).astype(np.int64)).to(dev)
        grid = mesh.make_grid()
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        t0 = time.perf_counter()
        if what == "generate":
            got = serving.generate_data_parallel(model, "mamba", src, meta, DP_TOKENS, p, gen(), grid)
            secs = time.perf_counter() - t0
            if rank == 0:
                want = generate(model, "mamba", src, meta, DP_TOKENS, p, gen())
                equal = int((got == want).all(dim=1).sum())
        else:
            reqs = [(src[i].cpu().numpy(), meta[i].cpu().numpy(), n, i) for i, n in enumerate(SERVE_LENGTHS)]

            def serve(grid_):
                sched = BatchScheduler(model, "mamba", prompt_len=p, slots=DP_ROWS, chunk=32, block_len=p,
                                       mesh=grid_)
                rids = [sched.submit(*r) for r in reqs]
                res = sched.run()
                return [res[rid] for rid in rids]

            got = serve(grid)
            secs = time.perf_counter() - t0
            if rank == 0:
                equal = sum(bool(np.array_equal(a, b)) for a, b in zip(got, serve(None)))
        if rank == 0:
            Path(out).write_text(json.dumps({"world": world, "equal": equal, "rows": DP_ROWS, "seconds": secs}))
    finally:
        dist.destroy_process_group()
    return 0


def dp_runs(root: Path, corpus: Path, meta: Path, device: str, ckpt: str, env: dict) -> list:
    """The data-parallel generation and serving runs over 4 ranks; the
    names of those that failed."""
    import json

    failed = []
    for what in ("generate", "serve"):
        name, out = f"dp_{what}", root / f"dp_{what}.json"
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                str(REPO / "multirank_smoke.py"), "rank", what, str(corpus), str(meta), str(out), device]
        argv += [ckpt] if ckpt else []
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode == 0 and out.exists():
            r = json.loads(out.read_text())
            print(f"[{name}] rc 0 in {secs:.1f} s (the launcher and 4 fresh processes included; the run itself "
                  f"{r['seconds']:.2f} s on rank 0): {r['equal']}/{r['rows']} "
                  f"{'rows' if what == 'generate' else 'requests'} bit for bit with rank 0's one-process run "
                  f"(batch {DP_ROWS}, {DP_TOKENS if what == 'generate' else 'mixed'} tokens, {r['world']} ranks)",
                  flush=True)
        else:
            print(f"[{name}] failed after {secs:.1f} s: rc {proc.returncode}\n{text[-6000:]}", flush=True)
            failed.append(name)
    return failed


def main(argv: list) -> int:
    if argv[:1] == ["rank"] and len(argv) in (6, 7):
        sys.path.insert(0, str(REPO))
        return rank_main(*argv[1:])
    cpu, dp_only = "cpu" in argv, "dp" in argv
    if len(set(argv)) != len(argv) or not set(argv) <= {"cpu", "dp"}:
        print("usage: python3 multirank_smoke.py [dp] [cpu]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs

    device = "cpu" if cpu else "cuda"
    if not cpu and torch.cuda.device_count() < 4:
        print("multirank_smoke: needs 4 CUDA cards (pass cpu to rehearse on gloo ranks)", file=sys.stderr)
        return 1
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, meta = cs.synth_corpus(root)
        if cpu:
            from tests.torch_cli_common import make_workdir

            (root / "w").mkdir()
            w = make_workdir(root / "w")
            tiny = {"mamba": w / "model.pth", "transformer": w / "transformer.pth"}
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        for name, (model, n, flags) in ({} if dp_only else runs(cpu)).items():
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n), "-m",
                    "musicgen_tpu_torch.cli.train", "--model", model, "--data", str(corpus), "--metadata",
                    str(meta), "--epochs", "1", "--device", device, "--ckpt-dir", str(root / name), "--log-json",
                    str(root / f"{name}.json"), *flags] + (["--resume", str(tiny[model])] if cpu else [])
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, start_new_session=True)
            try:
                out, _ = proc.communicate(timeout=RUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                out, _ = proc.communicate()
            secs = time.perf_counter() - t0
            lines = [ln for ln in out.splitlines() if ln.startswith(("Training started", "Epoch"))]
            try:
                if proc.returncode != 0:
                    raise RuntimeError(f"rc {proc.returncode}\n{out[-6000:]}")
                print(f"[{name}] rc 0 in {secs:.1f} s (the launcher and {n} fresh processes included); {lines}; "
                      f"{check_checkpoint(torch, root / name, device)}", flush=True)
            except (RuntimeError, ValueError) as e:
                print(f"[{name}] failed after {secs:.1f} s: {e}", flush=True)
                failed.append(name)
        failed += dp_runs(root, corpus, meta, device, str(tiny["mamba"]) if cpu else "", env)
    print("FAILED " + ", ".join(failed) if failed else "ALL OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
