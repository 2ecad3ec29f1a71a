"""cli.train's multi-rank strategies over 4 ranks of one host, end to end:

    python3 multirank_smoke.py        # on a machine with 4 CUDA cards (NCCL)
    python3 multirank_smoke.py cpu    # a rehearsal: gloo ranks, tiny models

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
drive checks their NCCL collectives and send/recv across cards."""
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RUN_TIMEOUT = 400  # seconds a torchrun may take (its ranks are killed after)


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


def main(argv: list) -> int:
    cpu = argv == ["cpu"]
    if argv not in ([], ["cpu"]):
        print("usage: python3 multirank_smoke.py [cpu]", file=sys.stderr)
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
        for name, (model, n, flags) in runs(cpu).items():
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
    print("FAILED " + ", ".join(failed) if failed else "ALL OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
