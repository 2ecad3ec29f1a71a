"""Evaluation CLI of the PyTorch/CUDA port (port of
musicgen_tpu/cli/evaluate.py): the reference's Test Accuracy and
test_classifier notebooks and its inference timing as commands
(scripts/Test Accuracy.ipynb, scripts/test_classifier.ipynb,
scripts/test_inference.ipynb; SURVEY.md §4).

  # per-field next-token accuracy of a generator checkpoint
  python -m musicgen_tpu_torch.cli.evaluate accuracy --model mamba --ckpt CKPT \
      --data data/np --metadata data/metadata.json [--batches 50]

  # classifier success rate over a corpus (real or generated)
  python -m musicgen_tpu_torch.cli.evaluate classifier --ckpt CKPT \
      --data output/mamba --metadata data/metadata.json --band-start 314

  # ms a forward of a (2, 2048) batch, and the peak device memory
  python -m musicgen_tpu_torch.cli.evaluate timing --model xlstm [--ckpt CKPT]

--ckpt takes a checkpoint directory (its `model.pth`, as `cli.train` and
`cli.train_classifier` write them) or a bare `.pth`; the model's config comes
from the weights' shapes, and its family must be --model's (the classifier's
for `classifier`). `timing` without --ckpt times the family's full-size
model initialised from seed 0. Every forward runs under no_grad on the card
(--device cuda, the default; it raises without one): a Transformer's
attention through kernel D, an xLSTM's or the classifier's sLSTM through
kernel H, a Mamba model through its plain forward (as the JAX package's
MambaLM.__call__). --device cpu runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from ..config import ClassifierConfig, TrainValues
from ..data.dataset import TokenDataset, full_batches, make_loaders
from ..eval.accuracy import evaluate_accuracy
from ..eval.classifier_eval import evaluate_success_rates
from ..eval.timing import device_memory_stats, time_forward
from ..interop import config_from_state_dict, family, load_checkpoint, load_model
from ..models.registry import KINDS, init_model, new_model
from .train import DEFAULT_CONFIGS, cli_device

# The batch `timing` times, (rows, tokens), as the JAX package's.
TIMING_SHAPE = (2, 2048)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluation harnesses (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("accuracy")
    pa.add_argument("--model", choices=list(KINDS), required=True)
    pa.add_argument("--ckpt", required=True, help="checkpoint directory, or a .pth")
    pa.add_argument("--data", required=True)
    pa.add_argument("--metadata", required=True)
    pa.add_argument("--batches", type=int, default=None,
                    help="subsample N random test batches; default is the reference protocol: one "
                         "deterministic full pass over the corpus (Test Accuracy.ipynb, "
                         "get_dataloader_full(shuffle=False))")
    pa.add_argument("--block-len", type=int, default=2048)
    pa.add_argument("--repeats", type=int, default=1,
                    help="random-crop passes over the corpus (random crops give a fresh last position per "
                         "pass; >1 thickens the per-field sample counts on small corpora)")
    pa.add_argument("--crop", choices=["random", "start", "end"], default="random",
                    help="per-file crop (reference ships random; end gives a fully deterministic pass)")
    pa.add_argument("--out", default=None)

    pc = sub.add_parser("classifier")
    pc.add_argument("--ckpt", required=True, help="checkpoint directory, or a classifier .pth")
    pc.add_argument("--data", required=True)
    pc.add_argument("--metadata", required=True)
    pc.add_argument("--band-start", type=int, required=True, help="first band token id (reference uses 314)")
    pc.add_argument("--batches", type=int, default=None,
                    help="subsample N random batches; default: one full deterministic pass "
                         "(test_classifier.ipynb protocol)")
    pc.add_argument("--out", default=None)

    pt = sub.add_parser("timing")
    pt.add_argument("--model", choices=list(KINDS), required=True)
    pt.add_argument("--ckpt", default=None, help="checkpoint directory, or a .pth (default: seed-0 weights)")
    pt.add_argument("--iters", type=int, default=100)
    pt.add_argument("--out", default=None)

    for sp in (pa, pc, pt):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    return p.parse_args(argv)


def load(kind: str, ckpt: str, device: torch.device):
    """The model of family `kind` held in `ckpt`, in eval() mode on `device`."""
    sd = load_checkpoint(ckpt)
    held = family(config_from_state_dict(sd))
    if held != kind:
        raise ValueError(f"--ckpt holds a {held} model, not a {kind}")
    return load_model(sd, device)


def _batches(ds: TokenDataset, block_len: int, n: Optional[int], passes: int):
    """One or `passes` deterministic full passes (n None), else n random
    test batches of the 80/20 split."""
    batch_size = TrainValues().batch_size
    if n is None:
        return (b for _ in range(max(passes, 1)) for b in full_batches(ds, batch_size))
    _, test_iter = make_loaders(ds, TrainValues(block_len=block_len))
    return (test_iter.sample_batch() for _ in range(n))


def _emit(result: dict, out: Optional[str]) -> None:
    print(json.dumps(result, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the CLI; returns what it prints."""
    args = parse_args(argv)
    device = cli_device(args.device)
    if args.cmd == "accuracy":
        model = load(args.model, args.ckpt, device)
        ds = TokenDataset.from_directory(args.data, args.metadata, block_len=args.block_len, crop=args.crop)
        result = evaluate_accuracy(model, _batches(ds, args.block_len, args.batches, args.repeats))
    elif args.cmd == "classifier":
        model = load("classifier", args.ckpt, device)
        block_len = ClassifierConfig().context_length
        ds = TokenDataset.from_directory(args.data, args.metadata, block_len=block_len)
        batches = ((b[0], b[2]) for b in _batches(ds, block_len, args.batches, 1))
        rates = evaluate_success_rates(model, batches, args.band_start)
        result = {"per_band": rates, "mean": float(np.mean(list(rates.values()))) if rates else float("nan")}
    else:
        if args.ckpt:
            model = load(args.model, args.ckpt, device)
        else:
            model = init_model(new_model(args.model, DEFAULT_CONFIGS[args.model](), device), args.model, 0).eval()
        rng = np.random.default_rng(0)
        src = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, TIMING_SHAPE), device=device)
        meta = torch.zeros(TIMING_SHAPE[0], 6, dtype=torch.int64, device=device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        result = time_forward(model, src, meta, iters=args.iters)
        result["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        result["memory"] = device_memory_stats(device)
    _emit(result, args.out)
    return result


if __name__ == "__main__":
    main()
