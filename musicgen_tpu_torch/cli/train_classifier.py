"""Composer-classifier training CLI of the PyTorch/CUDA port (reference
train_classifier.py; port of musicgen_tpu/cli/train_classifier.py, single
device): multi-label BCE over each sample's metadata-token set, on an xLSTM
trunk of width 512.

  python -m musicgen_tpu_torch.cli.train_classifier --data data/np \
      --metadata data/metadata.json [--distribution data_distribution.json]

The full-size ClassifierConfig is built and initialised from --seed.
--distribution reads explicit train and test file lists (`{"train": [...],
"test": [...]}`, reference train_classifier.py:52-57); otherwise the corpus
under --data is split 80/20. Samples are the config's context_length
tokens. Training runs on the GPU (--device cuda, the default; it raises
without one) through the plain sLSTM scan, its validation forward through
kernel H; --device cpu runs the plain versions. Each run ends with a
checkpoint directory in --ckpt-dir holding `model.pth`, which
`cli.evaluate classifier --ckpt` reads.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import ClassifierConfig, TrainValues
from ..data.dataset import BatchIterator, TokenDataset, make_loaders
from ..models.registry import init_model, new_model
from ..train import trainer as T
from .train import cli_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the composer classifier (PyTorch/CUDA)")
    p.add_argument("--data", required=True, help=".npy token corpus root")
    p.add_argument("--metadata", required=True, help="metadata.json path")
    p.add_argument("--distribution", default=None,
                   help="data_distribution.json with explicit train/test file lists "
                        "(reference train_classifier.py:52-57)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu (the plain versions)")
    return p.parse_args(argv)


def check_meta_vocab(datasets, metadata_vocab_size: int) -> None:
    """Every meta token of the corpus must index the classifier's logits:
    make_meta_multihot drops an id outside them (as the JAX package's
    one_hot does), so a tokenization larger than metadata_vocab_size would
    train on silently missing targets."""
    top = max(int(v.max()) for ds in datasets for v in ds.band_vectors.values())
    if top >= metadata_vocab_size:
        raise ValueError(f"the metadata tokenization reaches id {top}, beyond the classifier's "
                         f"metadata_vocab_size {metadata_vocab_size}")


def main(argv: Optional[List[str]] = None) -> T.TrainState:
    """Runs the CLI; returns the final TrainState."""
    args = parse_args(argv)
    device = cli_device(args.device)
    torch.manual_seed(args.seed)
    model = init_model(new_model("classifier", ClassifierConfig(), device), "classifier", args.seed)
    block_len = model.cfg.context_length
    defaults = TrainValues()
    values = TrainValues(batch_size=args.batch_size or defaults.batch_size, epochs=args.epochs or defaults.epochs,
                         block_len=block_len)
    if args.distribution:
        with open(args.distribution) as f:
            dist = json.load(f)
        train_ds = TokenDataset.from_file_list(dist["train"], args.metadata, block_len=block_len, seed=args.seed)
        test_ds = TokenDataset.from_file_list(dist["test"], args.metadata, block_len=block_len, seed=args.seed + 1)
        datasets = (train_ds, test_ds)
        train_iter = BatchIterator(train_ds, np.arange(len(train_ds)), values.batch_size, args.seed)
        test_iter = BatchIterator(test_ds, np.arange(len(test_ds)), values.batch_size, args.seed + 1)
    else:
        dataset = TokenDataset.from_directory(args.data, args.metadata, block_len=block_len, seed=args.seed)
        datasets = (dataset,)
        train_iter, test_iter = make_loaders(dataset, values, seed=args.seed)
    check_meta_vocab(datasets, model.cfg.metadata_vocab_size)

    state = T.TrainState(model, T.make_optimizer(model, values))
    return T.train_classifier(
        state, train_iter, test_iter, values,
        ckpt_dir=args.ckpt_dir or os.path.join("checkpoints", "classifier"),
        log_path=args.log or os.path.join("logs", "training_log_classifier.json"),
    )


if __name__ == "__main__":
    main()
