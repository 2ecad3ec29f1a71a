"""Training loop of the port: torch.optim.Adam, the grammar-filtered CE,
checkpoint directories, JSON step logs in the reference's format.

Port of musicgen_tpu/train/trainer.py (reference train.py:140-217), single
device. The step is eager PyTorch: augmentation on the device, forward,
loss, backward, Adam. On the GPU a Transformer's attention runs kernel D with
its LSE output forward and kernel E backward (models/transformer.py); a
Mamba model and an xLSTM train through their plain scans, as the JAX package
does, and an xLSTM's validation forward, outside grad mode, runs kernel H.
The composer classifier trains with the same loop on its BCE
(`train_classifier`, reference train_classifier.py).

Checkpoints are directories named `loss_{val:.2f}_time_{ts}` (NaN written as
inf) holding `model.pth`, a state dict in the reference layout that
interop.load_checkpoint / cli.generate --ckpt read, and `optimizer.pth`, the
Adam state and the step. Saving prunes to the `keep` newest but never evicts
the lowest loss; a crash before the first validation saves as `loss_inf`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import shutil
from datetime import datetime
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..config import TrainValues
from ..data.augment import augment
from ..interop import MODEL_FILE
from ..utils.ckpt_sanity import parsed_loss as _parsed_loss
from .loss import chunked_filtered_cross_entropy, classifier_bce, filtered_cross_entropy

OPTIMIZER_FILE = "optimizer.pth"


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def prefetch_to_device(iterator: Iterable, device: torch.device | str, size: int = 2):
    """Wrap a host batch iterator so that the next batches' host-to-device
    copies are in flight while the current step runs: each batch goes
    through pinned host memory and a non_blocking copy, `size` batches
    ahead. Yields tuples of int64 device tensors."""
    device = torch.device(device)

    def put(batch):
        out = []
        for x in batch:
            t = torch.from_numpy(np.asarray(x, dtype=np.int64))
            out.append(t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device))
        return tuple(out)

    queue = collections.deque()
    for item in iterator:
        queue.append(put(item))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def make_optimizer(model: nn.Module, values: TrainValues = TrainValues()) -> torch.optim.Adam:
    """Adam at values.learning_rate, betas (0.9, 0.999), eps 1e-8 (reference
    train.py:146): its bias-corrected update is optax.adam's."""
    return torch.optim.Adam(model.parameters(), lr=values.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def lm_head(model: nn.Module) -> nn.Linear:
    """The vocabulary projection: a TransformerLM's lm_head, a MambaLM's or
    an XLSTMLM's output_layer."""
    return model.lm_head if hasattr(model, "lm_head") else model.output_layer


def make_lm_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    augmentation: bool = False,
    loss_chunk: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """Returns step(src, trg, meta) -> loss (a 0-dim tensor on the device).

    The model runs in train() mode (dropout on), under grad mode whatever
    the caller's. augmentation transforms src (not trg, as the JAX step)
    with draws from `generator`. loss_chunk > 0 takes the chunked grammar-CE
    from the final hidden states: the same loss and gradients, without the
    (B, T, V) logits."""
    if augmentation and generator is None:
        raise ValueError("augmentation needs a torch.Generator")

    def loss_fn(src, trg, meta):
        if loss_chunk:
            head = lm_head(model)
            return chunked_filtered_cross_entropy(src, model.hidden(src, meta), head.weight, head.bias, trg,
                                                  chunk=loss_chunk)
        return filtered_cross_entropy(src, model(src, meta), trg)

    @torch.enable_grad()
    def step(src, trg, meta):
        model.train()
        if augmentation:
            src = augment(src, generator)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(src, trg, meta)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_lm_eval_step(model: nn.Module) -> Callable:
    """Returns step(src, trg, meta) -> loss, in eval() mode under no_grad."""

    @torch.no_grad()
    def step(src, trg, meta):
        was_training = model.training
        model.eval()
        loss = filtered_cross_entropy(src, model(src, meta), trg)
        model.train(was_training)
        return loss

    return step


def make_classifier_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns step(src, meta) -> loss: one Adam step on classifier_bce of
    model(src) against meta's multi-hot targets (musicgen_tpu/train/
    trainer.py make_classifier_train_step), under grad mode whatever the
    caller's, so the sLSTM runs its plain, differentiable scan."""

    @torch.enable_grad()
    def step(src, meta):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = classifier_bce(model(src), meta)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_classifier_eval_step(model: nn.Module) -> Callable:
    """Returns step(src, meta) -> classifier_bce, in eval() mode under
    no_grad (kernel H on the card)."""

    @torch.no_grad()
    def step(src, meta):
        was_training = model.training
        model.eval()
        loss = classifier_bce(model(src), meta)
        model.train(was_training)
        return loss

    return step


# ---------------------------------------------------------------------------
# Checkpoints (reference naming loss_{val:.2f}_time_{ts})
# ---------------------------------------------------------------------------


def checkpoint_name(loss: float) -> str:
    now = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    if math.isnan(loss):
        loss = float("inf")  # a NaN tag would confuse best-by-loss parsing
    return f"loss_{loss:.2f}_time_{now}"


def save_checkpoint(directory: str, state: TrainState, loss: float, keep: int = 3,
                    model_state: Optional[dict] = None, optimizer_state: Optional[dict] = None) -> str:
    """Save the weights, the Adam state and the step; prune to the newest
    `keep` checkpoints, always retaining the best-by-loss one (keep <= 0
    disables pruning). `model_state` / `optimizer_state` replace the
    state's own dicts (a sharded model's, gathered to the one-process
    layout: parallel/). Returns the checkpoint directory."""
    path = os.path.abspath(os.path.join(directory, checkpoint_name(loss)))
    os.makedirs(path, exist_ok=True)
    torch.save(state.model.state_dict() if model_state is None else model_state, os.path.join(path, MODEL_FILE))
    torch.save({"optimizer": state.optimizer.state_dict() if optimizer_state is None else optimizer_state,
                "step": state.step}, os.path.join(path, OPTIMIZER_FILE))
    if keep > 0:
        entries = sorted((os.path.join(directory, d) for d in os.listdir(directory) if d.startswith("loss_")),
                         key=os.path.getmtime)
        best = min(entries, key=_parsed_loss) if entries else None
        for old in entries[:-keep]:
            if os.path.abspath(old) != os.path.abspath(best):
                shutil.rmtree(old, ignore_errors=True)
    return path


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint directory into `state` (weights, and the Adam
    state and step where the directory holds them), as the JAX trainer's
    load_checkpoint restores a whole TrainState. `cli.train --resume` does
    not call it: like the JAX CLI it keeps the weights only."""
    device = next(state.model.parameters()).device
    state.model.load_state_dict(torch.load(os.path.join(path, MODEL_FILE), map_location=device, weights_only=True))
    opt = os.path.join(path, OPTIMIZER_FILE)
    if os.path.exists(opt):
        saved = torch.load(opt, map_location=device, weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
    return state


# ---------------------------------------------------------------------------
# JSON step logging (reference format, train.py:148-217)
# ---------------------------------------------------------------------------


class JsonLogger:
    """Prints and keeps the log entries; `enabled=False` (a data-parallel
    rank other than 0) does neither."""

    def __init__(self, path: Optional[str], enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self.entries = []

    def message(self, msg: str) -> None:
        if self.enabled:
            self.entries.append({"timestamp": str(datetime.now()), "message": msg})
            print(msg, flush=True)

    def step(self, step: int, loss: float) -> None:
        if self.enabled:
            self.entries.append({"Step": step, "Loss": f"{loss:.4f}"})
            print(f"Step: {step}, Loss: {loss:.4f}", flush=True)

    def flush(self) -> None:
        if self.enabled and self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(self.entries, f, indent=2)


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


def train_lm(
    state: TrainState,
    train_iter: Iterable,
    test_iter: Iterable,
    values: TrainValues = TrainValues(),
    ckpt_dir: str = "checkpoints/model",
    log_path: Optional[str] = None,
    num_epochs: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    loss_chunk: int = 0,
) -> TrainState:
    """Single-device training of a generator (reference train.py:140-217)
    on the grammar-filtered CE: `run_epochs` with the LM steps."""
    train_step = make_lm_train_step(state.model, state.optimizer, values.augmentation, loss_chunk, generator)
    return run_epochs(state, train_step, make_lm_eval_step(state.model), train_iter, test_iter, values, ckpt_dir,
                      log_path, num_epochs)


def train_classifier(
    state: TrainState,
    train_iter: Iterable,
    test_iter: Iterable,
    values: TrainValues = TrainValues(),
    ckpt_dir: str = "checkpoints/classifier",
    log_path: Optional[str] = None,
    num_epochs: Optional[int] = None,
) -> TrainState:
    """Single-device training of the composer classifier on classifier_bce
    (musicgen_tpu/cli/train_classifier.py's loop): `run_epochs` with the
    classifier steps, which read src and meta of each (src, trg, meta)."""
    train_step = make_classifier_train_step(state.model, state.optimizer)
    eval_step = make_classifier_eval_step(state.model)
    return run_epochs(state, lambda src, trg, meta: train_step(src, meta),
                      lambda src, trg, meta: eval_step(src, meta), train_iter, test_iter, values, ckpt_dir,
                      log_path, num_epochs)


def run_epochs(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_iter: Iterable,
    test_iter: Iterable,
    values: TrainValues,
    ckpt_dir: str,
    log_path: Optional[str],
    num_epochs: Optional[int] = None,
    started: str = "Training started!",
    main: bool = True,
    save: Optional[Callable[[float], None]] = None,
) -> TrainState:
    """The epoch loop: train_step(src, trg, meta) -> loss over train_iter,
    validation with eval_step over test_iter each epoch, a checkpoint and a
    log flush every save_interval epochs, and a final save on interrupt or
    error.

    Losses stay on the device until the epoch summary; only the
    eval_interval log line reads one back. `main=False` (a data-parallel
    rank other than 0) runs the same steps and validation but logs and
    saves nothing. `save(loss)`, where given, replaces the checkpoint write
    and runs on every rank (a sharded model gathers its state there, and
    its main rank writes it)."""
    device = next(state.model.parameters()).device

    def checkpoint_now(loss: float) -> None:
        if save is not None:
            save(loss)
        elif main:
            save_checkpoint(ckpt_dir, state, loss)
    logger = JsonLogger(log_path, enabled=main)
    epochs = num_epochs if num_epochs is not None else values.epochs
    logger.message(started)
    # No honest loss exists before the first validation: a crash before it
    # saves as `loss_inf` (never kept as best), not `loss_0.00`.
    avg_val_loss = float("inf")
    try:
        for epoch in range(epochs):
            losses = []
            for src, trg, meta in prefetch_to_device(train_iter, device):
                loss = train_step(src, trg, meta)
                state.step += 1
                losses.append(loss)
                if state.step % values.eval_interval == 0:
                    logger.step(state.step, float(loss))
            total = float(torch.stack(losses).sum()) if losses else 0.0
            logger.message(f"Epoch [{epoch+1}/{epochs}], Average Loss: {total / max(len(losses), 1):.4f}")

            val_losses = [eval_step(src, trg, meta) for src, trg, meta in prefetch_to_device(test_iter, device)]
            val_total = float(torch.stack(val_losses).sum()) if val_losses else 0.0
            avg_val_loss = val_total / max(len(val_losses), 1)
            logger.message(f"Epoch [{epoch+1}/{epochs}], Validation Loss: {avg_val_loss:.4f}")

            if (epoch + 1) % values.save_interval == 0:
                checkpoint_now(avg_val_loss)
                logger.flush()
    except KeyboardInterrupt:
        logger.message("Interrupted!")
    finally:
        checkpoint_now(avg_val_loss)
        logger.flush()
    return state
