"""Checkpoint sanity gating for evaluation harnesses (port of
musicgen_tpu/utils/ckpt_sanity.py, standard library only).

The trainer names each checkpoint directory `loss_{val:.2f}_time_{ts}`
(train/trainer.checkpoint_name) and writes `loss_inf_...` when it saves
before its first evaluation or after a NaN loss. A harness that loads a
trained checkpoint goes through this module instead of taking the newest
directory by mtime:

  * name gate  — the loss tag parsed from the name must be finite and
    nonzero (a validation loss of 0.00 on a 17,914-way vocabulary is not
    reachable by training: it marks a crash-time save; inf and nan mark the
    trainer's own sentinels).
  * log gate   — when the producing run's JSON training log is available
    (the reference {'Step', 'Loss'} schema, train.py:148-217), the run must
    hold >= min_steps real optimizer steps. A log with only "Training
    started!" means the run died before learning anything.

select_checkpoint() returns the best (lowest parsed loss) sane checkpoint,
the reference's pick-best-validation protocol (train.py:69-77).
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional


def parsed_loss(path: str) -> float:
    """Loss tag from a reference-format checkpoint dir name (inf if unparseable)."""
    try:
        v = float(os.path.basename(path).split("_")[1])
        return float("inf") if math.isnan(v) else v
    except (IndexError, ValueError):
        return float("inf")


def is_sane_checkpoint(path: str) -> bool:
    """Name gate: finite, nonzero parsed loss."""
    v = parsed_loss(path)
    return math.isfinite(v) and v > 0.005  # loss_0.00 rounds from < 0.005


def count_log_steps(log_path: str) -> int:
    """Number of real optimizer-step entries in a reference-schema JSON log."""
    try:
        with open(log_path) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return 0
    return sum(1 for e in entries if isinstance(e, dict) and "Step" in e)


def select_checkpoint(
    ckpt_dir: str,
    log_path: Optional[str] = None,
    min_steps: int = 20,
    classifier: bool = False,
) -> str:
    """Best sane checkpoint in `ckpt_dir`, or raise with a diagnostic.

    `classifier` is the JAX function's knob for a looser classifier policy;
    it changes nothing (a BCE classifier reaches about 0.01, which rounds to
    0.01, never 0.00, so the name gate holds for it too).
    """
    entries = sorted(
        (
            os.path.join(ckpt_dir, d)
            for d in os.listdir(ckpt_dir)
            if d.startswith("loss_")
        ),
        key=os.path.getmtime,
    )
    if not entries:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    sane = [p for p in entries if is_sane_checkpoint(p)]
    if not sane:
        raise RuntimeError(
            f"all {len(entries)} checkpoints under {ckpt_dir} fail the "
            f"sanity name gate (crash-save sentinels?): "
            f"{[os.path.basename(p) for p in entries]}"
        )
    if log_path is not None and os.path.exists(log_path):
        steps = count_log_steps(log_path)
        if steps < min_steps:
            raise RuntimeError(
                f"training log {log_path} records only {steps} optimizer "
                f"steps (< {min_steps}); refusing to evaluate checkpoints "
                f"from a run that died before training ({ckpt_dir})"
            )
    # Lowest parsed loss; ties broken by recency (entries are mtime-sorted).
    return min(sane, key=parsed_loss)
