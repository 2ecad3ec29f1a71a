"""The port's checkpoint-sanity gate (musicgen_tpu_torch/utils/ckpt_sanity.py)
held to the JAX package's (musicgen_tpu/utils/ckpt_sanity.py): the same
names, directories of `loss_*` checkpoints and training logs give the same
parsed losses, gates, selections and raises (type and message) on both
sides; the port's trainer names its crash saves `loss_inf_...`, which the
gate refuses and its pruner never keeps as the best."""
import json
import os
import time

import pytest
import torch

from musicgen_tpu.utils import ckpt_sanity as jsanity
from musicgen_tpu_torch.train import trainer as T
from musicgen_tpu_torch.utils import ckpt_sanity as sanity

NAMES = ["loss_inf_time_2026-08-20-06-31-36", "loss_0.00_time_2026-08-20-06-31-36",
         "loss_nan_time_2026-08-20-06-31-36", "loss_5.76_time_2026-08-20-06-01-05",
         "loss_0.01_time_2026-08-20-07-03-32", "loss_0.005_time_x", "loss_-1.00_time_x", "loss", "model.pth",
         "/a/b/loss_3.25_time_x", ""]


def _mk(dirpath, names):
    os.makedirs(dirpath, exist_ok=True)
    for i, n in enumerate(names):
        p = os.path.join(dirpath, n)
        os.makedirs(p)
        t = time.time() - (len(names) - i) * 60  # distinct mtimes in listing order, oldest first
        os.utime(p, (t, t))
    return str(dirpath)


def _outcome(fn, *args, **kw):
    """('ok', basename of the result) or (exception type, message)."""
    try:
        return "ok", os.path.basename(fn(*args, **kw))
    except (FileNotFoundError, RuntimeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", NAMES)
def test_name_gate_equal_jax(name):
    assert sanity.parsed_loss(name) == jsanity.parsed_loss(name)
    assert sanity.is_sane_checkpoint(name) == jsanity.is_sane_checkpoint(name)


def test_crash_sentinel_names_inf_not_zero():
    """The port's trainer names a save before the first evaluation, and one
    of a NaN loss, loss_inf: a parsed loss of inf, refused by the gate."""
    for loss in (float("inf"), float("nan")):
        name = T.checkpoint_name(loss)
        assert name.startswith("loss_inf_time_") and sanity.parsed_loss(name) == float("inf")
        assert not sanity.is_sane_checkpoint(name)


@pytest.mark.parametrize("names", [
    ["loss_6.17_time_a", "loss_5.65_time_b", "loss_0.00_time_c", "loss_inf_time_d"],
    ["loss_5.65_time_a", "loss_5.65_time_b", "loss_7.00_time_c"],
    ["loss_0.00_time_c"],
    ["loss_inf_time_a", "loss_nan_time_b", "other", "loss_x_time_c"],
    ["loss_4.00_time_a", "not_a_checkpoint", "loss_3.99_time_b"],
    [],
], ids=["best-sane", "tie", "only-sentinel", "only-garbage", "mixed", "empty"])
def test_select_equal_jax(tmp_path, names):
    d = _mk(tmp_path / "ckpt", names)
    got, want = _outcome(sanity.select_checkpoint, d), _outcome(jsanity.select_checkpoint, d)
    assert got == want
    assert _outcome(sanity.select_checkpoint, d, classifier=True) == want
    missing = str(tmp_path / "missing")
    got = _outcome(sanity.select_checkpoint, missing)
    assert got[0] == "FileNotFoundError" and got == _outcome(jsanity.select_checkpoint, missing)


@pytest.mark.parametrize("log", [
    [{"timestamp": "t", "message": "Training started!"}],
    [{"timestamp": "t", "message": "Training started!"}] + [{"Step": i, "Loss": "5.0000"} for i in range(1, 31)],
    [{"Step": i, "Loss": "5.0"} for i in range(19)] + ["Step", 3, {"step": 1}],
    [{"Step": i} for i in range(20)],
    None,  # a missing log is no failure (resumed runs relocate logs)
    "{not json",
], ids=["dead", "live", "19-steps", "20-steps", "missing", "corrupt"])
def test_log_gate_equal_jax(tmp_path, log):
    d = _mk(tmp_path / "ckpt", ["loss_5.65_time_b", "loss_6.00_time_a"])
    path = tmp_path / "training_log.json"
    if log is not None:
        path.write_text(log if isinstance(log, str) else json.dumps(log))
    assert sanity.count_log_steps(str(path)) == jsanity.count_log_steps(str(path))
    for min_steps in (20, 1):
        got = _outcome(sanity.select_checkpoint, d, log_path=str(path), min_steps=min_steps)
        assert got == _outcome(jsanity.select_checkpoint, d, log_path=str(path), min_steps=min_steps)


def test_pruner_never_retains_inf_as_best(tmp_path):
    """The port's save_checkpoint keeps the newest `keep` and the best by
    parsed loss (the gate's parsed_loss): a crash save's inf is pruned, and
    the gate then selects the best real save."""
    model = torch.nn.Linear(2, 2)
    state = T.TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    d = str(tmp_path / "ckpt")
    T.save_checkpoint(d, state, float("inf"), keep=2)
    for loss in (6.0, 5.5, 5.7):
        time.sleep(0.01)
        T.save_checkpoint(d, state, loss, keep=2)
    names = sorted(os.listdir(d))
    assert not any(n.startswith("loss_inf") for n in names), names
    assert os.path.basename(sanity.select_checkpoint(d)).startswith("loss_5.50")
