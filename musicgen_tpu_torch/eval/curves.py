"""Training-curve tooling (reference: scripts/visualize_training.ipynb).

Port of musicgen_tpu/eval/curves.py. Parses the JSON step logs written by
train.trainer.JsonLogger (the reference's training_log_*.json schema:
{'Step', 'Loss'} entries interleaved with {'timestamp', 'message'} epoch
summaries) and produces summary statistics and optional matplotlib plots
(`plot` imports matplotlib inside the call and does nothing without it).

    python -m musicgen_tpu_torch.eval.curves LOG.json [...]
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional


def parse_log(path: str) -> Dict[str, list]:
    with open(path) as f:
        entries = json.load(f)
    steps, losses, val_losses, timestamps = [], [], [], []
    val_re = re.compile(r"Validation Loss: ([0-9.]+)")
    for e in entries:
        if "Step" in e:
            steps.append(int(e["Step"]))
            losses.append(float(e["Loss"]))
        elif "message" in e:
            m = val_re.search(e["message"])
            if m:
                val_losses.append(float(m.group(1)))
            if "timestamp" in e:
                timestamps.append(e["timestamp"])
    return {
        "steps": steps,
        "losses": losses,
        "val_losses": val_losses,
        "timestamps": timestamps,
    }


def summarize(path: str) -> Dict[str, float]:
    data = parse_log(path)
    out: Dict[str, float] = {}
    if data["steps"]:
        out["num_steps"] = data["steps"][-1]
        out["last_loss"] = data["losses"][-1]
        out["min_loss"] = min(data["losses"])
    if data["val_losses"]:
        out["last_val_loss"] = data["val_losses"][-1]
        out["best_val_loss"] = min(data["val_losses"])
    # Steps/sec from first/last timestamps when present (the reference's
    # throughput numbers are derived the same way).
    if len(data["timestamps"]) >= 2 and data["steps"]:
        from datetime import datetime

        def parse_ts(s):
            return datetime.fromisoformat(s)

        try:
            span = (
                parse_ts(data["timestamps"][-1]) - parse_ts(data["timestamps"][0])
            ).total_seconds()
            if span > 0:
                out["steps_per_sec"] = data["steps"][-1] / span
        except ValueError:
            pass
    return out


def plot(paths: List[str], out_path: Optional[str] = None):
    """Loss curves for one or more logs; no-op if matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    for path in paths:
        data = parse_log(path)
        label = path.split("/")[-1].replace("training_log_", "").replace(".json", "")
        ax.plot(data["steps"], data["losses"], label=label, alpha=0.8)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    ax.set_yscale("log")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
    return fig


if __name__ == "__main__":
    import sys

    for p in sys.argv[1:]:
        print(p, json.dumps(summarize(p), indent=2))
