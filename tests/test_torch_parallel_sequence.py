"""The port's time-sharded SSD scan (parallel/sequence.py,
ssd_sequence_parallel) in gloo groups of 2 and 4 ranks against the JAX
package's ssd_sequence_parallel on a virtual CPU mesh of the same size, from
the same seeded numpy inputs (T = 128, chunks of 16): each rank's y and the
replicated final state to 1e-5 of the largest value, and the gradients of
x, dt, A, B and C of sum(y * wy) + sum(state * ws) to 1e-4 of each one's
largest value (each rank backpropagates its share, the state term on rank 0;
A's gradient summed over the group)."""
import numpy as np
import pytest
import torch

from tests import torch_ddp_common as ddp
from tests import torch_parallel_common as P
from tests import torch_parallel_jax as PJ

T_SCAN, CHUNK = 128, 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    inputs = PJ.scan_inputs(0, T_SCAN)
    np.savez(tmp / "inputs.npz", **inputs)
    started = {n: ddp.start_ranks(P.seq_rank, n, str(tmp / "inputs.npz"), CHUNK, str(tmp / f"seq{n}"))
               for n in (2, 4)}
    want = {n: PJ.jax_scan(inputs, n, CHUNK) for n in (2, 4)}
    got = {}
    for n, ctx in started.items():
        ddp.wait_ranks(ctx, timeout=60)
        got[n] = P.read_ranks(str(tmp / f"seq{n}"), n)
    return got, want


def close(got, want, rtol, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * float(np.abs(want).max()), f"{what}: {err} of {float(np.abs(want).max())}"


@pytest.mark.parametrize("n", [2, 4])
def test_scan_matches_jax_mesh(runs, n):
    got, want = runs
    ranks = got[n]
    close(torch.cat([r["y"] for r in ranks], dim=1), want[n]["y"], 1e-5, "y")
    for r in ranks:  # the final state, the same on every rank
        close(r["state"], want[n]["state"], 1e-5, "state")


@pytest.mark.parametrize("n", [2, 4])
def test_scan_gradients_match_jax_mesh(runs, n):
    got, want = runs
    ranks = got[n]
    for name in ("x", "dt", "B", "C"):
        close(torch.cat([r[name] for r in ranks], dim=1), want[n][name], 1e-4, name)
    for r in ranks:
        close(r["A"], want[n]["A"], 1e-4, "A")
