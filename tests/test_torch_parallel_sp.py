"""Sequence-parallel Mamba training of the port (parallel/sp_train.py) in a
gloo group of 2 ranks against the JAX package's sp_loss and
make_sp_train_step on a 2-device 'sp' mesh of the suite's virtual CPU
devices, from the same seeded weights: a Mamba of 2 layers at width 32,
batch 2 x 26 tokens (a stream of 32, 16 a rank, SSD chunks of 8). The loss
to 1e-5 relative and its gradients (each rank's share backpropagated, summed
over the group) to 1e-4 of each tensor's largest value; 2 Adam steps with
the losses to 1e-5, the gradients to 1e-4 and the parameters to 1e-6
(tests/torch_jax_common.assert_steps_close); and the refusal of a stream
that does not split over the ranks."""
import pytest

from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_common as P
from tests import torch_parallel_jax as PJ

STEPS = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jm, cfg, params = PJ.family("mamba", n_layers=2)
    ranks = ddp.start_ranks(P.sp_rank, 2, PJ.save_port(params, cfg, tmp / "m.pth"), str(tmp / "sp"), STEPS)
    want = PJ.jax_sp(jm, params, cfg, 2, STEPS)
    ddp.wait_ranks(ranks, timeout=60)
    return P.read_ranks(str(tmp / "sp"), 2), want


def test_sp_loss_and_gradients_match_jax_mesh(run):
    got, (loss, grads, _) = run
    for r in got:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss), (r["loss"], loss)
        J.assert_grads_close(r["grads"], grads, 1e-4)


def test_sp_steps_match_jax_mesh(run):
    got, (_, _, steps) = run
    for r in got:
        J.assert_steps_close(r["steps"], steps, 1e-5, 1e-4)


def test_sp_refuses_a_stream_that_does_not_split(run):
    got, _ = run
    for r in got:
        assert "must divide the 'sp' axis size 2" in r["refused"]
