"""The pipeline tests' shared run and checks (tests/test_torch_parallel_pp_
*.py): pp_loss with its backward in a gloo group against the JAX package's
pp_loss and its gradients on a virtual CPU mesh of the same shape, from the
same seeded weights. Not a test module."""
from tests import torch_ddp_common as ddp
from tests import torch_jax_common as J
from tests import torch_parallel_common as P
from tests import torch_parallel_jax as PJ

# pp_loss's loss to 1e-5 relative; a gradient to 1e-4 of its tensor's
# largest value (the microbatch split and the sums over stages and
# replicas reorder f32 sums).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def pp_run(tmp, name: str, stages: int, data: int, batch: int, micro: tuple):
    """(the ranks' pp_rank results, JAX's {M: (loss, grads)}, the port's
    state dict) for family `name` at 2 layers a stage."""
    jm, cfg, params = PJ.family(name, n_layers=2 * stages)
    path = PJ.save_port(params, cfg, tmp / f"{name}.pth")
    ranks = ddp.start_ranks(P.pp_rank, stages * data, path, stages, batch, micro, str(tmp / "pp"))
    want = PJ.jax_pp(jm, params, cfg, stages, data, batch, micro)
    ddp.wait_ranks(ranks, timeout=60)
    return P.read_ranks(str(tmp / "pp"), stages * data), want, path


def check_pp(got: list, want: dict, m: int) -> None:
    """Every rank's loss and the stages' gradients for M = m."""
    loss, grads = want[m]
    for r in got:
        assert abs(r["results"][m][0] - loss) <= LOSS_RTOL * abs(loss), (r["results"][m][0], loss)
    merged = PJ.merged_grads(got, m)
    assert sorted(merged) == sorted(grads)
    J.assert_grads_close(merged, grads, GRAD_RTOL, f"M={m}")
