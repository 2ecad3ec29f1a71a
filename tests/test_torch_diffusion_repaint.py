"""A whole RePaint trajectory of the port (SpacedDiffusion.p_sample_loop
with a ground truth, a keep mask and a jump schedule: jump length 3, 2
samples, over the ddim25 chain of 100 steps, as tests/test_diffusion.py's
test_p_sample_loop_scan_matches_python_loop) against the JAX package's
p_sample_loop_scan, on the tiny UNet with random weights. JAX's draws,
taken in the order its keys split (the initial x; each denoising step the
ground truth's noise, then the step's; each renoising step one draw), are
replayed into the port's noise source, so the two trajectories see the
same numbers: the final canvases agree to 1e-4 of their largest value
(measured: 1.6e-6 of it on this suite's CPU). The port's default source, a
torch.Generator, gives the same trajectory for the same seed."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu_torch.diffusion import RePaintConf
from tests.torch_diffusion_common import TINY, assert_close, diffusion_pair, unet_pair

SHAPE = (1, 2, 16, 16)


def jax_draws(key, times, shape):
    """The N(0, 1) draws of JAX's p_sample_loop_scan from `key` with a ground
    truth, in the order they are used."""
    normal = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32))
    key, init = jax.random.split(key)
    draws = [normal(init)]
    for t_last, t_cur in zip(times[:-1], times[1:]):
        key, step = jax.random.split(key)
        if t_cur < t_last:
            rest, gt_key = jax.random.split(step)
            _, step_key = jax.random.split(rest)
            draws += [normal(gt_key), normal(step_key)]
        else:
            draws.append(normal(step))
    return [np.array(d) for d in draws]


def test_repaint_jump_trajectory_matches_jax():
    jd, pd = diffusion_pair()
    jm, params, pm = unet_pair(TINY, seed=4, shape=SHAPE)
    times = RePaintConf(schedule_jump_params=dict(t_T=pd.num_timesteps, n_sample=1, jump_length=3,
                                                  jump_n_sample=2)).jump_times()
    assert sum(b > a for a, b in zip(times[:-1], times[1:])) > 0
    gt = np.tanh(np.random.default_rng(2).standard_normal(SHAPE)).astype(np.float32)
    keep = np.ones(SHAPE, np.float32)
    keep[..., 8:] = 0.0
    key = jax.random.PRNGKey(3)

    @jax.jit
    def run(params, gt, keep, key):
        return jd.p_sample_loop_scan(lambda x, t: jm.apply(params, x, t), SHAPE, key, gt=gt, gt_keep_mask=keep,
                                     times=times)

    want = np.asarray(run(params, gt, keep, key))
    draws = iter(jax_draws(key, times, SHAPE))

    def replay(shape):
        assert tuple(shape) == SHAPE
        return torch.from_numpy(next(draws))

    calls = []

    def model(x, t):
        calls.append(int(t[0]))
        return pm(x, t)

    with torch.no_grad():
        got = pd.p_sample_loop_scan(model, SHAPE, gt=torch.from_numpy(gt), gt_keep_mask=torch.from_numpy(keep),
                                    times=times, noise=replay)
    assert next(draws, None) is None  # every draw used, none missing
    assert len(calls) == sum(b < a for a, b in zip(times[:-1], times[1:]))
    assert set(calls) <= set(pd.timestep_map.tolist())  # the model saw the original timesteps
    assert np.isfinite(got.numpy()).all()
    assert_close(got.numpy(), want, 1e-4, "trajectory")

    with torch.no_grad():
        a, b = (pd.p_sample_loop(pm, SHAPE, torch.Generator().manual_seed(9), gt=torch.from_numpy(gt),
                                 gt_keep_mask=torch.from_numpy(keep), times=times) for _ in range(2))
    assert torch.equal(a, b)
