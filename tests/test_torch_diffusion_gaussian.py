"""The port's Gaussian diffusion steps (diffusion/gaussian.py through
respace.SpacedDiffusion's timestep remap) against the JAX package's, in
f32 on the same inputs, timesteps and noise (JAX's draws handed to the
port): q_sample, q_posterior, undo and p_mean_variance (LEARNED_RANGE,
FIXED_SMALL and FIXED_LARGE) to 1e-6 of the largest value, on a smooth
model function written in both frameworks; FIXED_SMALL's training_losses;
update_ema. tests/test_torch_diffusion_train.py holds the losses and
gradients through the UNet."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu_torch.diffusion import trainer as ptrainer
from tests.torch_diffusion_common import assert_close, diffusion_pair


def _models(channels: int):
    """A smooth function of (x, t) with `channels` output channels, written
    in both frameworks (p_mean_variance's model)."""
    def jf(x, t):
        y = jnp.tanh(1.3 * x + 0.01 * t[:, None, None, None].astype(jnp.float32))
        return jnp.concatenate([y, jnp.sin(x)], axis=1)[:, :channels]

    def pf(x, t):
        y = torch.tanh(1.3 * x + 0.01 * t[:, None, None, None].to(torch.float32))
        return torch.cat([y, torch.sin(x)], dim=1)[:, :channels]

    return jf, pf


def test_q_sample_q_posterior_undo_equal():
    jd, pd = diffusion_pair("LEARNED_RANGE")
    rng = np.random.default_rng(0)
    x0, xt, noise = (rng.standard_normal((3, 2, 8, 8)).astype(np.float32) for _ in range(3))
    t = np.array([0, 11, 24])
    tt = torch.from_numpy(t)
    assert_close(pd.base.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)),
                 jd.base.q_sample(x0, jnp.asarray(t), noise), 1e-6, "q_sample")
    for got, want in zip(pd.base.q_posterior(torch.from_numpy(x0), torch.from_numpy(xt), tt),
                         jd.base.q_posterior(x0, xt, jnp.asarray(t))):
        assert_close(got.expand(want.shape), want, 1e-6, "q_posterior")
    assert_close(pd.base.undo(torch.from_numpy(xt), tt, torch.from_numpy(noise)),
                 jd.base.undo(xt, jnp.asarray(t), noise), 1e-6, "undo")


@pytest.mark.parametrize("var", ["LEARNED_RANGE", "FIXED_SMALL", "FIXED_LARGE"])
def test_p_mean_variance_equal(var):
    jd, pd = diffusion_pair(var)
    c = 2
    jf, pf = _models(2 * c if var == "LEARNED_RANGE" else c)
    x = np.random.default_rng(1).standard_normal((3, c, 8, 8)).astype(np.float32) * 2
    t = np.array([0, 7, 24])
    got = pd.p_mean_variance(pf, torch.from_numpy(x), torch.from_numpy(t))
    want = jd.p_mean_variance(jf, jnp.asarray(x), jnp.asarray(t))
    for name, g, w in zip(("mean", "var", "log_var", "pred_xstart"), got, want):
        assert_close(g.expand(w.shape), w, 1e-6, f"{var} {name}")


def test_fixed_small_training_losses_equal():
    jd, pd = diffusion_pair("FIXED_SMALL")
    jf, pf = _models(2)
    x = np.random.default_rng(4).uniform(-1, 1, (3, 2, 8, 8)).astype(np.float32)
    t, key = np.array([0, 5, 24]), jax.random.PRNGKey(6)
    want, noise = jax.jit(lambda: (jd.training_losses(jf, jnp.asarray(x), jnp.asarray(t), key),
                                   jax.random.normal(key, x.shape, jnp.float32)))()
    noise = np.array(noise)
    got = pd.training_losses(pf, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    assert float(got["vb"]) == float(want["vb"]) == 0.0
    assert abs(float(got["mse"]) - float(want["mse"])) <= 1e-5 * float(want["mse"])


def test_update_ema():
    ema = {"w": torch.ones(3), "b": torch.zeros(2)}
    out = ptrainer.update_ema(ema, {"w": torch.zeros(3), "b": torch.ones(2)}, rate=0.9)
    assert out is ema
    assert torch.allclose(ema["w"], torch.full((3,), 0.9)) and torch.allclose(ema["b"], torch.full((2,), 0.1))
