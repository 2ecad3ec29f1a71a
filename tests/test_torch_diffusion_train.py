"""The port's diffusion training (diffusion/gaussian.py training_losses,
trainer.py) through the tiny UNet of tests/test_diffusion.py on random
weights, against the JAX package's on the same batch, t and noise (the
draws of JAX's train step): training_losses' terms to 1e-5 relative and
every gradient to 1e-5 of its tensor's largest entry; one Adam step with
the EMA update against optax.adam and trainer.update_ema; ten steps on one
batch from the factory's init, where the loss falls (the port's form of
tests/test_diffusion.py's test_diffusion_training_step_decreases_loss)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from musicgen_tpu.diffusion import trainer as jtrainer
from musicgen_tpu_torch.diffusion import trainer as ptrainer
from musicgen_tpu_torch.diffusion import unet as punet
from musicgen_tpu_torch.interop import diffusion_state_dict
from tests.torch_diffusion_common import TINY, assert_close, diffusion_pair, inputs, port_config, unet_pair


@pytest.fixture(scope="module")
def jax_step():
    """JAX's training_losses and gradients of the tiny UNet's random weights
    on one batch at seeded timesteps, with the noise training_losses draws
    from its key (one compile, shared by the tests below)."""
    jd, _ = diffusion_pair("LEARNED_RANGE")
    jm, params, _ = unet_pair(TINY)
    x = np.tanh(inputs()[0])
    t = np.random.default_rng(5).integers(0, jd.num_timesteps, x.shape[0])
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        terms = jd.training_losses(lambda xx, tt: jm.apply(p, xx, tt), jnp.asarray(x), jnp.asarray(t), key)
        return terms["loss"], (terms, jax.random.normal(key, x.shape, jnp.float32))

    # LLVM at optimisation level 0 compiles this in a third of the time (the
    # gradients differ from the optimised build's by rounding only).
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    (_, (terms, noise)), grads = step(params)
    return dict(params=params, x=x, t=t, noise=np.array(noise), terms={k: float(v) for k, v in terms.items()},
                grads=jax.tree.map(np.asarray, grads))


def _port_model(params):
    _, pd = diffusion_pair("LEARNED_RANGE")
    pm = punet.UNetModel(port_config(TINY))
    pm.load_state_dict(diffusion_state_dict(params), strict=True)
    return pd, pm


def test_training_losses_and_gradients_equal(jax_step):
    """The terms to 1e-5 relative; each gradient to 1e-5 of its tensor's
    largest entry, where that is above 1e-6 of the largest gradient (below
    it the gradient is 0 but for rounding, in both)."""
    pd, pm = _port_model(jax_step["params"])
    got = pd.training_losses(pm, *(torch.from_numpy(jax_step[k]) for k in ("x", "t", "noise")))
    got["loss"].backward()
    want = jax_step["terms"]
    for k in ("mse", "vb", "loss"):
        assert abs(float(got[k].detach()) - want[k]) <= 1e-5 * abs(want[k]), (k, float(got[k].detach()), want[k])
    assert want["vb"] > 0
    wg = diffusion_state_dict(jax_step["grads"])
    largest = max(float(g.abs().max()) for g in wg.values())
    zero = 0
    for name, p in pm.named_parameters():
        if float(wg[name].abs().max()) <= 1e-6 * largest:
            # A bias that a group norm of one-channel groups cancels (conv_in
            # of a ResBlock; conv_out and skip before the next norm): its
            # gradient is 0, rounding noise in both frameworks.
            assert float(p.grad.abs().max()) <= 1e-6 * largest, name
            zero += 1
            continue
        assert_close(p.grad.numpy(), wg[name].numpy(), 1e-5, f"grad {name}")
    assert zero < len(wg) // 4, zero


def test_adam_ema_step_matches_optax(jax_step):
    """One step of make_diffusion_train_step (Adam at lr 1e-3, EMA rate 0.5)
    against JAX's step on the same gradients (optax.adam's update and
    trainer.update_ema, as make_diffusion_train_step composes them): the
    parameters and the EMA to 1e-6 absolute, leaving out the elements whose
    gradient is below 1e-6 (Adam's first step moves each element by
    lr * g / (|g| + eps), which turns f32 order noise in such a g into a
    change of up to lr)."""
    params = jax_step["params"]
    opt = optax.adam(1e-3)

    def jax_update(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        new = optax.apply_updates(params, updates)
        return new, jtrainer.update_ema(params, new, rate=0.5)

    jp, jema = jax.jit(jax_update).lower(params, jax_step["grads"]).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params, jax_step["grads"])
    want_p, want_ema = (diffusion_state_dict(jax.tree.map(np.asarray, tree)) for tree in (jp, jema))
    small = {k: v.abs() < 1e-6 for k, v in diffusion_state_dict(jax_step["grads"]).items()}

    pd, pm = _port_model(params)
    ema = {n: p.detach().clone() for n, p in pm.named_parameters()}
    step = ptrainer.make_diffusion_train_step(pm, pd, torch.optim.Adam(pm.parameters(), lr=1e-3), ema_rate=0.5)
    loss, terms = step(ema, *(torch.from_numpy(jax_step[k]) for k in ("x", "t", "noise")))
    assert abs(float(loss) - jax_step["terms"]["loss"]) <= 1e-5 * jax_step["terms"]["loss"]
    moved = 0
    for name, p in pm.named_parameters():
        keep = ~(small[name] | (p.grad.abs() < 1e-6))
        for got, want in ((p.detach(), want_p[name]), (ema[name], want_ema[name])):
            if bool(keep.any()):
                assert float((got - want)[keep].abs().max()) <= 1e-6, name
        assert bool(torch.isfinite(p).all() and torch.isfinite(ema[name]).all()), name
        moved += int(keep.sum())
    assert moved > 0.9 * sum(p.numel() for p in pm.parameters())


def test_training_step_decreases_loss():
    """The port's form of test_diffusion_training_step_decreases_loss: ten
    Adam steps (lr 1e-3, EMA rate 0.5) on one batch and one draw, from the
    factory's init (flax's initializers: the output exactly 0)."""
    _, pd = diffusion_pair("LEARNED_RANGE")
    pm = punet.init_weights_(punet.UNetModel(port_config(TINY)), 0)
    with torch.no_grad():
        assert pm(torch.zeros(1, 2, 16, 16), torch.zeros(1, dtype=torch.long)).abs().max() == 0
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((4, 2, 16, 16)) * 0.5).astype(np.float32))
    t, noise = ptrainer.draw_step(x, pd.num_timesteps, torch.Generator().manual_seed(1))
    ema = {n: p.detach().clone() for n, p in pm.named_parameters()}
    step = ptrainer.make_diffusion_train_step(pm, pd, torch.optim.Adam(pm.parameters(), lr=1e-3), ema_rate=0.5)
    losses = [float(step(ema, x, t, noise)[0]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert sum(float((p.detach() - ema[n]).abs().sum()) for n, p in pm.named_parameters()) > 0


def test_training_step_decreases_loss():
    """Ten Adam steps (lr 1e-3, EMA rate 0.5) on one batch and one draw,
    from unet.init_weights_ (flax's initializers: the output exactly 0)."""
    _, pd = diffusion_pair("LEARNED_RANGE")
    pm = punet.init_weights_(punet.UNetModel(port_config(TINY)), 0)
    with torch.no_grad():
        assert pm(torch.zeros(1, 2, 16, 16), torch.zeros(1, dtype=torch.long)).abs().max() == 0
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((4, 2, 16, 16)) * 0.5).astype(np.float32))
    t, noise = ptrainer.draw_step(x, pd.num_timesteps, torch.Generator().manual_seed(1))
    ema = {n: p.detach().clone() for n, p in pm.named_parameters()}
    step = ptrainer.make_diffusion_train_step(pm, pd, torch.optim.Adam(pm.parameters(), lr=1e-3), ema_rate=0.5)
    losses = [float(step(ema, x, t, noise)[0]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert sum(float((p.detach() - ema[n]).abs().sum()) for n, p in pm.named_parameters()) > 0
