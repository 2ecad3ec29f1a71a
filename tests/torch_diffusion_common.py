"""Shared pieces of the port's diffusion tests (tests/test_torch_diffusion
*.py): the JAX package's tiny UNet configs, seeded numpy weights on every
tensor of a flax diffusion model (no init compiled), and the port's model
carrying them through interop.diffusion_state_dict. Not a test module: the
test files import it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from musicgen_tpu.diffusion import SpacedDiffusion as JaxSpaced
from musicgen_tpu.diffusion import VarType as JaxVarType
from musicgen_tpu.diffusion import unet as junet
from musicgen_tpu_torch.diffusion import SpacedDiffusion, VarType
from musicgen_tpu_torch.diffusion import unet as punet
from musicgen_tpu_torch.interop import diffusion_state_dict

# The gate runs the suite in several pytest-xdist workers on one host: torch
# on one intra-op thread a worker (tests/torch_families.py says why).
torch.set_num_threads(1)

# tests/test_diffusion.py `_tiny_model_and_diffusion`'s UNet, and a variant
# whose group norms hold more than one channel a group.
TINY = junet.UNetConfig(in_channels=2, model_channels=8, out_channels=4, num_res_blocks=1,
                        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)
WIDE = dataclasses.replace(TINY, model_channels=32, num_res_blocks=2)
# tests/test_diffusion.py `_tiny_model_and_diffusion`'s chain: ddim25 over 100 steps.
T, RESPACING = 100, "ddim25"
SHAPE = (2, 2, 16, 12)  # (B, C, pitches, columns): the columns not the pitches, so a transpose would show


def random_params(jm, *init_args, seed: int = 0):
    """Seeded numpy weights in the flax tree of `jm`: kernels N(0, 1/fan_in)
    (fan_in the product of all but the output axis), norm scales 1 + N(0,
    0.01), every other tensor (biases, the positional embedding) N(0, 0.01):
    no tensor zero, none the init's."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in init_args))

    def fill(path, leaf):
        name = path[-1].key
        if name in ("scale", "out_norm_scale"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) * np.prod(leaf.shape[:-1]) ** -0.5).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_config(cfg) -> punet.UNetConfig:
    return punet.UNetConfig(**dataclasses.asdict(cfg))


def inputs(shape=SHAPE, seed: int = 1):
    """(x, t): N(0, 1) canvases and timesteps in [0, 100)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.integers(0, 100, shape[0])


def unet_pair(cfg=TINY, seed: int = 0, shape=SHAPE, dtype=jnp.float32):
    """(JAX UNetModel, its params, the port's UNetModel on the same weights)."""
    jm = junet.UNetModel(cfg, dtype=dtype)
    x, t = inputs(shape)
    params = random_params(jm, x, t, seed=seed)
    pdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pm = punet.UNetModel(port_config(cfg), pdtype)
    pm.load_state_dict(diffusion_state_dict(params), strict=True)
    return jm, params, pm


def assert_close(got, want, rtol: float, what: str = "") -> float:
    """max |got - want| <= rtol * max |want|; returns that ratio."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ratio = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert ratio <= rtol, f"{what}: max abs error {ratio:.3e} of max |want| (tolerance {rtol})"
    return ratio


def diffusion_pair(var: str = "LEARNED_RANGE"):
    """(JAX SpacedDiffusion, the port's) over the tiny chain."""
    return (JaxSpaced.create(num_timesteps=T, timestep_respacing=RESPACING, var_type=JaxVarType[var]),
            SpacedDiffusion.create(num_timesteps=T, timestep_respacing=RESPACING, var_type=VarType[var]))

