"""The port's diffusion UNet in bf16 (the CLIs' compute dtype: f32
parameters, bf16 convs, matmuls and activations, f32 norms and softmax)
against the JAX package's bf16 UNet on the same weights. As for the LMs'
bf16 tests (tests/torch_bf16_common.py), the tolerance is a multiple of a
gap measured on the same inputs, `ref`, the largest difference between
JAX's bf16 and f32 UNets: XLA's CPU backend keeps excess precision between
fused ops, so the port, which rounds where flax's dtype names, sits about
as far from JAX's bf16 as JAX's bf16 sits from f32. The port's bf16 output
may be at most K = 2 times `ref` from JAX's, and must stand at least half
of `ref` from the port's f32 output (a bf16 path that computed in f32 would
fail). Measured on this suite's CPU at seeds 0, 1, 2: port / ref 0.95-1.67,
and the port's bf16 from its f32 0.77-1.54 of ref."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.diffusion import unet as junet
from musicgen_tpu_torch.diffusion import unet as punet
from tests.torch_diffusion_common import TINY, WIDE, inputs, port_config, unet_pair

K = 2.0


@pytest.mark.parametrize("name,cfg", [("tiny", TINY), ("wide", WIDE)])
def test_unet_bf16_within_twice_the_jax_gap(name, cfg):
    jm32, params, pm32 = unet_pair(cfg)
    jm16 = junet.UNetModel(cfg, dtype=jnp.bfloat16)
    pm16 = punet.UNetModel(port_config(cfg), torch.bfloat16)
    pm16.load_state_dict(pm32.state_dict())
    assert all(p.dtype == torch.float32 for p in pm16.parameters())
    x, t = inputs()
    j32 = np.asarray(jax.jit(jm32.apply)(params, x, t), np.float64)
    j16 = jax.jit(jm16.apply)(params, x, t)
    assert j16.dtype == jnp.bfloat16
    j16 = np.asarray(j16.astype(jnp.float32), np.float64)
    with torch.no_grad():
        p16 = pm16(torch.from_numpy(x), torch.from_numpy(t))
        p32 = pm32(torch.from_numpy(x), torch.from_numpy(t)).double().numpy()
    assert p16.dtype == torch.bfloat16
    p16 = p16.double().numpy()
    ref = np.abs(j16 - j32).max()
    assert ref > 0
    assert np.abs(p16 - j16).max() <= K * ref, (name, np.abs(p16 - j16).max() / ref)
    assert np.abs(p16 - p32).max() >= 0.5 * ref, (name, np.abs(p16 - p32).max() / ref)
