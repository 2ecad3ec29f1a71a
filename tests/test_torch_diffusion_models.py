"""The port's SuperResModel and EncoderUNetModel (all four pools) against
the JAX package's on the same random weights (every tensor seeded), in f32
to 1e-5 of the output's largest value, on 16 x 12 inputs: SuperRes
upsamples an 8 x 6 low-res input bilinearly (jax.image.resize and
F.interpolate(align_corners=False) agree when upsampling), the encoder's
attention pool holds a positional embedding of (H * W + 1, C) at its
downsampled size, spatial_v2 group-norms the (B, 2048) features."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu.diffusion import unet as junet
from musicgen_tpu_torch.diffusion import unet as punet
from musicgen_tpu_torch.interop import diffusion_state_dict
from tests.torch_diffusion_common import SHAPE, TINY, assert_close, inputs, port_config, random_params


def test_superres_matches_jax_f32():
    jm = junet.SuperResModel(TINY, dtype=jnp.float32)
    x, t = inputs()
    low = np.random.default_rng(2).standard_normal((SHAPE[0], 2, 8, 6)).astype(np.float32)
    params = random_params(jm, x, t, low)
    want = np.asarray(jax.jit(jm.apply)(params, x, t, low))
    pm = punet.SuperResModel(port_config(TINY))
    pm.load_state_dict(diffusion_state_dict(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(low))
    assert got.shape == (SHAPE[0], 4, 16, 12)
    assert_close(got.numpy(), want, 1e-5, "superres")


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_matches_jax_f32(pool):
    cfg = dataclasses.replace(TINY, num_head_channels=4) if pool == "attention" else TINY
    jm = junet.EncoderUNetModel(cfg, num_classes=5, pool=pool, dtype=jnp.float32)
    x, t = inputs()
    params = random_params(jm, x, t, seed=3)
    want = np.asarray(jax.jit(jm.apply)(params, x, t))
    pm = punet.EncoderUNetModel(port_config(cfg), num_classes=5, pool=pool, input_size=SHAPE[2:])
    pm.load_state_dict(diffusion_state_dict(params), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (SHAPE[0], 5) and got.dtype == torch.float32
    assert_close(got.numpy(), want, 1e-5, pool)


def test_full_size_layout_matches_jax():
    """At the CLIs' size (DiffusionDefaults(image_size=128) on a (4, 128,
    128) canvas) the flax tree, through diffusion_state_dict, gives the
    port's state dict key for key and shape for shape: 95,004,680
    parameters (from eval_shape; nothing is computed)."""
    from musicgen_tpu.diffusion import DiffusionDefaults as JaxDefaults
    from musicgen_tpu.diffusion import create_model as jax_create_model
    from musicgen_tpu_torch.diffusion import DiffusionDefaults
    from musicgen_tpu_torch.diffusion.factories import unet_config

    shapes = jax.eval_shape(jax_create_model(JaxDefaults(image_size=128)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 128, 128)), jnp.zeros((1,), jnp.int32))
    want = diffusion_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    cfg = unet_config(DiffusionDefaults(image_size=128))
    assert cfg == port_config(jax_create_model(JaxDefaults(image_size=128)).cfg)
    got = punet.empty_model(punet.UNetModel, "meta", cfg, torch.bfloat16).state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in got)
    assert sum(v.numel() for v in got.values()) == 95_004_680
