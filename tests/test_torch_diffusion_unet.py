"""The port's diffusion UNet (diffusion/unet.py UNetModel) against the JAX
package's flax UNetModel on the same random weights (every tensor seeded,
none zero: at flax's init the UNet outputs exactly 0), in f32 to 1e-5 of
the output's largest value: the tiny UNet of tests/test_diffusion.py with
learned and pooled resampling and with num_head_channels, and a wider one
(32-64 channels, two ResBlocks a level) whose group norms hold several
channels a group. Inputs are 16 x 12, so Downsample's one-sided "SAME"
padding and every transpose show. use_checkpoint gives the plain forward's
values and gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgen_tpu_torch.diffusion import unet as punet
from tests.torch_diffusion_common import TINY, WIDE, assert_close, inputs, port_config, unet_pair

CASES = {
    "tiny": TINY,
    "pooled_resample": dataclasses.replace(TINY, conv_resample=False),
    "head_channels": dataclasses.replace(TINY, num_head_channels=4),
    "wide": WIDE,
}


@pytest.mark.parametrize("case", list(CASES))
def test_unet_forward_matches_jax_f32(case):
    jm, params, pm = unet_pair(CASES[case])
    x, t = inputs()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, 1e-5, case)


def test_same_pad_is_xla_same():
    """Downsample's padding is XLA's "SAME" for a 3x3 stride-2 conv: 0 before
    and 1 after on an even size, 1 and 1 on an odd one."""
    assert punet.same_pad((16, 12)) == (0, 1, 0, 1)
    assert punet.same_pad((15, 7)) == (1, 1, 1, 1)
    assert punet.same_pad((2, 1)) == (1, 1, 0, 1)


def test_unet_checkpoint_matches_plain():
    """use_checkpoint (torch.utils.checkpoint on each ResBlock) gives the
    plain forward's values and every gradient, bit for bit."""
    plain = punet.UNetModel(port_config(WIDE))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p[0].numel() ** -0.5 if p.ndim > 1 else 0.1))
    remat = punet.UNetModel(port_config(dataclasses.replace(WIDE, use_checkpoint=True)))
    remat.load_state_dict(plain.state_dict())
    x, t = (torch.from_numpy(a) for a in inputs())
    outs, grads = [], []
    for model in (plain, remat):
        out = model(x, t)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
