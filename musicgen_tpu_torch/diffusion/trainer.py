"""Diffusion training loop.

Port of musicgen_tpu/diffusion/trainer.py (the reference never shipped one:
gaussian_diffusion.training_losses is referenced by respace.py:127-129 but
undefined): the UNet computes in its dtype (bf16 in cli.train_diffusion),
the loss in f32, Adam (torch.optim.Adam at its defaults, optax.adam's), and
EMA parameters (reference nn.py:71-81 update_ema) that start as a copy of
the parameters and follow them after every step.

A step's draws are data: `step(ema, x_start, t, noise)` takes the
timesteps and the forward process's noise, and `train_diffusion` draws
them from one `torch.Generator` seeded with `seed` (`draw_step`: t uniform
in [0, num_timesteps), then the noise), as the JAX step splits its key.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .respace import SpacedDiffusion

Params = Dict[str, torch.Tensor]


@torch.no_grad()
def update_ema(ema_params: Params, params: Params, rate: float = 0.9999) -> Params:
    """ema = rate * ema + (1 - rate) * params, in place, for every entry
    (reference diffusion/nn.py:71-81 `update_ema`)."""
    for name, e in ema_params.items():
        e.copy_(e * rate + params[name].to(e.dtype) * (1.0 - rate))
    return ema_params


def draw_step(x_start: torch.Tensor, num_timesteps: int, generator: torch.Generator):
    """A step's (t, noise): t uniform in [0, num_timesteps) a row, then the
    N(0, 1) noise of x_start's shape, both from `generator` on its device."""
    t = torch.randint(0, num_timesteps, (x_start.shape[0],), generator=generator, device=generator.device)
    noise = torch.randn(x_start.shape, generator=generator, device=generator.device, dtype=torch.float32)
    return t, noise


def make_diffusion_train_step(model: nn.Module, diffusion: SpacedDiffusion, optimizer: torch.optim.Optimizer,
                              ema_rate: float = 0.9999):
    """step(ema, x_start, t, noise) -> (loss, terms): one Adam step on the
    hybrid loss, then the EMA update of `ema` (a dict of the model's
    parameters by name)."""
    params = dict(model.named_parameters())

    def step(ema: Params, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
        terms = diffusion.training_losses(model, x_start, t, noise)
        optimizer.zero_grad(set_to_none=True)
        terms["loss"].backward()
        optimizer.step()
        update_ema(ema, params, ema_rate)
        return terms["loss"].detach(), {k: v.detach() for k, v in terms.items()}

    return step


def train_diffusion(
    model: nn.Module,
    diffusion: SpacedDiffusion,
    batches: Iterator[np.ndarray],
    num_steps: int,
    learning_rate: float = 1e-4,
    seed: int = 0,
    log_every: int = 10,
    params: Params | None = None,
    ema_rate: float = 0.9999,
    return_ema: bool = False,
):
    """Trains `model` (on its device; `params` loads other weights first)
    for num_steps steps on the numpy batches; returns its state dict, and
    the EMA's with return_ema."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    first = next(batches)
    if params is not None:
        model.load_state_dict(params)
    ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    step_fn = make_diffusion_train_step(model, diffusion, optimizer, ema_rate)

    batch = first
    for i in range(num_steps):
        x_start = torch.as_tensor(batch, dtype=torch.float32, device=device)
        loss, terms = step_fn(ema, x_start, *draw_step(x_start, diffusion.num_timesteps, generator))
        if (i + 1) % log_every == 0:
            print(
                f"diffusion step {i+1}: loss {float(loss):.5f} "
                f"(mse {float(terms['mse']):.5f}, vb {float(terms['vb']):.5f})",
                flush=True,
            )
        try:
            batch = next(batches)
        except StopIteration:
            break
    if return_ema:
        return model.state_dict(), ema
    return model.state_dict()
