"""Data augmentation as tensor transforms on the device, in PyTorch.

Port of musicgen_tpu/data/augment.py (reference processing/dataset.py:18-39,
137-165): the token-range transforms run on the whole (B, T) batch inside the
train step, with one draw of each amount per step from an explicit
torch.Generator (jax.random keys in the JAX package):

  * pitch shift in [-12, 12] preserving the instrument channel (div/mod 128)
  * velocity shift in [-20, 20]
  * time / length / tempo multiplied by one shared factor in {0.5, ..., 4.0}
"""
from __future__ import annotations

import torch

from ..config import VOCAB, VocabLayout


def shift_range(seq, amount, lower: int, upper: int):
    """Add `amount` to tokens in [lower, upper), clamped (dataset.py:18-22)."""
    mask = (seq >= lower) & (seq < upper)
    return torch.where(mask, torch.clamp(seq + amount, lower, upper - 1), seq)


def shift_pitch_preserving_channel(seq, amount, layout: VocabLayout = VOCAB):
    """Pitch shift inside the combined pitch+channel field (dataset.py:24-33)."""
    d = layout.disc
    lower = layout.pitch_start
    upper = layout.pitch_start + d.pitch * d.channel - 1
    mask = (seq >= lower) & (seq < upper)
    shifted = (seq // d.pitch) * d.pitch + torch.clamp(seq % d.pitch + amount, 0, d.pitch - 1)
    return torch.where(mask, shifted, seq)


def multiply_range(seq, factor, lower: int, upper: int):
    """Multiply (token - lower) by factor, clamped (dataset.py:35-39); the
    product is truncated toward zero, as jnp's astype."""
    mask = (seq >= lower) & (seq < upper)
    scaled = torch.clamp(((seq - lower).to(torch.float32) * factor).to(seq.dtype) + lower, lower, upper - 1)
    return torch.where(mask, scaled, seq)


def augment(seq: torch.Tensor, generator: torch.Generator, layout: VocabLayout = VOCAB) -> torch.Tensor:
    """Full augmentation pipeline (dataset.py:137-165). seq: (..., T) ints.
    The amounts are drawn on the generator's device, with the bounds of
    jax.random.randint: [-12, 13), [-20, 21) and [1, 9) / 2."""
    d = layout.disc

    def draw(lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, (), generator=generator, device=generator.device)

    pitch_shift, vel_shift = draw(-12, 13), draw(-20, 21)
    factor = draw(1, 9).to(torch.float32) / 2.0
    seq = shift_pitch_preserving_channel(seq, pitch_shift.to(seq.device), layout)
    seq = shift_range(seq, vel_shift.to(seq.device), layout.dyn_start, layout.dyn_start + d.dyn - 1)
    factor = factor.to(seq.device)
    for start, size in ((layout.time_start, d.time), (layout.length_start, d.length), (layout.tempo_start, d.tempo)):
        seq = multiply_range(seq, factor, start, start + size - 1)
    return seq
