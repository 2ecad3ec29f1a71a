"""Factories and default configs of the diffusion workload.

Port of musicgen_tpu/diffusion/factories.py (the reference's
diffusion/script_util.py:27-306 create_model_and_diffusion / create_model /
create_classifier / create_gaussian_diffusion) with the RePaint `conf`
interface the reference consumes but does not ship (conf.pget,
conf.schedule_jump_params). The models are built on `device` with their
weights drawn from `seed` (unet.init_weights_: flax's initializers), bf16
compute by default, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .gaussian import MeanType, VarType
from .respace import SpacedDiffusion
from .schedule import get_schedule_jump
from .unet import EncoderUNetModel, UNetConfig, UNetModel, channel_mult_for_size, empty_model, init_weights_


@dataclasses.dataclass(frozen=True)
class RePaintConf:
    """The RePaint config object whose interface the reference consumes at
    gaussian_diffusion.py:350,492,502 and respace.py:99-116 but never
    defines. Reconstructed from those call sites."""

    inpa_inj_sched_prev: bool = True
    inpa_inj_sched_prev_cumnoise: bool = False
    schedule_jump_params: dict = dataclasses.field(
        default_factory=lambda: dict(t_T=250, n_sample=1, jump_length=10, jump_n_sample=10)
    )

    def pget(self, key: str, default=None):
        return getattr(self, key, default)

    def jump_times(self):
        return get_schedule_jump(**self.schedule_jump_params)


@dataclasses.dataclass(frozen=True)
class DiffusionDefaults:
    """reference script_util.py:27-87 defaults, canvas-adapted."""

    image_size: int = 128  # pitch axis of the canvas
    in_channels: int = 4
    num_channels: int = 128
    num_res_blocks: int = 2
    num_heads: int = 4
    attention_resolutions: str = "16,8"
    dropout: float = 0.0
    learn_sigma: bool = True
    diffusion_steps: int = 1000
    noise_schedule: str = "linear"
    timestep_respacing: str = ""
    use_scale_shift_norm: bool = True


def unet_config(defaults: DiffusionDefaults = DiffusionDefaults()) -> UNetConfig:
    """The UNet of `defaults` (create_model's; the JAX factories build it
    inline)."""
    return UNetConfig(
        in_channels=defaults.in_channels,
        model_channels=defaults.num_channels,
        out_channels=defaults.in_channels * (2 if defaults.learn_sigma else 1),
        num_res_blocks=defaults.num_res_blocks,
        attention_resolutions=tuple(defaults.image_size // int(res)
                                    for res in defaults.attention_resolutions.split(",")),
        dropout=defaults.dropout,
        channel_mult=channel_mult_for_size(defaults.image_size),
        num_heads=defaults.num_heads,
    )


def create_model(defaults: DiffusionDefaults = DiffusionDefaults(), dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", seed: int = 0) -> UNetModel:
    return init_weights_(empty_model(UNetModel, device, unet_config(defaults), dtype), seed)


def create_gaussian_diffusion(defaults: DiffusionDefaults = DiffusionDefaults()) -> SpacedDiffusion:
    return SpacedDiffusion.create(
        schedule_name=defaults.noise_schedule,
        num_timesteps=defaults.diffusion_steps,
        timestep_respacing=defaults.timestep_respacing,
        mean_type=MeanType.EPSILON,
        var_type=VarType.LEARNED_RANGE if defaults.learn_sigma else VarType.FIXED_SMALL,
    )


def create_model_and_diffusion(defaults: DiffusionDefaults = DiffusionDefaults(),
                               dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda",
                               seed: int = 0) -> Tuple[UNetModel, SpacedDiffusion]:
    return create_model(defaults, dtype, device, seed), create_gaussian_diffusion(defaults)


def create_classifier(defaults: DiffusionDefaults = DiffusionDefaults(), num_classes: int = 1000,
                      dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda",
                      seed: int = 0) -> EncoderUNetModel:
    cfg = dataclasses.replace(unet_config(defaults), out_channels=defaults.in_channels, dropout=0.0)
    return init_weights_(empty_model(EncoderUNetModel, device, cfg, num_classes=num_classes, dtype=dtype), seed)
