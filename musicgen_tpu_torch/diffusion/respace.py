"""Timestep respacing (DDIM-style stride / section-count subsampling).

Port of musicgen_tpu/diffusion/respace.py (the reference's
diffusion/respace.py:23-79 `space_timesteps`, :82-174
`SpacedDiffusion`/`_WrappedModel`): a subset of the training timesteps is
kept, the betas are re-derived so that the subsampled chain has the same
marginals, and the model is called with the original training timestep of
each spaced index. `space_timesteps` and the re-derived betas are numpy,
copied from the JAX module and held equal to it by
tests/test_torch_diffusion_numpy.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Set

import numpy as np
import torch

from .gaussian import DiffusionSchedule, GaussianDiffusion, MeanType, VarType


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """Select timesteps: "ddimN" for DDIM striding, else per-section counts
    (reference respace.py:23-79)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur))
            cur += stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class SpacedDiffusion:
    """A GaussianDiffusion over a subsampled timestep chain."""

    base: GaussianDiffusion
    use_timesteps: frozenset

    @classmethod
    def create(
        cls,
        schedule_name: str = "linear",
        num_timesteps: int = 1000,
        timestep_respacing="",
        mean_type: MeanType = MeanType.EPSILON,
        var_type: VarType = VarType.LEARNED_RANGE,
    ) -> "SpacedDiffusion":
        """Factory matching reference script_util.create_gaussian_diffusion
        (script_util.py:258-306)."""
        if not timestep_respacing:
            timestep_respacing = [num_timesteps]
        base_sched = DiffusionSchedule.named(schedule_name, num_timesteps)
        use = space_timesteps(num_timesteps, timestep_respacing)

        # Re-derive betas over the kept steps (respace.py:95-113).
        alphas_cumprod = base_sched.alphas_cumprod
        last_alpha = 1.0
        new_betas, timestep_map = [], []
        for i, a in enumerate(alphas_cumprod):
            if i in use:
                new_betas.append(1.0 - a / last_alpha)
                last_alpha = a
                timestep_map.append(i)
        spaced = DiffusionSchedule(np.asarray(new_betas))
        diff = GaussianDiffusion(spaced, mean_type, var_type)
        obj = cls(base=diff, use_timesteps=frozenset(use))
        object.__setattr__(obj, "_timestep_map", np.asarray(timestep_map, np.int32))
        return obj

    @property
    def timestep_map(self) -> np.ndarray:
        return self._timestep_map

    @property
    def num_timesteps(self) -> int:
        return self.base.schedule.num_timesteps

    def wrap_model(self, model_fn):
        """Remap spaced timestep indices to original training timesteps
        before calling the model (reference respace.py:150-174)."""
        tmap = torch.as_tensor(self.timestep_map, dtype=torch.long)

        def wrapped(x, t):
            return model_fn(x, tmap.to(t.device)[t])

        return wrapped

    # Delegation with model wrapping.
    def p_sample_loop(self, model_fn, shape, generator=None, **kw):
        return self.base.p_sample_loop(self.wrap_model(model_fn), shape, generator, **kw)

    def p_sample_loop_scan(self, model_fn, shape, generator=None, **kw):
        return self.base.p_sample_loop_scan(self.wrap_model(model_fn), shape, generator, **kw)

    def training_losses(self, model_fn, x_start, t, noise):
        return self.base.training_losses(self.wrap_model(model_fn), x_start, t, noise)

    def p_mean_variance(self, model_fn, x, t):
        return self.base.p_mean_variance(self.wrap_model(model_fn), x, t)
