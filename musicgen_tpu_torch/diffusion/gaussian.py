"""Gaussian diffusion core in PyTorch.

Port of musicgen_tpu/diffusion/gaussian.py (the reference's
diffusion/gaussian_diffusion.py:33-558: posterior math, the LEARNED_RANGE
variance interpolation, ancestral sampling with RePaint ground-truth
injection, the jump-schedule loop with `undo` renoising), with the
`training_losses` the JAX package supplies (epsilon-MSE plus the
variational-bound term for learned variances, in f32 on the model output
cast to f32).

The schedule's coefficients are computed in numpy float64, as in JAX, and
gathered as float32 (`_extract`). Every random draw is data: the step
functions take the noise tensors they use, and the loops take them from a
noise source (`noise(shape) -> tensor`, by default N(0, 1) draws from one
`torch.Generator`) in the order in which JAX splits its keys:

  * the initial x;
  * then, each step that denoises, the ground truth's noise (when a ground
    truth and a keep mask are given) followed by the step's noise;
  * or, each step that renoises (a RePaint jump up), one draw.

So a caller can replay JAX's own draws into the port and compare whole
trajectories. `p_sample_loop_scan`, a `lax.scan` in JAX, is the same Python
loop as `p_sample_loop` here.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import named_betas

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, t) -> output
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]  # shape -> the next f32 draw


class MeanType(enum.Enum):
    EPSILON = "epsilon"  # model predicts noise (reference default)
    X_START = "xstart"


class VarType(enum.Enum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"  # model outputs [mean_out, frac] channels


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray  # (T,)

    @classmethod
    def named(cls, name: str, num_timesteps: int) -> "DiffusionSchedule":
        return cls(named_betas(name, num_timesteps))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    # Derived arrays (all float64 numpy, cast at use sites).
    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def alphas_cumprod_prev(self) -> np.ndarray:
        return np.append(1.0, self.alphas_cumprod[:-1])

    @property
    def posterior_variance(self) -> np.ndarray:
        return self.betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)

    @property
    def posterior_log_variance_clipped(self) -> np.ndarray:
        pv = self.posterior_variance
        return np.log(np.append(pv[1], pv[1:]))

    @property
    def posterior_mean_coef1(self) -> np.ndarray:
        return self.betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)

    @property
    def posterior_mean_coef2(self) -> np.ndarray:
        return (1.0 - self.alphas_cumprod_prev) * np.sqrt(1.0 - self.betas) / (1.0 - self.alphas_cumprod)


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients as float32 on t's device, broadcast
    to x's rank (reference gaussian_diffusion.py:545-558
    `_extract_into_tensor`)."""
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def generator_noise(generator: torch.Generator) -> NoiseFn:
    """The default noise source: N(0, 1) f32 draws from `generator`, on its
    device."""
    return lambda shape: torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule
    mean_type: MeanType = MeanType.EPSILON
    var_type: VarType = VarType.LEARNED_RANGE
    clip_denoised: bool = True

    # ----- forward process -----

    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (_extract(np.sqrt(s.alphas_cumprod), t, x_start.ndim) * x_start
                + _extract(np.sqrt(1.0 - s.alphas_cumprod), t, x_start.ndim) * noise)

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        mean = (_extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
                + _extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        var = _extract(s.posterior_variance, t, x_t.ndim)
        log_var = _extract(s.posterior_log_variance_clipped, t, x_t.ndim)
        return mean, var, log_var

    def undo(self, x_t, t, noise):
        """One forward (renoising) step x_t -> x_{t+1} for RePaint jumps
        (reference gaussian_diffusion.py:170-179)."""
        beta = _extract(self.schedule.betas, t, x_t.ndim)
        return torch.sqrt(1.0 - beta) * x_t + torch.sqrt(beta) * noise

    # ----- reverse process -----

    def _predict_xstart_from_eps(self, x_t, t, eps):
        s = self.schedule
        return (_extract(np.sqrt(1.0 / s.alphas_cumprod), t, x_t.ndim) * x_t
                - _extract(np.sqrt(1.0 / s.alphas_cumprod - 1.0), t, x_t.ndim) * eps)

    def p_mean_variance(self, model: ModelFn, x, t):
        """Returns (mean, var, log_var, pred_xstart)
        (reference gaussian_diffusion.py:208-288)."""
        s = self.schedule
        out = model(x, t).to(torch.float32)
        c = x.shape[1]

        if self.var_type == VarType.LEARNED_RANGE:
            assert out.shape[1] == 2 * c, (out.shape, c)
            out, frac_raw = torch.split(out, c, dim=1)
            min_log = _extract(s.posterior_log_variance_clipped, t, x.ndim)
            max_log = _extract(np.log(s.betas), t, x.ndim)
            frac = (frac_raw + 1.0) / 2.0  # [-1,1] -> [0,1]
            log_var = frac * max_log + (1.0 - frac) * min_log
            var = torch.exp(log_var)
        elif self.var_type == VarType.FIXED_LARGE:
            var = _extract(np.append(s.posterior_variance[1], s.betas[1:]), t, x.ndim)
            log_var = torch.log(var)
        else:
            var = _extract(s.posterior_variance, t, x.ndim)
            log_var = _extract(s.posterior_log_variance_clipped, t, x.ndim)

        if self.mean_type == MeanType.EPSILON:
            pred_xstart = self._predict_xstart_from_eps(x, t, out)
        else:
            pred_xstart = out
        if self.clip_denoised:
            pred_xstart = torch.clamp(pred_xstart, -1.0, 1.0)
        mean, _, _ = self.q_posterior(pred_xstart, x, t)
        return mean, var, log_var, pred_xstart

    def p_sample(self, model: ModelFn, x, t, noise, gt: Optional[torch.Tensor] = None,
                 gt_keep_mask: Optional[torch.Tensor] = None, gt_noise: Optional[torch.Tensor] = None):
        """Ancestral step with optional RePaint ground-truth injection
        (reference gaussian_diffusion.py:317-408 `inpa_inj_sched_prev`): the
        known region is replaced by the ground truth renoised to the SAME
        timestep (with `gt_noise`) before the reverse step, whose noise is
        `noise`."""
        if gt is not None and gt_keep_mask is not None:
            alpha_cum = _extract(self.schedule.alphas_cumprod, t, x.ndim)
            weighed_gt = torch.sqrt(alpha_cum) * gt + torch.sqrt(1.0 - alpha_cum) * gt_noise
            x = gt_keep_mask * weighed_gt + (1.0 - gt_keep_mask) * x

        mean, _, log_var, pred_xstart = self.p_mean_variance(model, x, t)
        nonzero = (t != 0).to(torch.float32).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = mean + nonzero * torch.exp(0.5 * log_var) * noise
        return sample, pred_xstart

    def p_sample_loop(self, model: ModelFn, shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                      gt: Optional[torch.Tensor] = None, gt_keep_mask: Optional[torch.Tensor] = None,
                      times: Optional[Sequence[int]] = None, noise: Optional[NoiseFn] = None) -> torch.Tensor:
        """Full reverse loop (reference gaussian_diffusion.py:410-543).

        With `times` from schedule.get_schedule_jump, descending pairs run
        p_sample and ascending pairs run `undo` renoising (RePaint). Without
        `times`, plain T..0 ancestral sampling. The draws come from `noise`,
        else from `generator` (whose device is the loop's), in the module
        docstring's order."""
        if noise is None:
            noise = generator_noise(generator)
        t_T = self.schedule.num_timesteps
        if times is None:
            times = list(range(t_T))[::-1] + [-1]
        injects = gt is not None and gt_keep_mask is not None
        x = noise(shape)
        for t_last, t_cur in zip(times[:-1], times[1:]):
            t_vec = torch.full((shape[0],), t_last, dtype=torch.long, device=x.device)
            if t_cur < t_last:  # reverse (denoise) step at t_last
                gt_noise = noise(shape) if injects else None
                x, _ = self.p_sample(model, x, t_vec, noise(shape), gt, gt_keep_mask, gt_noise)
            else:  # forward (renoise) jump
                x = self.undo(x, t_vec, noise(shape))
        return x

    # JAX compiles this trajectory as one lax.scan; here it is the same loop.
    p_sample_loop_scan = p_sample_loop

    # ----- training (missing from the reference; the JAX package's) -----

    def training_losses(self, model: ModelFn, x_start, t, noise) -> dict:
        """epsilon-MSE plus (for LEARNED_RANGE) the variational-bound term on
        the variance channels with the mean's gradient stopped: the
        improved-DDPM hybrid objective the reference's respace.py:127-129
        expects to exist. `noise` is the forward process's draw."""
        x_t = self.q_sample(x_start, t, noise)
        out = model(x_t, t).to(torch.float32)
        c = x_start.shape[1]
        terms = {}

        if self.var_type == VarType.LEARNED_RANGE:
            eps_pred, frac_raw = torch.split(out, c, dim=1)
            # Variational bound on the variance: KL(q_posterior || p) with
            # frozen mean.
            frozen_model_out = torch.cat([eps_pred.detach(), frac_raw], dim=1)
            mean, _, log_var, _ = self.p_mean_variance(lambda x_, t_: frozen_model_out, x_t, t)
            true_mean, _, true_log_var = self.q_posterior(x_start, x_t, t)
            kl = 0.5 * (-1.0 + log_var - true_log_var + torch.exp(true_log_var - log_var)
                        + (true_mean - mean) ** 2 * torch.exp(-log_var))
            terms["vb"] = torch.mean(kl) / float(np.log(2.0))
        else:
            eps_pred = out
            terms["vb"] = torch.zeros((), device=out.device)

        target = noise if self.mean_type == MeanType.EPSILON else x_start
        terms["mse"] = torch.mean((target - eps_pred) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"]
        return terms
