"""MToV latent DDPM sampling (port of ``moditalker_tpu/models/mtov/ddpm.py``,
ref MToV/losses/ddpm.py:119-561): linear β 0.0015→0.0195, T = 1000, eps
parameterization, DDIM-100 with eta 1 and the partial-renoise fast-AR path.
The plain conditional model runs when w == 0, a doubled-batch
classifier-free guidance when w > 0 (ddpm.py:72-89 of the JAX package).
"""

from __future__ import annotations

import dataclasses

import torch

from ...config import MtovDiffusionConfig, MtovUNetConfig
from ...core import diffusion as dcore
from ...core import schedules
from .unet import TriplaneUNet


@dataclasses.dataclass(frozen=True)
class MtovDDPM:
    model: TriplaneUNet
    sched: schedules.DiffusionSchedule
    cfg: MtovDiffusionConfig

    @classmethod
    def create(cls, model: TriplaneUNet,
               diff_cfg: MtovDiffusionConfig = MtovDiffusionConfig(),
               device=None) -> "MtovDDPM":
        if diff_cfg.parameterization != "eps":
            raise NotImplementedError("only the eps parameterization is ported")
        sched = schedules.make_schedule(
            diff_cfg.beta_schedule, diff_cfg.timesteps,
            linear_start=diff_cfg.linear_start,
            linear_end=diff_cfg.linear_end)
        return cls(model=model, sched=sched.to(device), cfg=diff_cfg)

    def _model_fn(self, cond, image_cond):
        w = self.cfg.w

        def fn(x, t):
            if w == 0.0:
                return self.model(x, cond, image_cond, t)
            b = x.shape[0]
            out = self.model(torch.cat([x, x]), torch.cat([cond, torch.zeros_like(cond)]),
                             torch.cat([image_cond, image_cond]), torch.cat([t, t]))
            c, unc = out[:b], out[b:]
            return (1 + w) * c - w * unc

        return fn

    def ddim_sample(self, shape, cond, image_cond, *, generator=None,
                    x_init=None, step_noise=None):
        return dcore.ddim_sample(
            self.sched, self._model_fn(cond, image_cond), shape,
            self.cfg.sampling_timesteps, generator=generator,
            device=cond.device, eta=self.cfg.ddim_eta,
            clip_denoised=self.cfg.clip_denoised, x_init=x_init,
            step_noise=step_noise)

    def ddim_sample_noised_start(self, x_start, cond, image_cond,
                                 ratio: float, *, generator=None,
                                 renoise=None, step_noise=None):
        """Fast AR windows: renoise a reference latent to t = T·ratio and
        denoise the schedule tail (ref ddpm.py:407-454)."""
        return dcore.ddim_sample_noised_start(
            self.sched, self._model_fn(cond, image_cond), x_start,
            self.cfg.sampling_timesteps, ratio, generator=generator,
            eta=self.cfg.ddim_eta, clip_denoised=self.cfg.clip_denoised,
            renoise=renoise, step_noise=step_noise)
