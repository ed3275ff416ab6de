"""MToV latent DDPM (port of ``moditalker_tpu/models/mtov/ddpm.py``, ref
MToV/losses/ddpm.py:119-561): linear β 0.0015→0.0195, T = 1000, the
training loss (``p_losses``: l1 or l2, eps or x0 target, ``loss_simple`` and
``loss_vlb``), and sampling under either parameterization: DDIM-100 with
eta 1, the partial-renoise fast-AR path, the ancestral loop
(``p_sample_loop``) and the reference's ``sample`` dispatcher. The plain
conditional model runs when w == 0, a doubled-batch classifier-free
guidance when w > 0 (ddpm.py:72-89 of the JAX package).
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
        sched = schedules.make_schedule(
            diff_cfg.beta_schedule, diff_cfg.timesteps,
            linear_start=diff_cfg.linear_start,
            linear_end=diff_cfg.linear_end, cosine_s=diff_cfg.cosine_s,
            v_posterior=diff_cfg.v_posterior,
            parameterization=diff_cfg.parameterization)
        return cls(model=model, sched=sched.to(device), cfg=diff_cfg)

    # ------------------------------------------------------------ training
    def draw_loss_inputs(self, generator: torch.Generator, x_start):
        """The draws ``p_losses`` takes, from ``generator`` (a CPU
        generator): t uniform in [0, T) and the noise (the JAX package's
        k_t, k_noise)."""
        t = torch.randint(0, self.sched.num_timesteps, (x_start.shape[0],),
                          generator=generator)
        noise = torch.randn(tuple(x_start.shape), generator=generator)
        return t.to(x_start.device), noise.to(x_start.device, x_start.dtype)

    def p_losses(self, x_start, cond, image_cond, t, noise):
        """(loss, {"loss_simple", "loss_vlb"}), ref ddpm.py:508-541.
        ``x_start`` [B, 4, L] latents; ``t`` [B] and ``noise`` like
        ``x_start`` are the caller's draws (``draw_loss_inputs``). l1 or l2
        per sample over (C, L), eps or x0 target."""
        cfg = self.cfg
        x_noisy = dcore.q_sample(self.sched, x_start, t, noise)
        model_out = self.model(x_noisy, cond, image_cond, t)
        target = noise if cfg.parameterization == "eps" else x_start
        if cfg.loss_type == "l1":
            per = (model_out - target).abs().mean(dim=(1, 2))
        else:
            per = (model_out - target).square().mean(dim=(1, 2))
        loss_simple = per.mean() * cfg.l_simple_weight
        loss_vlb = (self.sched.lvlb_weights[t] * per).mean()
        loss = loss_simple + cfg.original_elbo_weight * loss_vlb
        return loss, {"loss_simple": loss_simple, "loss_vlb": loss_vlb}

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
            parameterization=self.cfg.parameterization,
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
            eta=self.cfg.ddim_eta, parameterization=self.cfg.parameterization,
            clip_denoised=self.cfg.clip_denoised, renoise=renoise,
            step_noise=step_noise)

    def p_sample_loop(self, shape, cond, image_cond, *, generator=None,
                      x_init=None):
        """Full ancestral sampling, T steps: the reference's non-DDIM branch
        (ddpm.py:319-336, taken when sampling_timesteps >= timesteps)."""
        return dcore.p_sample_loop(
            self.sched, self._model_fn(cond, image_cond), shape,
            generator=generator, device=cond.device,
            parameterization=self.cfg.parameterization,
            clip_denoised=self.cfg.clip_denoised, x_init=x_init)

    def sample(self, batch_size: int, cond, image_cond, *, generator=None,
               noised_start=None, ratio: float | None = None,
               latent_len: int = 2048, channels: int = 4):
        """The reference's ``sample`` dispatcher (ddpm.py:456-484): the
        ancestral loop when sampling_timesteps >= timesteps, else DDIM,
        from a partial renoise of ``noised_start`` where one is given."""
        shape = (batch_size, channels, latent_len)
        if self.cfg.sampling_timesteps >= self.cfg.timesteps:
            return self.p_sample_loop(shape, cond, image_cond,
                                      generator=generator)
        if noised_start is not None:
            return self.ddim_sample_noised_start(
                noised_start, cond, image_cond, ratio, generator=generator)
        return self.ddim_sample(shape, cond, image_cond, generator=generator)
