"""AToM Gaussian diffusion for sampling (port of
``moditalker_tpu/models/atom/diffusion.py``, ref AToM/model/diffusion.py):
cosine schedule, x0 prediction, DDIM-50 with classifier-free guidance as one
doubled batch, the long-form chunked sampling with the temporal-overlap
constraint ``x[1:, :half] = x[:-1, half:]`` and the ancestral loops, and
the training loss (``p_losses``): 7.5·recon + 1.5·velocity, both
p2-weighted (gamma 0 in the shipped config: the weight is one).

Every draw comes from ``generator`` (``core/diffusion.py``): a
``torch.Generator`` or a callable that supplies the draws in the order the
sampler takes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import AtomDiffusionConfig
from ...core import diffusion as dcore
from ...core import schedules
from .decoder import MotionDecoder


def _overlap_constraint(half: int):
    def constraint(x, t):
        x = x.clone()
        x[1:, :half] = x[:-1, half:]
        return x
    return constraint


@dataclasses.dataclass(frozen=True)
class AtomDiffusion:
    """Bundles the schedule, the model and the sampling functions."""

    model: MotionDecoder
    sched: schedules.DiffusionSchedule
    cfg: AtomDiffusionConfig

    @classmethod
    def create(cls, model: MotionDecoder,
               diff_cfg: AtomDiffusionConfig = AtomDiffusionConfig(),
               device=None) -> "AtomDiffusion":
        """``model``: a built ``MotionDecoder``, weights loaded, in
        ``eval()`` and on ``device``."""
        sched = schedules.make_schedule(
            diff_cfg.schedule, diff_cfg.n_timesteps,
            p2_loss_weight_gamma=0.5 if diff_cfg.use_p2 else 0.0,
            parameterization="eps" if diff_cfg.predict_epsilon else "x0")
        return cls(model=model, sched=sched.to(device), cfg=diff_cfg)

    @property
    def _param_kind(self) -> str:
        return "eps" if self.cfg.predict_epsilon else "x0"

    # ------------------------------------------------------------ training
    def draw_loss_inputs(self, generator: torch.Generator, x_start):
        """The draws ``p_losses`` takes, from ``generator`` (a CPU
        generator, so that the card and the CPU get the same numbers): t
        uniform in [0, T), the noise, and keep_mask = U[0, 1) ≥
        cond_drop_prob (the JAX package's k_t, k_noise, k_drop)."""
        b = x_start.shape[0]
        t = torch.randint(0, self.sched.num_timesteps, (b,),
                          generator=generator)
        noise = torch.randn(tuple(x_start.shape), generator=generator)
        keep = torch.rand(b, generator=generator) >= self.cfg.cond_drop_prob
        dev = x_start.device
        return t.to(dev), noise.to(dev, x_start.dtype), keep.to(dev)

    def p_losses(self, x_start, face, cond, t, noise, keep_mask):
        """(total, (recon, velocity)), ref diffusion.py:412-440.

        ``x_start`` [B, T, 204] is the landmark residual, ``face`` the
        identity keypoint broadcast over T, ``cond`` [B, 2T, 1024] HuBERT
        features; ``t`` [B], ``noise`` like ``x_start`` and ``keep_mask``
        bool [B] are the caller's draws (``draw_loss_inputs``). Dropout runs
        as the model's mode says (``train()`` or ``eval()``)."""
        cfg = self.cfg
        b = x_start.shape[0]
        x_noisy = dcore.q_sample(self.sched, x_start, t, noise)
        model_out = self.model(x_noisy, face, cond, t, keep_mask=keep_mask)
        target = noise if cfg.predict_epsilon else x_start
        weight = self.sched.p2_loss_weight[t]

        def weighted_mse(pred, tgt):
            per = (pred - tgt).square().reshape(b, -1).mean(dim=-1)
            return (per * weight).mean()

        recon = weighted_mse(model_out, target)
        v_loss = weighted_mse(model_out[:, 1:] - model_out[:, :-1],
                              target[:, 1:] - target[:, :-1])
        total = cfg.recon_loss_weight * recon + cfg.velocity_loss_weight * v_loss
        return total, (recon, v_loss)

    # ------------------------------------------------------------ sampling
    def _guided_model_fn(self, face, cond, weight: float):
        """model_fn(x, t[, w]) doing CFG in one doubled-batch pass: the
        first half runs the null embeddings, the second the condition."""
        face2, cond2 = torch.cat([face, face]), torch.cat([cond, cond])

        def fn(x, t, w=None):
            b = x.shape[0]
            keep = torch.arange(2 * b, device=x.device) >= b
            out = self.model(torch.cat([x, x]), face2, cond2,
                             torch.cat([t, t]), keep_mask=keep)
            unc, c = out[:b], out[b:]
            return unc + (c - unc) * (weight if w is None else w)
        return fn

    def _ddim(self, shape, face, cond, generator, weight, **kw):
        return dcore.ddim_sample(
            self.sched, self._guided_model_fn(face, cond, weight), shape,
            self.cfg.sampling_steps, generator=generator, device=face.device,
            eta=self.cfg.ddim_eta, parameterization=self._param_kind,
            clip_denoised=self.cfg.clip_denoised, **kw)

    @torch.inference_mode()
    def ddim_sample(self, shape, face, cond, generator=None,
                    guidance_weight: float | None = None):
        """DDIM-50 with CFG (ref diffusion.py:212-250)."""
        w = (self.cfg.guidance_weight if guidance_weight is None
             else guidance_weight)
        return self._ddim(shape, face, cond, generator, w)

    @torch.inference_mode()
    def long_ddim_sample(self, shape, face, cond, generator=None):
        """Batched multi-chunk sampling with the overlap constraint and the
        guidance-weight ramp, clipped at the configured weight (ref
        diffusion.py:253-301)."""
        if shape[0] == 1:
            return self.ddim_sample(shape, face, cond, generator)
        gw = self.cfg.guidance_weight
        weights = np.clip(np.linspace(0, gw * 2, self.cfg.sampling_steps),
                          None, gw)
        return self._ddim(shape, face, cond, generator, gw,
                          post_step_fn=_overlap_constraint(shape[1] // 2),
                          guidance_weights=weights)

    # ---------------------------------------------------- ancestral loops
    @torch.inference_mode()
    def p_sample_loop(self, shape, face, cond, generator=None,
                      start_point: int | None = None, x_init=None,
                      post_step_fn=None):
        """Full ancestral sampling (ref diffusion.py:177-209)."""
        return dcore.p_sample_loop(
            self.sched,
            self._guided_model_fn(face, cond, self.cfg.guidance_weight),
            shape, generator=generator, device=face.device,
            parameterization=self._param_kind,
            clip_denoised=self.cfg.clip_denoised, start_point=start_point,
            x_init=x_init, post_step_fn=post_step_fn)

    def inpaint_loop(self, shape, face, cond, mask, value, generator=None,
                     start_point: int | None = None):
        """Masked inpainting: after every ancestral step, the masked region
        is set to ``q_sample(value, t - 1)`` with a fresh draw (ref
        diffusion.py:303-340). ``mask``/``value``: [B, horizon, repr], mask
        1 keeps the value. Each step takes its own draw and then the
        constraint's."""
        def constraint(x, t):
            n = dcore.normal(generator, x.shape, x.dtype, x.device)
            t_vec = torch.full((x.shape[0],), max(t - 1, 0),
                               dtype=torch.long, device=x.device)
            value_t = dcore.q_sample(self.sched, value, t_vec, n)
            return value_t * mask + (1.0 - mask) * x

        return self.p_sample_loop(shape, face, cond, generator,
                                  start_point=start_point,
                                  post_step_fn=constraint)

    def long_inpaint_loop(self, shape, face, cond, generator=None,
                          start_point: int | None = None):
        """Batched chunked ancestral sampling with the overlap constraint
        (ref diffusion.py:343-390)."""
        post = None if shape[0] == 1 else _overlap_constraint(shape[1] // 2)
        return self.p_sample_loop(shape, face, cond, generator,
                                  start_point=start_point, post_step_fn=post)

    def noise_to_t(self, x, timestep: int, generator=None):
        """q_sample x to a fixed timestep (ref diffusion.py:457-460)."""
        if timestep <= 0:
            return x
        t = torch.full((x.shape[0],), timestep, dtype=torch.long,
                       device=x.device)
        noise = dcore.normal(generator, x.shape, x.dtype, x.device)
        return dcore.q_sample(self.sched, x, t, noise)

    def partial_denoise(self, x, face, cond, timestep: int, generator=None):
        """Renoise to t, then ancestral-denoise from there (ref
        diffusion.py:453-455)."""
        x_noisy = self.noise_to_t(x, timestep, generator)
        return self.p_sample_loop(tuple(x.shape), face, cond, generator,
                                  start_point=timestep, x_init=x_noisy)
