"""Gaussian-diffusion math, the DDIM samplers and the ancestral loop (port
of ``moditalker_tpu/core/diffusion.py``): the eps parameterization for MToV,
the x0 parameterization for AToM.

A Python loop stands in for the JAX ``scan``/``fori_loop``. Every draw comes
from ``generator``: a ``torch.Generator``, or any callable
``(shape, dtype) -> Tensor`` that supplies the draws in the order the
sampler consumes them (tests feed the JAX package's draws this way). The
initial ``x``, the renoise draw and the per-step draws can also be passed in
as tensors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .schedules import DiffusionSchedule, ddim_time_pairs

# (x, t_long[B]) -> model output of x's shape; conditioning is closed over.
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def normal(generator, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """One standard-normal draw of ``shape`` from ``generator``."""
    if callable(generator):
        return torch.as_tensor(generator(tuple(shape), dtype)).to(device, dtype)
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch constants, shaped to broadcast over ``ndim`` dims
    (ref ``extract_into_tensor``, ddpm.py:100-103)."""
    out = table[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Diffuse x0 to x_t (ref ddpm.py:486-491)."""
    nd = x_start.ndim
    return (extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise)


def predict_noise_from_start(sched: DiffusionSchedule, x_t, t, x0):
    nd = x_t.ndim
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def q_posterior(sched: DiffusionSchedule, x_start, x_t, t):
    """Posterior q(x_{t-1} | x_t, x_0): mean, variance, clipped log variance
    (ref ddpm.py:289-296)."""
    nd = x_t.ndim
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(sched.posterior_variance, t, nd),
            extract(sched.posterior_log_variance_clipped, t, nd))


def _ddim_step(sched: DiffusionSchedule, x, pred_noise, x_start, time: int,
               time_next: int, eta: float, noise):
    """One DDIM update (ddpm.py:386-398); ``time_next < 0`` returns x_start."""
    if time_next < 0:
        return x_start
    alpha = sched.alphas_cumprod[time]
    alpha_next = sched.alphas_cumprod[time_next]
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                             / (1 - alpha))
    c = torch.sqrt(1 - alpha_next - sigma**2)
    return x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * noise


def ddim_sample(sched: DiffusionSchedule, model_fn: ModelFn,
                shape: tuple[int, ...], sampling_steps: int, *,
                generator=None, device=None, eta: float = 1.0,
                parameterization: str = "eps",
                clip_denoised: bool = True, x_init=None,
                start_pair_index: int = 0,
                step_noise: Sequence[torch.Tensor] | None = None,
                post_step_fn: Callable | None = None,
                guidance_weights: np.ndarray | None = None):
    """DDIM sampling (ddpm.py:362-404): plain from a fresh draw, or from a
    given ``x_init`` starting at pair ``start_pair_index`` (the
    partial-renoise tail). ``step_noise[j]`` is the draw of the j-th step
    run.

    AToM's long sampling (AToM diffusion.py:253-301) passes
    ``post_step_fn(x, time)``, applied after a step only while ``time > 0``,
    and ``guidance_weights`` [sampling_steps]: ``model_fn`` then takes the
    step's weight as a third argument. ``parameterization="x0"`` reads the
    model output as x0 (clipped when ``clip_denoised``) and derives the
    noise from it."""
    if parameterization not in ("eps", "x0"):
        raise NotImplementedError(parameterization)
    times, times_next = ddim_time_pairs(sched.num_timesteps, sampling_steps)
    x = normal(generator, shape, torch.float32, device) if x_init is None else x_init
    batch = x.shape[0]
    for j, i in enumerate(range(start_pair_index, len(times))):
        time = int(times[i])
        t_vec = torch.full((batch,), time, dtype=torch.long, device=x.device)
        if guidance_weights is not None:
            out = model_fn(x, t_vec, float(np.float32(guidance_weights[i])))
        else:
            out = model_fn(x, t_vec)
        if parameterization == "eps":
            pred_noise = out
            x_start = predict_start_from_noise(sched, x, t_vec, pred_noise)
            if clip_denoised:
                x_start = x_start.clamp(-1.0, 1.0)
        else:
            x_start = out.clamp(-1.0, 1.0) if clip_denoised else out
            pred_noise = predict_noise_from_start(sched, x, t_vec, x_start)
        noise = (step_noise[j] if step_noise is not None
                 else normal(generator, x.shape, x.dtype, x.device))
        x = _ddim_step(sched, x, pred_noise, x_start, time,
                       int(times_next[i]), eta, noise)
        if post_step_fn is not None and time > 0:
            x = post_step_fn(x, time)
    return x


def noised_start_indices(num_timesteps: int, sampling_steps: int,
                         ratio: float) -> tuple[int, int]:
    """(t0, start pair index) of the partial-renoise start with the floor
    semantics of the JAX package's traced ratio (diffusion.py:253-259):
    ``floor(T·r)`` and ``floor(steps·(1 − r))`` in float32."""
    r = np.float32(ratio)
    t0 = int(np.floor(np.float32(num_timesteps) * r))
    start = int(np.floor(np.float32(sampling_steps) * (np.float32(1.0) - r)))
    return t0, start


def ddim_sample_noised_start(sched: DiffusionSchedule, model_fn: ModelFn,
                             x_start, sampling_steps: int, ratio: float, *,
                             generator=None, eta: float = 1.0,
                             parameterization: str = "eps",
                             clip_denoised: bool = True, renoise=None,
                             step_noise: Sequence[torch.Tensor] | None = None):
    """Partial-renoise DDIM: q_sample a known latent to t = T·ratio, denoise
    the tail of the schedule (ref ddpm.py:407-454, the fast AR mode), the
    model output read as ``ddim_sample`` reads it."""
    t0, start_idx = noised_start_indices(sched.num_timesteps, sampling_steps,
                                         ratio)
    t_vec = torch.full((x_start.shape[0],), t0, dtype=torch.long,
                       device=x_start.device)
    if renoise is None:
        renoise = normal(generator, x_start.shape, x_start.dtype, x_start.device)
    x_noisy = q_sample(sched, x_start, t_vec, renoise)
    return ddim_sample(sched, model_fn, tuple(x_start.shape), sampling_steps,
                       generator=generator, eta=eta,
                       parameterization=parameterization,
                       clip_denoised=clip_denoised, x_init=x_noisy,
                       start_pair_index=start_idx, step_noise=step_noise)


def p_sample_loop(sched: DiffusionSchedule, model_fn: ModelFn,
                  shape: tuple[int, ...], *, generator=None, device=None,
                  parameterization: str = "eps", clip_denoised: bool = True,
                  start_point: int | None = None, x_init=None,
                  post_step_fn: Callable | None = None):
    """Ancestral sampling loop (ref ddpm.py:310-336) from ``start_point``
    (default T) down to 0. Draws, in order: the initial x unless ``x_init``
    is given, then one per step (the t = 0 step's draw is taken and not
    used, as in the JAX package's per-step key split).
    ``post_step_fn(x, t)`` is applied after a step only while ``t > 0``; it
    may take draws of its own from the same generator."""
    start_point = sched.num_timesteps if start_point is None else start_point
    x = normal(generator, shape, torch.float32, device) if x_init is None else x_init
    batch = x.shape[0]
    for t in range(start_point - 1, -1, -1):
        t_vec = torch.full((batch,), t, dtype=torch.long, device=x.device)
        out = model_fn(x, t_vec)
        x_recon = (predict_start_from_noise(sched, x, t_vec, out)
                   if parameterization == "eps" else out)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean, _, log_var = q_posterior(sched, x_recon, x, t_vec)
        noise = normal(generator, x.shape, x.dtype, x.device)
        x = mean + (torch.exp(0.5 * log_var) * noise if t > 0 else 0.0)
        if post_step_fn is not None and t > 0:
            x = post_step_fn(x, t)
    return x
