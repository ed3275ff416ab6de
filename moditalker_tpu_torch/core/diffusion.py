"""Gaussian-diffusion math and the DDIM samplers (port of
``moditalker_tpu/core/diffusion.py``, eps parameterization).

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
                clip_denoised: bool = True, x_init=None,
                start_pair_index: int = 0,
                step_noise: Sequence[torch.Tensor] | None = None):
    """DDIM sampling (ddpm.py:362-404): plain from a fresh draw, or from a
    given ``x_init`` starting at pair ``start_pair_index`` (the
    partial-renoise tail). ``step_noise[j]`` is the draw of the j-th step
    run."""
    times, times_next = ddim_time_pairs(sched.num_timesteps, sampling_steps)
    x = normal(generator, shape, torch.float32, device) if x_init is None else x_init
    batch = x.shape[0]
    for j, i in enumerate(range(start_pair_index, len(times))):
        t_vec = torch.full((batch,), int(times[i]), dtype=torch.long,
                           device=x.device)
        pred_noise = model_fn(x, t_vec)
        x_start = predict_start_from_noise(sched, x, t_vec, pred_noise)
        if clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        noise = (step_noise[j] if step_noise is not None
                 else normal(generator, x.shape, x.dtype, x.device))
        x = _ddim_step(sched, x, pred_noise, x_start, int(times[i]),
                       int(times_next[i]), eta, noise)
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
                             clip_denoised: bool = True, renoise=None,
                             step_noise: Sequence[torch.Tensor] | None = None):
    """Partial-renoise DDIM: q_sample a known latent to t = T·ratio, denoise
    the tail of the schedule (ref ddpm.py:407-454, the fast AR mode)."""
    t0, start_idx = noised_start_indices(sched.num_timesteps, sampling_steps,
                                         ratio)
    t_vec = torch.full((x_start.shape[0],), t0, dtype=torch.long,
                       device=x_start.device)
    if renoise is None:
        renoise = normal(generator, x_start.shape, x_start.dtype, x_start.device)
    x_noisy = q_sample(sched, x_start, t_vec, renoise)
    return ddim_sample(sched, model_fn, tuple(x_start.shape), sampling_steps,
                       generator=generator, eta=eta,
                       clip_denoised=clip_denoised, x_init=x_noisy,
                       start_pair_index=start_idx, step_noise=step_noise)
