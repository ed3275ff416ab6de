"""Diffusion noise schedule tables (port of
``moditalker_tpu/core/schedules.py``, the part the MToV sampler uses).

Tables are computed in float64 numpy, as the reference does with
``torch.float64`` (MToV/losses/ddpm.py:79-263), and stored as float32
tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linear_beta_schedule(
    n_timesteps: int, linear_start: float = 1e-4, linear_end: float = 2e-2
) -> np.ndarray:
    """``betas = linspace(sqrt(start), sqrt(end), T) ** 2`` (ref ddpm.py:81)."""
    return (np.linspace(linear_start**0.5, linear_end**0.5, n_timesteps,
                        dtype=np.float64) ** 2)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep constant tables, float32 tensors of shape [T]."""

    num_timesteps: int
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_timesteps"})


def make_schedule(schedule: str = "linear", n_timesteps: int = 1000,
                  linear_start: float = 1e-4,
                  linear_end: float = 2e-2) -> DiffusionSchedule:
    """The sampler's tables of ``DDPM.register_schedule``
    (MToV/losses/ddpm.py:195-264). Only the linear schedule is ported."""
    if schedule != "linear":
        raise NotImplementedError(f"schedule {schedule!r} is not ported")
    betas = linear_beta_schedule(n_timesteps, linear_start, linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return DiffusionSchedule(
        num_timesteps=int(betas.shape[0]),
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(np.append(1.0, alphas_cumprod[:-1])),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
    )


def ddim_time_pairs(n_timesteps: int,
                    sampling_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """DDIM (t, t_next) pairs, descending: ``torch.linspace(-1, T-1,
    steps+1).int()`` reversed and zipped (ddpm.py:372-376); ``t_next`` is -1
    at the final x0 step."""
    times = np.linspace(-1, n_timesteps - 1, sampling_steps + 1)
    times = times.astype(np.int32)[::-1]
    return times[:-1].copy(), times[1:].copy()
