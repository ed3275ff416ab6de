"""Diffusion noise schedules and their constant tables (port of
``moditalker_tpu/core/schedules.py``), shared by MToV (linear β, eps) and
AToM (cosine β, x0).

Tables are computed in float64 numpy, as the reference does with
``torch.float64`` (MToV/losses/ddpm.py:79-263, AToM/model/utils.py:67-99),
and stored as float32 tensors.
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


def cosine_beta_schedule(n_timesteps: int, cosine_s: float = 8e-3) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (ref AToM/model/utils.py:78-86)."""
    timesteps = np.arange(n_timesteps + 1, dtype=np.float64) / n_timesteps + cosine_s
    alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
    alphas = alphas / alphas[0]
    betas = 1 - alphas[1:] / alphas[:-1]
    return np.clip(betas, 0, 0.999)


def sqrt_linear_beta_schedule(
    n_timesteps: int, linear_start: float = 1e-4, linear_end: float = 2e-2
) -> np.ndarray:
    return np.linspace(linear_start, linear_end, n_timesteps, dtype=np.float64)


def sqrt_beta_schedule(
    n_timesteps: int, linear_start: float = 1e-4, linear_end: float = 2e-2
) -> np.ndarray:
    return np.linspace(linear_start, linear_end, n_timesteps,
                       dtype=np.float64) ** 0.5


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "sqrt_linear": sqrt_linear_beta_schedule,
    "sqrt": sqrt_beta_schedule,
}


def make_beta_schedule(schedule: str, n_timesteps: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "cosine":
        return cosine_beta_schedule(n_timesteps, cosine_s)
    if schedule not in _SCHEDULES:
        raise ValueError(f"schedule '{schedule}' unknown")
    return _SCHEDULES[schedule](n_timesteps, linear_start, linear_end)


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
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor
    lvlb_weights: torch.Tensor

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_timesteps"})


def make_schedule(schedule: str = "linear", n_timesteps: int = 1000,
                  linear_start: float = 1e-4, linear_end: float = 2e-2,
                  cosine_s: float = 8e-3, v_posterior: float = 0.0,
                  p2_loss_weight_gamma: float = 0.0,
                  p2_loss_weight_k: float = 1.0,
                  parameterization: str = "eps") -> DiffusionSchedule:
    """The tables of ``DDPM.register_schedule`` (MToV/losses/ddpm.py:195-264)
    and of AToM's ``GaussianDiffusion`` buffers
    (AToM/model/diffusion.py:64-111), the training losses' weights
    included: ``lvlb_weights`` by the parameterization (its entry at t = 0
    copies t = 1's) and ``p2_loss_weight`` = (k + ᾱ/(1 − ᾱ))^−γ."""
    betas = make_beta_schedule(schedule, n_timesteps, linear_start,
                               linear_end, cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (
        (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev)
        / (1.0 - alphas_cumprod) + v_posterior * betas)
    if parameterization == "eps":
        with np.errstate(divide="ignore"):
            # posterior_variance[0] == 0: inf at t = 0, overwritten below
            # (as the reference does, ddpm.py:256-262)
            lvlb_weights = betas**2 / (
                2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        # the reference's formula with its (2.0 * 1 - a) kept (ddpm.py:258);
        # no active path weights by it (original_elbo_weight = 0)
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    else:
        raise NotImplementedError(parameterization)
    lvlb_weights = np.asarray(lvlb_weights)
    lvlb_weights[0] = lvlb_weights[1]
    p2_loss_weight = (p2_loss_weight_k
                      + alphas_cumprod / (1 - alphas_cumprod)) \
        ** -p2_loss_weight_gamma
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return DiffusionSchedule(
        num_timesteps=int(betas.shape[0]),
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)),
        p2_loss_weight=f32(p2_loss_weight),
        lvlb_weights=f32(lvlb_weights),
    )


def ddim_time_pairs(n_timesteps: int,
                    sampling_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """DDIM (t, t_next) pairs, descending: ``torch.linspace(-1, T-1,
    steps+1).int()`` reversed and zipped (ddpm.py:372-376); ``t_next`` is -1
    at the final x0 step."""
    times = np.linspace(-1, n_timesteps - 1, sampling_steps + 1)
    times = times.astype(np.int32)[::-1]
    return times[:-1].copy(), times[1:].copy()
