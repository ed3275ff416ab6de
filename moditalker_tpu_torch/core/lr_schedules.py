"""Learning-rate schedules (port of ``moditalker_tpu/core/lr_schedules.py``,
ref MToV/tools/scheduler.py).

The reference defines LambdaWarmUpCosineScheduler(2) and
LambdaLinearScheduler (:4-97): multiplicative factors applied to a base LR.
These return ``schedule(step) -> absolute LR`` as a Python float, computed
in float32 as the JAX package computes them. ``torch_lambda`` turns one
into the factor ``torch.optim.lr_scheduler.LambdaLR`` takes.

The reference constructs LambdaLinearScheduler for the diffusion trainer but
never steps it (exps/diffusion.py:165); the trainers take a ``use_warmup``
flag so both behaviours are available.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 10000,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0,
                           cycle_length: int = 10_000_000_000_000):
    """ref LambdaLinearScheduler (scheduler.py:81-97): linear warm-up
    f_start → f_max, then linear decay toward f_min over cycle_length."""

    def schedule(step) -> float:
        step = _F(step)
        warm = _F(f_start) + _F(f_max - f_start) * step / _F(max(warm_up_steps, 1))
        decay = _F(f_min) + _F(f_max - f_min) * (_F(cycle_length) - step) \
            / _F(cycle_length)
        f = warm if step < warm_up_steps else decay
        return float(_F(base_lr) * f)

    return schedule


def lambda_warmup_cosine_schedule(base_lr: float, warm_up_steps: int,
                                  lr_max: float = 1.0, lr_min: float = 0.0,
                                  lr_start: float = 0.0,
                                  cycle_length: int = 10_000_000_000_000):
    """ref LambdaWarmUpCosineScheduler (scheduler.py:4-33)."""

    def schedule(step) -> float:
        step = _F(step)
        warm = _F(lr_start) + _F(lr_max - lr_start) * step \
            / _F(max(warm_up_steps, 1))
        t = min((step - _F(warm_up_steps)) / _F(cycle_length), _F(1.0))
        cos = _F(lr_min) + _F(0.5) * _F(lr_max - lr_min) \
            * (_F(1) + np.cos(_F(t) * _F(np.pi)))
        return float(_F(base_lr) * (warm if step < warm_up_steps else cos))

    return schedule

