"""Exponential moving average of parameters (port of
``moditalker_tpu/core/ema.py``; ref MToV/models/ema.py and
AToM/model/diffusion.py:24-37).

The JAX functions are pure over pytrees; these update an EMA copy of a
module's parameters IN PLACE: ``ema`` is a dict name → tensor
(``ema_copy(module)``), ``params`` the module's ``named_parameters()`` as a
dict, or any mapping with the same keys.
"""

from __future__ import annotations

import numpy as np
import torch


def ema_copy(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A detached copy of ``module``'s parameters, keyed by name."""
    return {k: p.detach().clone() for k, p in module.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict, params, decay: float) -> None:
    """In place: ema ← decay·ema + (1 − decay)·params."""
    params = dict(params)
    for k, e in ema.items():
        e.mul_(decay).add_(params[k].to(e.dtype) * (1.0 - decay))


def warmup_decay(num_updates, decay: float = 0.9999) -> float:
    """Warm-up-aware decay ``min(decay, (1+n)/(10+n))`` (ref
    MToV/models/ema.py:30), in float32."""
    n = np.float32(num_updates)
    return float(min(np.float32(decay),
                     (np.float32(1) + n) / (np.float32(10) + n)))


def ema_update_every(ema: dict, params, decay: float, step: int,
                     every: int = 1) -> bool:
    """``ema_update`` only when ``step % every == 0`` (ref trainer.py:111
    does it every 25 iterations); returns whether it ran."""
    if step % every:
        return False
    ema_update(ema, params, decay)
    return True
