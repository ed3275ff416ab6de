"""Adan as a ``torch.optim.Optimizer`` (port of
``moditalker_tpu/core/adan.py``, ref AToM/model/adan.py:33-123).

Every quirk of the JAX package's transformation is kept:

* the (beta1, beta2, beta3) = fraction-of-new convention, defaults
  (0.02, 0.08, 0.01);
* no moment update on the first step, so step 1 is the weight decay alone;
* ``prev_grad`` is set from step 1 on;
* the three bias corrections, in float32 as the JAX package computes them;
* the decoupled decay as a division by ``1 + wd·lr`` after the step, not
  AdamW's multiply.

Parameters are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

_F = np.float32


class Adan(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float, float] = (0.02, 0.08, 0.01),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("m", "v", "n", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                m, v, n, pg = st["m"], st["v"], st["n"], st["prev_grad"]
                if st["step"] > 0:   # moments skip the first step
                    diff = g - pg
                    nxt = (g + (1 - b2) * diff).square()
                    m.mul_(1 - b1).add_(g * b1)
                    v.mul_(1 - b2).add_(diff * b2)
                    n.mul_(1 - b3).add_(nxt * b3)
                st["step"] += 1
                step = _F(st["step"])
                cm = float(_F(1) / (_F(1) - _F(1 - b1) ** step))
                cv = float(_F(1) / (_F(1) - _F(1 - b2) ** step))
                cn = float(_F(1) / (_F(1) - _F(1 - b3) ** step))
                weighted = lr / ((n * cn).sqrt() + eps)
                new_p = (p - weighted * (m * cm + (1 - b2) * v * cv)) \
                    / (1.0 + wd * lr)
                p.copy_(new_p)
                pg.copy_(g)
        return loss
