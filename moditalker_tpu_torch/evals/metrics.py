"""Video PSNR, the train-diffusion probe's metric (port of ``psnr`` and
``video_psnr`` of ``moditalker_tpu/evals/metrics.py``; ref MToV/utils.py:117
and MToV/evals/eval.py:47-76). The rest of the JAX package's evals (FVD,
I3D, the eval loops, landmark distances) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def psnr(mse: float, max_val: float = 1.0) -> float:
    """ref MToV/utils.py:117-121 (inputs scaled to [0, 1])."""
    return float(20 * np.log10(max_val) - 10 * np.log10(mse))


def video_psnr(real, fake) -> float:
    """Videos in [-1, 1] → PSNR on the [0, 1] scale, as test_psnr
    (evals/eval.py:57-66: (x + 1)/2, then the MSE over all dims per batch
    item, averaged over the batch). Accepts numpy arrays or tensors."""
    def f64(v):
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        return (np.asarray(v, np.float64) + 1.0) / 2.0

    r, f = f64(real), f64(fake)
    mse = ((r - f) ** 2).mean(axis=tuple(range(1, r.ndim)))
    return float(np.mean([psnr(m) for m in mse]))
