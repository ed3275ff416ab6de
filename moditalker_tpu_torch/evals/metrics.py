"""Scalar quality metrics: PSNR, landmark L2, the reconstruction eval loop
(port of ``moditalker_tpu/evals/metrics.py``; ref MToV/utils.py:117 and
MToV/evals/eval.py:47-76). The landmark L2 is the AToM parity metric the
reference computes in commented-out code (AToM/model/diffusion.py:502-516).
Each takes numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np


def to_numpy(v) -> np.ndarray:
    """A tensor (any device, any float dtype) or array-like → numpy."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v)


def psnr(mse: float, max_val: float = 1.0) -> float:
    """ref MToV/utils.py:117-121 (inputs scaled to [0, 1])."""
    return float(20 * np.log10(max_val) - 10 * np.log10(mse))


def video_psnr(real, fake) -> float:
    """Videos in [-1, 1] → PSNR on the [0, 1] scale, as test_psnr
    (evals/eval.py:57-66: (x + 1)/2, then the MSE over all dims per batch
    item, averaged over the batch)."""
    r = (to_numpy(real).astype(np.float64) + 1.0) / 2.0
    f = (to_numpy(fake).astype(np.float64) + 1.0) / 2.0
    mse = ((r - f) ** 2).mean(axis=tuple(range(1, r.ndim)))
    return float(np.mean([psnr(m) for m in mse]))


def landmark_l2(pred, target) -> float:
    """Mean per-landmark Euclidean distance, [T, 68, 3] or [B, T, 68, 3]."""
    d = np.linalg.norm(to_numpy(pred) - to_numpy(target), axis=-1)
    return float(d.mean())


def ae_reconstruction_eval(ae_apply, batches, max_batches: int = 100) -> float:
    """AE reconstruction PSNR over a batch iterator (ref test_psnr,
    eval.py:47-76). ``ae_apply(video)`` → reconstruction, both
    [B, T, H, W, 3] in [-1, 1]."""
    vals = []
    for i, video in enumerate(batches):
        if i >= max_batches:
            break
        vals.append(video_psnr(video, ae_apply(video)))
    return float(np.mean(vals))


def mouth_landmark_l2(pred, target) -> float:
    """M-LMD: mean mouth-landmark (48:68) distance, the paper's lip-sync
    proxy (landmarks [..., 68, 2 or 3])."""
    return landmark_l2(to_numpy(pred)[..., 48:68, :],
                       to_numpy(target)[..., 48:68, :])


def face_landmark_l2(pred, target) -> float:
    """F-LMD: mean full-face landmark distance."""
    return landmark_l2(pred, target)
