"""In-training evaluation loops (port of ``moditalker_tpu/evals/loops.py``;
ref MToV/evals/eval.py): ``test_psnr`` (AE reconstruction PSNR, ≤ 100
batches, :47-76), ``test_ifvd`` (reconstruction FVD against the real clips
through I3D, :79-147) and the diffusion-sample FVD that the reference stubs
out (``test_fvd_ddpm`` returns 0, :240), computed here when an I3D is given.

The ``ae_apply``, ``sample_fn`` and ``i3d_apply`` callables may return
numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np

from .fvd import compute_fvd
from .metrics import to_numpy, video_psnr


def eval_ae_psnr(ae_apply, batches, max_batches: int = 100) -> float:
    """ref test_psnr. ``ae_apply(video) -> recon``; videos [B, T, H, W, 3] in
    [-1, 1]."""
    vals = []
    for i, video in enumerate(batches):
        if i >= max_batches:
            break
        vals.append(video_psnr(video, ae_apply(video)))
    return float(np.mean(vals)) if vals else float("nan")


def eval_ae_rfvd(ae_apply, batches, i3d_apply, max_batches: int = 32,
                 i3d_batch: int = 8) -> float:
    """Reconstruction FVD (ref test_ifvd): FVD between real clips and their
    AE reconstructions."""
    reals, fakes = [], []
    for i, video in enumerate(batches):
        if i >= max_batches:
            break
        reals.append(_to_u8(video))
        fakes.append(_to_u8(ae_apply(video)))
    if not reals:
        return float("nan")
    return compute_fvd(i3d_apply, np.concatenate(reals),
                       np.concatenate(fakes), batch=i3d_batch)


def eval_sample_fvd(sample_fn, batches, i3d_apply, max_batches: int = 16,
                    i3d_batch: int = 8) -> float:
    """Diffusion-sample FVD, the metric the reference stubs
    (evals/eval.py:240 returns 0). ``sample_fn(batch) -> video``."""
    reals, fakes = [], []
    for i, batch in enumerate(batches):
        if i >= max_batches:
            break
        gen = sample_fn(batch)
        reals.append(_to_u8(batch["x"]))
        fakes.append(_to_u8(gen))
    if not reals:
        return float("nan")
    return compute_fvd(i3d_apply, np.concatenate(reals),
                       np.concatenate(fakes), batch=i3d_batch)


def _to_u8(video) -> np.ndarray:
    v = np.clip(to_numpy(video), -1.0, 1.0)
    return ((v + 1.0) * 127.5).astype(np.uint8)
