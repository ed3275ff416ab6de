"""Fréchet Video Distance math and I3D preprocessing (a copy of
``moditalker_tpu/evals/fvd.py``; ref MToV/evals/fvd/fvd.py).

Resize the shorter side to 224 (PIL bilinear), centre crop, scale to
[-1, 1]; logits from InceptionI3d; the TF-GAN Fréchet distance with
symmetric-matrix square roots via SVD. The distance runs in float64 numpy
on the host: it is tiny, and its numerics matter more than its speed.
"""

from __future__ import annotations

import numpy as np


def preprocess_video(video_u8: np.ndarray, resolution: int = 224) -> np.ndarray:
    """uint8 [T, H, W, C] → float32 [T, res, res, C] in [-1, 1]
    (ref fvd.py:5-40)."""
    try:
        from PIL import Image
    except ImportError as e:  # nothing stands in for PIL's resampling
        raise ImportError("FVD preprocessing needs PIL") from e

    t, h, w, c = video_u8.shape
    scale = resolution / min(h, w)
    if h < w:
        th, tw = resolution, int(np.ceil(w * scale))
    else:
        th, tw = int(np.ceil(h * scale)), resolution
    out = np.empty((t, th, tw, c), np.float32)
    for i in range(t):
        im = Image.fromarray(video_u8[i])
        out[i] = np.asarray(im.resize((tw, th), Image.BILINEAR), np.float32)
    out = out / 255.0
    hs = (th - resolution) // 2
    ws = (tw - resolution) // 2
    out = out[:, hs : hs + resolution, ws : ws + resolution]
    return (out - 0.5) * 2.0


def preprocess_batch(videos_u8: np.ndarray, resolution: int = 224) -> np.ndarray:
    return np.stack([preprocess_video(v, resolution) for v in videos_u8])


def _sym_sqrt(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """ref fvd.py:48-51 (torch.svd convention: M = U S V^T)."""
    u, s, vt = np.linalg.svd(mat)
    si = np.where(s < eps, s, np.sqrt(s))
    return u @ np.diag(si) @ vt


def trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _sym_sqrt(sigma)
    return float(np.trace(_sym_sqrt(sqrt_sigma @ sigma_v @ sqrt_sigma)))


def cov(m: np.ndarray) -> np.ndarray:
    """Sample covariance, rows = observations (ref fvd.py:61-77)."""
    m = np.asarray(m, np.float64)
    fact = 1.0 / (m.shape[0] - 1)
    m = m - m.mean(axis=0, keepdims=True)
    return fact * (m.T @ m)


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """FVD between two embedding sets [N, D] (ref fvd.py:93-104)."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    m, m_w = x1.mean(axis=0), x2.mean(axis=0)
    sigma, sigma_w = cov(x1), cov(x2)
    sqrt_trace = trace_sqrt_product(sigma, sigma_w)
    trace = np.trace(sigma + sigma_w) - 2.0 * sqrt_trace
    mean = np.sum((m - m_w) ** 2)
    return float(trace + mean)


def compute_fvd(i3d_apply, real_u8: np.ndarray, fake_u8: np.ndarray,
                batch: int = 16) -> float:
    """End-to-end FVD given an ``i3d_apply(videos_f32) -> logits`` fn."""
    def embed(videos):
        vids = preprocess_batch(videos)
        outs = []
        for i in range(0, len(vids), batch):
            outs.append(np.asarray(i3d_apply(vids[i : i + batch])))
        return np.concatenate(outs)

    return frechet_distance(embed(real_u8), embed(fake_u8))
