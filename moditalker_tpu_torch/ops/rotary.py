"""TimeSformer rotary embeddings (port of ``moditalker_tpu/ops/rotary.py``).

1D rotary over frames and axial 2D rotary over the patch grid, applied per
head with the interleaved rotate-every-two (ref
MToV/models/autoencoder/vit_modules.py:8-63). The tables are built with numpy
exactly as the JAX package builds them, so both packages rotate by the same
float32 angles.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def time_rotary_sincos(n: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """TimeSformer 1D rotary: (sin, cos) each [n, dim].

    Reference quirk kept on purpose (vit_modules.py:52-63): the frequencies
    are duplicated by CONCATENATION, yet applied with the INTERLEAVED
    rotate-every-two, so a rotated pair (2i, 2i+1) mixes two frequencies.
    The trained weights expect exactly this.
    """
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freqs = np.outer(np.arange(n, dtype=np.float32), inv_freq)
    freqs = np.concatenate([freqs, freqs], axis=-1)
    return np.sin(freqs), np.cos(freqs)


def axial_rotary_sincos(
    h: int, w: int, dim: int, max_freq: float = 10.0
) -> tuple[np.ndarray, np.ndarray]:
    """TimeSformer 2D axial rotary: (sin, cos) each [h*w, dim]
    (vit_modules.py:22-50)."""
    n_scales = dim // 4
    # torch.logspace(0, log2(max_freq/2), n, base=2)
    scales = np.logspace(
        0.0, math.log(max_freq / 2) / math.log(2), n_scales, base=2.0
    ).astype(np.float32)
    h_seq = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None] * scales * math.pi
    w_seq = np.linspace(-1.0, 1.0, w, dtype=np.float32)[:, None] * scales * math.pi
    x_sinu = np.broadcast_to(h_seq[:, None, :], (h, w, n_scales))
    y_sinu = np.broadcast_to(w_seq[None, :, :], (h, w, n_scales))
    sin = np.concatenate([np.sin(x_sinu), np.sin(y_sinu)], axis=-1)
    cos = np.concatenate([np.cos(x_sinu), np.cos(y_sinu)], axis=-1)
    sin = sin.reshape(h * w, -1)
    cos = cos.reshape(h * w, -1)
    # 'n d -> n (d j)', j=2 — each element repeated twice (interleaved)
    sin = np.repeat(sin, 2, axis=-1)
    cos = np.repeat(cos, 2, axis=-1)
    return sin, cos


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(..., 2d) pairs (x[2i], x[2i+1]) -> (-x[2i+1], x[2i])
    (vit_modules.py:8-12). Exact in any dtype: only signs and places
    change."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)


def apply_rot_emb(
    q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """TimeSformer rotary application (vit_modules.py:14-20).

    q, k: [..., N, D_head]; sin/cos: [N, rot_dim] with rot_dim <= D_head,
    already in q's dtype (the JAX reference casts the tables to the compute
    dtype before rotating).
    """
    rot_dim = sin.shape[-1]
    q_rot, q_pass = q[..., :rot_dim], q[..., rot_dim:]
    k_rot, k_pass = k[..., :rot_dim], k[..., rot_dim:]
    q_rot = q_rot * cos + rotate_every_two(q_rot) * sin
    k_rot = k_rot * cos + rotate_every_two(k_rot) * sin
    return torch.cat([q_rot, q_pass], dim=-1), torch.cat([k_rot, k_pass], dim=-1)
