"""Attention primitives (port of ``moditalker_tpu/ops/attention.py``).

``plain_sdpa`` is the JAX package's ``_xla_sdpa``: scores accumulated in
float32, materialised in bf16 when the inputs are bf16, softmax in float32.

``sdpa`` dispatches as the JAX package's ``sdpa`` does on the TPU: at the
one-pass kernel's shapes a CUDA tensor goes to its port
(``ops/kernels/flash_attention.py``). The tiny-L kernel is not ported yet
(ROADMAP B5): at its shapes ``sdpa`` raises for a CUDA tensor rather than
compute quietly without the kernel the TPU ran. Tensors on the CPU always
take the plain math, as the JAX package's non-TPU branch does.
"""

from __future__ import annotations

import math

import torch


def _tiny_viable(b: int, nq: int, nk: int, d: int) -> bool:
    """``tiny_attention_viable`` (flash_attention.py:180-186)."""
    return (nq == nk and nq <= 32 and nq % 8 == 0 and b >= 4096
            and b % 128 == 0 and d % 64 == 0 and d <= 128)


def plain_sdpa(q, k, v):
    """The einsum path of the JAX package (``_xla_sdpa``); q pre-scaled.

    For bf16 inputs torch's matmul accumulates in float32 and rounds the
    scores to bf16: the JAX path's float32 einsum followed by its bf16
    cast of the score tensor."""
    sim = torch.matmul(q, k.transpose(-1, -2))
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def sdpa(q, k, v, scale: float | None = None):
    """Scaled dot-product attention over the last two axes.

    q: [..., Nq, D], k/v: [..., Nk, D]. If ``scale`` is None, q is assumed
    pre-scaled.
    """
    from .kernels import flash_attention  # lazy: the kernels import this module

    nq, d = q.shape[-2], q.shape[-1]
    nk = k.shape[-2]
    if q.is_cuda:
        lead = q.shape[:-2]
        b3 = math.prod(lead)
        if flash_attention.onepass_attention_viable(nq, nk, d):
            out = flash_attention.onepass_attention(
                q.reshape(b3, nq, d), k.reshape(b3, nk, d),
                v.reshape(b3, nk, d), 1.0 if scale is None else float(scale))
            return out.reshape(*lead, nq, d)
        if _tiny_viable(b3, nq, nk, d):
            raise NotImplementedError(
                f"attention at [{b3}, {nq}, {d}] runs the tiny-L Pallas "
                "kernel on the TPU; its CUDA port is ROADMAP B5")
    if scale is not None:
        q = q * scale
    return plain_sdpa(q, k, v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D]"""
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)
