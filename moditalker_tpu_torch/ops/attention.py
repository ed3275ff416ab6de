"""Attention primitives (port of ``moditalker_tpu/ops/attention.py``).

``plain_sdpa`` is the JAX package's ``_xla_sdpa``: scores accumulated in
float32, materialised in bf16 when the inputs are bf16, softmax in float32.

``sdpa`` dispatches as the JAX package's ``sdpa`` does on the TPU
(``sdpa_route``): mask-free self-attention goes to the one-pass kernel at
its gate's shapes, else to the tiny-L kernel at its gate's, else to the
plain math. ``sdpa_fused`` is the JAX package's public op of the same name
(``sdpa_fused_route``): the K-blocked fused kernel from 256 keys up. The
kernel wrappers (``ops/kernels/flash_attention.py``) launch their kernels
for CUDA tensors and run their plain versions, the same math as
``plain_sdpa``, for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch


def plain_sdpa(q, k, v, mask=None):
    """The einsum path of the JAX package (``_xla_sdpa``); q pre-scaled.
    ``mask`` (bool, broadcastable to the scores) keeps the True entries.

    For bf16 inputs torch's matmul accumulates in float32 and rounds the
    scores to bf16: the JAX path's float32 einsum followed by its bf16
    cast of the score tensor."""
    sim = torch.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        sim = torch.where(mask, sim, torch.finfo(sim.dtype).min)
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def sdpa_route(b3: int, nq: int, nk: int, d: int, masked: bool) -> str:
    """Where ``sdpa`` sends [b3, nq, d] x [b3, nk, d]: ``"onepass"``,
    ``"tiny"`` or ``"plain"`` — the JAX dispatch (attention.py:146-149,
    :54-56): a mask always takes the plain math, the one-pass gate is asked
    before the tiny-L gate."""
    from .kernels import flash_attention  # lazy: the kernels import this module

    if masked:
        return "plain"
    if flash_attention.onepass_attention_viable(nq, nk, d):
        return "onepass"
    if flash_attention.tiny_attention_viable(b3, nq, nk, d):
        return "tiny"
    return "plain"


def sdpa_fused_route(b3: int, nq: int, nk: int, d: int) -> str:
    """Where ``sdpa_fused`` sends a shape: below 256 keys wherever ``sdpa``
    does, else ``"fused"`` where the key length tiles and ``"plain"`` where
    it does not (attention.py:220, flash_attention.py:221-225)."""
    from .kernels import flash_attention

    if nk < 256:
        return sdpa_route(b3, nq, nk, d, masked=False)
    return "fused" if flash_attention.fused_attention_tiles(nk, d) else "plain"


def _attend(route: str, q, k, v, scale: float | None, mask=None):
    """Run one route: fold the leading axes for a kernel wrapper, or the
    plain math on the tensors as they are."""
    from .kernels import flash_attention

    if route == "plain":
        if scale is not None:
            q = q * scale
        return plain_sdpa(q, k, v, mask)
    kernel = {"onepass": flash_attention.onepass_attention,
              "tiny": flash_attention.tiny_attention,
              "fused": flash_attention.fused_attention}[route]
    nq, d = q.shape[-2:]
    nk = k.shape[-2]
    out = kernel(q.reshape(-1, nq, d), k.reshape(-1, nk, d),
                 v.reshape(-1, nk, d), 1.0 if scale is None else float(scale))
    return out.reshape(q.shape)


def sdpa(q, k, v, scale: float | None = None, mask=None):
    """Scaled dot-product attention over the last two axes.

    q: [..., Nq, D], k/v: [..., Nk, D]. If ``scale`` is None, q is assumed
    pre-scaled. ``mask``: bool, broadcastable to [..., Nq, Nk].
    """
    route = sdpa_route(math.prod(q.shape[:-2]), q.shape[-2], k.shape[-2],
                       q.shape[-1], mask is not None)
    return _attend(route, q, k, v, scale, mask)


def sdpa_fused(q, k, v, scale: float):
    """``sdpa`` through the K-blocked fused kernel from 256 keys up; all
    leading axes are folded into the kernel batch."""
    route = sdpa_fused_route(math.prod(q.shape[:-2]), q.shape[-2],
                             k.shape[-2], q.shape[-1])
    return _attend(route, q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, H, N, D]"""
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def multi_head_sdpa(q, k, v, num_heads: int, mask=None):
    """Multi-head attention on already-projected q/k/v of shape [B, N, H*D],
    scaled by 1/sqrt(head_dim)."""
    d = q.shape[-1] // num_heads
    out = sdpa(split_heads(q, num_heads), split_heads(k, num_heads),
               split_heads(v, num_heads), scale=d**-0.5, mask=mask)
    return merge_heads(out)
