"""Gradients of the kernel wrappers (port of the JAX package's
``custom_vjp``s around its Pallas kernels).

The kernels fill buffers through ``ctypes``, so their outputs carry no
``grad_fn``; without these functions a model trained through them on the
card would get no gradient upstream of any attention. The forward is the
kernel (on a CUDA tensor; the plain version on a CPU tensor).

* ``DividedAttention`` — packed qkv of the divided space and time kernels;
  saves qkv and the output, and its backward is the wrapper's: the backward
  kernels on a CUDA tensor (``csrc/divided_backward.cuh``), the written-out
  adjoints (``divided_backward.divided_attention_backward_reference``) on a
  CPU tensor. The JAX package's ``custom_vjp``
  (``ops/pallas/divided_attention.py:310-322``) runs ``jax.vjp`` of the
  reference there.
* ``RecomputeThroughPlain`` — one packed input (the packed kernel), backward
  = the vjp of the plain version recomputed
  (``ops/pallas/packed_attention.py:184-196``: ``jax.vjp`` of the
  reference). Only the input is saved.
* ``FlashSdpa`` — q, k, v of the one-pass and tiny-L kernels, backward = the
  standard softmax-attention adjoints on recomputed float32 probabilities
  with a float32 ``dp`` (``ops/attention.py:62-82``, ``_flash_sdpa_bwd``).

The last two have no backward kernel: the JAX package's backwards are XLA
over the reference, and ``torch.matmul`` stands there. Their recomputed
[B, N, N] probabilities are float32, several alive at once: at the UNet's
[80, 2048, 2048] that is 1.34 GB a tensor, per attention, in the backward.
"""

from __future__ import annotations

import torch


class DividedAttention(torch.autograd.Function):
    """``apply(qkv, forward, backward)``: ``out = forward(qkv)`` now,
    ``backward(qkv, out, g)`` → dqkv for the cotangent ``g``."""

    @staticmethod
    def forward(ctx, qkv, forward, backward):
        out = forward(qkv)
        ctx.save_for_backward(qkv, out)
        ctx.backward_fn = backward
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out = ctx.saved_tensors
        return ctx.backward_fn(qkv, out, g.contiguous()), None, None


class RecomputeThroughPlain(torch.autograd.Function):
    """``apply(x, forward, plain)``: ``forward(x)`` now, the vjp of
    ``plain(x)`` recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, forward, plain):
        ctx.save_for_backward(x)
        ctx.plain = plain
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            t = x.detach().requires_grad_(True)
            out = ctx.plain(t)
        (dx,) = torch.autograd.grad(out, t, g)
        return dx, None, None


def sdpa_adjoints(q, k, v, scale: float, g):
    """(dq, dk, dv) of ``softmax((q·scale) kᵀ) v`` for the cotangent ``g``
    (``_flash_sdpa_bwd``): scores, probabilities and ``dp`` in float32, the
    products that leave them in the inputs' dtype."""
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.matmul(p.to(v.dtype).transpose(-1, -2), g.to(v.dtype))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    # ds = p · (dp − Σ_j dp·p), in place on dp
    dp.sub_((dp * p).sum(-1, keepdim=True)).mul_(p)
    del p
    ds = dp.to(q.dtype)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


class FlashSdpa(torch.autograd.Function):
    """``apply(q, k, v, scale, forward)``: ``forward(q, k, v, scale)`` now
    (q not pre-scaled), ``sdpa_adjoints`` in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, forward):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*sdpa_adjoints(q, k, v, ctx.scale, g), None, None)
