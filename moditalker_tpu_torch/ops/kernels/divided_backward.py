"""The gradient of the divided space/time attention, in plain PyTorch: the
functions the backward kernels (``csrc/divided_backward.cuh``) are held to.

The JAX package takes this gradient as ``jax.vjp`` of its reference
(``moditalker_tpu/ops/pallas/divided_attention.py:310-322``). Here the
adjoints are written out, per (sequence, head), with q~ = scale·rot(q),
k~ = rot(k):

    S = q~·k~ᵀ, P = softmax(S), dV = Pᵀ·g, dP = g·Vᵀ, D = rowsum(g ∘ out),
    dS = P ∘ (dP − D), dq = rotᵀ(scale·dS·k~), dk = rotᵀ(dSᵀ·q~),

``rotᵀ`` being the transpose of the rotary (``rotary_transpose``).
``divided_attention_backward_reference`` computes them in float32 with no
rounding: the CPU path's backward and the tests' oracle.
``divided_attention_backward_float32_route`` writes out the kernels'
rounding points on top (the forward float32 route's, and g, P and dS
rounded to bf16 as product operands), the function their float32 results
are held to. ``space_backward_prepass_reference`` is the plain version of
the space backward's pre-pass (the bf16 scratch its kernels read, bit for
bit), and ``space_backward_route_from_prepass`` the route computed from
that scratch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import rotary
from .flash_attention import mma_products


def rotary_transpose(g, sin, cos):
    """The adjoint of the rotation in ``rotary.apply_rot_emb`` (x ↦ x∘cos +
    rotate_every_two(x)∘sin): dx = g∘cos − rotate_every_two(g∘sin), i.e.
    dx[2i] = g[2i]·cos[2i] + g[2i+1]·sin[2i+1] and dx[2i+1] =
    g[2i+1]·cos[2i+1] − g[2i]·sin[2i]. The time table's pair entries
    differ (its frequencies are concatenated, not repeated), so the sin of
    the other element of the pair is the one that enters."""
    return g * cos - rotary.rotate_every_two(g * sin)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _kernel_rowsum(a, b):
    """rowsum(a ∘ b) over the last dim in fp32, in the space pre-pass's
    order: each 8-element chunk (zeros past the row) summed in order, each
    product and sum rounded on its own, then the chunks' sums added
    pairwise (chunks 2i and 2i + 1, then pairs of pairs)."""
    dh = a.shape[-1]
    prod = F.pad(a.float() * b.float(), (0, -dh % 8))
    prod = prod.unflatten(-1, (-1, 8))
    d = torch.zeros_like(prod[..., 0])
    for e in range(8):
        d = d + prod[..., e]
    while d.shape[-1] > 1:
        d = d[..., 0::2] + d[..., 1::2]
    return d[..., 0]


def space_backward_prepass_reference(qkv, out, g, sin, cos, heads: int,
                                     dim_head: int, scale: float):
    """The plain version of the space backward's pre-pass
    (``csrc/divided_backward.cuh``; heads of 32 to 128 dims), bit for bit:
    qkv [BF, N, 3·H·dh], the forward's output and its cotangent g
    [BF, N, H·dh] (bf16 or float32) →

    * the scratch [BF, N, 3·H·dh] bf16: q rotated in fp32 (each product and
      the sum rounded on its own), multiplied by ``scale`` and rounded to
      bf16 once, k rotated and rounded once, v rounded once (the forward's
      ``space_rotate_reference`` with its v third);
    * gs [BF, N, H·dh] bf16: g rounded once;
    * dsum [BF, H, N] float32: D = rowsum(g ∘ out) (``_kernel_rowsum``)."""
    bf, n, _ = qkv.shape
    q, k, v = (t.float().reshape(bf, n, heads, dim_head)
               for t in qkv.chunk(3, dim=-1))
    sin, cos = sin.float()[:, None], cos.float()[:, None]
    q = (q * cos + rotary.rotate_every_two(q) * sin) * scale
    k = k * cos + rotary.rotate_every_two(k) * sin
    scratch = torch.stack((q, k, v), dim=2).bfloat16().reshape(
        bf, n, 3 * heads * dim_head)
    gh = g.float().reshape(bf, n, heads, dim_head)
    d = _kernel_rowsum(gh, out.float().reshape(bf, n, heads, dim_head))
    return (scratch, gh.bfloat16().reshape(bf, n, heads * dim_head),
            d.transpose(1, 2).contiguous())


def _space_adjoints(q_scores, k_scores, qs, kr, v, gv, d, sin, cos,
                    scale: float):
    """The space route's adjoints from its bf16-valued operands
    [BF, H, N, ·] (q_scores and k_scores: what the scores multiply, the
    split operands at head dims 2 and 4) and D [BF, H, N] → dqkv
    [BF, N, 3·H·dh] float32."""
    q_scores, k_scores, qs, kr, v, gv = (
        t.contiguous() for t in (q_scores, k_scores, qs, kr, v, gv))
    s, dp = mma_products(q_scores, k_scores), mma_products(gv, v)
    p = torch.softmax(s, dim=-1)
    ds = p * (dp - d[..., None])
    p, ds = _bf16(p), _bf16(ds)
    dv = torch.matmul(p.transpose(-1, -2), gv)
    dq = rotary_transpose(torch.matmul(ds, kr) * scale, sin, cos)
    dk = rotary_transpose(torch.matmul(ds.transpose(-1, -2), qs), sin, cos)
    bf, heads, n, dh = qs.shape
    return torch.cat([t.transpose(1, 2).reshape(bf, n, heads * dh)
                      for t in (dq, dk, dv)], dim=-1)


def _space_route(qkv, out, g, sin, cos, heads: int, dim_head: int,
                 scale: float):
    """The space axis of ``divided_attention_backward_float32_route``."""
    b, f, n, _ = qkv.shape

    def split(t):  # [B,F,N,H*dh] -> [B·F,H,N,dh]
        return t.float().reshape(b * f, n, heads, dim_head).transpose(1, 2)

    q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
    dout = split(g)
    sin, cos = sin.float(), cos.float()
    qr, k_full = rotary.apply_rot_emb(q, k, sin, cos)
    q_full = qr * scale
    qs, kr = _bf16(q_full), _bf16(k_full)
    q_scores, k_scores = qs, kr
    if dim_head <= 4:
        # heads of 2 and 4 dims: q~ and k~ each split into its bf16
        # rounding and the bf16 rounding of the rest for the scores, one
        # k16 step (the space kernels' split operands); the products below
        # take the rounding alone
        q_scores = torch.cat([qs, _bf16(q_full - qs), qs], dim=-1)
        k_scores = torch.cat([kr, kr, _bf16(k_full - kr)], dim=-1)
    dqkv = _space_adjoints(q_scores, k_scores, qs, kr, _bf16(v),
                           _bf16(dout), _kernel_rowsum(dout, split(out)),
                           sin, cos, scale)
    return dqkv.reshape(b, f, n, -1)


def space_backward_route_from_prepass(scratch, gs, dsum, sin, cos,
                                      heads: int, dim_head: int,
                                      scale: float):
    """``divided_attention_backward_float32_route`` of the space axis
    computed from the pre-pass's scratch, gs and dsum
    (``space_backward_prepass_reference``'s, or the kernel's) instead of
    from qkv: dqkv [BF, N, 3·H·dh] float32, heads of 32 to 128 dims. Equal
    to the route bit for bit where the scratch holds the route's rounding
    points."""
    bf, n, _ = scratch.shape
    q, k, v = scratch.float().reshape(bf, n, 3, heads, dim_head).permute(
        2, 0, 3, 1, 4)
    gv = gs.float().reshape(bf, n, heads, dim_head).transpose(1, 2)
    return _space_adjoints(q, k, q, k, v, gv, dsum.float(), sin.float(),
                           cos.float(), scale)


def _backward(qkv, out, g, sin, cos, axis: str, heads: int, dim_head: int,
              scale: float, rounded: bool):
    if rounded and axis == "space":
        return _space_route(qkv, out, g, sin, cos, heads, dim_head, scale)
    b, f, n, _ = qkv.shape

    def split(t):  # [B,F,N,H*dh] -> [B,H,F,N,dh], time: [B,H,N,F,dh]
        t = t.float().reshape(b, f, n, heads, dim_head).permute(0, 3, 1, 2, 4)
        return t.transpose(2, 3) if axis == "time" else t

    def merge(t):  # inverse of split
        if axis == "time":
            t = t.transpose(2, 3)
        return t.permute(0, 2, 3, 1, 4).reshape(b, f, n, heads * dim_head)

    q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
    dout = split(g)
    sin, cos = sin.float(), cos.float()
    qr, kr = rotary.apply_rot_emb(q, k, sin, cos)
    qs = qr * scale
    gv = dout
    if rounded:
        qs, kr, v, gv = _bf16(qs), _bf16(kr), _bf16(v), _bf16(dout)
        s, dp = mma_products(qs, kr), mma_products(gv, v)
    else:
        s = torch.matmul(qs, kr.transpose(-1, -2))
        dp = torch.matmul(gv, v.transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    if rounded:
        # the time kernel holds whole rows: D from P and dP, not the output
        d = (p * dp).sum(-1, keepdim=True)
    else:
        d = (dout * split(out)).sum(-1, keepdim=True)
    ds = p * (dp - d)
    if rounded:
        p, ds = _bf16(p), _bf16(ds)
    dv = torch.matmul(p.transpose(-1, -2), gv)
    dq = rotary_transpose(torch.matmul(ds, kr) * scale, sin, cos)
    dk = rotary_transpose(torch.matmul(ds.transpose(-1, -2), qs), sin, cos)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)


def divided_attention_backward_reference(qkv, out, g, sin, cos, axis: str,
                                         heads: int, dim_head: int,
                                         scale: float):
    """dqkv [B, F, N, 3·H·dh] float32 of ``divided_attention`` for the
    cotangent g [B, F, N, H·dh], from qkv, the forward's output ``out`` and
    the float32 rotary tables [seq, dh]; every step in float32."""
    return _backward(qkv, out, g, sin, cos, axis, heads, dim_head, scale,
                     rounded=False)


def divided_attention_backward_float32_route(qkv, out, g, sin, cos,
                                             axis: str, heads: int,
                                             dim_head: int, scale: float):
    """What the backward kernels compute, in plain PyTorch (the tests' and
    ``chip_smoke.py``'s oracle of their float32 route; never on the card's
    main path). Rounding points: q rotated and multiplied by ``scale`` in
    fp32 and rounded to bf16 once, k rotated and rounded once, v rounded
    once (the forward float32 route's); g rounded to bf16 as an operand of
    dP and dV; P and dS rounded to bf16 as product operands; the softmax, D
    and every product's sum in fp32. D is rowsum(g ∘ out) in fp32 for the
    space axis, summed in its pre-pass's order (``_kernel_rowsum``), and
    Σ P ∘ dP for the time axis, whose kernel holds whole rows. S and dP are summed as the tensor cores sum them
    (``flash_attention.mma_products``); at space head dims 2 and 4 the
    scores add the products of each operand's rounding with the other's
    bf16-rounded remainder (q~ and k~ split into hi + lo). Differs from the
    kernels by the order of the other fp32 sums and their ex2."""
    return _backward(qkv, out, g, sin, cos, axis, heads, dim_head, scale,
                     rounded=True)
