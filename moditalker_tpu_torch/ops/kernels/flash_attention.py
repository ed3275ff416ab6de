"""One-pass, tiny-L and K-blocked fused attention over folded sequences
(port of ``moditalker_tpu/ops/pallas/flash_attention.py``).

Kernels (sm_90a), all on [B, N, D] bf16 with heads folded into B:

* one-pass (``csrc/flash_attention.cu``) — replaces ``_onepass_kernel``:
  mask-free self-attention with an online softmax; the TPU kernel's full-row
  softmax over a VMEM-resident K/V does not fit a Hopper block. At D = 16
  and 32 it runs on ``csrc/smallhead_tile.cuh`` (``mma.sync`` with
  ``ldmatrix`` fragments behind a ``cp.async`` ring, the packed kernel's
  tile), at D = 64 on ``csrc/wgmma_tile.cuh`` without the rotary (the space
  kernel's tile). Bound by operations. ``ops.attention.sdpa`` dispatches here
  at the one-pass gate's shapes, as the JAX package's ``sdpa`` does on the
  TPU: the UNet's joint attention after the last upsample, [B·8, 2048, 32],
  and, with the fused divided and packed kernels switched off, the
  TimeSformer space attention [B·8·16, 1024, 64] and the UNet's dh = 16
  attentions.
* tiny-L (``csrc/tiny_attention.cu``) — replaces ``_tiny_kernel``: one warp
  per sequence, both products as ``mma.sync`` around a full-row softmax in
  registers, 16-byte coalesced loads and stores. Bound by bytes. ``sdpa``
  dispatches here at the tiny gate's shapes: the TimeSformer time attention
  [B·8·1024, 16, 64] when the fused divided kernels are switched off.
* K-blocked fused (``csrc/flash_attention.cu``) — replaces ``_attn_kernel``:
  Nq query rows against Nk keys on the one-pass kernel's two tiles (the
  one-pass kernel is this one at Nq = Nk), with the ragged last query chunk
  and a key tile short of 128 masked in the kernel. Bound by operations.
  Reached through ``ops.attention.sdpa_fused`` only, as in the JAX package;
  no model calls it.

For tensors on the CPU a wrapper runs its plain version (the plain ``sdpa``
math); for CUDA tensors it launches the kernel or raises. The one-pass and
fused kernels also take float32 through the cast passes of ``convert.py``
(bf16 operands, fp32 accumulators, a float32 result); tiny-L takes bf16
only. The one-pass and tiny-L wrappers are differentiable, with the JAX
package's ``_flash_sdpa`` adjoints on recomputed float32 probabilities
(``autograd.FlashSdpa``); the fused kernel has no gradient, as in the JAX
package, and on the card raises where one is asked of it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..attention import plain_sdpa
from . import _build, convert, count_launch
from .autograd import FlashSdpa

# instantiated in csrc/: the shapes the repository's configurations reach
# (UNet attention at 128 and 256 model channels, AE dim_head 64, 16 frames);
# others raise on the card. HEAD_DIMS serves the one-pass and fused kernels.
HEAD_DIMS = (16, 32, 64)
TINY_SHAPES = ((16, 64),)   # (L, head dim)


def onepass_attention_viable(nq: int, nk: int, d: int) -> bool:
    """``onepass_attention_viable`` (flash_attention.py:194-199)."""
    return nq == nk and nq >= 1024 and nq % 256 == 0 and d % 8 == 0 and d <= 128


def onepass_attention_reference(q, k, v, scale: float):
    """The plain version of all three kernels (the JAX package's einsum
    path): q [B, Nq, D] over k, v [B, Nk, D]."""
    return plain_sdpa(q * scale, k, v)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_attention.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.fused_attention.restype = i
    return lib


def _operands(what: str, q, k, v, kv_shape, float32_ok: bool):
    """q, k, v as the kernel reads them (bf16, contiguous, 16-byte aligned;
    float32 cast by ``convert.to_bf16`` where ``float32_ok``) and whether
    the result goes back to float32."""
    dtypes = (torch.bfloat16, torch.float32) if float32_ok else (torch.bfloat16,)
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the {what} kernel takes "
                        f"{'bf16 or float32' if float32_ok else 'bf16'}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"the {what} kernel needs k and v of shape "
                         f"{kv_shape}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    f32 = q.dtype == torch.float32
    if f32:
        q, k, v = (convert.to_bf16(t) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel operands must be 16-byte aligned")
    return q, k, v, f32


def _attention_cuda(what: str, q, k, v, scale: float, nk: int):
    """The one-pass and the fused wrapper's checks and launch (the one-pass
    kernel is the fused one at Nq = Nk): q [B, Nq, D] over k, v [B, nk, D]
    bf16 → [B, Nq, D] bf16, or float32 → float32. Head dims as built; at
    64, above 1152 keys (where K streams through a ring instead of staying
    in shared memory) only whole 128-key tiles."""
    b, nq, d = q.shape
    q, k, v, f32 = _operands(what, q, k, v, (b, nk, d), float32_ok=True)
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"{what} kernel built for head dims "
                                  f"{HEAD_DIMS}, not {d}")
    if d == 64 and nk > 1152 and nk % 128:
        raise ValueError(f"at head dim 64 the {what} kernel takes more than "
                         f"1152 keys only in multiples of 128, not {nk}")
    out = torch.empty_like(q)
    lib = _lib()
    status = lib.fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk,
        d, scale, kernels.cuda_stream(q))
    _build.check(lib, status, f"{what} attention")
    return convert.to_float32(out) if f32 else out


def onepass_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q, k, v [B, N, D] bf16 or float32 → [B, N, D] of the
    same dtype."""
    out = _attention_cuda("one-pass", q, k, v, scale, q.shape[1])
    count_launch("onepass_attention", q.shape)
    return out


def _onepass_forward(q, k, v, scale: float):
    if not kernels.on_card(q):
        return onepass_attention_reference(q, k, v, scale)
    return onepass_attention_cuda(q, k, v, scale)


def onepass_attention(q, k, v, scale: float):
    """Attention on [B, N, D] at a shape ``onepass_attention_viable``
    accepts; differentiable in q, k and v."""
    return FlashSdpa.apply(q, k, v, float(scale), _onepass_forward)


# ------------------------------------------------------------------ tiny-L
def tiny_attention_viable(b: int, nq: int, nk: int, d: int) -> bool:
    """``tiny_attention_viable`` (flash_attention.py:180-186)."""
    return (nq == nk and nq <= 32 and nq % 8 == 0 and b >= 4096
            and b % 128 == 0 and d % 64 == 0 and d <= 128)


tiny_attention_reference = onepass_attention_reference  # the same plain math


@functools.cache
def _tiny_lib() -> ctypes.CDLL:
    lib = _build.load("tiny_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tiny_attention.argtypes = [p, p, p, p, ctypes.c_long, i, i,
                                   ctypes.c_float, p]
    lib.tiny_attention.restype = i
    return lib


def tiny_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q, k, v [B, L, D] bf16 → [B, L, D]."""
    b, l, d = q.shape
    q, k, v, _ = _operands("tiny-L", q, k, v, (b, l, d), float32_ok=False)
    if (l, d) not in TINY_SHAPES:
        raise NotImplementedError(f"tiny-L kernel built for (L, head dim) "
                                  f"{TINY_SHAPES}, not {(l, d)}")
    out = torch.empty_like(q)
    lib = _tiny_lib()
    status = lib.tiny_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, d,
        scale, kernels.cuda_stream(q))
    _build.check(lib, status, "tiny_attention")
    count_launch("tiny_attention", q.shape)
    return out


def _tiny_forward(q, k, v, scale: float):
    if not kernels.on_card(q):
        return tiny_attention_reference(q, k, v, scale)
    return tiny_attention_cuda(q, k, v, scale)


def tiny_attention(q, k, v, scale: float):
    """Attention on [B, L, D] at a shape ``tiny_attention_viable`` accepts;
    differentiable in q, k and v."""
    return FlashSdpa.apply(q, k, v, float(scale), _tiny_forward)


# ------------------------------------------------------------------ K-blocked
def fused_attention_tiles(nk: int, d: int) -> bool:
    """Whether the K-blocked kernel takes a key length and head dim
    (flash_attention.py:221-224): 8-aligned, and Nk a multiple of its
    128-wide (or, below 128, whole-sequence) key block."""
    return nk % 8 == 0 and d % 8 == 0 and nk % min(128, max(8, nk)) == 0


fused_attention_reference = onepass_attention_reference  # the same plain math


def fused_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q [B, Nq, D], k, v [B, Nk, D] bf16 or float32 →
    [B, Nq, D] of the same dtype. No gradient: raises where one is asked."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the fused kernel has no gradient (the JAX "
                           "package's sdpa_fused has no custom_vjp): call it "
                           "under torch.no_grad(), or use sdpa")
    b, nq, d = q.shape
    nk = k.shape[1]
    out = _attention_cuda("fused", q, k, v, scale, nk)
    count_launch("fused_attention", (b, nq, nk, d))
    return out


def fused_attention(q, k, v, scale: float | None = None):
    """Attention of q [B, Nq, D] over k, v [B, Nk, D] (heads folded into B);
    ``scale`` defaults to ``D**-0.5``.

    Where Nk does not tile (``fused_attention_tiles``) the JAX package takes
    its einsum path on the TPU as well, so such shapes take the plain math
    here on any device: that is the JAX dispatch, not a way around a kernel.
    At a shape that tiles, a CUDA tensor launches the kernel or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if (not fused_attention_tiles(k.shape[1], q.shape[-1])
            or not kernels.on_card(q)):
        return fused_attention_reference(q, k, v, scale)
    return fused_attention_cuda(q, k, v, float(scale))
