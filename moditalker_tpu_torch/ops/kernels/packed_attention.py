"""Packed multi-head self-attention for small head dims (port of
``moditalker_tpu/ops/pallas/packed_attention.py``).

Kernel (``csrc/packed_attention.cu``, sm_90a) — replaces ``_packed_kernel``
(``_packed_fused``): qkv [B, L, 3C] (q|k|v thirds, heads contiguous inside
each third — what the UNet's qkv Dense produces) → [B, L, C], dh = 16. The
TPU kernel isolates heads with lane masks; here a head is its 16-column
slice, read with strided offsets by ``csrc/smallhead_tile.cuh``: K and V
behind a ``cp.async`` ring, ``ldmatrix`` fragments for ``mma.sync``, an
online softmax over 128-key tiles; the launcher there picks the query rows
per block from the shape. Bound by operations at the main path's L = 1024
and 2048 (and held back by the softmax's ``ex2`` before that).

For a tensor on the CPU the wrapper runs the plain version
(``packed_attention_reference``); for a CUDA tensor it launches the kernel
or raises. At shapes the gate rejects it runs the plain head-split math, as
the JAX package runs XLA's there.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..attention import plain_sdpa, sdpa
from . import _build, count_launch

_LANES = 128
# instantiated in csrc/packed_attention.cu: the gate's head dim
PACKED_HEAD_DIMS = (16,)


def packed_attention_reference(qkv, heads: int, scale: float,
                               use_flash: bool = False):
    """Head-split semantics on packed qkv [B, L, 3C] → [B, L, C].
    ``use_flash=True`` routes the attention through ``sdpa`` (the gated
    dispatch of the JAX package), ``False`` is the kernel's plain version."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    q, k, v = qkv.chunk(3, dim=-1)

    def split(t):  # [B, L, C] -> [B, H, L, dh]
        return t.reshape(b, l, heads, dh).transpose(1, 2)

    if use_flash:
        out = sdpa(split(q), split(k), split(v), scale=scale)
    else:
        out = plain_sdpa(split(q) * scale, split(k), split(v))
    return out.transpose(1, 2).reshape(b, l, c)


def packed_attention_viable(l: int, c: int, heads: int) -> bool:
    """Shape gate (packed_attention.py:151-164): dh = 16, MIN_L <= L <= 4096,
    and K+V of one sequence within 4 MB. (The JAX gate also asks for a query
    block of its TPU kernel; with dh = 16 and the 4 MB bound that exists
    whenever L % 8 == 0.) Both switches are read at call time, as the JAX
    gate reads them: ``MODITALKER_PACKED_MIN_L`` (default 1024) moves the
    floor of L (512 admits the ds = 1 ytxt attention [2B, 512, 128]; the
    kernel takes any L), and ``MODITALKER_NO_PACKED_ATTN`` closes the gate:
    the head-split attention then goes through ``sdpa`` (one-pass kernel at
    dh = 16)."""
    if os.environ.get("MODITALKER_NO_PACKED_ATTN"):
        return False
    min_l = int(os.environ.get("MODITALKER_PACKED_MIN_L", "1024"))
    return (c % _LANES == 0 and c % heads == 0 and c // heads == 16
            and min_l <= l <= 4096 and l % 8 == 0
            and l * c * 2 * 2 <= 4 * 1024 * 1024)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.packed_attention.argtypes = [p, p, i, i, i, i, ctypes.c_float, p]
    lib.packed_attention.restype = i
    return lib


def packed_attention_cuda(qkv, heads: int, scale: float):
    """Kernel launch: qkv [B, L, 3C] bf16 → [B, L, C]."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the packed-attention kernel takes bf16 qkv, got "
                        f"{qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    b, l, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c % heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not q|k|v thirds of "
                         f"{heads} heads")
    if c // heads not in PACKED_HEAD_DIMS:
        raise NotImplementedError(f"packed kernel built for head dims "
                                  f"{PACKED_HEAD_DIMS}, not {c // heads}")
    out = torch.empty(b, l, c, dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    status = lib.packed_attention(
        qkv.data_ptr(), out.data_ptr(), b, l, heads, c // heads, scale,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, status, "packed_attention")
    count_launch("packed_attention", qkv.shape)
    return out


def packed_attention(qkv, heads: int, scale: float):
    """Multi-head self-attention on packed qkv [B, L, 3C] → [B, L, C]."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    if not packed_attention_viable(l, c, heads):
        return packed_attention_reference(qkv, heads, scale, use_flash=True)
    if not qkv.is_cuda:
        return packed_attention_reference(qkv, heads, scale)
    return packed_attention_cuda(qkv, heads, float(scale))
