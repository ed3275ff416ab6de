"""One-pass attention over folded sequences (port of ``_onepass_kernel`` in
``moditalker_tpu/ops/pallas/flash_attention.py``).

Kernel (``csrc/flash_attention.cu``, sm_90a): mask-free attention on
[B, N, D] (heads folded into B) as an online-softmax ``mma.sync`` flash
kernel; the TPU kernel's full-row softmax over a VMEM-resident K/V does not
fit a Hopper block. Bound by operations. ``ops.attention.sdpa`` dispatches
here at the one-pass gate's shapes, as the JAX package's ``sdpa`` does on
the TPU; on the main path that is the UNet's joint attention after the last
upsample, [B·8, 2048, 32].

For tensors on the CPU the wrapper runs the plain version (the plain
``sdpa`` math); for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import plain_sdpa
from . import LAUNCHES, _build

# instantiated in csrc/flash_attention.cu: the head dims the repository's
# configurations reach (32 and 64); others raise on the card
_HEAD_DIMS = (32, 64)


def onepass_attention_viable(nq: int, nk: int, d: int) -> bool:
    """``onepass_attention_viable`` (flash_attention.py:194-199)."""
    return nq == nk and nq >= 1024 and nq % 256 == 0 and d % 8 == 0 and d <= 128


def onepass_attention_reference(q, k, v, scale: float):
    """The plain version (the JAX package's einsum path)."""
    return plain_sdpa(q * scale, k, v)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.onepass_attention.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
    lib.onepass_attention.restype = i
    return lib


def onepass_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q, k, v [B, N, D] bf16 → [B, N, D]."""
    b, n, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the one-pass kernel takes bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("the one-pass kernel is self-attention: q, k and v "
                         "must share one shape")
    if d not in _HEAD_DIMS:
        raise NotImplementedError(f"one-pass kernel built for head dims "
                                  f"{_HEAD_DIMS}, not {d}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel operands must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    status = lib.onepass_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, d,
        scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, status, "onepass_attention")
    LAUNCHES["onepass_attention"] += 1
    return out


def onepass_attention(q, k, v, scale: float):
    """Attention on [B, N, D] at a shape ``onepass_attention_viable``
    accepts."""
    if not q.is_cuda:
        return onepass_attention_reference(q, k, v, scale)
    return onepass_attention_cuda(q, k, v, float(scale))
