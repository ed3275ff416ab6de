"""The float32 route of the attention kernels: cast passes in front of and
behind a bf16 kernel (``csrc/convert.cu``, sm_90a).

The JAX trainers build their models in float32, and the Pallas kernels run
their products in the input dtype. The port's kernels keep bf16 operands
with fp32 accumulators, which is what a float32 dot costs at JAX's default
precision on a TPU, so a float32 operand is cast to bf16 on its way in and
the result back to float32 on its way out. The tiles copy raw bytes with
``cp.async`` and cannot convert in flight; hence one hand-written pass on
each side, bound by bytes. Their launches are not counted apart: they serve
the kernel whose wrapper calls them, and their time counts in its row.

These run only on CUDA tensors; a wrapper given a CPU tensor runs its plain
version in the tensor's own dtype and never gets here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from . import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("convert")
    p = ctypes.c_void_p
    for name in ("convert_f32_to_bf16", "convert_bf16_to_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ctypes.c_long, p]
        fn.restype = ctypes.c_int
    return lib


def _cast(t, src: torch.dtype, dst: torch.dtype, entry: str):
    if t.dtype != src:
        raise TypeError(f"{entry} takes {src}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    if t.numel() % 8:
        raise ValueError(f"{entry} takes a multiple of 8 elements, not "
                         f"{t.numel()}")
    out = torch.empty(t.shape, dtype=dst, device=t.device)
    lib = _lib()
    status = getattr(lib, entry)(t.data_ptr(), out.data_ptr(), t.numel(),
                                 kernels.cuda_stream(t))
    _build.check(lib, status, entry)
    return out


def to_bf16(t):
    """float32 CUDA tensor → a contiguous bf16 copy (round to nearest)."""
    return _cast(t, torch.float32, torch.bfloat16, "convert_f32_to_bf16")


def to_float32(t):
    """bf16 CUDA tensor → a contiguous float32 copy (exact)."""
    return _cast(t, torch.bfloat16, torch.float32, "convert_bf16_to_f32")
