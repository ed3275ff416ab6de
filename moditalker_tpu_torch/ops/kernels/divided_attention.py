"""Divided space/time attention on packed qkv (port of
``moditalker_tpu/ops/pallas/divided_attention.py``).

Kernels (``csrc/divided_attention.cu``, sm_90a):

* space — replaces ``_space_kernel`` (``_space_fused``): per frame,
  attention over the N patch tokens with the axial rotary. Bound by
  operations, so both products run on ``wgmma`` (``csrc/wgmma_tile.cuh``):
  consumer warpgroups of 64 query rows with an online softmax (the TPU's
  full-row [N, N] score tile does not fit a Hopper block's shared memory),
  K rotated once per block into a swizzled tile, a producer warpgroup that
  keeps V copies in flight behind a ring, V read as the transposed operand.
  The tile's launcher keeps K resident (one block per (frame, head), three
  consumer warpgroups) where K fits in shared memory (N <= 1152) and runs a
  K ring (two consumers, the producer rotating) above that;
  ``rotary_pair_table`` packs the table to the half width the kernel reads.
* time — replaces ``_time_kernel`` (``_time_fused``): per patch, attention
  over the F frames with the time rotary. Bound by bytes: one warp per
  (b, n, head), 16-byte coalesced loads and stores through a per-warp
  shared buffer, the rotary applied on the way in from tables staged in
  shared memory, both products as ``mma.sync`` around a full-row softmax in
  registers (``csrc/tiny_tile.cuh``); each qkv element is read once.

Both read q/k/v straight from the packed ``[.., 3·H·dh]`` projection and
write the head-merged ``[.., H·dh]`` layout, with no transposes. For a
tensor on the CPU the wrapper runs the plain version
(``divided_attention_reference``); for a CUDA tensor it launches the kernel
or raises. At shapes the gate rejects it runs the plain head-split math, as
the JAX package runs XLA's there. A float32 qkv takes the float32 route of
``convert.py`` (bf16 operands, fp32 accumulators, a float32 result). The
gradient with respect to qkv recomputes through the plain version
(``autograd.py``), as the JAX package's ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .. import kernels, rotary
from ..attention import plain_sdpa, sdpa
from . import _build, convert, count_launch
from .autograd import RecomputeThroughPlain

_LANES = 128
# what csrc/divided_attention.cu is built for: the shapes the repository's
# configurations reach (AE dim_head 64, 16 frames); others raise on the card
SPACE_HEAD_DIMS = (64,)
TIME_SHAPES = ((16, 64),)   # (frames, head dim)

_pair_tables: dict = {}


def rotary_pair_table(sin, cos):
    """The table the space kernel reads: float32 [N, dh/2, 2] holding
    (cos, sin) of each rotated pair, so a 16-byte chunk of bf16 (four pairs)
    needs 32 contiguous bytes of table. The axial table repeats each entry
    over its pair (``rotary.axial_rotary_sincos``), which is what makes half
    the width enough; a table whose pair entries differ raises. Memoised on
    the table tensors (the model builds them once per shape)."""
    key = (sin.data_ptr(), cos.data_ptr(), tuple(sin.shape), sin.device)
    hit = _pair_tables.get(key)
    if hit is not None:
        return hit[0]
    if not (torch.equal(sin[:, 0::2], sin[:, 1::2])
            and torch.equal(cos[:, 0::2], cos[:, 1::2])):
        raise ValueError("the space kernel needs a rotary table that repeats "
                         "each entry over its pair, as the axial table does")
    table = torch.stack((cos[:, 0::2], sin[:, 0::2]), dim=-1).contiguous()
    if len(_pair_tables) >= 16:
        _pair_tables.clear()
    _pair_tables[key] = (table, sin, cos)   # keeps the keyed storage alive
    return table


def divided_attention_reference(qkv, sin, cos, axis: str, heads: int,
                                dim_head: int, scale: float,
                                use_flash: bool = True):
    """Transpose-based semantics of the fused kernels.

    qkv: [B, F, N, 3·H·dh] packed as [q|k|v] with heads contiguous inside
    each third; sin/cos: [seq, dh] float32 tables. Returns [B, F, N, H·dh].
    ``use_flash=False`` is the plain version of the kernels; ``True`` routes
    the head-split attention through ``sdpa``, whose gates mirror the JAX
    package's dispatch to its other Pallas kernels.
    """
    b, f, n, _ = qkv.shape
    q, k, v = qkv.chunk(3, dim=-1)

    def heads_split(t):  # [B,F,N,H*dh] -> [B,H,F,N,dh]
        return t.reshape(b, f, n, heads, dim_head).permute(0, 3, 1, 2, 4)

    q, k, v = heads_split(q), heads_split(k), heads_split(v)
    if axis == "time":
        q, k, v = (t.transpose(2, 3) for t in (q, k, v))
    q, k = rotary.apply_rot_emb(q, k, sin.to(qkv.dtype), cos.to(qkv.dtype))
    out = sdpa(q, k, v, scale=scale) if use_flash else plain_sdpa(q * scale, k, v)
    if axis == "time":
        out = out.transpose(2, 3)
    return out.permute(0, 2, 3, 1, 4).reshape(b, f, n, heads * dim_head)


def divided_attention_viable(axis: str, f: int, n: int, heads: int,
                             dim_head: int, rot_dim: int) -> bool:
    """Shape gate of the fused path (divided_attention.py:260-277): full
    head-dim rotary, head groups that tile 128 lanes, clean sequence
    tiling. ``MODITALKER_NO_DIVIDED_FUSED``, read at call time as the JAX
    gate reads it, closes the gate: the head-split attention then goes
    through ``sdpa`` (space → one-pass kernel, time → tiny-L kernel)."""
    if (os.environ.get("MODITALKER_NO_DIVIDED_FUSED")
            or rot_dim != dim_head or dim_head > _LANES or _LANES % dim_head != 0
            or (heads * dim_head) % _LANES != 0):
        return False
    if axis == "space":
        return n % 128 == 0 and 256 <= n <= 2048
    if axis == "time":
        return f % 8 == 0 and f <= 32 and n % 8 == 0
    return False


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("divided_attention")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.divided_space_attention.argtypes = [p, p, p, i, i, i, i, fl, p]
    lib.divided_space_attention.restype = i
    lib.divided_time_attention.argtypes = [p, p, p, p, i, i, i, i, i, fl, p]
    lib.divided_time_attention.restype = i
    return lib


def _operands(qkv, sin, cos):
    """qkv as the kernels read it (bf16, a float32 qkv cast by
    ``convert.to_bf16``) and whether the result goes back to float32."""
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the divided-attention kernels take bf16 or float32 "
                        f"qkv, got {qkv.dtype}")
    f32 = qkv.dtype == torch.float32
    if f32:
        qkv = convert.to_bf16(qkv)
    for t in (qkv, sin, cos):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
    if sin.dtype != torch.float32 or cos.dtype != torch.float32:
        raise TypeError("rotary tables must be float32")
    if sin.device != qkv.device or cos.device != qkv.device:
        raise ValueError("rotary tables must be on the device of qkv")
    return qkv, f32


def space_attention_cuda(qkv, sin, cos, heads: int, dim_head: int,
                         scale: float):
    """Kernel launch: qkv [BF, N, 3·H·dh] bf16 → [BF, N, H·dh] bf16 (float32
    through the cast passes → float32), N a multiple of 128 and at least
    256."""
    qkv, f32 = _operands(qkv, sin, cos)
    if dim_head not in SPACE_HEAD_DIMS:
        raise NotImplementedError(f"space kernel built for head dims "
                                  f"{SPACE_HEAD_DIMS}, not {dim_head}")
    bf, n, c3 = qkv.shape
    if c3 != 3 * heads * dim_head or tuple(sin.shape) != (n, dim_head):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} sin "
                         f"{tuple(sin.shape)} for {heads}x{dim_head}")
    if n % 128 or n < 256:
        raise ValueError(f"the space kernel takes N % 128 == 0, N >= 256, "
                         f"not {n}")
    table = rotary_pair_table(sin, cos)
    out = torch.empty(bf, n, heads * dim_head, dtype=qkv.dtype,
                      device=qkv.device)
    lib = _lib()
    status = lib.divided_space_attention(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), bf, n, heads,
        dim_head, scale, kernels.cuda_stream(qkv))
    _build.check(lib, status, "divided_space_attention")
    count_launch("divided_space_attention", qkv.shape)
    return convert.to_float32(out) if f32 else out


def time_attention_cuda(qkv, sin, cos, heads: int, dim_head: int,
                        scale: float):
    """Kernel launch: qkv [B, F, N, 3·H·dh] bf16 → [B, F, N, H·dh] bf16
    (float32 through the cast passes → float32)."""
    qkv, f32 = _operands(qkv, sin, cos)
    b, f, n, c3 = qkv.shape
    if (f, dim_head) not in TIME_SHAPES:
        raise NotImplementedError(f"time kernel built for (frames, head dim) "
                                  f"{TIME_SHAPES}, not {(f, dim_head)}")
    if c3 != 3 * heads * dim_head or tuple(sin.shape) != (f, dim_head):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} sin "
                         f"{tuple(sin.shape)} for {heads}x{dim_head}")
    out = torch.empty(b, f, n, heads * dim_head, dtype=qkv.dtype,
                      device=qkv.device)
    lib = _lib()
    status = lib.divided_time_attention(
        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(), b, f,
        n, heads, dim_head, scale, kernels.cuda_stream(qkv))
    _build.check(lib, status, "divided_time_attention")
    count_launch("divided_time_attention", qkv.shape)
    return convert.to_float32(out) if f32 else out


def divided_attention(qkv, sin, cos, axis: str, heads: int, dim_head: int,
                      scale: float):
    """Divided attention on packed qkv [B, F, N, 3·H·dh] → [B, F, N, H·dh].

    sin/cos: float32 [seq, dh] rotary tables on qkv's device (seq = N for
    ``axis='space'``, F for ``'time'``). Differentiable in qkv.
    """
    b, f, n, _ = qkv.shape
    if not divided_attention_viable(axis, f, n, heads, dim_head,
                                    sin.shape[-1]):
        return divided_attention_reference(qkv, sin, cos, axis, heads,
                                           dim_head, scale)
    scale = float(scale)

    def plain(t):
        return divided_attention_reference(t, sin, cos, axis, heads,
                                           dim_head, scale, use_flash=False)

    def forward(t):
        if not kernels.on_card(t):
            return plain(t)
        if axis == "space":
            out = space_attention_cuda(t.reshape(b * f, n, t.shape[-1]), sin,
                                       cos, heads, dim_head, scale)
            return out.reshape(b, f, n, heads * dim_head)
        return time_attention_cuda(t, sin, cos, heads, dim_head, scale)

    return RecomputeThroughPlain.apply(qkv, forward, plain)
