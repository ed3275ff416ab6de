"""One-pass, tiny-L and K-blocked fused attention over folded sequences
(port of ``moditalker_tpu/ops/pallas/flash_attention.py``).

Kernels (sm_90a), all on [B, N, D] bf16 or float32 with heads folded into
B:

* one-pass (``csrc/flash_attention.cu``) — replaces ``_onepass_kernel``:
  mask-free self-attention with an online softmax; the TPU kernel's full-row
  softmax over a VMEM-resident K/V does not fit a Hopper block. Which tile
  each head dim runs on: up to 32 ``csrc/smallhead_tile.cuh`` (``mma.sync``
  with ``ldmatrix`` fragments behind a ``cp.async`` ring, the packed
  kernel's tile: D = 16 and 32 in ``flash_attention.cu``, 8 and 24 on its
  classes 16 and 32); in bf16 at 40, 48 and 56 ``csrc/wgmma_narrow.cuh``
  (``csrc/flash_narrow.cu``: the D = 64 tile's plan at the head's own
  width, S in ceil(d / 16) k16 steps and P·V at n = d, the columns past d
  zeros in shared memory only); at 64 ``csrc/wgmma_tile.cuh`` without the
  rotary (the space kernel's tile: K resident up to 1152 keys, Q fragments
  in registers), in
  float32 at Nq = Nk with K resident from ``ONEPASS_F32_MIN_SEQS``
  sequences the float32 space kernel's ``csrc/resident_f32_tile.cuh``
  without its rotary (K and V rounded once per sequence, V into a scratch
  the wrapper allocates, two consumer warpgroups), and in float32 past
  resident K a pre-pass that rounds K and V to bf16 once per sequence into
  a scratch the wrapper allocates, then the tile's bf16 K ring on it
  (``onepass_f32_prerounded``);
  every other d % 8 == 0 above 32 that tile built per width
  (``csrc/wgmma_wide.cuh``, ``csrc/flash_wide.cu``: ``wgmma`` with Q in
  shared memory, K and V streamed, P·V at N = d). Bound by operations.
  ``ops.attention.sdpa`` dispatches here at the one-pass gate's shapes, as
  the JAX package's ``sdpa`` does on the TPU: the UNet's joint attention
  after the last upsample, [B·8, 2048, 32], and, with the fused divided and
  packed kernels switched off, the TimeSformer space attention
  [B·8·16, 1024, 64] and the UNet's dh = 16 attentions.
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
math); for CUDA tensors it launches the kernel or raises. All three also
take float32 (the trainers' and the golden record's), which their float32
entry points (``csrc/flash_attention_f32.cu``, ``csrc/tiny_attention_f32.cu``)
read and write themselves, with no cast pass around them: q multiplied by
the scale in fp32 and rounded to bf16 once, k and v rounded once, fp32
scores, max and sums, p rounded to bf16 for P·V, the result divided by the
fp32 row sum and stored as float32 (``attention_float32_route`` writes that
function out).

Every shape a gate admits launches a kernel. The configurations' head dims
(16, 32, 64; tiny-L at 16 rows of 64) are the instantiations of
``flash_attention{,_f32}.cu`` and ``tiny_attention{,_f32}.cu``; the rest of
the gates runs the same kernels built per class or per width: the one-pass
and fused kernels at 8 and 24 on the small-head tile's classes 16 and 32
(``flash_classes{,_f32}.cu``; the columns past d read as zeros, never
stored), in bf16 at 40, 48 and 56 on the narrow tile (``flash_narrow.cu``),
at every other d % 8 == 0 up to 256 but 64 on the wgmma tile built for
that width (``flash_wide{,_f32}.cu``), and past 256 (the fused gate has no
upper bound on d) on its 256-column tile in groups of output columns, each
group summing the scores over all of d; tiny-L at 8, 24 and 32 rows (the row
classes 16 and 32, padded rows masked) and at head dim 128
(``flash_classes{,_f32}.cu``). The one-pass and tiny-L wrappers are
differentiable, with the JAX package's ``_flash_sdpa`` adjoints on
recomputed float32 probabilities (``autograd.FlashSdpa``); the fused kernel
has no gradient, as in the JAX package, and on the card raises where one is
asked of it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..attention import plain_sdpa
from . import _build, count_launch
from .autograd import FlashSdpa

# instantiated in flash_attention{,_f32}.cu and tiny_attention{,_f32}.cu:
# the shapes the repository's configurations reach (UNet attention at 128
# and 256 model channels, AE dim_head 64, 16 frames); every other shape the
# gates admit runs the classes of flash_classes{,_f32}.cu or the widths of
# flash_wide{,_f32}.cu. HEAD_DIMS serves the one-pass and fused kernels.
HEAD_DIMS = (16, 32, 64)
TINY_SHAPES = ((16, 64),)   # (L, head dim)
# the small-head tile's head-dim classes (the divided space and time
# classes); of them the one-pass and fused kernels run on
# FUSED_HEAD_DIM_CLASSES (flash_classes.cu's launch_fused_classes) for
# every d up to SMALLHEAD_MAX_DIM
HEAD_DIM_CLASSES = (16, 32, 64, 128)
FUSED_HEAD_DIM_CLASSES = (16, 32)
SMALLHEAD_MAX_DIM = 32
# bf16 at these widths runs the narrow tile (csrc/wgmma_narrow.cuh, the
# entry point NARROW_ENTRY in flash_narrow.cu), at each width where paired
# runs (class, narrow, narrow, class in one call, tools/ab_classes.py
# --narrow, H100 80GB HBM3, 700 W) read it faster than the small-head
# class 64 it replaced; float32 takes the wgmma tile built per width
NARROW_HEAD_DIMS = (40, 48, 56)
NARROW_ENTRY = "fused_attention_narrow"
# the wgmma tile built per width (flash_wide.cu's launch_fused_wide): every
# d % 8 == 0 from 40 to 256 but 64 in float32, the same but
# NARROW_HEAD_DIMS in bf16; wider heads run the WIDE_GROUP-column tile in
# groups of output columns, each group summing S over all of d
WIDE_HEAD_DIMS = tuple(d for d in range(40, 257, 8) if d != 64)
WIDE_GROUP = 256
TINY_ROWS = (8, 16, 24, 32)
TINY_HEAD_DIMS = (64, 128)
# at head dim 64, K stays resident in shared memory up to 9 tiles of 128
# keys; above that it streams through a ring that takes whole tiles only
RESIDENT_KEYS_D64 = 1152
# the sequences from which float32 q, k, v at head dim 64 with Nq = Nk and
# K resident run the float32 resident-K kernel (csrc/resident_f32_tile.cuh,
# which takes a V scratch) rather than the wgmma tile's float32 route
# (``onepass_f32_own_kernel``), by length: where it read faster on an H100
# (tools/ab_space_f32.py --onepass --gate; PERF.md). At the one-pass gate's
# only resident-K length, 1024, from 192 sequences (72 to 128 read 0.98x to
# 1.02x the route in two calls: no faster); no other length was measured,
# so the route takes every length not listed
ONEPASS_F32_MIN_SEQS = {1024: 192}
# float32 q, k, v at head dim 64 past resident K: where the pre-pass that
# rounds K and V to bf16 once per sequence, then the bf16 K ring
# (PREROUNDED_ENTRY), read faster than the wgmma tile's float32 route, whose
# producer rounds K and V once per block of 128 query rows
# (``onepass_f32_prerounded``; tools/ab_space_f32.py --onepass --gate on an
# H100, PERF.md). The pre-pass reads K and V once and writes half as much;
# the route reads them once per query block. So the kernel from
# PREROUNDED_MIN_BLOCKS query blocks a sequence (Nq > 384: 0.85x the route
# at [128, 512] over 2048 keys, every one-pass length 0.66-0.93x), and at
# fewer where B·Nk is at most PREROUNDED_MAX_KEYS, so that the pre-pass is
# short and each block's time rules (0.90x at [2, 300] over 1280 keys, 0.97x
# at [16, 128] over 2048); the route with fewer blocks over more keys
# (1.11-1.60x at [128 | 512 | 1280, 64 | 128 | 256] over 2048 keys)
PREROUNDED_ENTRY = "fused_attention_f32_prerounded"
PREROUNDED_MIN_BLOCKS = 4
PREROUNDED_MAX_KEYS = 16 * 2048
_RING_ROWS = 128            # query rows per block of the K ring
_KEY_TILE = 128             # keys per tile of the kernels' online softmax
_LOG2E = 1.4426950408889634  # the kernels' kLog2e (held in fp32)
# how the tensor cores sum bf16 products into an fp32 accumulator (mma.sync
# m16n8k16 and wgmma k16 alike): per step of 16 products, those products,
# exact, and the accumulator aligned to the largest of them and cut to
# _MMA_BITS bits below its leading one, summed, the sum rounded to fp32
# toward zero (read off an H100's kernels: this sum reproduces their
# scores where a plain fp32 or exact sum does not, tools/mma_sum.py)
_MMA_K = 16
_MMA_BITS = 26
_MMA_CHUNK = 1 << 22        # elements of a [.., M, N, 17] step at a time


def _round_to_zero32(x):
    """float64 ``x`` rounded to float32 toward zero (as float64)."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)),
                       r).double()


def mma_products(a, b):
    """a [..., M, K] · b [..., N, K]ᵀ → [..., M, N] float32, each entry summed
    as the tensor cores sum bf16 operands (``_MMA_K``, ``_MMA_BITS``): the
    score sums of the kernels' float32 route, which a float32 ``matmul``
    (another order, rounded to nearest) misses by an ulp often enough to
    move a p across its bf16 rounding boundary. a and b hold bf16 values."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    m, n, kd = a.shape[-2], b.shape[-2], a.shape[-1]
    a = a.expand(*lead, m, kd).reshape(-1, m, kd).double()
    b = b.expand(*lead, n, kd).reshape(-1, n, kd).double()
    out = torch.empty(a.shape[0], m, n, dtype=torch.float32, device=a.device)
    step = n * (_MMA_K + 1)       # elements a row of a adds to a step
    rows = max(1, min(m, _MMA_CHUNK // step))
    seqs = max(1, _MMA_CHUNK // (m * step)) if rows == m else 1
    for i in range(0, a.shape[0], seqs):
        for r in range(0, m, rows):
            x, y = a[i:i + seqs, r:r + rows], b[i:i + seqs]
            acc = torch.zeros(x.shape[0], x.shape[1], n, dtype=torch.float64,
                              device=a.device)
            for c in range(0, kd, _MMA_K):
                terms = torch.cat(
                    [acc[..., None],
                     x[:, :, None, c:c + _MMA_K] * y[:, None, :, c:c + _MMA_K]],
                    dim=-1)
                _, e = torch.frexp(terms.abs().amax(dim=-1, keepdim=True))
                ulp = torch.ldexp(torch.ones_like(terms[..., :1]),
                                  e - _MMA_BITS)
                acc = _round_to_zero32((torch.trunc(terms / ulp) * ulp).sum(-1))
            out[i:i + seqs, r:r + rows] = acc.float()
    return out.reshape(*lead, m, n)


def onepass_attention_viable(nq: int, nk: int, d: int) -> bool:
    """``onepass_attention_viable`` (flash_attention.py:194-199)."""
    return nq == nk and nq >= 1024 and nq % 256 == 0 and d % 8 == 0 and d <= 128


def onepass_attention_reference(q, k, v, scale: float):
    """The plain version of all three kernels (the JAX package's einsum
    path): q [B, Nq, D] over k, v [B, Nk, D]."""
    return plain_sdpa(q * scale, k, v)


def key_tile(d: int) -> int:
    """Keys per tile of the kernels' online softmax at head dim ``d``: 128,
    and 64 on the wide tile past 128 (where S shares a thread's registers
    with more than 64 of O)."""
    return _KEY_TILE if d <= 128 else _KEY_TILE // 2


def attention_float32_route(q, k, v, scale: float, exp2: bool = False):
    """What the kernels' float32 route computes, in plain PyTorch: the
    function their float32 results are held to (by the tests and
    ``chip_smoke.py``; never on the card's main path).

    q [..., Nq, D], k, v [..., Nk, D] float32 → [..., Nq, D] float32.
    Rounding points: q multiplied by ``scale`` in fp32 and rounded to bf16
    once; k and v rounded once; the scores, their max and the row sums in
    fp32; p rounded to bf16 for P·V; the result divided by the row sum in
    fp32 and kept float32. The softmax is the kernels' online one: the keys
    are taken in tiles of ``key_tile(D)`` in order, each tile's p is taken
    against the running max and rounded to bf16 there, and what the earlier
    tiles summed is rescaled in fp32 (one tile up to 128 keys: tiny-L's
    full-row softmax). The scores are summed as the tensor cores sum them
    (``mma_products``). It differs from the float32 plain version by those
    roundings (bf16 operands with fp32 accumulators), and from the kernels
    by the order of the other fp32 sums and, unless ``exp2``, the kernels'
    ``ex2``.

    ``exp2``: p and the factor that rescales the earlier tiles as the
    one-pass and fused kernels take them, 2^(s·log2e − m·log2e) with
    log2e and m·log2e in fp32 and the rest rounded once (the kernels'
    ``fmaf``), and 2^((m_old − m)·log2e); in place of exp(s − m), the form
    tiny-L and the time kernel take. The wgmma tile built per width
    agrees with this form row for row, to fp32 rounding, where with
    ``exp`` a p now and then lands on the other side of a bf16 rounding
    boundary and moves its output row (``tools/mma_sum.py --wide``)."""
    q = (q.float() * scale).bfloat16().float()
    k, v = k.float().bfloat16().float(), v.float().bfloat16().float()
    s = mma_products(q, k)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=s.device)
    row_sum = torch.zeros_like(m)
    out = torch.zeros(s.shape[:-1] + v.shape[-1:], device=q.device)
    tile = key_tile(q.shape[-1])
    log2e = torch.tensor(_LOG2E, dtype=torch.float32, device=s.device)
    for j in range(0, s.shape[-1], tile):
        s_j = s[..., j:j + tile]
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        if exp2:
            alpha = torch.exp2((m - m_new) * log2e)
            p = torch.exp2((s_j.double() * log2e.double()
                            - (m_new * log2e).double()).float())
        else:
            alpha = torch.exp(m - m_new)
            p = torch.exp(s_j - m_new)
        row_sum = row_sum * alpha + p.sum(dim=-1, keepdim=True)
        out = out * alpha + torch.matmul(p.bfloat16().float(),
                                         v[..., j:j + tile, :])
        m = m_new
    return out / row_sum


def _bind(lib: ctypes.CDLL, suffix: str, tiny: bool = False) -> ctypes.CDLL:
    """Binds the entry point of ``lib``; the float32 one of
    ``flash_attention_f32.cu`` also takes the V scratch (or null), and that
    library's ``fused_attention_f32_prerounded`` the K and V scratch."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if tiny:
        names = ["tiny_attention" + suffix]
        argtypes = [p, p, p, p, ctypes.c_long, i, i, fl, p]
    else:
        names = ["fused_attention" + suffix] + (
            [PREROUNDED_ENTRY] if suffix == "_f32" else [])
        argtypes = [p] * (5 if suffix == "_f32" else 4) + [i, i, i, i, fl, p]
    for name in names:
        entry = getattr(lib, name)
        entry.argtypes, entry.restype = argtypes, i
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("flash_attention"), "")


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    """The float32 entry point, built apart (``csrc/flash_attention_f32.cu``)
    so that the bf16 kernels' translation unit holds no float32
    instantiation."""
    return _bind(_build.load("flash_attention_f32"), "_f32")


@functools.cache
def _classes_lib() -> ctypes.CDLL:
    """The bf16 classes beyond the configurations' shapes, one-pass / fused
    and tiny-L (``csrc/flash_classes.cu``), a library of their own."""
    return _bind(_bind(_build.load("flash_classes"), "_classes"), "_classes",
                 tiny=True)


@functools.cache
def _classes_lib_f32() -> ctypes.CDLL:
    """The float32 classes (``csrc/flash_classes_f32.cu``)."""
    return _bind(_bind(_build.load("flash_classes_f32"), "_classes_f32"),
                 "_classes_f32", tiny=True)


@functools.cache
def _wide_lib() -> ctypes.CDLL:
    """The one-pass and fused kernels above 56 but 64, bf16, on the wgmma
    tile built per width (``csrc/flash_wide.cu``), a library of its own."""
    return _bind(_build.load("flash_wide"), "_wide")


@functools.cache
def _wide_lib_f32() -> ctypes.CDLL:
    """The same in float32 above 32 but 64 (``csrc/flash_wide_f32.cu``)."""
    return _bind(_build.load("flash_wide_f32"), "_wide_f32")


@functools.cache
def _narrow_lib() -> ctypes.CDLL:
    """The one-pass and fused kernels at 40, 48 and 56, bf16, on the
    narrow tile (``csrc/flash_narrow.cu``), a library of its own."""
    return _bind(_build.load("flash_narrow"), "_narrow")


_SUFFIXES = {"flash_attention": "", "flash_classes": "_classes",
             "flash_wide": "_wide", "flash_narrow": "_narrow"}


def attention_source(d: int, f32: bool = False) -> str:
    """The source (``csrc/<name>.cu``; its float32 entry point in
    ``<name>_f32.cu``) of the kernel the one-pass and fused wrappers launch
    at head dim ``d`` (d % 8 == 0), bf16 or float32: the configurations'
    instantiations, the small-head classes up to 32, in bf16 the narrow
    tile at NARROW_HEAD_DIMS, the wgmma tile built per width above."""
    if d in HEAD_DIMS:
        return "flash_attention"
    if d <= SMALLHEAD_MAX_DIM:
        return "flash_classes"
    if not f32 and d in NARROW_HEAD_DIMS:
        return "flash_narrow"
    return "flash_wide"


def _library(d: int, f32: bool) -> tuple[ctypes.CDLL, str]:
    """The library and entry point of the one-pass and fused kernels at
    head dim ``d``."""
    suffix = _SUFFIXES[attention_source(d, f32)] + ("_f32" if f32 else "")
    lib = {"": _lib, "_f32": _lib_f32, "_classes": _classes_lib,
           "_classes_f32": _classes_lib_f32, "_wide": _wide_lib,
           "_narrow": _narrow_lib,
           "_wide_f32": _wide_lib_f32}[suffix]()
    return lib, "fused_attention" + suffix


def _operands(what: str, q, k, v, kv_shape):
    """q, k, v as the kernel reads them (bf16 or float32, each read in its
    own type; contiguous, 16-byte aligned) and whether they are float32."""
    if (q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"the {what} kernel takes bf16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"the {what} kernel needs k and v of shape "
                         f"{kv_shape}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel operands must be 16-byte aligned")
    return q, k, v, q.dtype == torch.float32


def onepass_f32_own_kernel(b: int, nq: int, nk: int) -> bool:
    """Whether float32 q, k, v at head dim 64, [B, Nq, 64] over [B, Nk, 64],
    run the float32 resident-K kernel (``csrc/resident_f32_tile.cuh``, which
    takes the V scratch) rather than the wgmma tile's float32 route (which
    takes none): the one place that chooses, by passing the scratch or not.
    Nq = Nk at a length of ``ONEPASS_F32_MIN_SEQS``, from its sequences."""
    least = ONEPASS_F32_MIN_SEQS.get(nq)
    return nq == nk and least is not None and b >= least


def onepass_f32_scratch(b: int, n: int, device):
    """The float32 resident-K kernel's V scratch, allocated
    (``torch.empty``) for one call: bf16 [B, N, 64], a slot per sequence,
    into which its block rounds V once and from which it copies V in every
    round."""
    return torch.empty(b, n, 64, dtype=torch.bfloat16, device=device)


def onepass_f32_prerounded(b: int, nq: int, nk: int) -> bool:
    """Whether float32 q, k, v at head dim 64, [B, Nq, 64] over [B, Nk, 64],
    run the pre-pass that rounds K and V to bf16 once per sequence and the
    wgmma tile's bf16 K ring on its scratch (the entry point
    ``fused_attention_f32_prerounded``) rather than the wgmma tile's
    float32 route, whose producer rounds every K and V tile again in each
    of a sequence's blocks: the one place that chooses. Past resident K
    (``RESIDENT_KEYS_D64``), from ``PREROUNDED_MIN_BLOCKS`` blocks of 128
    query rows a sequence (every one-pass length there), or over at most
    ``PREROUNDED_MAX_KEYS`` keys in all."""
    blocks = -(-nq // _RING_ROWS)
    return nk > RESIDENT_KEYS_D64 and (blocks >= PREROUNDED_MIN_BLOCKS
                                       or b * nk <= PREROUNDED_MAX_KEYS)


def onepass_f32_kv_scratch(b: int, nk: int, device):
    """The pre-pass's scratch, allocated (``torch.empty``) for one call:
    bf16 [2, B, Nk, 64], K then V rounded once."""
    return torch.empty(2, b, nk, 64, dtype=torch.bfloat16, device=device)


def prerounded_kv_reference(k, v):
    """The plain version of the pre-pass: k, v [B, Nk, 64] float32 rounded
    to bf16 once (to nearest) → the scratch [2, B, Nk, 64] bf16."""
    return torch.stack([k.bfloat16(), v.bfloat16()])


def attention_float32_route_from_scratch(q, kv, scale: float,
                                         exp2: bool = False):
    """``attention_float32_route`` on float32 q and the pre-pass's scratch
    kv [2, B, Nk, 64] bf16: what the K-ring kernel computes from it."""
    return attention_float32_route(q, kv[0].float(), kv[1].float(), scale,
                                   exp2)


def _attention_cuda(what: str, q, k, v, scale: float, nk: int):
    """The one-pass and the fused wrapper's checks and launch (the one-pass
    kernel is the fused one at Nq = Nk): q [B, Nq, D] over k, v [B, nk, D]
    bf16 → [B, Nq, D] bf16, or float32 → float32 (the float32 entry point).
    D % 8 == 0; at 64 (and on the narrow tile, bf16 at 40, 48 and 56),
    above 1152 keys (where K streams through a ring instead of staying in
    shared memory) only whole 128-key tiles. The
    float32 entry point at 64 takes the V scratch (``onepass_f32_scratch``)
    where ``onepass_f32_own_kernel`` takes its own kernel, a null pointer
    (the wgmma tile's float32 route) elsewhere; past resident K, where
    ``onepass_f32_prerounded`` takes it, ``fused_attention_f32_prerounded``
    takes the K and V scratch (``onepass_f32_kv_scratch``) instead; this
    allocates each. Returns the output, whether it is float32 and the entry
    point launched ("+ V scratch" where it was given one)."""
    b, nq, d = q.shape
    q, k, v, f32 = _operands(what, q, k, v, (b, nk, d))
    if d % 8 or d < 8:
        raise ValueError(f"the {what} kernel takes head dims d % 8 == 0, not "
                         f"{d}")
    lib, entry = _library(d, f32)
    if ((d == 64 or entry == NARROW_ENTRY) and nk > RESIDENT_KEYS_D64
            and nk % _KEY_TILE):
        raise ValueError(f"at head dim {d} the {what} kernel takes more than "
                         f"{RESIDENT_KEYS_D64} keys only in multiples of "
                         f"{_KEY_TILE}, not {nk}")
    out = torch.empty_like(q)
    pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    own, scratch = False, None
    if entry == "fused_attention_f32":
        if d == 64 and onepass_f32_prerounded(b, nq, nk):
            entry = PREROUNDED_ENTRY
            scratch = onepass_f32_kv_scratch(b, nk, q.device)
        elif d == 64 and onepass_f32_own_kernel(b, nq, nk):
            own, scratch = True, onepass_f32_scratch(b, nk, q.device)
        pointers.append(None if scratch is None else scratch.data_ptr())
    status = getattr(lib, entry)(
        *pointers, out.data_ptr(), b, nq, nk, d, scale, kernels.cuda_stream(q))
    _build.check(lib, status, f"{what} attention ({entry})")
    return out, f32, entry + (" + V scratch" if own else "")


def onepass_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q, k, v [B, N, D] bf16 or float32 → [B, N, D] of the
    same dtype."""
    out, f32, entry = _attention_cuda("one-pass", q, k, v, scale, q.shape[1])
    count_launch("onepass_attention", q.shape, float32=f32, entry=entry)
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
    return _bind(_build.load("tiny_attention"), "", tiny=True)


@functools.cache
def _tiny_lib_f32() -> ctypes.CDLL:
    """The float32 entry point, built apart (``csrc/tiny_attention_f32.cu``)."""
    return _bind(_build.load("tiny_attention_f32"), "_f32", tiny=True)


def tiny_attention_cuda(q, k, v, scale: float):
    """Kernel launch: q, k, v [B, L, D] bf16 or float32 → [B, L, D] of the
    same dtype; L in ``TINY_ROWS``, D in ``TINY_HEAD_DIMS``."""
    b, l, d = q.shape
    q, k, v, f32 = _operands("tiny-L", q, k, v, (b, l, d))
    if l not in TINY_ROWS or d not in TINY_HEAD_DIMS:
        raise ValueError(f"the tiny-L kernel takes L in {TINY_ROWS} and head "
                         f"dims {TINY_HEAD_DIMS}, not {(l, d)}")
    out = torch.empty_like(q)
    if (l, d) in TINY_SHAPES:
        lib = _tiny_lib_f32() if f32 else _tiny_lib()
        entry = "tiny_attention" + ("_f32" if f32 else "")
    else:
        lib = _classes_lib_f32() if f32 else _classes_lib()
        entry = "tiny_attention_classes" + ("_f32" if f32 else "")
    status = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, d,
        scale, kernels.cuda_stream(q))
    _build.check(lib, status, entry)
    count_launch("tiny_attention", q.shape, float32=f32, entry=entry)
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
    out, f32, entry = _attention_cuda("fused", q, k, v, scale, nk)
    count_launch("fused_attention", (b, nq, nk, d), float32=f32, entry=entry)
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
