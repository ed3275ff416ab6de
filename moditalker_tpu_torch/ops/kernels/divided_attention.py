"""Divided space/time attention on packed qkv (port of
``moditalker_tpu/ops/pallas/divided_attention.py``).

Kernels (``csrc/divided_attention.cuh``, sm_90a; the bf16 entry points in
``divided_attention.cu``, the float32 ones in ``divided_attention_f32.cu``):

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
  Float32 qkv at head dim 64 with K resident has a kernel of its own
  (``csrc/resident_f32_tile.cuh``), the same tile's products and softmax:
  every thread of a block rotates K and rounds V to bf16 once before the
  roles split, V into a scratch slot the wrapper allocates
  (``space_f32_scratch``) from which every round copies it, and two
  consumer warpgroups of 64 rows walk the rounds; or a cluster of two
  blocks per pair (``SPACE_F32_CLUSTER_ENTRY``), each rotating half of K
  into both blocks' shared memory and walking every other round, so that
  64 pairs (8-frame clips) fill the card in one wave. Each plan runs where
  it read faster than the other and than the tile's float32 route
  (``space_f32_own_kernel``; at the configurations' 1024 tokens the
  cluster from 64 pairs), which runs elsewhere.
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
the JAX package runs XLA's there. A float32 qkv (the trainers' and the
golden record's) takes each kernel's float32 route, which reads float32 and
writes float32 itself, with no cast pass around it: q rotated and scaled in
fp32 and rounded to bf16 once, k rotated and rounded once, v rounded once,
bf16 operands with fp32 accumulators, the result divided by the fp32 row
sum and stored as float32 (``divided_attention_float32_route`` writes it
out).

Every shape the gate admits launches a kernel. The configurations' shapes
(space at head dim 64, time at 16 frames of head dim 64) are the
instantiations of ``divided_attention.cu`` and ``divided_attention_f32.cu``;
the rest of the gate runs the same kernels built per class in
``divided_classes.cu`` and ``divided_classes_f32.cu``: time at 16 frames
per head-dim class (16, 32, 64, 128), heads narrower than their class
padded with zeros; at clips of 8 frames (the frame class 16, padded frames
masked in the softmax, never stored) and of 24 and 32 (the frame class 32)
a kernel of its own (``csrc/time_staged.cuh``, entry point
``STAGED_TIME_ENTRY``): each warp copies its item's raw rows into shared
memory with ``cp.async`` and rotates them there, and warps walk items
grid-stride so that device memory stays busy while others compute (the
classes' arithmetic, so their output bit for bit). Space at head dims other
than 64, and in float32 at 64 past resident K (N > 1152), runs the
pre-rotated design
(``csrc/divided_space.cuh``): a pre-pass writes q rotated and scaled and k
rotated, in bf16, once per call into a scratch the wrapper allocates (v too
where the tile cannot read it from qkv; ``space_rotate_reference`` is its
plain version), then the small-head tile (head dims up to 32) or the wgmma
tile built per width (128, and 64 in float32) streams it raw. A head dim of
1 has no rotary pair: the JAX package's rotary raises there too.

The gradient with respect to qkv (``autograd.DividedAttention``) runs the
backward kernels on a CUDA tensor (``csrc/divided_backward.cuh``; bf16
entry points in ``divided_backward.cu``, float32 ones in
``divided_backward_f32.cu``, the head dims and clip lengths beyond the
configurations' in ``divided_backward_classes{,_f32}.cu``), which read qkv,
the forward's output and its cotangent and write the packed dqkv. Space at
head dims 32 to 128 is the forward's pre-rotated design carried over: a
pre-pass writes q~, k~ and v, and g, in bf16 into scratch the wrapper
allocates, with D = rowsum(g ∘ out) (``space_backward_prepass_reference``
is its plain version), then a dq kernel and a dk/dv kernel on ``wgmma``
stream it (N a multiple of 128 from 256); at 2 to 16 it runs on
``mma.sync``, which ran faster there: up to 1024 tokens one block per
(frame, head) with its operands resident, which works S out twice per score
(``SPACE_BACKWARD_RESIDENT_ENTRY``), where
``SPACE_BACKWARD_RESIDENT_MIN_PAIRS`` names it, else the earlier class
(three times). Time is one warp per (b, n, head); at clips of 8 frames two
items a warp's tile, staged by ``cp.async``
(``STAGED_TIME_BACKWARD_ENTRY``: the class's dqkv bit for bit). Every shape
the forward's gate admits has its backward; nothing falls back to the plain
version on the card. On a CPU tensor the backward is
``divided_backward.divided_attention_backward_reference``, the written-out
adjoints of the JAX package's ``jax.vjp`` of its reference.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .. import kernels, rotary
from ..attention import plain_sdpa, sdpa
from . import _build, count_launch
from .autograd import DividedAttention
from .divided_backward import divided_attention_backward_reference
from .flash_attention import attention_float32_route

_LANES = 128
# the instantiations of csrc/divided_attention.cu (and _f32, and of the
# backward's divided_backward.cu): the shapes the repository's
# configurations reach (AE dim_head 64, 16 frames). Every other shape the
# gate admits runs the libraries of csrc/divided_classes.cu (and
# divided_backward_classes.cu): time per frame class and head-dim class,
# space the pre-rotated design (csrc/divided_space.cuh) per head-dim class.
SPACE_HEAD_DIMS = (64,)
TIME_SHAPES = ((16, 64),)   # (frames, head dim)
# clips of 8 frames (the frame class 16) and of 24 and 32 (the frame class
# 32): the time kernel staged by cp.async (csrc/time_staged.cuh, in the
# classes' libraries under its own entry point), bf16 and float32
STAGED_TIME_FRAMES = (8, 24, 32)
STAGED_TIME_ENTRY = "divided_time_attention_staged"
# the float32 space kernel at head dim 64 (csrc/resident_f32_tile.cuh) keeps K
# resident in shared memory: 9 tiles of 128 keys (the configurations' AE
# reaches N = 1024); above that the float32 space attention at head dim 64
# is the pre-rotated design's (divided_classes_f32.cu)
SPACE_F32_MAX_N = 1152
# that kernel's cluster plan (two blocks per (frame, head)), an entry point
# of its own beside ``divided_space_attention_f32``
SPACE_F32_CLUSTER_ENTRY = "divided_space_attention_f32_cluster"
# the plan the float32 space attention at head dim 64 runs
# (``space_f32_own_kernel``), by length: (least (frame, head) pairs, plan)
# in rising order, the last one the pairs reach taking it ("cluster": the
# cluster plan, "block": one block per pair, None: the wgmma tile's float32
# route), the route below the first; where each read faster than the
# others on an H100 (tools/ab_space_f32.py --gate at 32 to 1280 pairs;
# PERF.md). At the configurations' 1024 tokens the cluster from 64 pairs
# (32 read 1.09x the route); a length not listed takes the route
SPACE_F32_PLANS = {256: ((64, "cluster"), (128, None)),
                   512: ((64, "cluster"), (128, None)),
                   896: ((1280, "cluster"),),
                   1024: ((64, "cluster"),),
                   1152: ((1280, "block"),)}
SPACE_BACKWARD_HEAD_DIMS = (64,)
# the space backward's launches in order, each an entry point of its
# library with its count of pointer arguments: the pre-pass (qkv, the pair
# table, out, g -> scratch, gs, dsum), then dq and dk/dv (scratch, gs,
# dsum, the pair table -> dqkv, stats)
SPACE_BACKWARD_STEPS = (("prepass", 7), ("dq", 6), ("dkdv", 6))
# head dims up to which the space backward runs on mma.sync (heads of 2 to
# 16 dims, where it ran faster than the wgmma design): one block per (frame,
# head) with q~, k~, v and g resident, S worked out twice per score
# (``SPACE_BACKWARD_RESIDENT_ENTRY``, csrc/divided_backward.cuh, up to 1024
# tokens), or the earlier class of a dq and a dk/dv kernel over 128-row
# blocks, S three times (``divided_space_attention_backward_classes``)
SPACE_BACKWARD_NARROW_MAX = 16
SPACE_BACKWARD_RESIDENT_ENTRY = "divided_space_attention_backward_resident"
# where the space backward at those head dims runs its resident plan
# (``space_backward_narrow_plan``): by length, the least (frame, head) pairs
# from which it read faster than the class at that count and every larger
# one, on an H100 in float32 and bf16 at 16 dims, the table
# tools/ab_space_backward.py --gate prints (N = 256 to 1024, 32 to 2048
# pairs; PERF.md). Fewer pairs, and a length not listed (past 1024 tokens
# the resident operands do not fit a block), take the class
SPACE_BACKWARD_RESIDENT_MIN_PAIRS = {384: 128, 512: 128, 640: 128, 768: 128,
                                     896: 128, 1024: 128}
# clips of 8 frames: the time backward staged by cp.async, two items a
# 16-row tile (csrc/time_staged_backward.cuh), an entry point of its own in
# the backward's classes' libraries; 16 frames keep the configurations' and
# the classes' kernel, 24 and 32 the class
STAGED_TIME_BACKWARD_FRAMES = (8,)
STAGED_TIME_BACKWARD_ENTRY = "divided_time_attention_backward_staged"

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


def space_scratch_width(dim_head: int) -> int:
    """The head width of the space pre-pass's scratch: whole 16-byte chunks
    of bf16 (heads of 2 and 4 padded to 8 with zeros)."""
    return max(dim_head, 8)


def space_rotate_reference(qkv, sin, cos, heads: int, dim_head: int,
                           scale: float):
    """The plain version of the space kernel's rotation pre-pass
    (``csrc/divided_space.cuh``): qkv [BF, N, 3·H·dh] (bf16 or float32) →
    the bf16 scratch [BF, N, 3·H·w] (w = ``space_scratch_width(dh)``, zeros
    past dh): q rotated in fp32 (each product and the sum rounded on its
    own), multiplied by ``scale`` and rounded to bf16 once, k rotated and
    rounded once, v rounded once. The kernel writes the v third only where
    the tile reads it from there (float32 qkv, heads narrower than 8)."""
    bf, n, _ = qkv.shape
    w = space_scratch_width(dim_head)
    q, k, v = (t.float().reshape(bf, n, heads, dim_head)
               for t in qkv.chunk(3, dim=-1))
    sin, cos = sin.float()[:, None], cos.float()[:, None]
    q = (q * cos + rotary.rotate_every_two(q) * sin) * scale
    k = k * cos + rotary.rotate_every_two(k) * sin
    out = torch.stack((q, k, v), dim=2)        # [BF, N, 3, H, dh]
    out = torch.nn.functional.pad(out, (0, w - dim_head))
    return out.bfloat16().reshape(bf, n, 3 * heads * w)


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


def divided_attention_float32_route(qkv, sin, cos, axis: str, heads: int,
                                    dim_head: int, scale: float,
                                    exp2: bool = False):
    """What the kernels' float32 route computes, in plain PyTorch: the
    function their float32 results are held to (by the tests and
    ``chip_smoke.py``; never on the card's main path).

    qkv [B, F, N, 3·H·dh] float32 → [B, F, N, H·dh] float32. Rounding points:
    q read as float32, rotated and multiplied by ``scale`` in fp32, rounded
    to bf16 once; k rotated in fp32 and rounded once; v rounded once; the
    scores, their max and the row sums in fp32; p rounded to bf16 for P·V;
    the result divided by the row sum in fp32 and kept float32. The softmax
    is the kernels' online one over 128-key tiles
    (``flash_attention.attention_float32_route``, from the rotated q and k
    on: one tile at F = 16, the time axis, a full-row softmax; the scores
    summed as the tensor cores sum them). It differs from the float32 plain
    version by those roundings (bf16 operands with fp32 accumulators), and
    from the kernels by the order of the other fp32 sums and, unless
    ``exp2``, the kernels' ``ex2`` (``exp2``: p and the rescaling factor as
    the space kernels take them, ``attention_float32_route``'s ``exp2``).
    """
    b, f, n, _ = qkv.shape
    q, k, v = qkv.float().chunk(3, dim=-1)

    def heads_split(t):  # [B,F,N,H*dh] -> [B,H,F,N,dh]
        return t.reshape(b, f, n, heads, dim_head).permute(0, 3, 1, 2, 4)

    q, k, v = heads_split(q), heads_split(k), heads_split(v)
    if axis == "time":
        q, k, v = (t.transpose(2, 3) for t in (q, k, v))
    q, k = rotary.apply_rot_emb(q, k, sin.float(), cos.float())
    out = attention_float32_route(q, k, v, scale, exp2=exp2)
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


def _bind_forward(lib: ctypes.CDLL, suffix: str) -> ctypes.CDLL:
    """Binds the space and time entry points of ``lib``; in the classes'
    libraries the space entry is the pre-rotated design's, in the float32
    library there is also the space kernel's cluster plan
    (``SPACE_F32_CLUSTER_ENTRY``). Every space entry but the bf16 one also
    takes a scratch (the pre-rotated design's, or the float32 kernel's V
    scratch)."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if suffix.startswith("_classes"):
        space = getattr(lib, "divided_space_attention_prerotated"
                        + suffix[len("_classes"):])
    else:
        space = getattr(lib, "divided_space_attention" + suffix)
    space.argtypes = [p] * (4 if suffix else 3) + [i, i, i, i, fl, p]
    space.restype = i
    if suffix == "_f32":
        cluster = getattr(lib, SPACE_F32_CLUSTER_ENTRY)
        cluster.argtypes, cluster.restype = space.argtypes, i
    names = ["divided_time_attention" + suffix]
    if suffix.startswith("_classes"):
        names.append(STAGED_TIME_ENTRY + suffix[len("_classes"):])
    for name in names:
        time = getattr(lib, name)
        time.argtypes = [p, p, p, p, i, i, i, i, i, fl, p]
        time.restype = i
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind_forward(_build.load("divided_attention"), "")


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    """The float32 entry points, built apart
    (``csrc/divided_attention_f32.cu``) so that the bf16 kernels'
    translation unit holds no float32 instantiation."""
    return _bind_forward(_build.load("divided_attention_f32"), "_f32")


@functools.cache
def _classes_lib() -> ctypes.CDLL:
    """The bf16 classes beyond the configurations' shapes
    (``csrc/divided_classes.cu``), a library of their own."""
    return _bind_forward(_build.load("divided_classes"), "_classes")


@functools.cache
def _classes_lib_f32() -> ctypes.CDLL:
    """The float32 classes (``csrc/divided_classes_f32.cu``)."""
    return _bind_forward(_build.load("divided_classes_f32"), "_classes_f32")


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernels' bf16 entry points (``csrc/divided_backward.cu``)."""
    return _bind_backward(_build.load("divided_backward"), "")


@functools.cache
def _bwd_lib_f32() -> ctypes.CDLL:
    """The backward kernels' float32 entry points, built apart
    (``csrc/divided_backward_f32.cu``)."""
    return _bind_backward(_build.load("divided_backward_f32"), "_f32")


@functools.cache
def _bwd_classes_lib() -> ctypes.CDLL:
    """The backward's bf16 classes (``csrc/divided_backward_classes.cu``)."""
    return _bind_backward(_build.load("divided_backward_classes"), "_classes")


@functools.cache
def _bwd_classes_lib_f32() -> ctypes.CDLL:
    """The backward's float32 classes
    (``csrc/divided_backward_classes_f32.cu``)."""
    return _bind_backward(_build.load("divided_backward_classes_f32"),
                          "_classes_f32")


def _bind_backward(lib: ctypes.CDLL, suffix: str) -> ctypes.CDLL:
    """Binds the backward's entry points of ``lib``; the classes'
    libraries also hold the narrow space backward's two plans and the
    staged time backward at 8 frames."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    time_args = [p, p, p, p, p, i, i, i, i, i, fl, p]
    if suffix.startswith("_classes"):
        narrow = getattr(lib, "divided_space_attention_backward" + suffix)
        narrow.argtypes = [p] * 6 + [i, i, i, i, fl, p]
        narrow.restype = i
        f32 = suffix[len("_classes"):]
        resident = getattr(lib, SPACE_BACKWARD_RESIDENT_ENTRY + f32)
        resident.argtypes = [p] * 5 + [i, i, i, i, fl, p]
        resident.restype = i
        staged = getattr(lib, STAGED_TIME_BACKWARD_ENTRY + f32)
        staged.argtypes, staged.restype = time_args, i
    for step, pointers in SPACE_BACKWARD_STEPS:
        entry = getattr(lib, f"divided_space_backward_{step}{suffix}")
        entry.argtypes = [p] * pointers + [i, i, i, i, fl, p]
        entry.restype = i
    time = getattr(lib, "divided_time_attention_backward" + suffix)
    time.argtypes, time.restype = time_args, i
    return lib


def _library(f32: bool, classes: bool, backward: bool = False):
    """The library and entry-point suffix of a launch: the configurations'
    instantiations or the classes beyond them, bf16 or float32."""
    suffix = ("_classes" if classes else "") + ("_f32" if f32 else "")
    if backward:
        libs = {"": _bwd_lib, "_f32": _bwd_lib_f32,
                "_classes": _bwd_classes_lib,
                "_classes_f32": _bwd_classes_lib_f32}
    else:
        libs = {"": _lib, "_f32": _lib_f32, "_classes": _classes_lib,
                "_classes_f32": _classes_lib_f32}
    return libs[suffix](), suffix


def _check_head_dim(dim_head: int) -> None:
    """The gate's head dims, 2 to 128 dividing 128 (a head dim of 1 has no
    rotary pair: the JAX package's rotary raises there as well)."""
    if dim_head < 2 or _LANES % dim_head:
        raise ValueError(f"the divided kernels take head dims dividing "
                         f"{_LANES} from 2 up (rotary pairs), not {dim_head}")


def _operands(qkv, sin, cos) -> bool:
    """Checks what the kernels read (qkv bf16 or float32, each read in its
    own type; float32 tables on qkv's device; all contiguous and 16-byte
    aligned); returns whether qkv is float32."""
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the divided-attention kernels take bf16 or float32 "
                        f"qkv, got {qkv.dtype}")
    for t in (qkv, sin, cos):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
    if sin.dtype != torch.float32 or cos.dtype != torch.float32:
        raise TypeError("rotary tables must be float32")
    if sin.device != qkv.device or cos.device != qkv.device:
        raise ValueError("rotary tables must be on the device of qkv")
    return qkv.dtype == torch.float32


def space_prerotated(dim_head: int, n: int, f32: bool) -> bool:
    """Whether the space kernel at head dim ``dim_head`` over ``n`` tokens
    is the pre-rotated design (``divided_space_attention_prerotated``):
    everywhere but the configurations' wgmma tile at 64 (in float32 up to
    resident K)."""
    return dim_head not in SPACE_HEAD_DIMS or (f32 and n > SPACE_F32_MAX_N)


def space_f32_own_kernel(bf: int, n: int, heads: int) -> str | None:
    """The plan of the space kernel of its own
    (``csrc/resident_f32_tile.cuh``, which takes the V scratch) that
    float32 qkv [BF, N, 3·H·64] with K resident runs: "block" (one block per
    (frame, head), ``divided_space_attention_f32`` with the scratch) or
    "cluster" (two, ``SPACE_F32_CLUSTER_ENTRY``); None for the wgmma tile's
    float32 route (``divided_space_attention_f32`` without a scratch). The
    one place that chooses, from ``SPACE_F32_PLANS``."""
    plan = None
    for least, name in SPACE_F32_PLANS.get(n, ()):
        if bf * heads >= least:
            plan = name
    return plan


def space_f32_scratch(bf: int, n: int, heads: int, device):
    """The float32 space kernel's V scratch (``csrc/resident_f32_tile.cuh``),
    allocated (``torch.empty``) for one call: bf16 [BF·H, N, 64], a slot per
    (frame, head), into which its block rounds V once and from which it
    copies V in every round."""
    return torch.empty(bf * heads, n, SPACE_HEAD_DIMS[0],
                       dtype=torch.bfloat16, device=device)


def space_attention_cuda(qkv, sin, cos, heads: int, dim_head: int,
                         scale: float):
    """Kernel launch: qkv [BF, N, 3·H·dh] → [BF, N, H·dh] in qkv's type
    (bf16 or float32), N a multiple of 128 and at least 256, dh dividing 128
    from 2 up. The pre-rotated design (``space_prerotated``) writes a bf16
    scratch [BF, N, 3·H·w] first (``space_rotate_reference``: its plain
    version), and the float32 kernel at head dim 64 writes its V scratch
    (``space_f32_scratch``) where ``space_f32_own_kernel`` takes it, one
    block or a cluster of two per (frame, head) (a null pointer runs the
    wgmma tile's float32 route); this allocates either. One launch in the
    count."""
    f32 = _operands(qkv, sin, cos)
    _check_head_dim(dim_head)
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
    pre = space_prerotated(dim_head, n, f32)
    own = f32 and not pre and space_f32_own_kernel(bf, n, heads)
    lib, suffix = _library(f32, pre)
    pointers = [qkv.data_ptr(), table.data_ptr()]
    entry = "divided_space_attention" + suffix
    if own == "cluster":
        entry = SPACE_F32_CLUSTER_ENTRY
    if pre:
        entry = "divided_space_attention_prerotated" + ("_f32" if f32 else "")
        scratch = torch.empty(bf, n, 3 * heads * space_scratch_width(
            dim_head), dtype=torch.bfloat16, device=qkv.device)
        pointers.append(scratch.data_ptr())
    elif own:
        scratch = space_f32_scratch(bf, n, heads, qkv.device)
        pointers.append(scratch.data_ptr())
    elif f32:
        pointers.append(None)
    status = getattr(lib, entry)(
        *pointers, out.data_ptr(), bf, n, heads, dim_head, scale,
        kernels.cuda_stream(qkv))
    _build.check(lib, status, entry)
    count_launch("divided_space_attention", qkv.shape, float32=f32,
                 entry=entry + (" + V scratch" if own == "block" else ""))
    return out


def time_staged(f: int) -> bool:
    """Whether the time attention at ``f`` frames runs the kernel staged by
    cp.async (``csrc/time_staged.cuh``, the entry point
    ``STAGED_TIME_ENTRY``): clips of 8, 24 and 32 frames
    (``STAGED_TIME_FRAMES``) at every head dim; the configurations' kernel
    and the classes' at 16 frames."""
    return f in STAGED_TIME_FRAMES


def _check_frames(f: int) -> None:
    if f % 8 or not 8 <= f <= 32:
        raise ValueError(f"the time kernels take F % 8 == 0, 8 <= F <= 32 "
                         f"frames, not {f}")


def time_attention_cuda(qkv, sin, cos, heads: int, dim_head: int,
                        scale: float):
    """Kernel launch: qkv [B, F, N, 3·H·dh] → [B, F, N, H·dh] in qkv's type
    (bf16 or float32), F % 8 == 0 up to 32, dh dividing 128 from 2 up."""
    f32 = _operands(qkv, sin, cos)
    b, f, n, c3 = qkv.shape
    _check_frames(f)
    _check_head_dim(dim_head)
    if c3 != 3 * heads * dim_head or tuple(sin.shape) != (f, dim_head):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} sin "
                         f"{tuple(sin.shape)} for {heads}x{dim_head}")
    out = torch.empty(b, f, n, heads * dim_head, dtype=qkv.dtype,
                      device=qkv.device)
    lib, suffix = _library(f32, (f, dim_head) not in TIME_SHAPES)
    entry = "divided_time_attention" + suffix
    if time_staged(f):
        entry = STAGED_TIME_ENTRY + ("_f32" if f32 else "")
    status = getattr(lib, entry)(
        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(), b, f,
        n, heads, dim_head, scale, kernels.cuda_stream(qkv))
    _build.check(lib, status, entry)
    count_launch("divided_time_attention", qkv.shape, float32=f32,
                 entry=entry)
    return out


def _cotangents(qkv, *ts) -> None:
    """The forward's output and its cotangent, as the backward kernels read
    them: qkv's type, contiguous, 16-byte aligned, one third of qkv wide."""
    want = (*qkv.shape[:-1], qkv.shape[-1] // 3)
    for t in ts:
        if (t.dtype != qkv.dtype or tuple(t.shape) != want
                or t.device != qkv.device):
            raise ValueError(f"the backward kernels take the output and its "
                             f"cotangent as {qkv.dtype} {list(want)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")


def space_backward_narrow_plan(bf: int, n: int, heads: int) -> str:
    """The plan the space backward at heads of up to
    ``SPACE_BACKWARD_NARROW_MAX`` dims runs on [BF, N, ...]: "resident" (one
    block per (frame, head), ``SPACE_BACKWARD_RESIDENT_ENTRY``) or "class"
    (``divided_space_attention_backward_classes``). The one place that
    chooses, from ``SPACE_BACKWARD_RESIDENT_MIN_PAIRS``."""
    least = SPACE_BACKWARD_RESIDENT_MIN_PAIRS.get(n)
    return "resident" if least is not None and bf * heads >= least \
        else "class"


def space_backward_scratch(bf: int, n: int, heads: int, dim_head: int,
                           device):
    """What the space backward's kernels share, allocated (``torch.empty``)
    for one call: the pre-pass's bf16 scratch [BF, N, 3·H·dh] (q~, k~, v)
    and gs [BF, N, H·dh], dsum [BF, H, N] (D = rowsum(g ∘ out)) and the dq
    kernel's stats [BF, H, N, 2] (each row's log2-sum-exp and D), both
    float32. At head dims up to ``SPACE_BACKWARD_NARROW_MAX`` the stats
    alone where the class runs (it reads qkv where it lies), and nothing
    where the resident plan runs (its block keeps them in shared memory)."""
    if (dim_head <= SPACE_BACKWARD_NARROW_MAX
            and space_backward_narrow_plan(bf, n, heads) == "resident"):
        return ()
    stats = torch.empty(bf, heads, n, 2, dtype=torch.float32, device=device)
    if dim_head <= SPACE_BACKWARD_NARROW_MAX:
        return (stats,)
    return (torch.empty(bf, n, 3 * heads * dim_head, dtype=torch.bfloat16,
                        device=device),
            torch.empty(bf, n, heads * dim_head, dtype=torch.bfloat16,
                        device=device),
            torch.empty(bf, heads, n, dtype=torch.float32, device=device),
            stats)


def space_attention_backward_cuda(qkv, out, g, sin, cos, heads: int,
                                  dim_head: int, scale: float):
    """Kernel launch: dqkv [BF, N, 3·H·dh] in qkv's type (bf16 or float32)
    from qkv [BF, N, 3·H·dh], the forward's output and its cotangent g
    [BF, N, H·dh]; N a multiple of 128 from 256, dh dividing 128 from 2 up.
    Three launches (``SPACE_BACKWARD_STEPS``: the pre-pass, dq, dk/dv)
    through the scratch of ``space_backward_scratch``, or at head dims up to
    ``SPACE_BACKWARD_NARROW_MAX`` one: the plan
    ``space_backward_narrow_plan`` names, the resident block per (frame,
    head) or the class (its dq and dk/dv kernels through the stats alone);
    one launch of the backward in the count."""
    f32 = _operands(qkv, sin, cos)
    _cotangents(qkv, out, g)
    _check_head_dim(dim_head)
    bf, n, c3 = qkv.shape
    if c3 != 3 * heads * dim_head or tuple(sin.shape) != (n, dim_head):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} sin "
                         f"{tuple(sin.shape)} for {heads}x{dim_head}")
    if n % 128 or n < 256:
        raise ValueError(f"the space backward takes N % 128 == 0, N >= 256, "
                         f"not {n}")
    table = rotary_pair_table(sin, cos)
    dqkv = torch.empty_like(qkv)
    bufs = space_backward_scratch(bf, n, heads, dim_head, qkv.device)
    lib, suffix = _library(f32, dim_head not in SPACE_BACKWARD_HEAD_DIMS,
                           backward=True)
    if dim_head > SPACE_BACKWARD_NARROW_MAX:
        scratch, gs, dsum, stats = bufs
        pointers = {"prepass": (qkv, table, out, g, scratch, gs, dsum),
                    "dq": (scratch, gs, dsum, table, dqkv, stats),
                    "dkdv": (scratch, gs, dsum, table, dqkv, stats)}
        launches = [(f"divided_space_backward_{step}{suffix}", pointers[step])
                    for step, _ in SPACE_BACKWARD_STEPS]
    elif not bufs:   # the resident plan: no scratch
        launches = [(SPACE_BACKWARD_RESIDENT_ENTRY + ("_f32" if f32 else ""),
                     (qkv, table, out, g, dqkv))]
    else:
        launches = [("divided_space_attention_backward" + suffix,
                     (qkv, table, out, g, dqkv, *bufs))]
    stream = kernels.cuda_stream(qkv)
    for entry, tensors in launches:
        status = getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), bf, n, heads, dim_head, scale,
            stream)
        _build.check(lib, status, entry)
    count_launch("divided_space_attention_backward", qkv.shape, float32=f32,
                 entry=" + ".join(entry for entry, _ in launches))
    return dqkv


def time_backward_staged(f: int) -> bool:
    """Whether the time backward at ``f`` frames runs the kernel staged by
    cp.async (``csrc/time_staged_backward.cuh``, the entry point
    ``STAGED_TIME_BACKWARD_ENTRY``): clips of 8 frames
    (``STAGED_TIME_BACKWARD_FRAMES``) at every head dim; the configurations'
    kernel and the classes' elsewhere."""
    return f in STAGED_TIME_BACKWARD_FRAMES


def time_attention_backward_cuda(qkv, g, sin, cos, heads: int,
                                 dim_head: int, scale: float):
    """Kernel launch: dqkv [B, F, N, 3·H·dh] in qkv's type (bf16 or float32)
    from qkv and the output's cotangent g [B, F, N, H·dh] (the softmax's D
    comes from P and dP: no output read); F and dh as the forward's. At
    clips of 8 frames the staged kernel (``time_backward_staged``)."""
    f32 = _operands(qkv, sin, cos)
    _cotangents(qkv, g)
    b, f, n, c3 = qkv.shape
    _check_frames(f)
    _check_head_dim(dim_head)
    if c3 != 3 * heads * dim_head or tuple(sin.shape) != (f, dim_head):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)} sin "
                         f"{tuple(sin.shape)} for {heads}x{dim_head}")
    dqkv = torch.empty_like(qkv)
    lib, suffix = _library(f32, (f, dim_head) not in TIME_SHAPES,
                           backward=True)
    entry = "divided_time_attention_backward" + suffix
    if time_backward_staged(f):
        entry = STAGED_TIME_BACKWARD_ENTRY + ("_f32" if f32 else "")
    status = getattr(lib, entry)(
        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), b, f, n, heads, dim_head, scale,
        kernels.cuda_stream(qkv))
    _build.check(lib, status, entry)
    count_launch("divided_time_attention_backward", qkv.shape, float32=f32,
                 entry=entry)
    return dqkv


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

    def forward(t):
        if not kernels.on_card(t):
            return divided_attention_reference(t, sin, cos, axis, heads,
                                               dim_head, scale,
                                               use_flash=False)
        if axis == "space":
            out = space_attention_cuda(t.reshape(b * f, n, t.shape[-1]), sin,
                                       cos, heads, dim_head, scale)
            return out.reshape(b, f, n, heads * dim_head)
        return time_attention_cuda(t, sin, cos, heads, dim_head, scale)

    def backward(t, out, g):
        if not kernels.on_card(t):
            return divided_attention_backward_reference(
                t, out, g, sin, cos, axis, heads, dim_head, scale).to(t.dtype)
        if axis == "space":
            flat = (b * f, n)
            dqkv = space_attention_backward_cuda(
                t.reshape(*flat, t.shape[-1]), out.reshape(*flat, -1),
                g.reshape(*flat, -1), sin, cos, heads, dim_head, scale)
            return dqkv.reshape(t.shape)
        return time_attention_backward_cuda(t, g, sin, cos, heads, dim_head,
                                            scale)

    return DividedAttention.apply(qkv, forward, backward)
