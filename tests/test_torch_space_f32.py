"""The float32 divided space kernel at head dim 64
(``csrc/resident_f32_tile.cuh``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: its function, the ``exp2`` float32 route, against
the JAX package's space kernel (``_space_fused`` in interpret mode) on
float32 qkv at the lengths the kernel keeps K resident for, from 256 to its
limit of 1152 tokens; the wrapper driven with stub libraries (a float32 qkv
at head dim 64 up to that limit launches ``divided_space_attention_f32``
once, with the V scratch the wrapper allocates where
``space_f32_own_kernel`` takes this kernel and a null pointer, the wgmma
tile's float32 route, elsewhere; a bf16 qkv the bf16 entry point without
one, longer float32 sequences the pre-rotated design); and the register
split, shared memory and rows a round that the header states, read from
it, and the entry point's dispatch on the scratch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv

from . import torch_stubs
from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADER = _build.CSRC / "resident_f32_tile.cuh"


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("n", [256, 1152])
def test_space_f32_route_matches_jax_interpret(n):
    """The function the float32 space kernel is held to on the card (the
    route in its ``ex2`` form) is the TPU kernel's on float32 qkv but for
    its bf16 operands, at the shortest and the longest sequence the kernel
    takes: within ``BF16_LIMITS`` and ``QUANTILE_LIMITS``."""
    heads, dh = 2, 64
    qkv = np.random.default_rng(19).normal(
        size=(1, n, 3 * heads * dh)).astype(np.float32)
    side = 16 if n == 256 else 32
    sin, cos = jrot.axial_rotary_sincos(side, n // side, dh)
    assert tdiv.divided_attention_viable("space", 1, n, heads, dh, dh)
    assert not tdiv.space_prerotated(dh, n, True)
    want = jdiv._space_fused(jnp.asarray(qkv), sin, cos, heads, dh,
                             dh**-0.5, interpret=True)
    got = tdiv.divided_attention_float32_route(
        torch.from_numpy(qkv)[None], torch.from_numpy(np.asarray(sin)),
        torch.from_numpy(np.asarray(cos)), "space", heads, dh, dh**-0.5,
        exp2=True)[0]
    assert got.dtype == torch.float32
    tkernels.check_bf16("divided_space_attention", got,
                        torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("bf,n,heads", [(2, 256, 2), (16, 1024, 8),
                                        (9, 1024, 8), (8, 1024, 8),
                                        (1, 1152, 2)])
def test_float32_space_launches_its_kernel_with_the_v_scratch(
        stub_launches, monkeypatch, bf, n, heads):
    """A float32 qkv at head dim 64 with K resident (N up to
    ``SPACE_F32_MAX_N``) launches ``divided_space_attention_f32`` once, or
    where ``space_f32_own_kernel`` takes the cluster plan (at 1024 tokens
    from 64 pairs: 8-frame clips', the trainers' 128, 72)
    ``SPACE_F32_CLUSTER_ENTRY``. Where it takes the kernel of its own, one
    block or a cluster of two per pair, the pointer after qkv and
    the table is the V scratch the wrapper allocated: bf16 [BF·H, N, 64] on
    qkv's device (``space_f32_scratch``), a slot per (frame, head);
    elsewhere (other lengths) it is null, which runs the wgmma tile's
    float32 route, and nothing is allocated."""
    calls, made = [], []
    stub = torch_stubs.StubLib(stub_launches, calls)
    monkeypatch.setattr(tdiv, "_lib_f32", lambda: stub)
    allocate = tdiv.space_f32_scratch

    def recorded(*args):
        made.append(allocate(*args))
        return made[-1]

    monkeypatch.setattr(tdiv, "space_f32_scratch", recorded)
    qkv = torch.zeros(bf, n, 3 * heads * 64)
    tab = torch.zeros(n, 64)
    out = tdiv.space_attention_cuda(qkv, tab, tab, heads, 64, 0.125)
    assert out.dtype == torch.float32 and out.shape == (bf, n, heads * 64)
    entry = ("divided_space_attention_f32" if tdiv.space_f32_own_kernel(
        bf, n, heads) != "cluster" else tdiv.SPACE_F32_CLUSTER_ENTRY)
    assert stub_launches == [entry]
    name, args = calls[0]
    assert name == entry
    if tdiv.space_f32_own_kernel(bf, n, heads):
        (scratch,) = made
        assert scratch.dtype == torch.bfloat16
        assert scratch.device == qkv.device
        assert tuple(scratch.shape) == (bf * heads, n, 64)
        assert args[2] == scratch.data_ptr()
    else:
        assert made == [] and args[2] is None
    assert args[0] == qkv.data_ptr()
    assert args[3] == out.data_ptr()
    assert args[4:9] == (bf, n, heads, 64, 0.125)
    assert tkernels.FLOAT32_LAUNCHES_BY_SHAPE["divided_space_attention"] == {
        (bf, n, 3 * heads * 64): 1}


# the plan the chooser's table names at each length and count of (frame,
# head) pairs, and the entry point each plan launches with what it counts
PLAN_ENTRIES = {
    "cluster": ("divided_space_attention_f32_cluster",
                "divided_space_attention_f32_cluster"),
    "block": ("divided_space_attention_f32",
              "divided_space_attention_f32 + V scratch"),
    None: ("divided_space_attention_f32", "divided_space_attention_f32")}


def _table_plan(n, pairs):
    """The plan of ``SPACE_F32_PLANS`` read from the table itself: the last
    (least pairs, plan) the pairs reach, the route below the first."""
    reached = [plan for least, plan in tdiv.SPACE_F32_PLANS.get(n, ())
               if pairs >= least]
    return reached[-1] if reached else None


@pytest.mark.parametrize("n", [256, 1024, 1152])
@pytest.mark.parametrize("pairs", [64, 72, 128, 1280])
def test_float32_space_launches_the_plan_its_table_names(
        stub_launches, monkeypatch, n, pairs):
    """At 64, 72, 128 and 1280 (frame, head) pairs over 256, 1024 and 1152
    tokens, the float32 space attention at head dim 64 launches exactly the
    plan its table (``SPACE_F32_PLANS``) names there: the cluster plan's
    entry point (``SPACE_F32_CLUSTER_ENTRY``) or the one-block plan's, each
    with the V scratch, or the wgmma tile's float32 route (a null scratch),
    once, and counts it under its own entry (``LAUNCHES_BY_ENTRY``); the
    table's rows rise, each plan a name the chooser knows."""
    for rows in tdiv.SPACE_F32_PLANS.values():
        assert [least for least, _ in rows] == sorted({l for l, _ in rows})
        assert {plan for _, plan in rows} <= {"cluster", "block", None}
    calls = []
    stub = torch_stubs.StubLib(stub_launches, calls)
    monkeypatch.setattr(tdiv, "_lib_f32", lambda: stub)
    plan = _table_plan(n, pairs)
    assert tdiv.space_f32_own_kernel(pairs // 8, n, 8) == plan
    qkv = torch.zeros(pairs // 8, n, 3 * 8 * 64)
    tab = torch.zeros(n, 64)
    tdiv.space_attention_cuda(qkv, tab, tab, 8, 64, 0.125)
    entry, counted = PLAN_ENTRIES[plan]
    assert stub_launches == [entry]
    assert (calls[0][1][2] is None) == (plan is None)
    assert dict(tkernels.LAUNCHES_BY_ENTRY) == {counted: 1}


def test_bf16_space_launches_without_a_scratch(stub_launches, monkeypatch):
    """A bf16 qkv at the same shape launches the bf16 entry point, which
    takes no scratch, and allocates none."""
    calls = []
    stub = torch_stubs.StubLib(stub_launches, calls)
    monkeypatch.setattr(tdiv, "_lib", lambda: stub)
    monkeypatch.setattr(tdiv, "space_f32_scratch", None)
    qkv = torch.zeros(16, 1024, 3 * 8 * 64, dtype=torch.bfloat16)
    tab = torch.zeros(1024, 64)
    out = tdiv.space_attention_cuda(qkv, tab, tab, 8, 64, 0.125)
    assert out.dtype == torch.bfloat16
    assert stub_launches == ["divided_space_attention"]
    assert len(calls[0][1]) == 9


@pytest.mark.parametrize("n", [1280, 2048])
def test_float32_space_past_resident_k_is_prerotated(stub_launches, n):
    """Past the kernel's resident-K limit a float32 qkv at head dim 64
    launches the pre-rotated design's float32 entry point."""
    tab = torch.zeros(n, 64)
    tdiv.space_attention_cuda(torch.zeros(1, n, 3 * 2 * 64), tab, tab, 2, 64,
                              0.125)
    assert stub_launches == ["divided_space_attention_prerotated_f32"]


# the plan tools/ab_space_f32.py --gate read fastest on an H100 (PERF.md), by
# length and (frame, head) pairs: "cluster" (two blocks a pair), "block" (one)
# or None (the wgmma tile's float32 route)
GATE_FASTEST = {
    256: {64: "cluster", 128: None, 256: None, 1280: None},
    384: {64: None, 128: None, 256: None, 1280: None},
    512: {64: "cluster", 128: None, 256: None, 1280: None},
    640: {64: None, 128: None, 256: None, 1280: None},
    768: {64: None, 128: None, 256: None, 1280: None},
    896: {64: None, 128: None, 256: None, 1280: "cluster"},
    1024: {32: None, 64: "cluster", 80: "cluster", 96: "cluster",
           128: "cluster", 256: "cluster", 1280: "cluster"},
    1152: {64: None, 128: None, 256: None, 1280: "block"}}


@pytest.mark.parametrize("n", sorted(GATE_FASTEST))
def test_space_f32_own_kernel_where_it_read_faster(n):
    """The wrapper's choice names, at every measured (length, pairs), the
    plan that read fastest there (however the pairs split into frames and
    heads), and its table lists exactly the lengths where a plan of the
    kernel of its own read faster than the route."""
    for pairs, plan in GATE_FASTEST[n].items():
        assert tdiv.space_f32_own_kernel(pairs // 8, n, 8) == plan, (n, pairs)
        assert tdiv.space_f32_own_kernel(pairs, n, 1) == plan, (n, pairs)
    assert set(tdiv.SPACE_F32_PLANS) == {
        length for length, read in GATE_FASTEST.items() if any(read.values())}


def test_space_f32_scratch_size():
    """One bf16 [N, 64] slot per (frame, head): at train-diffusion's
    qkv [10, 16, 1024, 1536] (160 frames of 8 heads) 160 x 8 x 1024 x 64
    elements, 168 MB, as large as the bf16 V it holds."""
    s = tdiv.space_f32_scratch(160, 1024, 8, torch.device("meta"))
    assert s.dtype == torch.bfloat16 and s.device.type == "meta"
    assert s.numel() * s.element_size() == 160 * 8 * 1024 * 64 * 2


def test_space_f32_header_states_a_plan_that_fits():
    """The header's constants keep the plan it states: one block per
    (frame, head), of two consumer warpgroups of 64 rows, so that a round is 128 rows and every N the
    kernel takes (a multiple of 128, the configurations' 1024 among them)
    is whole rounds: no warpgroup sits a round out; the registers of 384
    threads (168 each at launch) split as 40 for the producer and 232 for
    each consumer; K resident up to ``SPACE_F32_MAX_N`` tokens beside the V
    ring and the two Q tiles in a Hopper block's shared memory."""
    text = HEADER.read_text()
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    consumers = _constant(text, "kRfConsumers")
    rows = _constant(tile, "kWgRows")
    assert consumers * rows == 128
    threads = (consumers + 1) * 128
    at_launch = 65536 // threads // 8 * 8
    # the space instantiation's split: V rounded in the prologue, the
    # producer at 40 (it only copies), each consumer at 232
    space = text[text.index("struct SpaceF32Args {"):]
    dec, inc = map(int, re.search(
        r"kVFirst = false;\n  static constexpr int kProducerRegs = (\d+), "
        r"kConsumerRegs = (\d+);", space[:space.index("};")]).groups())
    assert (dec, inc) == (40, 232)
    assert dec + consumers * inc == (consumers + 1) * at_launch
    assert len(re.findall(r"setmaxnreg\.(dec|inc)\.sync\.aligned\.u32 %0;",
                          text)) == 2
    slots = _constant(tile, "kWgMaxKSlots")
    assert tdiv.SPACE_F32_MAX_N == 128 * slots
    assert "nkt > kWgMaxKSlots" in text
    # the entry point chooses nothing: with the wrapper's scratch this
    # kernel, without one the wgmma tile's float32 route
    entry = (_build.CSRC / "divided_attention_f32.cu").read_text()
    entry = entry[entry.index("int divided_space_attention_f32("):]
    entry = entry[:entry.index("\n}\n")]
    assert "kRf" not in entry
    assert ("  if (vs != nullptr)\n    return mdt::launch_space_f32("
            in entry)
    assert "  return mdt::launch_space<float>(" in entry
    tile_bytes = 128 * 64 * 2
    smem = (1024 + (slots + _constant(tile, "kWgVStages")) * tile_bytes
            + consumers * rows * 64 * 2 + 8 * 2 * _constant(tile, "kWgVStages"))
    assert smem <= _constant(tile, "kWgSmemLimit")
