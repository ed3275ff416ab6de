"""The kernels' float32 route on the CPU.

For float32 operands every kernel reads float32 and writes float32 itself.
``divided_attention_float32_route`` (space, time),
``packed_attention_float32_route`` (packed) and ``attention_float32_route``
(one-pass, fused, tiny-L) write out the function they compute (q rotated
where there is a rotary, multiplied by the scale in fp32 and rounded to bf16
once, k and v rounded once, fp32 scores and sums, p rounded to bf16 for P·V
against each 128-key tile's running max, the result divided in fp32 and
kept float32). Here each is held to the JAX package's Pallas kernel in
interpret mode on the same float32 inputs (the Pallas kernels keep float32
operands, so the gap is the route's bf16 rounding: within ``BF16_LIMITS``
and ``QUANTILE_LIMITS``) and to the bf16 route at bf16-exact inputs;
``FLOAT32_ROUTE_LIMITS`` are shown to pass a change of summation order and
to fail a result rounded to bf16 and a fully bf16 result widened to
float32; and the
wrappers are driven with stub libraries to show that float32 operands reach
the float32 entry points, that the
modular path's float32 time attention reaches tiny-L, and what is refused.
The kernels themselves are held to these functions on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu.ops.pallas import packed_attention as jpack
from moditalker_tpu_torch.ops import attention as tattn
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack

from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

AXES = ["space", "time"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _inputs(axis, seed=7):
    """qkv [B, F, N, 3·H·dh] float32 from a numpy seed and the tables, at
    small shapes both gates pass (2 heads of 64)."""
    heads, dh = 2, 64
    b, f, n = (1, 2, 256) if axis == "space" else (1, 16, 128)
    qkv = np.random.default_rng(seed).normal(
        size=(b, f, n, 3 * heads * dh)).astype(np.float32)
    sin, cos = (jrot.axial_rotary_sincos(16, 16, dh) if axis == "space"
                else jrot.time_rotary_sincos(f, dh))
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    return qkv, sin, cos, heads, dh


def _route(qkv, sin, cos, axis, heads, dh):
    return tdiv.divided_attention_float32_route(
        _t(qkv) if isinstance(qkv, np.ndarray) else qkv, _t(sin), _t(cos),
        axis, heads, dh, dh**-0.5)


@pytest.mark.parametrize("axis", AXES)
def test_float32_route_matches_jax_interpret(axis):
    """The function the float32 route computes is the TPU kernel's on
    float32 qkv but for its bf16 operands: within the bf16 limits the card
    holds every kernel to (``BF16_LIMITS``, ``QUANTILE_LIMITS``)."""
    qkv, sin, cos, heads, dh = _inputs(axis)
    want = jdiv.divided_attention(jnp.asarray(qkv), sin, cos, axis, heads,
                                  dh, dh**-0.5, interpret=True)
    got = _route(qkv, sin, cos, axis, heads, dh)
    assert got.dtype == torch.float32
    tkernels.check_bf16(f"divided_{axis}_attention", got, _t(want))


@pytest.mark.parametrize("heads,dh", [(4, 128), (16, 32)])
def test_space_float32_route_with_ex2_matches_jax_interpret(heads, dh):
    """The space route in the kernels' ``ex2`` form
    (``divided_attention_float32_route(exp2=True)``: what the card holds the
    float32 space kernels to) is the TPU kernel's function, ``_space_fused``
    in interpret mode, on float32 qkv at 4 heads of 128 and 16 of 32 (the
    pre-rotated design's widths) but for its bf16 operands: within the bf16
    limits; and within ``FLOAT32_ROUTE_LIMITS`` of the route's ``exp``
    form, from which it differs where a p lands on the other side of a
    bf16 rounding boundary."""
    n = 256
    qkv = np.random.default_rng(9).normal(
        size=(1, n, 3 * heads * dh)).astype(np.float32)
    sin, cos = jrot.axial_rotary_sincos(16, n // 16, dh)
    assert tdiv.divided_attention_viable("space", 1, n, heads, dh, dh)
    want = jdiv._space_fused(jnp.asarray(qkv), sin, cos, heads, dh,
                             dh**-0.5, interpret=True)
    x = _t(qkv)[None]
    got = tdiv.divided_attention_float32_route(
        x, _t(sin), _t(cos), "space", heads, dh, dh**-0.5, exp2=True)[0]
    assert got.dtype == torch.float32
    tkernels.check_bf16("divided_space_attention", got, _t(want))
    exp = tdiv.divided_attention_float32_route(
        x, _t(sin), _t(cos), "space", heads, dh, dh**-0.5)[0]
    tkernels.check_float32_route("divided_space_attention", got, exp)
    assert not torch.equal(got, exp)


@pytest.mark.parametrize("axis", AXES)
def test_float32_route_at_bf16_inputs_sits_within_the_bf16_route(axis):
    """At a qkv bf16 represents exactly, the float32 route's result rounded
    to bf16 is the bf16 route's function: it lies within the limits that
    hold the bf16 kernel to the plain bf16 version. (Not within one bf16 ulp
    of that plain version: it rounds the tables, the rotation and the scores
    to bf16 where the kernels keep fp32.)"""
    qkv, sin, cos, heads, dh = _inputs(axis, seed=8)
    x = _t(qkv).bfloat16()
    got = _route(x.float(), sin, cos, axis, heads, dh).bfloat16()
    plain = tdiv.divided_attention_reference(x, _t(sin), _t(cos), axis, heads,
                                             dh, dh**-0.5, use_flash=False)
    tkernels.check_bf16(f"divided_{axis}_attention", got, plain)


@pytest.mark.parametrize("axis", AXES)
def test_bf16_rounded_share_tells_float32_from_widened_bf16(axis):
    qkv, sin, cos, heads, dh = _inputs(axis)
    out = _route(qkv, sin, cos, axis, heads, dh)
    assert tkernels.bf16_rounded_share(out) < 1e-3
    assert tkernels.bf16_rounded_share(out.bfloat16().float()) == 1.0


@pytest.mark.parametrize("axis", AXES)
def test_float32_route_limits_pass_sum_order_and_fail_a_bf16_result(axis):
    """The sequence axis permuted inside each 128-key tile (queries, keys
    and the tables' rows alike) gives the same function, each tile's keys
    the same, with every fp32 sum over the keys in another order: within
    ``FLOAT32_ROUTE_LIMITS``. The result rounded to bf16 fails them."""
    qkv, sin, cos, heads, dh = _inputs(axis)
    name = f"divided_{axis}_attention"
    want = _route(qkv, sin, cos, axis, heads, dh)
    seq_axis = 2 if axis == "space" else 1
    rng, length = np.random.default_rng(3), qkv.shape[seq_axis]
    perm = np.concatenate([j + rng.permutation(min(128, length - j))
                           for j in range(0, length, 128)])
    moved = _route(np.take(qkv, perm, axis=seq_axis), sin[perm], cos[perm],
                   axis, heads, dh)
    back = torch.empty_like(moved)
    back.index_copy_(seq_axis, torch.from_numpy(perm), moved)
    assert not torch.equal(back, want)
    tkernels.check_float32_route(name, back, want)
    with pytest.raises(AssertionError, match="float32 route"):
        tkernels.check_float32_route(name, want.bfloat16().float(), want)


@pytest.mark.parametrize("axis", AXES)
def test_float32_qkv_launches_the_float32_entry_point(stub_launches, axis):
    """A float32 qkv goes to the kernel's float32 entry point once (no cast
    pass exists to call), and the result the wrapper returns is the float32
    buffer the kernel writes; a bf16 qkv still takes the bf16 entry
    point."""
    qkv, sin, cos, heads, dh = _inputs(axis)
    name = f"divided_{axis}_attention"
    for dtype, entry in ((torch.float32, name + "_f32"),
                         (torch.bfloat16, name)):
        stub_launches.clear()
        out = tdiv.divided_attention(_t(qkv).to(dtype), _t(sin), _t(cos),
                                     axis, heads, dh, dh**-0.5)
        assert stub_launches == [entry]
        assert out.dtype == dtype and out.shape == (*qkv.shape[:3],
                                                    heads * dh)
    assert tkernels.LAUNCHES[name] == 2


def test_float32_space_kernel_is_built_for_resident_k(stub_launches):
    """The float32 space kernel (``resident_f32_tile.cuh``) is built for
    resident K only: its launcher refuses more than ``kWgMaxKSlots`` tiles
    of 128 keys. Up to that limit a float32 qkv launches its entry point;
    past it (1152 < N <= 2048, which the gate admits) the wrapper launches
    the pre-rotated design's float32 entry point
    (``divided_classes_f32.cu``: the rotation pre-pass, then the wgmma tile
    built per width at 64), never raising."""
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    slots = int(re.search(r"kWgMaxKSlots = (\d+);", tile).group(1))
    kernel = (_build.CSRC / "resident_f32_tile.cuh").read_text()
    assert "nkt > kWgMaxKSlots" in kernel
    assert tdiv.SPACE_F32_MAX_N == 128 * slots
    for n, entry in ((tdiv.SPACE_F32_MAX_N, "divided_space_attention_f32"),
                     (tdiv.SPACE_F32_MAX_N + 128,
                      "divided_space_attention_prerotated_f32"),
                     (2048, "divided_space_attention_prerotated_f32")):
        stub_launches.clear()
        tab = torch.zeros(n, 64)
        tdiv.space_attention_cuda(torch.zeros(1, n, 3 * 2 * 64), tab, tab,
                                  2, 64, 0.125)
        assert stub_launches == [entry]


def test_float32_entry_points_are_in_their_own_source():
    """The C symbols the wrappers bind are defined in each kernel's bf16
    source and in a float32 source of its own (``FLOAT32_SOURCES``, built
    with the kernels), the classes beyond the configurations' shapes in
    sources of their own likewise (``CLASS_SOURCES``,
    ``CLASS_FLOAT32_SOURCES``, and the one-pass and fused kernels' widths
    ``WIDE_SOURCES``, ``WIDE_FLOAT32_SOURCES``; their bf16 narrow tile
    ``NARROW_SOURCES`` alone, without a float32 twin), and every source
    under csrc/ is a kernel's."""
    symbols = {"divided_attention": {"divided_space_attention",
                                     "divided_time_attention"},
               "packed_attention": {"packed_attention"},
               "flash_attention": {"fused_attention"},
               "tiny_attention": {"tiny_attention"},
               "divided_classes": {"divided_space_attention_prerotated",
                                   "divided_time_attention_classes",
                                   "divided_time_attention_staged"},
               "flash_classes": {"fused_attention_classes",
                                 "tiny_attention_classes"},
               "flash_wide": {"fused_attention_wide"},
               "divided_backward_classes": {
                   "divided_space_attention_backward_classes",
                   "divided_space_backward_prepass_classes",
                   "divided_space_backward_dq_classes",
                   "divided_space_backward_dkdv_classes",
                   "divided_time_attention_backward_classes",
                   tdiv.SPACE_BACKWARD_RESIDENT_ENTRY,
                   tdiv.STAGED_TIME_BACKWARD_ENTRY}}
    # float32 alone: the one-pass and fused kernels at head dim 64 past
    # resident K (the pre-pass and the bf16 K ring), the space kernel's
    # cluster plan
    float32_only = {"flash_attention_f32": {tflash.PREROUNDED_ENTRY},
                    "divided_attention_f32": {tdiv.SPACE_F32_CLUSTER_ENTRY}}
    # bf16 alone: the narrow tile at head dims 40 to 56 (float32 there is
    # the wide tile's), a source without a float32 twin
    for source, names in {"flash_narrow": {tflash.NARROW_ENTRY}}.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        c_api = text[text.index('extern "C" {'):]
        assert set(re.findall(r"\bint (\w+)\(", c_api)) == names
        assert not (_build.CSRC / f"{source}_f32.cu").exists()
    assert set(tkernels.NARROW_SOURCES.values()) == {"flash_narrow"}
    for source, names in symbols.items():
        for src, suffix in ((source, ""), (source + "_f32", "_f32")):
            text = (_build.CSRC / f"{src}.cu").read_text()
            c_api = text[text.index('extern "C" {'):]
            found = set(re.findall(r"\bint (\w+)\(", c_api))
            assert found == {n + suffix for n in names} | float32_only.get(
                src, set()), src
    for name, source in tkernels.SOURCES.items():
        assert tkernels.FLOAT32_SOURCES[name] == source + "_f32"
    for name, source in tkernels.CLASS_SOURCES.items():
        assert tkernels.CLASS_FLOAT32_SOURCES[name] == source + "_f32"
        assert name in tkernels.SOURCES
    assert set(tkernels.CLASS_SOURCES) == set(tkernels.SOURCES) - {
        "packed_attention"}
    for name, source in tkernels.WIDE_SOURCES.items():
        assert tkernels.WIDE_FLOAT32_SOURCES[name] == source + "_f32"
    assert set(tkernels.WIDE_SOURCES) == {"onepass_attention",
                                          "fused_attention"}
    built = {*tkernels.SOURCES.values(), *tkernels.FLOAT32_SOURCES.values(),
             *tkernels.CLASS_SOURCES.values(),
             *tkernels.CLASS_FLOAT32_SOURCES.values(),
             *tkernels.WIDE_SOURCES.values(),
             *tkernels.WIDE_FLOAT32_SOURCES.values(),
             *tkernels.NARROW_SOURCES.values()}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == built
    assert tkernels.all_sources() == sorted(built)


# ------------------------------------------- packed, one-pass, fused, tiny-L
# (name, shape of q, shape of k and v): the kernels' float32 rows at small
# sizes, each a shape the Pallas kernel of the same name takes
FLASH_CASES = {
    "tiny": ("tiny_attention", (256, 16, 64), (256, 16, 64)),
    "onepass16": ("onepass_attention", (2, 1024, 16), (2, 1024, 16)),
    "onepass32": ("onepass_attention", (2, 1024, 32), (2, 1024, 32)),
    "onepass64": ("onepass_attention", (2, 1024, 64), (2, 1024, 64)),
    "fused": ("fused_attention", (2, 64, 64), (2, 512, 64)),
    # the wide tile: a width of its own, past 128 (64-key softmax tiles),
    # and the 256-column tile
    "onepass48": ("onepass_attention", (2, 1024, 48), (2, 1024, 48)),
    "fused136": ("fused_attention", (2, 100, 136), (2, 256, 136)),
    "fused256": ("fused_attention", (2, 64, 256), (2, 384, 256)),
}
PACKED = (1, 128, 8)   # B, C, heads: dh = 16


def _flash_inputs(case, seed=9):
    name, qs, ks = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    return (name, rng.normal(size=qs).astype(np.float32),
            rng.normal(size=ks).astype(np.float32),
            rng.normal(size=ks).astype(np.float32))


def _packed_inputs(l, seed=9):
    b, c, heads = PACKED
    qkv = np.random.default_rng(seed).normal(
        size=(b, l, 3 * c)).astype(np.float32)
    return qkv, heads, (c // heads) ** -0.5


def _jax_flash(name, q, k, v, scale):
    fn = {"tiny_attention": jflash.tiny_attention,
          "onepass_attention": jflash.onepass_attention,
          "fused_attention": jflash.fused_attention}[name]
    return fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
              interpret=True)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_attention_float32_route_matches_jax_interpret(case):
    """``attention_float32_route`` is the TPU kernel's function on float32
    q, k, v but for its bf16 operands: within the bf16 limits the card holds
    every kernel to."""
    name, q, k, v = _flash_inputs(case)
    sc = q.shape[-1] ** -0.5
    got = tflash.attention_float32_route(_t(q), _t(k), _t(v), sc)
    assert got.dtype == torch.float32 and got.shape == q.shape
    tkernels.check_bf16(name, got, _t(_jax_flash(name, q, k, v, sc)))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_attention_float32_route_with_ex2_is_the_same_function(case):
    """``attention_float32_route(exp2=True)`` (p as the one-pass and fused
    kernels' ``ex2`` takes it; what the wide tile's float32 results are
    held to) is the same function: within the bf16 limits of the Pallas
    kernel in interpret mode, and within ``FLOAT32_ROUTE_LIMITS`` of the
    route with ``exp`` (they differ where a p lands on the other side of a
    bf16 rounding boundary)."""
    name, q, k, v = _flash_inputs(case)
    sc = q.shape[-1] ** -0.5
    x = (_t(q), _t(k), _t(v))
    got = tflash.attention_float32_route(*x, sc, exp2=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    tkernels.check_bf16(name, got, _t(_jax_flash(name, q, k, v, sc)))
    tkernels.check_float32_route(name, got,
                                 tflash.attention_float32_route(*x, sc))
    assert not torch.equal(got, tflash.attention_float32_route(*x, sc))


@pytest.mark.parametrize("l", [1024, 1032])
def test_packed_float32_route_matches_jax_interpret(l):
    """``packed_attention_float32_route`` against the packed Pallas kernel on
    float32 qkv, at the xy plane's length and a ragged one."""
    qkv, heads, sc = _packed_inputs(l)
    want = jpack.packed_attention(jnp.asarray(qkv), heads, sc, interpret=True)
    got = tpack.packed_attention_float32_route(_t(qkv), heads, sc)
    assert got.dtype == torch.float32
    tkernels.check_bf16("packed_attention", got, _t(want))


def _route_and_plain(case, x):
    """(the float32 route on ``x`` [float32 tensors], the plain version on
    the same tensors): for a flash case x = (q, k, v), for "packed" x =
    (qkv,)."""
    if case == "packed":
        _, heads, sc = _packed_inputs(8)
        return (tpack.packed_attention_float32_route(x[0], heads, sc),
                lambda *t: tpack.packed_attention_reference(t[0], heads, sc))
    sc = x[0].shape[-1] ** -0.5
    return (tflash.attention_float32_route(*x, sc),
            lambda *t: tflash.onepass_attention_reference(*t, sc))


def _case_inputs(case, seed=9):
    if case == "packed":
        return "packed_attention", (_t(_packed_inputs(1024, seed)[0]),)
    name, q, k, v = _flash_inputs(case, seed)
    return name, (_t(q), _t(k), _t(v))


ROUTE_CASES = [*sorted(FLASH_CASES), "packed"]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_float32_routes_at_bf16_inputs_sit_within_the_bf16_route(case):
    """At inputs bf16 represents exactly, the float32 route's result rounded
    to bf16 lies within the limits that hold the bf16 kernel to its plain
    bf16 version."""
    name, x = _case_inputs(case, seed=10)
    x = tuple(t.bfloat16() for t in x)
    route, plain = _route_and_plain(case, tuple(t.float() for t in x))
    tkernels.check_bf16(name, route.bfloat16(), plain(*x))


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_float32_route_limits_pass_sum_order_and_fail_bf16_results(case):
    """The keys permuted inside each softmax tile of keys (128, or 64 past
    head dim 128; k and v alike; for packed the sequence, queries included)
    give the same function with every fp32
    sum over the keys in another order: within ``FLOAT32_ROUTE_LIMITS``.
    The route's result rounded to bf16 (a bf16 kernel between two cast
    passes) fails them, and so does the fully bf16 plain version widened to
    float32 (a bf16 kernel whose result is widened); the float32 result
    keeps under 1 % of its elements equal to their bf16 rounding."""
    name, x = _case_inputs(case)
    want, plain = _route_and_plain(case, x)
    rng = np.random.default_rng(4)
    length = x[-1].shape[-2]
    # within the route's softmax tiles (flash_attention.key_tile)
    tile = 128 if case == "packed" else tflash.key_tile(x[0].shape[-1])
    perm = torch.from_numpy(np.concatenate(
        [j + rng.permutation(min(tile, length - j))
         for j in range(0, length, tile)]))
    if case == "packed":
        moved, _ = _route_and_plain(case, (x[0][:, perm],))
        back = torch.empty_like(moved).index_copy_(1, perm, moved)
    else:
        back, _ = _route_and_plain(case, (x[0], x[1][:, perm], x[2][:, perm]))
    assert not torch.equal(back, want)
    tkernels.check_float32_route(name, back, want)
    assert tkernels.bf16_rounded_share(want) < 0.01
    for widened in (want.bfloat16().float(),
                    plain(*(t.bfloat16() for t in x)).float()):
        with pytest.raises(AssertionError, match="float32 route"):
            tkernels.check_float32_route(name, widened, want)


def test_float32_route_limits_cover_every_kernel():
    """Every kernel has a row (fused: the one-pass row), each measure's
    limit ordered as the measures read: max above rms and quantile."""
    for name in tkernels.LAUNCHES:
        lim = tkernels.FLOAT32_ROUTE_LIMITS[name]
        assert lim[0] > lim[1] > 0 and lim[0] > lim[2] > 0, name
    assert (tkernels.FLOAT32_ROUTE_LIMITS["fused_attention"]
            == tkernels.FLOAT32_ROUTE_LIMITS["onepass_attention"])


@pytest.mark.parametrize("name", ["packed_attention", "onepass_attention",
                                  "tiny_attention", "fused_attention"])
def test_float32_operands_launch_the_float32_entry_points(stub_launches,
                                                          name):
    """Float32 operands go to the kernel's float32 entry point once, counted
    as a float32 launch, and come back float32; bf16 operands take the bf16
    entry point."""
    entry = {"packed_attention": "packed_attention",
             "onepass_attention": "fused_attention",
             "tiny_attention": "tiny_attention",
             "fused_attention": "fused_attention"}[name]
    shapes = {"packed_attention": [(2, 1024, 384)],
              "onepass_attention": [(4, 1024, 32)] * 3,
              "tiny_attention": [(4096, 16, 64)] * 3,
              "fused_attention": [(2, 64, 64), (2, 512, 64), (2, 512, 64)]}
    run = {"packed_attention": lambda x: tpack.packed_attention(x[0], 8, 0.25),
           "onepass_attention": lambda x: tflash.onepass_attention(*x, 0.2),
           "tiny_attention": lambda x: tflash.tiny_attention(*x, 0.125),
           "fused_attention": lambda x: tflash.fused_attention(*x)}[name]
    for dtype, suffix in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        stub_launches.clear()
        out = run([torch.randn(s).to(dtype) for s in shapes[name]])
        assert stub_launches == [entry + suffix], name
        assert out.dtype == dtype
    assert tkernels.LAUNCHES[name] == 2
    assert sum(tkernels.FLOAT32_LAUNCHES_BY_SHAPE[name].values()) == 1


def test_modular_float32_time_attention_reaches_tiny_l(stub_launches):
    """With the fused divided kernels switched off the AE's time attention
    is ``sdpa`` over [B·H·N, 16, 64]: at B = 1 and 8 heads of the shipped AE
    (8192 sequences) ``sdpa_route`` sends it to tiny-L, and on the card a
    float32 one launches tiny-L's float32 entry point (before, it raised
    TypeError); the space attention [B·F·H, 1024, 64] launches the one-pass
    kernel's."""
    assert tattn.sdpa_route(8192, 16, 16, 64, masked=False) == "tiny"
    q = torch.randn(1, 8, 1024, 16, 64)
    out = tattn.sdpa(q, q, q, scale=0.125)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert stub_launches == ["tiny_attention_f32"]
    assert dict(tkernels.FLOAT32_LAUNCHES_BY_SHAPE["tiny_attention"]) == {
        (8192, 16, 64): 1}
    stub_launches.clear()
    q = torch.randn(1, 16, 8, 1024, 64)
    tattn.sdpa(q, q, q, scale=0.125)
    assert stub_launches == ["fused_attention_f32"]


def test_float32_at_head_dim_64_is_built_for_resident_k(stub_launches):
    """At head dim 64 the float32 route keeps K resident in shared memory up
    to the tile's ``kWgMaxKSlots`` tiles of 128 keys, and above that takes
    the K ring as bf16 does: the UNet's joint attention at 256 model
    channels, [B·8, 2048, 64], launches the float32 K ring's entry point
    past resident K, here the pre-pass and the bf16 K ring (one-pass, and
    fused at a cross length; ``onepass_f32_prerounded``); past resident K
    only whole 128-key tiles, in either type, refused before anything is
    built or launched."""
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    slots = int(re.search(r"kWgMaxKSlots = (\d+);", tile).group(1))
    assert tflash.RESIDENT_KEYS_D64 == 128 * slots
    x = torch.randn(2, 2048, 64)
    out = tflash.onepass_attention(x, x, x, 0.125)
    assert out.dtype == torch.float32 and out.shape == x.shape
    out = tflash.fused_attention(x[:, :300], x, x)
    assert out.dtype == torch.float32 and out.shape == (2, 300, 64)
    assert tflash.onepass_f32_prerounded(2, 2048, 2048)
    assert tflash.onepass_f32_prerounded(2, 300, 2048)
    assert stub_launches == [tflash.PREROUNDED_ENTRY] * 2
    kv = torch.zeros(2, tflash.RESIDENT_KEYS_D64 + 8, 64)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="only in multiples of 128"):
            tflash.fused_attention_cuda(x[:, :64].to(dtype), kv.to(dtype),
                                        kv.to(dtype), 0.125)
    assert stub_launches == [tflash.PREROUNDED_ENTRY] * 2


def test_route_sums_scores_as_the_tensor_cores():
    """``mma_products`` sums each step of 16 bf16 products with the
    accumulator as the tensor cores do: aligned to the largest addend, cut
    to 26 bits, the sum rounded toward zero. 1 + 2^-24 + 2^-25 is kept
    whole by the 26 bits and then rounded toward zero to 1.0, where the
    exact sum rounded to nearest is 1 + 2^-23; a term below the 26th
    bit of the largest is dropped; across steps the accumulator is one
    addend of the next. On random bf16 operands the model stays within a
    few float32 ulps of the exact sum and differs from a float32 matmul."""
    q = torch.zeros(1, 1, 16)
    q[0, 0, :3] = torch.tensor([1.0, 2.0**-24, 2.0**-25])
    k = torch.zeros(1, 1, 16)
    k[0, 0, :3] = 1.0
    assert tflash.mma_products(q, k).item() == 1.0
    exact = torch.matmul(q.double(), k.double().transpose(-1, -2))
    assert exact.float().item() == 1.0 + 2.0**-23
    q[0, 0, 1:3] = torch.tensor([2.0**-27, 0.0])
    assert tflash.mma_products(q, k).item() == 1.0
    # two steps: the first step's 1.0 is an addend of the second
    q2, k2 = torch.zeros(1, 1, 32), torch.zeros(1, 1, 32)
    q2[0, 0, 0], q2[0, 0, 16], q2[0, 0, 17] = 1.0, 2.0**-24, 2.0**-25
    k2[0, 0, [0, 16, 17]] = 1.0
    assert tflash.mma_products(q2, k2).item() == 1.0
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(3, 40, 72, generator=gen).bfloat16().float()
    b = torch.randn(3, 24, 72, generator=gen).bfloat16().float()
    got = tflash.mma_products(a, b)
    exact = torch.matmul(a.double(), b.double().transpose(-1, -2))
    ulp = torch.finfo(torch.float32).eps * exact.abs().amax()
    assert got.dtype == torch.float32 and got.shape == (3, 40, 24)
    assert (got.double() - exact).abs().max() <= 8 * ulp
    assert not torch.equal(got, torch.matmul(a, b.transpose(-1, -2)))
