"""Every shape the JAX kernels' gates admit runs a kernel in the port.

The port's kernels are built per head-dim class (16, 32, 64, 128) and, for
the time and tiny-L kernels, per row class (16, 32), padded where a shape is
not its class (``CLASS_SOURCES``). Here, on the CPU:

* each gate enumerated over a grid (head dims 8 to 128 in steps of 8 for the
  one-pass kernel, 8 to 512 for the fused kernel, 64 and 128 for tiny-L;
  every head dim dividing 128 for space and time; F and L in
  {8, 16, 24, 32}; N from 256 to 2048 in steps of 128 for space): with stub
  libraries (``torch_stubs.py``) the wrapper launches exactly once wherever
  the gate opens, forward and backward, bf16 and float32, on the library
  its head dim names, and never raises ``NotImplementedError``;
* the classes' launchers switch on the classes the wrappers name, and the
  wide tile's launcher on the widths they name;
* the UNet launches ``chip_smoke.py``'s variants phase predicts
  (``VARIANT_UNET_PER_CALL``: clips of 32 frames, 192 channels), against
  the JAX gates;
* each plain version against the JAX Pallas kernel in interpret mode at
  one new shape per family (time at 8 and 32 frames, tiny-L at 8 and 24
  rows of head dim 128, one-pass at head dims 24 and 128, space at head
  dims 32 and 128) and the plain backward against ``jax.vjp`` (time at 8
  frames, space at head dim 32), within 1e-5 of the largest value (float32,
  DESIGN.md §6's kernels' tolerance).

The kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.models.mtov import TriplaneUNet
from moditalker_tpu_torch.ops import attention
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import divided_backward as tbwd
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash

from .test_torch_shipped_configs import (_attention_shapes, _jax_launches,
                                         _launches)
from . import torch_stubs
from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]

EXACT = 1e-5   # float32 plain version vs the Pallas kernel / jax.vjp
DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIVISORS = (1, 2, 4, 8, 16, 32, 64, 128)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=EXACT * np.abs(want).max())


# ------------------------------------------------------------ gate grids
def _divided_launch(axis, f, n, dh, dtype):
    """The forward and the backward of ``divided_attention`` at one shape
    (qkv of 128 lanes of heads), on the stub libraries."""
    heads = max(1, 128 // dh)
    seq = n if axis == "space" else f
    sin = cos = torch.zeros(seq, dh)
    x = torch.zeros(1, f, n, 3 * heads * dh, dtype=dtype).requires_grad_()
    out = tdiv.divided_attention(x, sin, cos, axis, heads, dh, dh**-0.5)
    torch.autograd.grad(out, x, torch.zeros(out.shape, dtype=dtype))


def _divided_grid(axis):
    if axis == "time":
        return [(f, 8, dh) for f in (8, 16, 24, 32) for dh in HEAD_DIVISORS]
    return [(1, n, dh) for n in range(256, 2049, 128) for dh in HEAD_DIVISORS]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", ["space", "time"])
def test_divided_gate_grid_launches_everywhere_it_opens(stub_launches, axis,
                                                        dtype):
    """Over the grid, every shape the divided gate admits launches the
    forward kernel once and the backward kernel once; a head dim of 1 (the
    gate admits it, but it has no rotary pair) raises ValueError in the
    port as the JAX package's rotary raises there, never
    NotImplementedError."""
    name = f"divided_{axis}_attention"
    opened = 0
    for f, n, dh in _divided_grid(axis):
        heads = max(1, 128 // dh)
        assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh) \
            == jdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
        if not tdiv.divided_attention_viable(axis, f, n, heads, dh, dh):
            continue
        opened += 1
        before = (tkernels.LAUNCHES[name],
                  tkernels.LAUNCHES[name + "_backward"])
        if dh == 1:
            with pytest.raises(IndexError):
                jrot._rot_matrix(1)   # the JAX kernel's rotary, at dh = 1
            with pytest.raises(ValueError, match="rotary pairs"):
                _divided_launch(axis, f, n, dh, dtype)
            continue
        _divided_launch(axis, f, n, dh, dtype)
        assert (tkernels.LAUNCHES[name],
                tkernels.LAUNCHES[name + "_backward"]) == (before[0] + 1,
                                                           before[1] + 1)
    assert opened == len(_divided_grid(axis))   # the grid is inside the gate
    f32 = dict(tkernels.FLOAT32_LAUNCHES_BY_SHAPE[name])
    assert (sum(f32.values()) == tkernels.LAUNCHES[name]) == (
        dtype == torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_space_head_dims_reach_their_design(stub_launches, monkeypatch,
                                            dtype):
    """Each head dim the space gate admits (2 to 128 dividing 128), over N
    from 256 to 2048, reaches the entry point its design names: the
    configurations' kernel at 64 (in float32 up to resident K: the float32
    kernel of its own), the pre-rotated design everywhere else. The
    pre-rotated design and the float32 kernel take a scratch beside qkv,
    the table and the output (one pointer more)."""
    f32 = dtype == torch.float32
    suffix = "_f32" if f32 else ""
    calls = []
    stub = torch_stubs.StubLib(stub_launches, calls)
    for lib in ("_lib", "_lib_f32", "_classes_lib", "_classes_lib_f32"):
        monkeypatch.setattr(tdiv, lib, lambda: stub)
    for n in range(256, 2049, 128):
        for dh in HEAD_DIVISORS[1:]:
            heads = 512 // dh
            assert tdiv.divided_attention_viable("space", 1, n, heads, dh, dh)
            tab = torch.zeros(n, dh)
            stub_launches.clear()
            calls.clear()
            out = tdiv.space_attention_cuda(
                torch.zeros(1, n, 3 * heads * dh, dtype=dtype), tab, tab,
                heads, dh, dh**-0.5)
            assert out.shape == (1, n, heads * dh) and out.dtype == dtype
            shipped = dh == 64 and not (f32 and n > tdiv.SPACE_F32_MAX_N)
            assert tdiv.space_prerotated(dh, n, f32) == (not shipped)
            entry = ("divided_space_attention" if shipped else
                     "divided_space_attention_prerotated") + suffix
            assert stub_launches == [entry], (n, dh)
            assert len(calls[0][1]) == (9 if shipped and not f32 else 10)
            assert calls[0][1][-6:-1] == (1, n, heads, dh, dh**-0.5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_gate_grid_launches_everywhere_it_opens(stub_launches, dtype):
    """``sdpa`` over head dims 8 to 128 in steps of 8 at the one-pass gate's
    lengths, and over the tiny-L gate's rows and head dims: every shape a
    gate admits launches its kernel once (meta tensors: nothing is
    allocated)."""
    count = lambda: dict(tkernels.LAUNCHES)
    for d in range(8, 129, 8):
        for n in (1024, 1280, 2048):
            admitted = tflash.onepass_attention_viable(n, n, d)
            assert admitted == jflash.onepass_attention_viable(n, n, d)
            assert admitted == (n % 256 == 0)
            q = torch.empty(2, 1, n, d, dtype=dtype, device="meta")
            before = count()
            attention.sdpa(q, q, q, scale=d**-0.5)
            want = before["onepass_attention"] + admitted
            assert count()["onepass_attention"] == want, (n, d)
    for l in (8, 16, 24, 32):
        for d in (64, 128):
            assert tflash.tiny_attention_viable(4096, l, l, d)
            assert jflash.tiny_attention_viable(4096, l, l, d)
            q = torch.empty(4096, l, d, dtype=dtype, device="meta")
            before = count()
            attention.sdpa(q, q, q, scale=d**-0.5)
            assert count()["tiny_attention"] == before["tiny_attention"] + 1
    assert not tflash.tiny_attention_viable(4096, 16, 16, 32)
    assert tkernels.LAUNCHES["fused_attention"] == 0


def _fused_entry(d, dtype, b=2, nq=1, nk=1):
    """The C entry point the fused and one-pass wrappers call at head dim
    d: the configurations' instantiations, the small-head classes up to 32,
    in bf16 the narrow tile at 40, 48 and 56, the wgmma tile built per width
    above; in float32 at 64, q [b, nq] over k [b, nk] past resident K where
    ``onepass_f32_prerounded`` takes it, the pre-pass and the bf16 K ring."""
    f32 = dtype == torch.float32
    if f32 and d == 64 and tflash.onepass_f32_prerounded(b, nq, nk):
        return tflash.PREROUNDED_ENTRY
    if not f32 and d in tflash.NARROW_HEAD_DIMS:
        return tflash.NARROW_ENTRY
    if d in tflash.HEAD_DIMS:
        entry = "fused_attention"
    elif d <= tflash.SMALLHEAD_MAX_DIM:
        entry = "fused_attention_classes"
    else:
        entry = "fused_attention_wide"
    return entry + ("_f32" if dtype == torch.float32 else "")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gate_grid_launches_everywhere_it_opens(stub_launches, dtype):
    """``sdpa_fused`` from 256 keys up (the fused gate: Nk a multiple of 128,
    d % 8 == 0) and ``fused_attention`` below 128 keys (Nk % 8 == 0) over
    head dims 8 to 512 (the gate has no upper bound on d): one launch each,
    on the entry point its head dim names, and never NotImplementedError.
    (Until the wide tile was built, heads past 128 raised it here.)"""
    for d in range(8, 513, 8):
        for nq, nk in ((100, 256), (64, 2048), (1000, 384)):
            q = torch.empty(2, nq, d, dtype=dtype, device="meta")
            k = torch.empty(2, nk, d, dtype=dtype, device="meta")
            assert attention.sdpa_fused_route(2, nq, nk, d) == "fused"
            before = tkernels.LAUNCHES["fused_attention"]
            stub_launches.clear()
            attention.sdpa_fused(q, k, k, d**-0.5)
            assert tkernels.LAUNCHES["fused_attention"] == before + 1
            assert stub_launches == [_fused_entry(d, dtype, 2, nq, nk)], d
        for nk in (8, 64, 120):
            assert tflash.fused_attention_tiles(nk, d)
            q = torch.empty(2, 33, d, dtype=dtype, device="meta")
            k = torch.empty(2, nk, d, dtype=dtype, device="meta")
            before = tkernels.LAUNCHES["fused_attention"]
            tflash.fused_attention(q, k, k, d**-0.5)
            assert tkernels.LAUNCHES["fused_attention"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_head_dims_reach_the_narrow_tile(stub_launches, dtype):
    """bf16 one-pass and fused attention at head dims 40, 48 and 56 launch
    the narrow tile's entry point (``NARROW_ENTRY``, csrc/flash_narrow.cu):
    one-pass with K resident (1024) and past it (2048), fused over one
    whole and one short key tile with ragged query chunks, over resident K
    and past it; float32 there launches the wgmma tile built per width
    (``fused_attention_wide_f32``). Counted under the wrappers' names and
    by entry point."""
    f32 = dtype == torch.float32
    want = "fused_attention_wide_f32" if f32 else tflash.NARROW_ENTRY
    assert tflash.NARROW_HEAD_DIMS == (40, 48, 56)
    for d in tflash.NARROW_HEAD_DIMS:
        assert tflash.attention_source(d, f32) == (
            "flash_wide" if f32 else "flash_narrow")
        for nq, nk in ((2048, 2048), (1024, 1024), (1000, 128), (1000, 120),
                       (300, 1024), (1280, 2048)):
            q = torch.empty(2, nq, d, dtype=dtype, device="meta")
            k = torch.empty(2, nk, d, dtype=dtype, device="meta")
            name = "onepass_attention" if nq == nk else "fused_attention"
            stub_launches.clear()
            before = tkernels.LAUNCHES_BY_ENTRY[want]
            if nq == nk:
                tflash.onepass_attention(q, k, k, d**-0.5)
            else:
                tflash.fused_attention(q, k, k, d**-0.5)
            assert stub_launches == [want], (d, nq, nk)
            assert tkernels.LAUNCHES_BY_ENTRY[want] == before + 1
            assert tkernels.LAUNCHES_BY_SHAPE[name][
                (2, nq, d) if nq == nk else (2, nq, nk, d)] >= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_at_32_frame_clips_reaches_the_staged_kernel(stub_launches,
                                                          dtype):
    """The time attention at clips of 8 frames (the frame class 16) and of
    24 and 32 (the frame class 32) launches the staged kernel's entry point
    (``STAGED_TIME_ENTRY``, csrc/time_staged.cuh) at every head dim, bf16
    and float32; at 16 frames the classes' kernel, the configurations' 16
    frames of 64 their own. The backward is the classes' at every clip
    length."""
    suffix = "_f32" if dtype == torch.float32 else ""
    staged = tdiv.STAGED_TIME_ENTRY + suffix
    assert tdiv.STAGED_TIME_FRAMES == (8, 24, 32)
    for f in (8, 16, 24, 32):
        for dh in HEAD_DIVISORS[1:]:
            stub_launches.clear()
            _divided_launch("time", f, 8, dh, dtype)
            if f != 16:
                forward = staged
            elif (f, dh) in tdiv.TIME_SHAPES:
                forward = "divided_time_attention" + suffix
            else:
                forward = "divided_time_attention_classes" + suffix
            assert tdiv.time_staged(f) == (forward == staged)
            assert stub_launches[0] == forward, (f, dh)
            assert stub_launches[1].startswith(
                "divided_time_attention_backward"), (f, dh)


# ------------------------------------------------------------ the sources
def _case_labels(source: str, function: str) -> tuple[int, ...]:
    text = (_build.CSRC / source).read_text()
    body = text[re.search(rf"(int|cudaError_t) {function}\(", text).start():]
    body = body[:body.index("\n}\n")]
    return tuple(int(n) for n in re.findall(r"case (\d+):", body))


def test_class_launchers_switch_on_the_named_classes():
    """The classes' launchers switch on the head-dim classes the wrappers
    name; the space backward's class 64 is the configurations' library,
    and its heads up to ``SPACE_BACKWARD_NARROW_MAX`` dims the class 16 on
    mma.sync."""
    classes = tflash.HEAD_DIM_CLASSES
    assert classes == (16, 32, 64, 128)
    assert _case_labels("divided_attention.cuh", "launch_time_classes") \
        == classes
    # the space kernel beside the configurations' head dim 64: the
    # pre-rotated design, per head-dim class (64 in float32 past resident K)
    assert _case_labels("divided_space.cuh", "launch_space_prerotated") \
        == classes
    assert _case_labels("divided_backward.cuh",
                        "launch_time_backward_classes") == classes
    assert _case_labels("divided_backward.cuh",
                        "launch_space_backward_classes") == tuple(
        c for c in classes if c not in tdiv.SPACE_BACKWARD_HEAD_DIMS
        and c > tdiv.SPACE_BACKWARD_NARROW_MAX) == (32, 128)
    assert _case_labels("divided_backward.cuh",
                        "launch_space_backward_narrow") == (
        tdiv.SPACE_BACKWARD_NARROW_MAX,)
    tile = (_build.CSRC / "tiny_attention.cuh").read_text()
    assert "launch_tiny<16, D, T, true>" in tile   # L = 8
    assert "launch_tiny<32, D, T, true>" in tile   # L = 24
    # the one-pass and fused kernels: the small-head classes 16 and 32 up to
    # head dim 32 (nothing else of the small-head tile: its class 64 went
    # with bf16 40-56's move to the narrow tile); in bf16 at 40, 48 and 56
    # the narrow tile, a case each; the wgmma tile built per width from 40
    # to 256 but 64 (a case each; in bf16 from 72), then its 256-column tile
    # in groups, up to the widest head Q fits for
    assert _case_labels("smallhead_tile.cuh", "launch_fused_classes") \
        == tflash.FUSED_HEAD_DIM_CLASSES == (16, 32)
    tile = (_build.CSRC / "smallhead_tile.cuh").read_text()
    body = tile[tile.index("cudaError_t launch_fused_classes("):]
    body = body[:body.index("\n}\n")]
    assert "if (D < 8 || D > 32 || D % 8)" in body
    assert "static_assert(DH == 16 || DH == 32," in tile
    assert tflash.SMALLHEAD_MAX_DIM == 32
    assert _case_labels("flash_narrow.cu", "fused_attention_narrow") \
        == tflash.NARROW_HEAD_DIMS
    assert _case_labels("time_staged.cuh", "launch_time_staged_classes") \
        == classes
    assert _case_labels("wgmma_wide.cuh", "launch_fused_wide") \
        == tflash.WIDE_HEAD_DIMS
    assert tflash.WIDE_HEAD_DIMS == tuple(
        d for d in range(tflash.SMALLHEAD_MAX_DIM + 8, tflash.WIDE_GROUP + 1, 8)
        if d not in tflash.HEAD_DIMS)
    # where bf16 runs the narrow tile, the wide tile is built for float32
    # alone
    assert all(tflash.SMALLHEAD_MAX_DIM < d < 64
               for d in tflash.NARROW_HEAD_DIMS)
    wide = (_build.CSRC / "wgmma_wide.cuh").read_text()
    launcher = wide[wide.index("cudaError_t launch_fused_wide("):]
    f32_only = launcher[launcher.index(
        "if constexpr (std::is_same<T, float>::value) {"):]
    f32_only = f32_only[:f32_only.index("\n  }\n")]
    assert tuple(int(n) for n in re.findall(r"case (\d+):", f32_only)) \
        == tflash.NARROW_HEAD_DIMS
    assert f"constexpr int kWdGroup = {tflash.WIDE_GROUP};" in wide
    assert "if (D > kWdGroup) return launch_wide<kWdGroup, T>" in wide

def test_staged_launcher_takes_8_frames_on_the_paired_tile():
    """The staged time kernel's launcher switches on the head-dim classes
    the wrappers name, and in each class launches 8 frames on the 16-row
    tile with two items a tile (``PAIR``) and 24 or 32 on the 32-row tile;
    it refuses 16 frames (the classes' kernel's), as the wrapper never sends
    them (``STAGED_TIME_FRAMES``)."""
    assert _case_labels("time_staged.cuh", "launch_time_staged_classes") \
        == tflash.HEAD_DIM_CLASSES
    text = (_build.CSRC / "time_staged.cuh").read_text()
    body = text[text.index("int launch_time_staged_classes("):]
    body = body[:body.index("\n}\n")]
    assert "if ((F != 8 && (F <= 16 || F > 32)) || F % 8" in body
    assert "F == 8 ? launch_time_staged<16, DH, TI, true>(" in body
    assert ": launch_time_staged<32, DH, TI>(" in body
    assert 16 not in tdiv.STAGED_TIME_FRAMES


# ------------------------------------------------------------ vs Pallas
def _divided_inputs(axis, f, n, dh, seed=11):
    heads = max(1, 128 // dh)
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(1, f, n, 3 * heads * dh)).astype(np.float32)
    if axis == "space":
        sin, cos = jrot.axial_rotary_sincos(16, n // 16, dh)
    else:
        sin, cos = jrot.time_rotary_sincos(f, dh)
    return qkv, sin, cos, heads


@pytest.mark.parametrize("axis,f,n,dh", [("time", 8, 16, 64),
                                         ("time", 32, 8, 64),
                                         ("time", 24, 8, 64),
                                         ("time", 32, 8, 8),
                                         ("space", 1, 256, 32),
                                         ("space", 1, 256, 128)])
def test_divided_class_plain_matches_pallas_interpret(axis, f, n, dh):
    qkv, sin, cos, heads = _divided_inputs(axis, f, n, dh)
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    want = jdiv.divided_attention(jnp.asarray(qkv), sin, cos, axis, heads,
                                  dh, dh**-0.5, interpret=True)
    got = tdiv.divided_attention(_t(qkv), _t(sin), _t(cos), axis, heads, dh,
                                 dh**-0.5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("l", [8, 24])
def test_tiny_class_plain_matches_pallas_interpret(l):
    """Tiny-L at 8 and 24 rows of head dim 128 (folded batch cut to 256)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(256, l, 128)).astype(np.float32)
               for _ in range(3))
    want = jflash.tiny_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 128**-0.5, interpret=True)
    got = tflash.tiny_attention(_t(q), _t(k), _t(v), 128**-0.5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", [24, 40, 48, 56, 128])
def test_onepass_class_plain_matches_pallas_interpret(d):
    """One-pass at head dim 24 (the UNet at 192 model channels), 40, 48
    (192 channels at ds = 1) and 56 (the narrow tile's widths) and 128 (8
    heads at 1024 channels, or 2 at 256)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 1024, d)).astype(np.float32)
               for _ in range(3))
    assert tflash.onepass_attention_viable(1024, 1024, d)
    assert d not in tflash.HEAD_DIMS
    want = jflash.onepass_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), d**-0.5, interpret=True)
    got = tflash.onepass_attention(_t(q), _t(k), _t(v), d**-0.5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("nq,nk", [(100, 128), (100, 120), (300, 256)])
def test_fused_narrow_plain_matches_pallas_interpret(nq, nk):
    """The fused kernel's plain version at head dim 48 (the narrow tile's
    fused shapes: ragged query rows over one whole 128-key tile, one short
    of it and two tiles) against the JAX package's K-blocked Pallas kernel
    (``_attn_kernel``) in interpret mode."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, nq, 48)).astype(np.float32)
    k, v = (rng.normal(size=(2, nk, 48)).astype(np.float32)
            for _ in range(2))
    assert tflash.fused_attention_tiles(nk, 48)
    want = jflash.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 48**-0.5, interpret=True)
    got = tflash.fused_attention(_t(q), _t(k), _t(v), 48**-0.5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("axis,f,n,dh", [("time", 8, 8, 64),
                                         ("space", 1, 256, 32)])
def test_divided_class_backward_matches_jax_vjp(axis, f, n, dh):
    """The written-out adjoints (the plain backward the kernels are held
    to) at a new class of each axis, against ``jax.vjp`` of the JAX
    reference."""
    qkv, sin, cos, heads = _divided_inputs(axis, f, n, dh, seed=12)
    g = np.random.default_rng(13).normal(
        size=(1, f, n, heads * dh)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jdiv.divided_attention_reference(
        t, sin, cos, axis, heads, dh, dh**-0.5, use_flash=False),
        jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    got = tbwd.divided_attention_backward_reference(
        _t(qkv), _t(np.asarray(out)), _t(g), _t(sin), _t(cos), axis, heads,
        dh, dh**-0.5)
    _close(got.numpy(), want)


# ------------------------------------------------------------ the variants
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant,path", [("clip32", "fused"),
                                          ("clip32", "modular"),
                                          ("channels192", "fused"),
                                          ("num_heads2", "fused")])
def test_variant_unet_launches_follow_the_jax_gates(stub_launches,
                                                    monkeypatch, tmp_path,
                                                    variant, path):
    """The variants phase's configurations (a shipped YAML with one key
    changed, read by ``load_config`` as ``sample`` reads it): the UNet at
    batch 2 on the meta device launches exactly what the JAX gates send its
    attention blocks, and what ``VARIANT_UNET_PER_CALL`` holds for the card
    run to be checked against."""
    smoke = _chip_smoke()
    monkeypatch.chdir(REPO)
    if path == "modular":
        for name in smoke.SWITCHES:
            monkeypatch.setenv(name, "1")
    cfg = tcfg.load_config(smoke.variant_yaml(variant, str(tmp_path)))
    ae = cfg.mtov_ae
    unet_cfg = dataclasses.replace(cfg.mtov_unet, latent_res=ae.latent_res,
                                   latent_t=ae.timesteps // ae.splits)
    length = ae.latent_res**2 + 2 * unet_cfg.latent_t * ae.latent_res
    with torch.device("meta"):
        unet = TriplaneUNet(unet_cfg, torch.bfloat16)
        shapes = _attention_shapes(unet)
        unet(torch.empty(2, 4, length),
             torch.empty(2, 8, length, dtype=torch.bfloat16),
             torch.empty(2, 4, length, dtype=torch.bfloat16),
             torch.zeros(2, dtype=torch.long))
    want = smoke.VARIANT_UNET_PER_CALL[variant, path]
    assert _launches() == _jax_launches(shapes, unet_cfg.num_heads) == want
