"""The gradient of the divided space/time attention: the port's written-out
adjoints against the JAX package, and the wiring of its backward kernels.

* ``rotary_transpose`` is the adjoint of the rotary, with tables whose pair
  entries differ (the time table's) and with the axial table.
* ``divided_attention_backward_reference`` against ``jax.vjp`` of the JAX
  package's ``divided_attention_reference(..., use_flash=False)``, float32,
  within 1e-5 of the largest gradient, for both axes and a space table of
  random angles; the float32 route (the kernels' rounding points) against
  the same within ``ROUTE_VS_EXACT``, and not equal to it.
* The gradient of ``divided_attention`` on the CPU (the plain path) against
  ``jax.vjp`` of the JAX wrapper (its Pallas kernels in interpret mode).
* The space backward's pre-pass: its plain version
  (``space_backward_prepass_reference``) against the JAX package's rotary
  and forward output, the route computed from its scratch against
  ``jax.vjp`` and, bit for bit, against the route computed from qkv.
* ``DividedAttention``'s wiring with stub libraries (``torch_stubs.py``): a
  CUDA-like call reaches the backward entry points in order (space: the
  pre-pass, dq, dk/dv) with the tensors' pointers, the scratch's shapes and
  the problem's shape, is counted, and shapes the kernels are not built for
  raise rather than fall back to the plain backward.
* The ``case`` labels and C symbols of ``csrc/divided_backward{,_f32}.cu``
  against the wrappers' shape lists.

The kernels themselves run on the card: tests/test_torch_cuda.py and
``chip_smoke.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import divided_backward as tbwd

from .torch_stubs import StubLib, stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADS, DH = 2, 64
EXACT = 1e-5      # float32 adjoints vs jax.vjp, over the largest gradient
# the float32 route against the exact gradient, (max, rms, quantile) of
# ``relative_errors``: the bf16 rounding of q~, k~, v, g, P and dS. About
# 2.5 times what these inputs read (space 6.1e-3 / 4.0e-3 / 2.4e-3, time
# 3.9e-3 / 3.5e-3 / 1.9e-3); a route that rounds nothing reads ~1e-7
ROUTE_VS_EXACT = (1.5e-2, 1e-2, 6e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tables(case, f, n):
    if case == "space":
        return jrot.axial_rotary_sincos(16, n // 16, DH)
    if case == "time":
        return jrot.time_rotary_sincos(f, DH)
    # random angles: every entry of a pair its own
    ang = np.random.default_rng(5).uniform(-3, 3, (n, DH)).astype(np.float32)
    return np.sin(ang), np.cos(ang)


def _inputs(case, seed=0):
    """(axis, qkv, g, sin, cos) at a small shape of the axis."""
    axis = "time" if case == "time" else "space"
    b, f, n = (1, 2, 256) if axis == "space" else (2, 16, 8)
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, f, n, 3 * HEADS * DH)).astype(np.float32)
    g = rng.normal(size=(b, f, n, HEADS * DH)).astype(np.float32)
    sin, cos = _tables(case, f, n)
    return axis, qkv, g, sin, cos


def _jax_vjp(axis, qkv, g, sin, cos):
    out, vjp = jax.vjp(lambda t: jdiv.divided_attention_reference(
        t, sin, cos, axis, HEADS, DH, DH**-0.5, use_flash=False),
        jnp.asarray(qkv))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _assert_close(got, want, rel):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


# ------------------------------------------------------------ the rotary
@pytest.mark.parametrize("case", ["time", "space"])
def test_rotary_transpose_is_the_adjoint(case):
    """<rot(x), y> = <x, rotᵀ(y)>, and rotᵀ is the per-element formula
    dx[2i] = y[2i]·c[2i] + y[2i+1]·s[2i+1], dx[2i+1] = y[2i+1]·c[2i+1] −
    y[2i]·s[2i]. The time table's pairs differ, so a transpose that reads
    one sin per pair fails it."""
    sin, cos = (_t(a) for a in _tables(case, 16, 256))
    if case == "time":
        assert not torch.equal(sin[:, 0::2], sin[:, 1::2])
    gen = torch.Generator().manual_seed(1)
    x, y = (torch.randn(3, *sin.shape, generator=gen, dtype=torch.float64)
            for _ in range(2))
    s64, c64 = sin.double(), cos.double()
    rot_x, _ = rotary.apply_rot_emb(x, x, s64, c64)
    dx = tbwd.rotary_transpose(y, s64, c64)
    assert torch.allclose((rot_x * y).sum(), (x * dx).sum(), rtol=1e-12)
    want = torch.empty_like(y)
    want[..., 0::2] = y[..., 0::2] * c64[:, 0::2] + y[..., 1::2] * s64[:, 1::2]
    want[..., 1::2] = y[..., 1::2] * c64[:, 1::2] - y[..., 0::2] * s64[:, 0::2]
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-12)


# ------------------------------------------------------------ the adjoints
@pytest.mark.parametrize("case", ["space", "time", "space_random_table"])
def test_backward_reference_matches_jax_vjp(case):
    axis, qkv, g, sin, cos = _inputs(case)
    out, want = _jax_vjp(axis, qkv, g, sin, cos)
    got = tbwd.divided_attention_backward_reference(
        _t(qkv), _t(out), _t(g), _t(sin), _t(cos), axis, HEADS, DH,
        DH**-0.5)
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    _assert_close(got, want, EXACT)


@pytest.mark.parametrize("case", ["space", "time"])
def test_float32_route_matches_jax_vjp_within_its_rounding(case):
    """The route rounds where the kernels do: within ``ROUTE_VS_EXACT`` of
    the exact gradient, and visibly not equal to it."""
    axis, qkv, g, sin, cos = _inputs(case, seed=1)
    out, want = _jax_vjp(axis, qkv, g, sin, cos)
    got = tbwd.divided_attention_backward_float32_route(
        _t(qkv), _t(out), _t(g), _t(sin), _t(cos), axis, HEADS, DH,
        DH**-0.5)
    errs = tkernels.relative_errors(got, _t(want))
    assert all(e <= lim for e, lim in zip(errs, ROUTE_VS_EXACT)), errs
    assert errs[1] > 1e-4, errs


# ------------------------------------------------------------ the pre-pass
def _space_case(dh, dtype, seed):
    """qkv [2, 256, 3·H·dh] (heads of 128 lanes), g, the JAX package's
    forward output and a table of random angles repeated over each pair."""
    n, heads = 256, max(1, 128 // dh)
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(1, 2, n, 3 * heads * dh)).astype(np.float32)
    g = rng.normal(size=(1, 2, n, heads * dh)).astype(np.float32)
    ang = np.repeat(rng.uniform(-3, 3, (n, dh // 2)), 2, -1).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    if dtype == torch.bfloat16:   # bf16 inputs: the JAX package sees them too
        qkv, g = (_t(a).bfloat16().float().numpy() for a in (qkv, g))
    out, vjp = jax.vjp(lambda t: jdiv.divided_attention_reference(
        t, sin, cos, "space", heads, dh, dh**-0.5, use_flash=False),
        jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    flat = lambda a: _t(a).reshape(2, n, -1)
    return (heads, flat(qkv).to(dtype), flat(np.asarray(out)).to(dtype),
            flat(g).to(dtype), _t(sin), _t(cos), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [128, 64, 32])
def test_space_prepass_matches_jax(dh, dtype):
    """The pre-pass's plain version against the JAX package: q~ and k~ are
    its kernel's ``_apply_rot`` of q (times the scale) and k, rounded to
    bf16, v and g rounded once, and D = rowsum(g ∘ out) of its forward
    output within fp32 rounding. The route computed from the scratch is
    within ``ROUTE_VS_EXACT`` of ``jax.vjp``."""
    heads, qkv, out, g, sin, cos, exact = _space_case(dh, dtype, seed=4)
    scale = dh**-0.5
    scratch, gs, dsum = tbwd.space_backward_prepass_reference(
        qkv, out, g, sin, cos, heads, dh, scale)
    assert scratch.dtype == gs.dtype == torch.bfloat16
    assert scratch.shape == (2, 256, 3 * heads * dh)
    assert gs.shape == (2, 256, heads * dh) and dsum.shape == (2, heads, 256)
    x = scratch.float().reshape(2, 256, 3, heads, dh)
    # the JAX kernel's rotary on the one 128-lane block of q and of k
    sin_t, cos_t = jdiv._tile_tables(sin.numpy(), cos.numpy(), heads)
    r = jnp.asarray(jdiv._rot_block(heads, dh))
    q, k, v = (t.float() for t in qkv.chunk(3, dim=-1))
    for third, t, mul in ((0, q, scale), (1, k, 1.0)):
        want = jdiv._apply_rot(jnp.asarray(t.numpy()), sin_t, cos_t, r, mul)
        want = _t(want).bfloat16().float().reshape(2, 256, heads, dh)
        assert torch.equal(x[:, :, third, :, :dh], want), third
    assert torch.equal(x[:, :, 2], v.bfloat16().float().reshape(
        2, 256, heads, dh))
    gh = g.float().reshape(2, 256, heads, dh)
    assert torch.equal(gs.float().reshape(2, 256, heads, dh),
                       gh.bfloat16().float())
    d = (gh.double() * out.double().reshape(2, 256, heads, dh)).sum(-1)
    _assert_close(dsum.transpose(1, 2), d.numpy(), 1e-6)
    got = tbwd.space_backward_route_from_prepass(scratch, gs, dsum, sin, cos,
                                                 heads, dh, scale)
    errs = tkernels.relative_errors(got, _t(exact).reshape(got.shape))
    assert all(e <= lim for e, lim in zip(errs, ROUTE_VS_EXACT)), errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [128, 64, 32])
def test_space_route_from_prepass_is_the_route(dh, dtype):
    """The float32 route computed from the pre-pass's scratch, gs and dsum
    equals ``divided_attention_backward_float32_route`` computed from qkv
    bit for bit, at every head dim the pre-pass serves: the scratch holds
    the route's rounding points (q~, k~ and v rounded once, g rounded, D in
    the pre-pass's order)."""
    heads, qkv, out, g, sin, cos, _ = _space_case(dh, dtype, seed=5)
    args = (sin, cos, heads, dh, dh**-0.5)
    prepass = tbwd.space_backward_prepass_reference(qkv, out, g, *args)
    got = tbwd.space_backward_route_from_prepass(*prepass, *args)
    want = tbwd.divided_attention_backward_float32_route(
        qkv[None], out[None], g[None], sin, cos, "space", heads, dh,
        dh**-0.5)[0]
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("case", ["space", "time"])
def test_divided_gradient_on_cpu_matches_jax_vjp(case):
    """``divided_attention`` on CPU tensors: the plain forward, the
    written-out adjoints backward (``DividedAttentionBackward``), against
    ``jax.vjp`` of the JAX wrapper with its kernels in interpret mode."""
    axis, qkv, g, sin, cos = _inputs(case, seed=2)
    b, f, n, _ = qkv.shape
    assert tdiv.divided_attention_viable(axis, f, n, HEADS, DH, DH)
    want_out, vjp = jax.vjp(lambda t: jdiv.divided_attention(
        t, sin, cos, axis, HEADS, DH, DH**-0.5, interpret=True),
        jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    tkernels.reset_launch_counts()
    x = _t(qkv).requires_grad_()
    out = tdiv.divided_attention(x, _t(sin), _t(cos), axis, HEADS, DH,
                                 DH**-0.5)
    assert type(out.grad_fn).__name__ == "DividedAttentionBackward"
    (got,) = torch.autograd.grad(out, x, _t(g))
    _assert_close(out.detach(), np.asarray(want_out), EXACT)
    _assert_close(got, np.asarray(want), EXACT)
    assert not any(tkernels.LAUNCHES.values())


# ------------------------------------------------------------ the wiring
@pytest.mark.parametrize("axis,dtype", [("space", torch.float32),
                                        ("time", torch.float32),
                                        ("space", torch.bfloat16),
                                        ("time", torch.bfloat16)])
def test_backward_reaches_its_entry_point(stub_launches, monkeypatch, axis,
                                          dtype):
    """A CUDA-like qkv (stub libraries) launches the forward kernel, then
    the backward once, through the entry points of qkv's type, with the
    pointers of qkv, the saved output, the cotangent and the returned
    gradient, and the problem's shape; nothing else is launched. Space runs
    its three steps in order: the pre-pass (qkv, the pair table, out and g
    into the scratch, gs and dsum of ``space_backward_scratch``, with their
    shapes), dq and dk/dv (those, the table, dqkv and the row statistics)."""
    args, scratch = [], []
    for lib in ("_bwd_lib", "_bwd_lib_f32"):
        monkeypatch.setattr(tdiv, lib,
                            lambda: StubLib(stub_launches, args))
    allocate = tdiv.space_backward_scratch
    monkeypatch.setattr(tdiv, "space_backward_scratch", lambda *a: (
        scratch.extend(allocate(*a)) or tuple(scratch)))
    f, n = (2, 256) if axis == "space" else (16, 8)
    sin, cos = (_t(a) for a in _tables(axis, f, n))
    x = torch.randn(1, f, n, 3 * HEADS * DH).to(dtype).requires_grad_()
    out = tdiv.divided_attention(x, sin, cos, axis, HEADS, DH, 0.125)
    assert type(out.grad_fn).__name__ == "DividedAttentionBackward"
    g = torch.randn(out.shape).to(dtype)
    (dx,) = torch.autograd.grad(out, x, g)
    suffix = "_f32" if dtype == torch.float32 else ""
    fwd, bwd = f"divided_{axis}_attention", f"divided_{axis}_attention_backward"
    assert dx.dtype == dtype and dx.shape == x.shape
    ptr = lambda *ts: tuple(t.data_ptr() for t in ts)
    if axis == "space":
        steps = [f"divided_space_backward_{step}{suffix}"
                 for step in ("prepass", "dq", "dkdv")]
        assert stub_launches == [fwd + suffix, *steps]
        assert [name for name, _ in args] == steps
        pre, dq, dkdv = (a for _, a in args)
        sc, gs, dsum, stats = scratch
        assert [(t.dtype, tuple(t.shape)) for t in scratch] == [
            (torch.bfloat16, (f, n, 3 * HEADS * DH)),
            (torch.bfloat16, (f, n, HEADS * DH)),
            (torch.float32, (f, HEADS, n)),
            (torch.float32, (f, HEADS, n, 2))]
        table = pre[1]
        assert table and table not in ptr(sin, cos)
        assert pre[:7] == (x.data_ptr(), table, *ptr(out, g, sc, gs, dsum))
        assert dq[:6] == dkdv[:6] == (*ptr(sc, gs, dsum), table,
                                      dx.data_ptr(), stats.data_ptr())
        for a in (pre, dq, dkdv):
            assert list(a[-6:-2]) == [f, n, HEADS, DH]
            assert a[-2] == 0.125
        shape = (f, n, 3 * HEADS * DH)
    else:
        assert stub_launches == [fwd + suffix, bwd + suffix]
        ((name, a),) = args
        assert name == bwd + suffix
        qkv_p, sin_p, cos_p, g_p, dqkv_p, *ints, scale, _ = a
        assert (sin_p, cos_p) == ptr(sin, cos)
        assert (qkv_p, g_p, dqkv_p) == ptr(x, g, dx)
        assert ints == [1, f, n, HEADS, DH] and scale == 0.125
        shape = tuple(x.shape)
    assert tkernels.LAUNCHES[bwd] == 1
    assert dict(tkernels.LAUNCHES_BY_SHAPE[bwd]) == {shape: 1}
    f32 = dict(tkernels.FLOAT32_LAUNCHES_BY_SHAPE[bwd])
    assert f32 == ({shape: 1} if dtype == torch.float32 else {})
    assert sum(tkernels.LAUNCHES.values()) == 2


@pytest.mark.parametrize("axis,f,n,dh,dtype,error", [
    ("space", 1, 1000, 64, torch.bfloat16, ValueError),
    ("space", 1, 256, 48, torch.float32, ValueError),
    ("time", 40, 8, 64, torch.float32, ValueError)])
def test_backward_refuses_unbuilt_shapes(stub_launches, axis, f, n, dh,
                                         dtype, error):
    """A shape outside the forward's gate (N off the 128-row tiling, a head
    dim that does not divide 128, 40 frames) has no backward kernel: it
    raises on the card before anything launches, and the plain backward is
    never run in its place. (Inside the gate every shape has one: the
    shapes this test once refused launch in
    ``test_backward_reaches_the_classes_entry_points``.)"""
    heads = 2
    sin = cos = torch.zeros(n if axis == "space" else f, dh)
    qkv = torch.randn(1, f, n, 3 * heads * dh).to(dtype)
    g = torch.randn(1, f, n, heads * dh).to(dtype)
    with pytest.raises(error):
        if axis == "space":
            tdiv.space_attention_backward_cuda(
                qkv.reshape(f, n, -1), g.reshape(f, n, -1),
                g.reshape(f, n, -1), sin, cos, heads, dh, 0.125)
        else:
            tdiv.time_attention_backward_cuda(qkv, g, sin, cos, heads, dh,
                                              0.125)
    assert stub_launches == []
    assert not tkernels.LAUNCHES["divided_space_attention_backward"]
    assert not tkernels.LAUNCHES["divided_time_attention_backward"]


@pytest.mark.parametrize("axis,f,n,dh,dtype,entry", [
    ("space", 1, 1280, 64, torch.bfloat16, ""),
    ("space", 1, 2048, 64, torch.float32, "_f32"),
    ("space", 1, 256, 32, torch.float32, "_classes_f32"),
    ("space", 1, 256, 128, torch.bfloat16, "_classes"),
    ("space", 1, 384, 2, torch.float32, "_classes_f32"),
    ("space", 1, 256, 16, torch.bfloat16, "_classes"),
    ("time", 8, 8, 64, torch.float32,
     "divided_time_attention_backward_classes_f32"),
    ("time", 32, 8, 128, torch.bfloat16,
     "divided_time_attention_backward_classes")])
def test_backward_reaches_the_classes_entry_points(stub_launches, axis, f,
                                                   n, dh, dtype, entry):
    """Through the autograd function: the forward launches, then the
    backward once, at shapes the configurations do not reach: space at
    head dim 64 past 1152 keys (the configurations' library, which takes
    any N % 128 == 0), space at head dims 32 and 128 (the classes'
    library: its pre-pass, dq and dk/dv) and 2 and 16 (the classes'
    library, one entry point: the resident plan's where
    ``space_backward_narrow_plan`` names it, else the mma.sync class's),
    and time at 8 (the staged kernel's entry point in that library) and 32
    frames (``entry``: the classes' entry point each shape reached before
    the resident plan and the staged kernel)."""
    heads = 256 // dh if axis == "space" else HEADS
    if axis == "space":
        side = 32 if n % 32 == 0 and n >= 1024 else 16
        if dh >= 4:
            sin, cos = (_t(a) for a in rotary.axial_rotary_sincos(
                side, n // side, dh))
        else:   # the axial table has no entry below head dim 4
            sin = cos = torch.ones(n, dh)
    else:
        sin, cos = (_t(a) for a in rotary.time_rotary_sincos(f, dh))
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    x = torch.randn(1, f, n, 3 * heads * dh).to(dtype).requires_grad_()
    out = tdiv.divided_attention(x, sin, cos, axis, heads, dh, 0.125)
    (dx,) = torch.autograd.grad(out, x, torch.randn(out.shape).to(dtype))
    assert dx.shape == x.shape and dx.dtype == dtype
    f32 = "_f32" if dtype == torch.float32 else ""
    if axis == "space" and dh <= tdiv.SPACE_BACKWARD_NARROW_MAX:
        if tdiv.space_backward_narrow_plan(f, n, heads) == "resident":
            entry = tdiv.SPACE_BACKWARD_RESIDENT_ENTRY + f32
        else:
            entry = "divided_space_attention_backward" + entry
        assert stub_launches[1:] == [entry]
    elif axis == "space":
        assert stub_launches[1:] == [f"divided_space_backward_{step}{entry}"
                                     for step in ("prepass", "dq", "dkdv")]
    else:
        if tdiv.time_backward_staged(f):
            entry = tdiv.STAGED_TIME_BACKWARD_ENTRY + f32
        assert stub_launches[-1] == entry and len(stub_launches) == 2
    assert tkernels.LAUNCHES[f"divided_{axis}_attention_backward"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_time_backward_at_8_frames_reaches_the_staged_kernel(stub_launches,
                                                             monkeypatch,
                                                             dtype):
    """The time backward at clips of 8 frames launches the staged kernel's
    entry point (``STAGED_TIME_BACKWARD_ENTRY``, csrc/time_staged_backward.cuh)
    at every head-dim class, 2 to 128, bf16 and float32, with the pointers
    of qkv, the tables, the cotangent and dqkv and the problem's shape; 16
    frames keep the configurations' kernel (at head dim 64) and the
    classes', 24 and 32 the classes'."""
    f32 = "_f32" if dtype == torch.float32 else ""
    args = []
    for lib in ("_bwd_lib", "_bwd_lib_f32", "_bwd_classes_lib",
                "_bwd_classes_lib_f32"):
        monkeypatch.setattr(tdiv, lib, lambda: StubLib(stub_launches, args))
    assert tdiv.STAGED_TIME_BACKWARD_FRAMES == (8,)
    for f in (8, 16, 24, 32):
        for dh in (2, 4, 8, 16, 32, 64, 128):
            heads, n = max(1, 128 // dh), 8
            sin, cos = (_t(a) for a in rotary.time_rotary_sincos(f, dh))
            qkv = torch.zeros(1, f, n, 3 * heads * dh, dtype=dtype)
            g = torch.zeros(1, f, n, heads * dh, dtype=dtype)
            stub_launches.clear()
            args.clear()
            dqkv = tdiv.time_attention_backward_cuda(qkv, g, sin, cos, heads,
                                                     dh, dh**-0.5)
            if f == 8:
                want = tdiv.STAGED_TIME_BACKWARD_ENTRY + f32
            elif (f, dh) in tdiv.TIME_SHAPES:
                want = "divided_time_attention_backward" + f32
            else:
                want = "divided_time_attention_backward_classes" + f32
            assert tdiv.time_backward_staged(f) == (f == 8)
            assert stub_launches == [want], (f, dh)
            ((name, a),) = args
            assert a[:5] == tuple(t.data_ptr()
                                  for t in (qkv, sin, cos, g, dqkv))
            assert list(a[5:10]) == [1, f, n, heads, dh]
            assert a[10] == dh**-0.5
    by_entry = tkernels.LAUNCHES_BY_ENTRY
    assert by_entry[tdiv.STAGED_TIME_BACKWARD_ENTRY + f32] == 7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_space_backward_narrow_heads_reach_their_plan(stub_launches,
                                                      monkeypatch, dtype):
    """The space backward at heads of 2, 4, 8 and 16 dims over N = 256 to
    2048 and 16 to 4096 (frame, head) pairs launches the one entry point of
    the plan ``space_backward_narrow_plan`` names: the resident block per
    (frame, head) (``SPACE_BACKWARD_RESIDENT_ENTRY``: qkv, the pair table,
    out, g and dqkv, no scratch) or the class
    (``divided_space_attention_backward_classes``: those and the stats
    scratch), in the classes' library of qkv's type; never the resident one
    past the 1024 tokens it holds."""
    f32 = "_f32" if dtype == torch.float32 else ""
    args, scratch = [], []
    for lib in ("_bwd_classes_lib", "_bwd_classes_lib_f32"):
        monkeypatch.setattr(tdiv, lib, lambda: StubLib(stub_launches, args))
    allocate = tdiv.space_backward_scratch
    monkeypatch.setattr(tdiv, "space_backward_scratch", lambda *a: (
        scratch.clear() or scratch.extend(allocate(*a)) or tuple(scratch)))
    plans = set()
    for n in range(256, 2049, 128):
        for dh in (2, 4, 8, 16):
            heads = 128 // dh
            sin = cos = torch.ones(n, dh)
            for bf in (1, 8, 64):
                qkv = torch.zeros(bf, n, 3 * heads * dh, dtype=dtype)
                out = torch.zeros(bf, n, heads * dh, dtype=dtype)
                stub_launches.clear()
                args.clear()
                dqkv = tdiv.space_attention_backward_cuda(
                    qkv, out, out, sin, cos, heads, dh, dh**-0.5)
                plan = tdiv.space_backward_narrow_plan(bf, n, heads)
                plans.add(plan)
                ((name, a),) = args
                ptrs = (qkv.data_ptr(), a[1], out.data_ptr(),
                        out.data_ptr(), dqkv.data_ptr())
                if plan == "resident":
                    assert n <= 1024
                    assert stub_launches == [
                        tdiv.SPACE_BACKWARD_RESIDENT_ENTRY + f32]
                    assert scratch == [] and a[:5] == ptrs
                else:
                    assert plan == "class"
                    assert stub_launches == [
                        "divided_space_attention_backward_classes" + f32]
                    (stats,) = scratch
                    assert tuple(stats.shape) == (bf, heads, n, 2)
                    assert a[:6] == (*ptrs, stats.data_ptr())
                assert a[-6:-1] == (bf, n, heads, dh, dh**-0.5)
    assert plans == {"resident", "class"}


def test_narrow_plan_table_names_one_plan_everywhere_it_was_measured():
    """``SPACE_BACKWARD_RESIDENT_MIN_PAIRS`` (tools/ab_space_backward.py
    --gate over N = 256 to 1024 and 32 to 2048 (frame, head) pairs): lengths
    the resident kernel holds (up to ``kSbrMaxN`` in
    csrc/divided_backward.cuh), each with a least pair count the gate
    measured; at every measured (N, pairs) the chooser names exactly one
    plan, the resident one from that count on, and past the table the
    class."""
    header = (_build.CSRC / "divided_backward.cuh").read_text()
    (max_n,) = re.findall(r"constexpr int kSbrMaxN = (\d+);", header)
    measured = (32, 64, 128, 256, 512, 1024, 2048)
    table = tdiv.SPACE_BACKWARD_RESIDENT_MIN_PAIRS
    assert max(table) <= int(max_n) == 1024
    for n, least in table.items():
        assert n % 128 == 0 and 256 <= n and least in measured
    for n in range(256, 1025, 128):
        for pairs in measured:
            want = ("resident" if n in table and pairs >= table[n]
                    else "class")
            assert tdiv.space_backward_narrow_plan(1, n, pairs) == want
            assert tdiv.space_backward_narrow_plan(pairs, n, 1) == want
    for n in range(1152, 2049, 128):
        assert tdiv.space_backward_narrow_plan(64, n, 64) == "class"


def test_backward_refuses_a_cotangent_of_another_type(stub_launches):
    """The output and cotangent are read in qkv's type and shape."""
    sin, cos = (_t(a) for a in rotary.time_rotary_sincos(16, DH))
    qkv = torch.randn(1, 16, 8, 3 * HEADS * DH)
    g = torch.randn(1, 16, 8, HEADS * DH)
    with pytest.raises(ValueError, match="cotangent"):
        tdiv.time_attention_backward_cuda(qkv, g.bfloat16(), sin, cos, HEADS,
                                          DH, 0.125)
    with pytest.raises(ValueError, match="cotangent"):
        tdiv.time_attention_backward_cuda(qkv, g[..., :64], sin, cos, HEADS,
                                          DH, 0.125)
    assert stub_launches == []


def test_first_stage_g_step_launches_the_backward_kernels(stub_launches):
    """A first-stage G micro-step (AE 64 wide, depth 1, full spatial size,
    so that both gates pass; stub libraries) launches each backward kernel
    once per attention, float32, and a D micro-step, whose AE runs without
    a graph, none; no ``RecomputeThroughPlain`` backward runs."""
    from moditalker_tpu_torch.config import (MtovAEConfig, MtovLossConfig,
                                             MtovTrainConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import autograd
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    trainer = FirstStageTrainer(ae_cfg, MtovLossConfig(disc_start=-1),
                                MtovTrainConfig(seed=0, accum_iter=1),
                                device="cpu")
    video = synthetic_mtov_batch(1, ae_cfg.timesteps, ae_cfg.resolution,
                                 0)["x"]
    recomputed = []
    kept = vars(autograd.RecomputeThroughPlain)["backward"]

    def counted(ctx, g):
        recomputed.append(1)
        return kept.__func__(ctx, g)

    per_step = 2 * ae_cfg.depth   # the encoder's blocks and the decoder's
    shapes = {"divided_space_attention_backward": (16, 1024, 384),
              "divided_time_attention_backward": (1, 16, 1024, 384)}
    try:
        autograd.RecomputeThroughPlain.backward = staticmethod(counted)
        for kind in ("G", "D"):
            assert trainer._disc_phase == (kind == "D")
            tkernels.reset_launch_counts()
            trainer.step(video)
            for name, shape in shapes.items():
                want = per_step if kind == "G" else 0
                assert tkernels.LAUNCHES[name] == want, (kind, name)
                assert dict(tkernels.FLOAT32_LAUNCHES_BY_SHAPE[name]) == (
                    {shape: want} if want else {}), (kind, name)
            assert tkernels.LAUNCHES["divided_space_attention"] == per_step
    finally:
        autograd.RecomputeThroughPlain.backward = kept
    assert not recomputed


# ------------------------------------------------------------ the sources
def _entry_body(source: str, function: str) -> str:
    text = (_build.CSRC / source).read_text()
    body = text[text.index(f"int {function}("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("suffix", ["", "_f32"])
def test_backward_sources_match_the_wrappers(suffix):
    """Each backward source defines exactly its entry points (space: the
    pre-pass, dq and dk/dv of ``SPACE_BACKWARD_STEPS``; time: one), and
    their ``case`` labels are the shapes the wrappers let through: head dims
    for the space backward, (frames, head dim) for the time backward."""
    src = f"divided_backward{suffix}.cu"
    text = (_build.CSRC / src).read_text()
    c_api = text[text.index('extern "C" {'):]
    space = [f"divided_space_backward_{step}"
             for step, _ in tdiv.SPACE_BACKWARD_STEPS]
    assert space == [f"divided_space_backward_{step}"
                     for step in ("prepass", "dq", "dkdv")]
    assert set(re.findall(r"\bint (\w+)\(", c_api)) == {
        n + suffix for n in (*space, "divided_time_attention_backward")}
    labels = lambda fn: tuple(int(x) for x in re.findall(
        r"case (\d+):", _entry_body(src, fn + suffix)))
    for name in space:
        assert labels(name) == tdiv.SPACE_BACKWARD_HEAD_DIMS == (64,)
    assert labels("divided_time_attention_backward") == tuple(
        x for shape in tdiv.TIME_SHAPES for x in shape) == (16, 64)
    for name in ("divided_space_attention_backward",
                 "divided_time_attention_backward"):
        assert tkernels.SOURCES[name] == "divided_backward"
        assert tkernels.FLOAT32_SOURCES[name] == "divided_backward_f32"
        assert name in tkernels.LAUNCHES
    # the classes' sources: the wgmma design's three steps beyond head dim
    # 64, the narrow heads' two plans and the time backward's class and its
    # staged kernel at 8 frames, each launcher switching on its classes
    classes = f"divided_backward_classes{suffix}.cu"
    text = (_build.CSRC / classes).read_text()
    c_api = text[text.index('extern "C" {'):]
    assert set(re.findall(r"\bint (\w+)\(", c_api)) == {
        *(f"{n}_classes{suffix}" for n in space),
        f"divided_space_attention_backward_classes{suffix}",
        tdiv.SPACE_BACKWARD_RESIDENT_ENTRY + suffix,
        f"divided_time_attention_backward_classes{suffix}",
        tdiv.STAGED_TIME_BACKWARD_ENTRY + suffix}
    assert '#include "time_staged_backward.cuh"' in text
    body = _entry_body(classes, tdiv.SPACE_BACKWARD_RESIDENT_ENTRY + suffix)
    assert "launch_space_backward_resident<" in body
    body = _entry_body(classes, tdiv.STAGED_TIME_BACKWARD_ENTRY + suffix)
    assert "launch_time_backward_staged_classes<" in body
    header = (_build.CSRC / "divided_backward.cuh").read_text()
    launcher = header[header.index("int launch_space_backward_resident("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert tuple(int(x) for x in re.findall(r"case (\d+):", launcher)) == (
        tdiv.SPACE_BACKWARD_NARROW_MAX,)
    staged = (_build.CSRC / "time_staged_backward.cuh").read_text()
    launcher = staged[staged.index(
        "int launch_time_backward_staged_classes("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert tuple(int(x) for x in re.findall(r"case (\d+):", launcher)) == (
        16, 32, 64, 128)
    assert "if (F != 8 ||" in launcher


@pytest.mark.parametrize("name", ["divided_space_attention_backward",
                                  "divided_time_attention_backward"])
def test_backward_limits_pass_the_route_and_catch_a_wrong_head(name):
    """The card's limits against the plain backward (``BF16_LIMITS``,
    ``QUANTILE_LIMITS``) take the float32 route's rounding, what a right
    kernel differs by, and refuse a dqkv with two heads of dk swapped; the
    limits against the route (``FLOAT32_ROUTE_LIMITS``) refuse the exact
    gradient rounded to bf16."""
    axis, qkv, g, sin, cos = _inputs(name.split("_")[1], seed=3)
    args = (_t(qkv), None, _t(g), _t(sin), _t(cos), axis, HEADS, DH,
            DH**-0.5)
    out = tdiv.divided_attention_reference(
        _t(qkv), _t(sin), _t(cos), axis, HEADS, DH, DH**-0.5,
        use_flash=False)
    args = (args[0], out, *args[2:])
    exact = tbwd.divided_attention_backward_reference(*args)
    route = tbwd.divided_attention_backward_float32_route(*args)
    tkernels.check_bf16(name, route, exact)
    tkernels.check_float32_route(name, route, route)
    hd = HEADS * DH
    swapped = torch.cat([exact[..., :hd], exact[..., hd + DH:2 * hd],
                         exact[..., hd:hd + DH], exact[..., 2 * hd:]], -1)
    with pytest.raises(AssertionError, match=name):
        tkernels.check_bf16(name, swapped, exact)
    with pytest.raises(AssertionError, match="float32 route"):
        tkernels.check_float32_route(name, exact.bfloat16().float(), route)


@pytest.mark.parametrize("dim_head", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_space_route_at_two_and_four_dim_heads_splits_the_scores(dim_head,
                                                                 dtype):
    """At space head dims 2 and 4 the kernels' scores take q~ and k~ each
    as its bf16 rounding plus the bf16 rounding of the rest (one k16 step
    holds all three products): the float32 route that writes this out is
    within the backward's ``BF16_LIMITS`` and ``QUANTILE_LIMITS`` of the
    plain backward on five seeds, bf16 and float32 inputs alike. With the
    scores of bf16-rounded operands alone the rms measure reads past its
    8e-3 at head dim 2 on most draws."""
    n, heads = 256, 128 // dim_head
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        ang = (torch.rand(n, dim_head // 2, generator=gen) * 6 - 3
               ).repeat_interleave(2, dim=-1)
        sin, cos = ang.sin(), ang.cos()
        x = torch.randn(1, 1, n, 3 * heads * dim_head, generator=gen).to(dtype)
        g = torch.randn(1, 1, n, heads * dim_head, generator=gen).to(dtype)
        out = tdiv.divided_attention_reference(x, sin, cos, "space", heads,
                                               dim_head, dim_head**-0.5,
                                               use_flash=False)
        args = (x, out, g, sin, cos, "space", heads, dim_head, dim_head**-0.5)
        tkernels.check_bf16(
            "divided_space_attention_backward",
            tbwd.divided_attention_backward_float32_route(*args),
            tbwd.divided_attention_backward_reference(*args))
