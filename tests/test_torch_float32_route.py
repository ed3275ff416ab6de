"""The divided kernels' float32 route on the CPU.

For a float32 qkv the space and time kernels read float32 and write float32
themselves. ``divided_attention_float32_route`` writes out the function
they compute (q rotated and scaled in fp32 and rounded to bf16 once, k
rotated and rounded once, v rounded once, fp32 scores and sums, p rounded
to bf16 for P·V, the result divided in fp32 and kept float32). Here it is
held to the JAX package's Pallas kernels in interpret mode on float32 qkv
and to the bf16 route at bf16-exact inputs; ``FLOAT32_ROUTE_LIMITS`` are
shown to pass a change of summation order and to fail a result rounded to
bf16 (the cast route's); and the wrappers are driven with stub libraries to
show that a float32 qkv reaches the float32 entry points with no cast pass.
The kernels themselves are held to this function on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build, convert
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv

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
    ``FLOAT32_ROUTE_LIMITS``. The result rounded to bf16 (what a bf16 kernel
    between two cast passes returns) fails them."""
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


class _StubLib:
    """Records each entry point's call and returns success."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


def _no_cast(*args):
    raise AssertionError("a cast pass ran for the divided kernels")


@pytest.fixture
def stub_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(tkernels, "on_card", lambda t: True)
    monkeypatch.setattr(tkernels, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(tdiv, "_lib", lambda: _StubLib(calls))
    monkeypatch.setattr(tdiv, "_lib_f32", lambda: _StubLib(calls))
    monkeypatch.setattr(convert, "to_bf16", _no_cast)
    monkeypatch.setattr(convert, "to_float32", _no_cast)
    tkernels.reset_launch_counts()
    yield calls
    tkernels.reset_launch_counts()


@pytest.mark.parametrize("axis", AXES)
def test_float32_qkv_launches_the_float32_entry_point(stub_launches, axis):
    """A float32 qkv goes to the kernel's float32 entry point once, with no
    cast pass on either side (both raise here), and the result the wrapper
    returns is the float32 buffer the kernel writes; a bf16 qkv still takes
    the bf16 entry point."""
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


def test_float32_space_kernel_is_built_for_resident_k():
    """The float32 space route is instantiated for resident K only: the
    wrapper refuses a longer N before it builds or launches anything, and
    its limit is the tile's (``kWgMaxKSlots`` tiles of 128 keys)."""
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    slots = int(re.search(r"kWgMaxKSlots = (\d+);", tile).group(1))
    assert tdiv.SPACE_F32_MAX_N == 128 * slots
    n = tdiv.SPACE_F32_MAX_N + 128
    tab = torch.zeros(n, 64)
    with pytest.raises(NotImplementedError, match="resident"):
        tdiv.space_attention_cuda(torch.zeros(1, n, 3 * 2 * 64), tab, tab,
                                  2, 64, 0.125)


def test_float32_entry_points_are_in_their_own_source():
    """The C symbols ``_lib`` and ``_lib_f32`` bind are defined in
    csrc/divided_attention.cu (bf16) and csrc/divided_attention_f32.cu
    (float32), each library's own, and the float32 source is built with the
    kernels (``FLOAT32_SOURCES``)."""
    for source, suffix in (("divided_attention.cu", ""),
                           ("divided_attention_f32.cu", "_f32")):
        text = (_build.CSRC / source).read_text()
        c_api = text[text.index('extern "C" {'):]
        names = set(re.findall(r"\bint (divided_\w+)\(", c_api))
        assert names == {"divided_space_attention" + suffix,
                         "divided_time_attention" + suffix}, source
    assert set(tkernels.FLOAT32_SOURCES.values()) == {"divided_attention_f32"}
