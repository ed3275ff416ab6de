"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a CUDA device (the kernels have no CPU mode).
Imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Inputs are bf16. Kernel and plain version round q, the scores or the
probabilities to bf16 at different places, so each kernel is held to
``BF16_LIMITS``: its max and rms error relative to the plain output's max
and rms. The shapes are those the kernels are built for, at the main
path's sizes and smaller (the divided kernels also at B = 1 and the space
kernel at the gate's edges and on both sides of the resident-K limit), with
a ragged tile for the packed and the fused kernel and a last block that is
not full for the tiny-L and the time kernel; the packed kernel also at
L = 512, where ``MODITALKER_PACKED_MIN_L`` lowers its gate. The packed and the one-pass
kernel are held on both sides of every choice their launchers make: 256, 128
and 64 query rows per block (B = 2 and B = 1 at L = 2048 and 1024, a large
batch), whole and ragged last tiles, and at D = 64 resident K (N = 1024) and
the K ring (N = 1280, 2048). The fused kernel is held at every edge its two
tiles mask: ragged query chunks (Nq = 1, 100, 1100), key tiles short of 128
(Nk = 8 … 120), one whole key tile (Nk = 128), Nq != Nk on both sides of the
resident-K limit, and D = 16, 32 and 64.

Every kernel also takes float32, which it reads and writes itself (no cast
pass exists), held to the same limits against the float32 plain version at
the training shapes and smaller, to its float32 route's function within
``FLOAT32_ROUTE_LIMITS`` (the space kernels' in the form that takes p as
their ``ex2`` does: ``exp2=True``), and to a result that was never rounded
to bf16
(under 1 % of it equal to its bf16 rounding); and each differentiable
wrapper's gradient (its ``autograd.Function``) is held against autograd
through the plain version. The divided space and time backwards are
kernels of their own (``csrc/divided_backward.cuh``): held against the
float32 plain backward and their float32 route within their rows' limits,
bit for bit equal from call to call, and refusing the shapes they are not
built for.
"""

import pytest
import torch

from moditalker_tpu_torch.ops import attention, rotary
from moditalker_tpu_torch.ops.kernels import (FLOAT32_LAUNCHES_BY_SHAPE,
                                              LAUNCHES, LAUNCHES_BY_ENTRY,
                                              bf16_rounded_share,
                                              check_bf16, check_float32_route)
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import divided_backward as tbwd
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _launched(name, fn):
    before = LAUNCHES[name]
    out = fn()
    assert LAUNCHES[name] == before + 1
    return out


def _divided_tables(axis, f, n, dh=64):
    side = 1 << (n.bit_length() - 1) // 2   # n = side × (n / side)
    while n % side:
        side //= 2
    tables = (rotary.axial_rotary_sincos(side, n // side, dh)
              if axis == "space" else rotary.time_rotary_sincos(f, dh))
    return [torch.from_numpy(t).cuda() for t in tables]


@pytest.mark.cuda
@pytest.mark.parametrize("axis,b,f,n,heads,dh", [
    ("space", 2, 2, 256, 2, 64), ("space", 2, 2, 1024, 8, 64),
    ("space", 2, 1, 2048, 2, 64), ("space", 1, 16, 1024, 8, 64),
    ("space", 1, 1, 256, 2, 64), ("space", 1, 1, 1152, 2, 64),
    ("space", 1, 1, 1280, 2, 64), ("space", 2, 2, 1536, 2, 64),
    ("time", 2, 16, 128, 2, 64), ("time", 2, 16, 1024, 8, 64),
    ("time", 2, 16, 64, 4, 64), ("time", 1, 16, 1024, 8, 64),
    ("time", 3, 16, 8, 2, 64)])
def test_divided_kernels_match_plain(gen, axis, b, f, n, heads, dh):
    sin, cos = _divided_tables(axis, f, n, dh)
    x = _randn(gen, b, f, n, 3 * heads * dh)
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    name = f"divided_{axis}_attention"
    got = _launched(name, lambda: tdiv.divided_attention(
        x, sin, cos, axis, heads, dh, dh**-0.5))
    want = tdiv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                            dh**-0.5, use_flash=False)
    check_bf16(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads", [(1, 5, 3), (2, 9, 1)])
def test_time_kernel_partial_last_block(gen, b, n, heads):
    """The gate admits only N % 8 == 0, which fills every block of 8 warps;
    the wrapper below the gate also takes a batch whose last block is not
    full of warps."""
    sin, cos = (torch.from_numpy(t).cuda()
                for t in rotary.time_rotary_sincos(16, 64))
    x = _randn(gen, b, 16, n, 3 * heads * 64)
    got = _launched("divided_time_attention",
                    lambda: tdiv.time_attention_cuda(x, sin, cos, heads, 64,
                                                     0.125))
    want = tdiv.divided_attention_reference(x, sin, cos, "time", heads, 64,
                                            0.125, use_flash=False)
    check_bf16("divided_time_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(2, 1024), (1, 2048), (2, 1032), (2, 2048),
                                 (1, 1024), (1, 1032), (1, 4096), (2, 4096),
                                 (5, 1160)])
def test_packed_kernel_matches_plain(gen, b, l):
    x = _randn(gen, b, l, 384)
    got = _launched("packed_attention",
                    lambda: tpack.packed_attention(x, 8, 0.25))
    want = tpack.packed_attention_reference(x, 8, 0.25)
    check_bf16("packed_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 1])
def test_packed_kernel_below_the_default_floor(gen, monkeypatch, b):
    """``MODITALKER_PACKED_MIN_L=512`` admits the ds = 1 ytxt attention
    [2B, 512, 128] × 8 heads; the small-head tile takes any L."""
    monkeypatch.setenv("MODITALKER_PACKED_MIN_L", "512")
    x = _randn(gen, b, 512, 384)
    got = _launched("packed_attention",
                    lambda: tpack.packed_attention(x, 8, 0.25))
    want = tpack.packed_attention_reference(x, 8, 0.25)
    check_bf16("packed_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(16, 2048, 32), (3, 1280, 64),
                                   (2, 1024, 32), (16, 2048, 16),
                                   (16, 1024, 16), (32, 1024, 64),
                                   (8, 2048, 32), (16, 1024, 32),
                                   (8, 2304, 32), (16, 2304, 16),
                                   (8, 2048, 16), (8, 1024, 16),
                                   (40, 1024, 16), (2, 2048, 64),
                                   (1, 1024, 64)])
def test_onepass_kernel_matches_plain(gen, b, n, d):
    q, k, v = (_randn(gen, b, n, d) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    want = tflash.onepass_attention_reference(q, k, v, d**-0.5)
    check_bf16("onepass_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16384, 4096, 130])
def test_tiny_kernel_matches_plain(gen, b):
    q, k, v = (_randn(gen, b, 16, 64) for _ in range(3))
    got = _launched("tiny_attention",
                    lambda: tflash.tiny_attention(q, k, v, 0.125))
    want = tflash.tiny_attention_reference(q, k, v, 0.125)
    check_bf16("tiny_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,d", [
    (16, 2048, 2048, 16), (4, 1024, 1024, 64), (2, 64, 512, 64),
    (3, 100, 256, 64), (3, 1000, 384, 16),
    # D = 64: a key tile short of 128 (resident K, one tile) and a whole one
    (3, 100, 64, 64), (2, 1100, 64, 64), (2, 200, 8, 64), (2, 70, 120, 64),
    (2, 256, 128, 64),
    # D = 64, Nq != Nk on the K ring, with ragged query chunks
    (2, 1100, 1280, 64), (3, 100, 2048, 64), (2, 1, 2048, 64),
    # D = 64, ragged query chunks against resident K
    (4, 1, 512, 64), (2, 1100, 1152, 64),
    # D = 16: eight keys, more query rows than keys
    (3, 300, 8, 16), (2, 3000, 512, 16),
    # D = 32: self- and cross-length
    (8, 1024, 1024, 32), (3, 200, 640, 32)])
def test_fused_kernel_matches_plain(gen, b, nq, nk, d):
    q, k, v = _randn(gen, b, nq, d), _randn(gen, b, nk, d), _randn(gen, b, nk, d)
    got = _launched("fused_attention",
                    lambda: tflash.fused_attention(q, k, v))
    want = tflash.fused_attention_reference(q, k, v, d**-0.5)
    check_bf16("fused_attention", got, want)


@pytest.mark.cuda
def test_sdpa_routes_launch_their_kernels(gen):
    """``sdpa`` and ``sdpa_fused`` on the card: head-split tensors reach the
    tiny-L, one-pass and fused kernels; a key length that does not tile and a
    mask take the plain math and launch nothing."""
    q, k, v = (_randn(gen, 2, 8, 1024, 16, 64) for _ in range(3))
    got = _launched("tiny_attention",
                    lambda: attention.sdpa(q, k, v, scale=0.125))
    check_bf16("tiny_attention", got, attention.plain_sdpa(q * 0.125, k, v))
    q, k, v = (_randn(gen, 2, 8, 1024, 16) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: attention.sdpa(q, k, v, scale=0.25))
    check_bf16("onepass_attention", got, attention.plain_sdpa(q * 0.25, k, v))
    q, k, v = _randn(gen, 2, 2, 64, 64), _randn(gen, 2, 2, 512, 64), \
        _randn(gen, 2, 2, 512, 64)
    got = _launched("fused_attention",
                    lambda: attention.sdpa_fused(q, k, v, 0.125))
    check_bf16("fused_attention", got, attention.plain_sdpa(q * 0.125, k, v))
    before = dict(LAUNCHES)
    k2 = _randn(gen, 2, 2, 260, 64)
    attention.sdpa_fused(q, k2, k2, 0.125)
    mask = torch.ones(64, 512, dtype=torch.bool, device="cuda")
    attention.sdpa(q, k, v, scale=0.125, mask=mask)
    assert LAUNCHES == before


# ------------------------------------------------------------ float32
def _randn32(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def _check_float32(name, got, plain, route, limits=None):
    """A kernel's float32 result: float32, under 1 % of it equal to its bf16
    rounding, within the limits of the float32 plain version and of its
    float32 route's function (``FLOAT32_ROUTE_LIMITS[limits or name]``);
    the route's result rounded to bf16 fails the route's limits."""
    assert got.dtype == torch.float32
    assert bf16_rounded_share(got) < 0.01
    check_bf16(name, got, plain)
    check_float32_route(limits or name, got, route)
    with pytest.raises(AssertionError, match="float32 route"):
        check_float32_route(limits or name, route.bfloat16().float(), route)


@pytest.mark.cuda
@pytest.mark.parametrize("axis,b,f,n,heads", [
    ("space", 2, 2, 1024, 8), ("space", 1, 1, 1152, 2),
    ("space", 2, 16, 1024, 8), ("space", 1, 16, 1024, 8),
    ("space", 1, 1, 256, 2), ("space", 2, 1, 1152, 8),
    ("space", 2, 1, 256, 8),
    ("time", 2, 16, 128, 2), ("time", 1, 16, 1024, 8),
    ("time", 10, 16, 1024, 8)])
def test_divided_kernels_take_float32(gen, axis, b, f, n, heads):
    """A float32 qkv goes through the kernel's float32 route (float32 read
    and written in the kernel, bf16 operands, fp32 accumulators) to a
    float32 result (``_check_float32``)."""
    dh = 64
    sin, cos = _divided_tables(axis, f, n)
    x = _randn32(gen, b, f, n, 3 * heads * dh)
    name = f"divided_{axis}_attention"
    got = _launched(name, lambda: tdiv.divided_attention(
        x, sin, cos, axis, heads, dh, dh**-0.5))
    _check_float32(
        name, got,
        tdiv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                         dh**-0.5, use_flash=False),
        tdiv.divided_attention_float32_route(x, sin, cos, axis, heads, dh,
                                             dh**-0.5, exp2=axis == "space"))


@pytest.mark.cuda
@pytest.mark.parametrize("own", ["block", None], ids=["kernel", "route"])
@pytest.mark.parametrize("b,f,n", [(1, 16, 1024), (1, 12, 1024),
                                   (2, 1, 1152), (2, 1, 256), (1, 8, 1024)])
def test_space_f32_kernel_is_the_wgmma_tile_bit_for_bit(gen, monkeypatch,
                                                         own, b, f, n):
    """The float32 space entry point at head dim 64 computes what the wgmma
    tile's float32 route computes, through ``csrc/resident_f32_tile.cuh``'s
    kernel (V rounded into its scratch, two consumer warpgroups) and
    through that route itself, each forced at every shape whichever the
    wrapper's choice (``space_f32_own_kernel``) would take: its output
    equals the fused kernel's at head dim 64 (the same tile, resident K,
    without the rotary) on q and k rotated as the kernel rotates them, bit
    for bit, and two calls give the same output. The shapes:
    train-first-stage's qkv, 96 pairs, the resident-K limit, the gate's
    shortest sequence and 8-frame clips' 64 pairs."""
    monkeypatch.setattr(tdiv, "space_f32_own_kernel", lambda *a: own)
    heads, dh = 8, 64
    sin, cos = _divided_tables("space", f, n)
    x = _randn32(gen, b, f, n, 3 * heads * dh)
    got = tdiv.divided_attention(x, sin, cos, "space", heads, dh, dh**-0.5)
    assert torch.equal(got, tdiv.divided_attention(x, sin, cos, "space",
                                                   heads, dh, dh**-0.5))
    q, k, v = (t.reshape(b * f, n, heads, dh).transpose(1, 2)
               for t in x.chunk(3, -1))
    q, k = rotary.apply_rot_emb(q, k, sin, cos)
    q, k, v = (t.reshape(b * f * heads, n, dh).contiguous() for t in (q, k, v))
    with torch.no_grad():
        tile = tflash.fused_attention_cuda(q, k, v, dh**-0.5)
    tile = tile.reshape(b * f, heads, n, dh).transpose(1, 2)
    assert torch.equal(got, tile.reshape(got.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 640, 1024, 1152])
@pytest.mark.parametrize("pairs", [64, 80, 96, 128])
def test_space_f32_cluster_is_the_route_bit_for_bit(gen, monkeypatch, pairs,
                                                    n):
    """The float32 space kernel's cluster plan (two blocks per (frame,
    head), ``SPACE_F32_CLUSTER_ENTRY``), forced at 64 to 128 pairs over 256
    to 1152 tokens whichever plan the wrapper's choice would take: launched
    through its entry point, its output equal bit for bit to the wgmma
    tile's float32 route's (forced) and to the one-block plan's, two calls
    equal, within the limits of the float32 plain version and of the
    ``exp2`` route (``_check_float32``)."""
    heads, dh = 8, 64
    sin, cos = _divided_tables("space", 1, n)
    x = _randn32(gen, 1, pairs // heads, n, 3 * heads * dh)
    run = lambda: tdiv.divided_attention(x, sin, cos, "space", heads, dh,
                                         dh**-0.5)
    outs = {}
    for plan in ("cluster", None, "block"):
        monkeypatch.setattr(tdiv, "space_f32_own_kernel",
                            lambda *a, plan=plan: plan)
        before = LAUNCHES_BY_ENTRY[tdiv.SPACE_F32_CLUSTER_ENTRY]
        outs[plan] = run()
        assert LAUNCHES_BY_ENTRY[tdiv.SPACE_F32_CLUSTER_ENTRY] == before + (
            plan == "cluster")
    monkeypatch.setattr(tdiv, "space_f32_own_kernel", lambda *a: "cluster")
    got = outs["cluster"]
    assert torch.equal(got, run())
    assert torch.equal(got, outs[None]) and torch.equal(got, outs["block"])
    _check_float32(
        "divided_space_attention", got,
        tdiv.divided_attention_reference(x, sin, cos, "space", heads, dh,
                                         dh**-0.5, use_flash=False),
        tdiv.divided_attention_float32_route(x, sin, cos, "space", heads, dh,
                                             dh**-0.5, exp2=True))


@pytest.mark.cuda
def test_space_f32_cluster_refuses_what_it_is_not_built_for(gen):
    """The cluster plan's entry point takes head dim 64 with the V scratch
    from 256 tokens (a round for each block): without a scratch, at 128
    tokens or at head dim 32 it raises through the wrapper's check."""
    lib = tdiv._lib_f32()
    entry = getattr(lib, tdiv.SPACE_F32_CLUSTER_ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    for n, dh, scratch in ((1024, 64, False), (128, 64, True),
                           (256, 32, True)):
        heads = 512 // dh
        x = _randn32(gen, 1, n, 3 * heads * dh)
        table = torch.zeros(n, dh // 2, 2, device="cuda")
        vs = tdiv.space_f32_scratch(1, n, heads, x.device)
        out = torch.empty(1, n, heads * dh, device="cuda")
        status = entry(x.data_ptr(), table.data_ptr(),
                       vs.data_ptr() if scratch else None, out.data_ptr(),
                       1, n, heads, dh, 0.125, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, status, tdiv.SPACE_F32_CLUSTER_ENTRY)


@pytest.mark.cuda
@pytest.mark.parametrize("own", [True, False], ids=["kernel", "route"])
@pytest.mark.parametrize("b", [128, 8])
def test_onepass_f32_kernel_is_the_wgmma_tile_bit_for_bit(gen, monkeypatch,
                                                           own, b):
    """The float32 one-pass entry point at head dim 64, Nq = Nk = 1024 with
    K resident, through ``csrc/resident_f32_tile.cuh``'s kernel without the
    rotary (V rounded into the wrapper's scratch, two consumer warpgroups)
    and through the wgmma tile's float32 route, each forced whichever the
    wrapper's choice (``onepass_f32_own_kernel``) would take: within the
    limits of the float32 plain version and of the float32 route's
    function, two calls equal bit for bit, and equal bit for bit to the
    other side forced. The shapes: train-first-stage's modular space
    attention, 128 sequences, and 8, both below the chooser's threshold
    (each side forced)."""
    monkeypatch.setattr(tflash, "onepass_f32_own_kernel", lambda *a: own)
    n, d = 1024, 64
    q, k, v = (_randn32(gen, b, n, d) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    _check_float32("onepass_attention", got,
                   tflash.onepass_attention_reference(q, k, v, d**-0.5),
                   tflash.attention_float32_route(q, k, v, d**-0.5))
    assert torch.equal(got, tflash.onepass_attention(q, k, v, d**-0.5))
    monkeypatch.setattr(tflash, "onepass_f32_own_kernel", lambda *a: not own)
    assert torch.equal(got, tflash.onepass_attention(q, k, v, d**-0.5))


@pytest.mark.cuda
def test_onepass_f32_kernel_refuses_other_shapes(gen):
    """Given the V scratch, the float32 entry point takes head dim 64 at
    Nq = Nk, a multiple of 128 up to 1152 keys, and refuses anything else
    with an error: it never gives way to another kernel."""
    lib = tflash._lib_f32()
    for b, nq, nk, d in ((2, 1024, 1024, 32), (2, 512, 1024, 64),
                         (2, 1000, 1000, 64), (2, 1280, 1280, 64)):
        q = _randn32(gen, b, nq, d)
        k = _randn32(gen, b, nk, d)
        scratch = tflash.onepass_f32_scratch(b, nk, q.device)
        status = lib.fused_attention_f32(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), scratch.data_ptr(),
            torch.empty_like(q).data_ptr(), b, nq, nk, d, d**-0.5,
            torch.cuda.current_stream().cuda_stream)
        assert status != 0, (b, nq, nk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk", [(80, 2048, 2048), (2, 1280, 1280),
                                     (8, 1536, 1536), (16, 1000, 2048),
                                     (2, 300, 1280)])
def test_onepass_f32_prerounded_is_the_route_bit_for_bit(gen, monkeypatch, b,
                                                         nq, nk):
    """Past resident K the float32 one-pass and fused wrappers at head dim
    64 launch the pre-pass that rounds K and V to bf16 once per sequence and
    the wgmma tile's bf16 K ring on its scratch
    (``fused_attention_f32_prerounded``): within the limits of the float32
    plain version and of the route's ``exp2`` form (the entry point's own
    ``FLOAT32_ROUTE_LIMITS``), two calls equal bit for bit, and equal bit
    for bit to the wgmma tile's float32 route, forced.
    The shapes: the 256-channel UNet's joint attention at train-diffusion's
    B = 10, a few sequences at 1280 and 1536 keys, fused query rows over
    2048 and 1280 keys (ragged and short of a block)."""
    d, name = 64, "onepass_attention" if nq == nk else "fused_attention"
    q = _randn32(gen, b, nq, d)
    k, v = (_randn32(gen, b, nk, d) for _ in range(2))
    call = ((lambda: tflash.onepass_attention(q, k, v, d**-0.5)) if nq == nk
            else (lambda: tflash.fused_attention(q, k, v)))
    entry = "fused_attention_f32_prerounded"
    before = LAUNCHES_BY_ENTRY[entry]
    got = _launched(name, call)
    assert LAUNCHES_BY_ENTRY[entry] == before + 1
    _check_float32(name, got,
                   tflash.onepass_attention_reference(q, k, v, d**-0.5),
                   tflash.attention_float32_route(q, k, v, d**-0.5,
                                                  exp2=True), limits=entry)
    assert torch.equal(got, call())
    monkeypatch.setattr(tflash, "onepass_f32_prerounded", lambda *a: False)
    assert torch.equal(got, call())
    assert LAUNCHES_BY_ENTRY[entry] == before + 2


@pytest.mark.cuda
def test_onepass_f32_prepass_matches_plain(gen):
    """Called on its own, ``fused_attention_f32_prerounded`` leaves in the
    scratch it is given (NaN before the call) k and v rounded to bf16 once,
    bit for bit ``prerounded_kv_reference``, and its output equals the
    wrapper's."""
    b, nq, nk, d = 3, 1000, 1536, 64
    q = _randn32(gen, b, nq, d)
    k, v = (_randn32(gen, b, nk, d) for _ in range(2))
    kv = torch.full((2, b, nk, d), float("nan"), dtype=torch.bfloat16,
                    device="cuda")
    out = torch.empty_like(q)
    lib = tflash._lib_f32()
    status = lib.fused_attention_f32_prerounded(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
        out.data_ptr(), b, nq, nk, d, d**-0.5,
        torch.cuda.current_stream().cuda_stream)
    assert status == 0
    assert torch.equal(kv, tflash.prerounded_kv_reference(k, v))
    assert torch.equal(out, tflash.fused_attention(q, k, v))


@pytest.mark.cuda
def test_onepass_f32_prerounded_refuses_other_shapes(gen):
    """``fused_attention_f32_prerounded`` takes head dim 64 past resident K
    (1152 keys) in whole 128-key tiles, with a scratch, and refuses anything
    else with an error: it never gives way to another kernel."""
    lib = tflash._lib_f32()
    for b, nq, nk, d, with_scratch in (
            (2, 1024, 1024, 64, True), (2, 1152, 1152, 64, True),
            (2, 1280, 1280, 32, True), (2, 1280, 1300, 64, True),
            (2, 1280, 1280, 64, False)):
        q = _randn32(gen, b, nq, d)
        k = _randn32(gen, b, nk, d)
        kv = tflash.onepass_f32_kv_scratch(b, nk, q.device)
        status = lib.fused_attention_f32_prerounded(
            q.data_ptr(), k.data_ptr(), k.data_ptr(),
            kv.data_ptr() if with_scratch else None,
            torch.empty_like(q).data_ptr(), b, nq, nk, d, d**-0.5,
            torch.cuda.current_stream().cuda_stream)
        assert status != 0, (b, nq, nk, d, with_scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_space_tile_float32_rotates_as_the_route(gen, seed):
    """The float32 space kernel's D = 64 tile (resident K) at qkv
    [1, 1, 1152, 384], seeds 0–3 (``tools/mma_sum.py --space``'s inputs),
    within ``FLOAT32_ROUTE_LIMITS`` of the ``exp2`` route. With the tile's
    rotary contracted into FMAs, seed 1 read a 0.999 quantile of 1.309e-4
    against the limit of 1.1e-4; the tile now rounds each product and sum
    of the rotation as the route's rotary does."""
    heads, dh, n = 2, 64, 1152
    assert not tdiv.space_prerotated(dh, n, True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 1, n, 3 * heads * dh), generator=g, device="cuda")
    sin, cos = _divided_tables("space", 1, n, dh)
    got = _launched("divided_space_attention", lambda: tdiv.divided_attention(
        x, sin, cos, "space", heads, dh, dh**-0.5))
    check_float32_route("divided_space_attention", got,
                        tdiv.divided_attention_float32_route(
                            x, sin, cos, "space", heads, dh, dh**-0.5,
                            exp2=True))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["space", "time"])
def test_bf16_kernels_round_where_the_float32_route_does(gen, axis):
    """At a bf16 qkv the bf16 kernel and the float32 route round q, k, v and
    p at the same points: the kernel's result is the route's rounded to
    bf16, to one bf16 ulp at the 0.999 quantile (the ulp taken at no less
    than 2^-8 of the output's max, where the fp32 sums' order decides)."""
    heads, dh, f, n = 8, 64, 16, 1024
    sin, cos = _divided_tables(axis, f, n)
    x = _randn(gen, 2, f, n, 3 * heads * dh)
    got = tdiv.divided_attention(x, sin, cos, axis, heads, dh, dh**-0.5)
    want = tdiv.divided_attention_float32_route(
        x.float(), sin, cos, axis, heads, dh, dh**-0.5,
        exp2=axis == "space").bfloat16().float()
    mag = want.abs().clamp_min(want.abs().max() * 2.0**-8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    ulps = ((got.float() - want).abs() / ulp).flatten()
    assert ulps.kthvalue(round(0.999 * ulps.numel())).values.item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(10, 2048), (10, 1024), (1, 1032),
                                 (1, 2048), (2, 8)])
def test_packed_kernel_takes_float32(gen, b, l):
    x = _randn32(gen, b, l, 384)
    got = _launched("packed_attention",
                    lambda: tpack.packed_attention_cuda(x, 8, 0.25))
    _check_float32("packed_attention", got,
                   tpack.packed_attention_reference(x, 8, 0.25),
                   tpack.packed_attention_float32_route(x, 8, 0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(80, 2048, 32), (4, 1024, 16),
                                   (80, 2048, 16), (8, 1024, 32),
                                   (128, 1024, 64), (2, 1152, 64),
                                   (3, 1000, 64), (2, 1032, 16),
                                   (80, 2048, 64), (2, 1280, 64)])
def test_onepass_kernel_takes_float32(gen, b, n, d):
    """The float32 entry point at the head dims 16 and 32 (small-head tile)
    and 64 (wgmma tile: resident K up to 1152 keys, the K ring above, as the
    256-channel UNet's joint attention [B·8, 2048, 64] takes it), at whole
    and ragged lengths."""
    q, k, v = (_randn32(gen, b, n, d) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    assert FLOAT32_LAUNCHES_BY_SHAPE["onepass_attention"][(b, n, d)] >= 1
    _check_float32("onepass_attention", got,
                   tflash.onepass_attention_reference(q, k, v, d**-0.5),
                   tflash.attention_float32_route(q, k, v, d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,d", [
    (2, 64, 512, 64), (3, 1000, 120, 64), (2, 200, 8, 64), (2, 1100, 1152, 64),
    (2, 300, 1280, 64), (3, 300, 8, 16), (2, 3000, 512, 16),
    (3, 200, 640, 32)])
def test_fused_kernel_takes_float32(gen, b, nq, nk, d):
    """Nq != Nk on both tiles, ragged query chunks, key tiles short of 128
    and, at head dim 64, the K ring past 1152 keys, in float32."""
    q, k, v = _randn32(gen, b, nq, d), _randn32(gen, b, nk, d), \
        _randn32(gen, b, nk, d)
    got = _launched("fused_attention", lambda: tflash.fused_attention(q, k, v))
    _check_float32("fused_attention", got,
                   tflash.fused_attention_reference(q, k, v, d**-0.5),
                   tflash.attention_float32_route(q, k, v, d**-0.5))


@pytest.mark.cuda
def test_tiny_kernel_takes_float32_and_fused_refuses_a_gradient(gen):
    """Tiny-L takes float32 (the modular path's time attention at B = 1:
    [8192, 16, 64]; a last block short of warps at 130), through its
    float32 entry point; the fused kernel has no gradient and raises where
    one is asked, never falling back."""
    for b in (8192, 130):
        q, k, v = (_randn32(gen, b, 16, 64) for _ in range(3))
        got = _launched("tiny_attention",
                        lambda: tflash.tiny_attention(q, k, v, 0.125))
        _check_float32("tiny_attention", got,
                       tflash.tiny_attention_reference(q, k, v, 0.125),
                       tflash.attention_float32_route(q, k, v, 0.125))
    assert FLOAT32_LAUNCHES_BY_SHAPE["tiny_attention"][(8192, 16, 64)] >= 1
    x = _randn32(gen, 2, 256, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        tflash.fused_attention(x, x, x)


# ------------------------------------------------------------ gradients
# the Function's input gradient against autograd through the plain version
# (float32, TF32 off): the packed backward is the plain version's own vjp,
# the one-pass and tiny-L ones the JAX package's adjoints (the divided
# backwards are kernels, held to their rows' limits instead)
GRAD_LIMIT = 1e-4


def _check_gradient(gen, name, kern, plain, inputs, function):
    """``kern`` launches its kernel once and returns the Function's
    ``grad_fn``; its input gradients agree with autograd through the plain
    version in float32 (matmul TF32 is off by default): within GRAD_LIMIT
    for float32 inputs, within bf16's 2e-2 for bf16 ones."""
    xs = [x.detach().requires_grad_() for x in inputs]
    before = LAUNCHES[name]
    out = kern(*xs)
    assert LAUNCHES[name] == before + 1
    assert type(out.grad_fn).__name__ == function
    cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, xs, cot)
    ref = [x.detach().float().requires_grad_() for x in inputs]
    want = torch.autograd.grad(plain(*ref), ref, cot.float())
    limit = GRAD_LIMIT if out.dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == out.dtype
        err = ((a.float() - b).abs().max() / b.abs().max()).item()
        assert err <= limit, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["space", "time"])
def test_divided_gradient_on_the_card(gen, axis):
    """The forward and backward kernels under autograd, float32 at
    train-first-stage's shape: ``DividedAttentionBackward``, one backward
    launch a gradient, two gradients equal bit for bit, within the backward
    row's limits of autograd through the plain version and of the float32
    route."""
    dh, heads, f, n = 64, 8, 16, 1024
    tables = (rotary.axial_rotary_sincos(32, 32, dh) if axis == "space"
              else rotary.time_rotary_sincos(f, dh))
    sin, cos = (torch.from_numpy(t).cuda() for t in tables)
    name = f"divided_{axis}_attention_backward"
    x = _randn32(gen, 1, f, n, 3 * heads * dh).requires_grad_()
    out = tdiv.divided_attention(x, sin, cos, axis, heads, dh, dh**-0.5)
    assert type(out.grad_fn).__name__ == "DividedAttentionBackward"
    cot = _randn32(gen, *out.shape)
    before = LAUNCHES[name]
    (got,) = torch.autograd.grad(out, x, cot, retain_graph=True)
    (again,) = torch.autograd.grad(out, x, cot)
    assert LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    ref = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(tdiv.divided_attention_reference(
        ref, sin, cos, axis, heads, dh, dh**-0.5, use_flash=False), ref, cot)
    route = tbwd.divided_attention_backward_float32_route(
        x.detach(), out.detach(), cot, sin, cos, axis, heads, dh, dh**-0.5)
    _check_float32(name, got, want, route)


@pytest.mark.cuda
@pytest.mark.parametrize("axis,b,f,n,heads,dtype", [
    ("space", 1, 16, 1024, 8, torch.float32),
    ("space", 2, 2, 256, 2, torch.float32),
    ("space", 1, 1, 1152, 2, torch.float32),
    ("space", 1, 1, 2048, 2, torch.float32),
    ("space", 1, 2, 512, 4, torch.bfloat16),
    ("space", 1, 16, 1024, 8, torch.bfloat16),
    ("space", 2, 2, 256, 2, torch.bfloat16),
    ("space", 1, 1, 2048, 2, torch.bfloat16),
    ("time", 1, 16, 1024, 8, torch.float32),
    ("time", 2, 16, 64, 4, torch.float32),
    ("time", 1, 16, 5, 3, torch.float32),
    ("time", 1, 16, 1024, 8, torch.bfloat16)])
def test_divided_backward_kernels_match_plain(gen, axis, b, f, n, heads,
                                              dtype):
    """Each backward kernel's dqkv (qkv's type) against the float32 plain
    backward within its row's limits, a float32 one also against its
    float32 route; two calls equal bit for bit. Space at the gate's edges
    (N = 256 and 2048, both types) and the float32 forward's resident-K
    edge (N = 1152), time with a last block of warps that is not full
    (5 × 3 sequences)."""
    dh = 64
    sin, cos = _divided_tables(axis, f, n)
    qkv = _randn32(gen, b, f, n, 3 * heads * dh).to(dtype)
    g = _randn32(gen, b, f, n, heads * dh).to(dtype)
    out = tdiv.divided_attention_reference(qkv, sin, cos, axis, heads, dh,
                                           dh**-0.5, use_flash=False)
    name = f"divided_{axis}_attention_backward"
    if axis == "space":
        flat = (b * f, n, -1)
        run = lambda: tdiv.space_attention_backward_cuda(
            qkv.reshape(flat), out.reshape(flat), g.reshape(flat), sin, cos,
            heads, dh, dh**-0.5).reshape(qkv.shape)
    else:
        run = lambda: tdiv.time_attention_backward_cuda(
            qkv, g, sin, cos, heads, dh, dh**-0.5)
    got = _launched(name, run)
    assert got.dtype == dtype and torch.equal(got, run())
    args = (qkv, out, g, sin, cos, axis, heads, dh, dh**-0.5)
    plain = tbwd.divided_attention_backward_reference(*args)
    if dtype == torch.float32:
        _check_float32(name, got, plain,
                       tbwd.divided_attention_backward_float32_route(*args))
    else:
        check_bf16(name, got, plain)


@pytest.mark.cuda
def test_divided_backward_kernels_refuse_unbuilt_shapes(gen):
    """What lies outside the forward's gate, and so has no kernel: N below
    256 or off the 128-row tiling, a head dim that does not divide 128 (or
    of 1: no rotary pair), 40 frames or a frame count off the 8-frame
    classes: each raises before anything launches."""
    before = dict(LAUNCHES)
    for n, heads, dh in ((128, 2, 64), (1000, 2, 64), (256, 4, 48)):
        sin, cos = (torch.zeros(n, dh, device="cuda") for _ in range(2))
        qkv = _randn32(gen, 1, n, 3 * heads * dh)
        g = _randn32(gen, 1, n, heads * dh)
        with pytest.raises(ValueError):
            tdiv.space_attention_backward_cuda(qkv, g, g, sin, cos, heads,
                                               dh, dh**-0.5)
    for f, dh in ((40, 64), (12, 64), (16, 1)):
        heads = 128 // dh
        sin, cos = (torch.zeros(f, dh, device="cuda") for _ in range(2))
        with pytest.raises(ValueError):
            tdiv.time_attention_backward_cuda(
                _randn32(gen, 1, f, 16, 3 * heads * dh),
                _randn32(gen, 1, f, 16, heads * dh), sin, cos, heads, dh,
                0.125)
    assert LAUNCHES == before


@pytest.mark.cuda
def test_packed_gradient_on_the_card(gen):
    _check_gradient(
        gen, "packed_attention",
        lambda x: tpack.packed_attention(x, 8, 0.25),
        lambda x: tpack.packed_attention_reference(x, 8, 0.25),
        [_randn32(gen, 2, 2048, 384)], "RecomputeThroughPlainBackward")


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype", [
    ("onepass_attention", (16, 2048, 32), torch.float32),
    ("onepass_attention", (8, 1024, 64), torch.float32),
    ("tiny_attention", (4096, 16, 64), torch.bfloat16),
    ("tiny_attention", (4096, 16, 64), torch.float32)])
def test_flash_gradient_on_the_card(gen, name, shape, dtype):
    """One-pass in float32; tiny-L in float32 and in bf16 (against the
    float32 plain gradient within bf16's reach)."""
    fn = {"onepass_attention": tflash.onepass_attention,
          "tiny_attention": tflash.tiny_attention}[name]
    sc = shape[-1] ** -0.5
    _check_gradient(
        gen, name, lambda *x: fn(*x, sc),
        lambda *x: tflash.onepass_attention_reference(*x, sc),
        [_randn32(gen, *shape).to(dtype) for _ in range(3)],
        "FlashSdpaBackward")


# ------------------------------------------------- distribution on the card
@pytest.mark.cuda
def test_device_prefetch_and_shared_draws_on_the_card(gen):
    """``device_prefetch`` hands over batches copied on its side stream,
    in order and whole; ``SharedDraws`` over a CUDA generator gives each
    replica its rows of one padded-batch draw."""
    from moditalker_tpu_torch.core.sharding import device_prefetch
    from moditalker_tpu_torch.pipelines.data_parallel import SharedDraws

    host = [{"x": torch.full((64, 1024), float(i)).pin_memory()}
            for i in range(5)]
    got = [b["x"] for b in device_prefetch(iter(host), "cuda")]
    assert [float(x.mean()) for x in got] == [0, 1, 2, 3, 4]
    assert all(x.is_cuda for x in got)
    full = torch.randn((4, 8), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    shared = SharedDraws(torch.Generator(device="cuda").manual_seed(1), 2)
    assert torch.equal(shared.draw(1)((2, 8), torch.float32), full[2:])
    assert torch.equal(shared.draw(0)((2, 8), torch.float32), full[:2])


@pytest.mark.cuda
def test_head_parallel_attention_launches_the_onepass_kernel(gen):
    """``tp.head_parallel_attention``'s per-rank heads go through ``sdpa``:
    at the UNet's one-pass shape, one one-pass launch, within its limits
    of the plain version (a group of one process over NCCL)."""
    import socket

    from moditalker_tpu_torch.core import sharding
    from moditalker_tpu_torch.parallel import tp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    sharding.init_distributed(f"localhost:{port}", 1, 0)
    try:
        mesh = tp.make_2d_mesh(1, 1)
        q, k, v = (_randn(gen, 2, 2048, 8, 32) for _ in range(3))
        out = _launched("onepass_attention", lambda: tp.head_parallel_attention(
            mesh, 8)(q, k, v))
    finally:
        sharding.shutdown()
    heads = lambda t: t.transpose(1, 2).reshape(16, 2048, 32)
    plain = attention.plain_sdpa(heads(q) * 32**-0.5, heads(k), heads(v))
    check_bf16("onepass_attention", heads(out), plain)


# ------------------------------------------------- the classes beyond the
# configurations' shapes: every shape the JAX gates admit runs a kernel
def _pair_tables(n, dh, seed=3):
    """A space table at any even head dim: angles drawn per rotated pair and
    repeated over it, as the axial table repeats them (which has no entry
    below head dim 4)."""
    g = torch.Generator().manual_seed(seed)
    ang = (torch.rand(n, dh // 2, generator=g) * 6.0 - 3.0)
    ang = ang.repeat_interleave(2, dim=-1)
    return ang.sin().cuda(), ang.cos().cuda()


def _class_tables(axis, f, n, dh):
    if axis == "time":
        return [torch.from_numpy(t).cuda()
                for t in rotary.time_rotary_sincos(f, dh)]
    return _pair_tables(n, dh)


def _divided_class_case(gen, axis, b, f, n, heads, dh, dtype, scale=None):
    sin, cos = _class_tables(axis, f, n, dh)
    x = _randn32(gen, b, f, n, 3 * heads * dh)
    if scale is not None:
        x = x * scale
    return x.to(dtype), sin, cos


DIVIDED_CLASSES = [
    # time: clips of 8, 24 and 32 frames at the AE's head dim, on both
    # frame classes; head dims 2 to 128 (2, 4 and 8 padded to 16)
    ("time", 2, 8, 64, 8, 64), ("time", 1, 24, 128, 8, 64),
    ("time", 2, 32, 64, 8, 64), ("time", 1, 32, 16, 2, 64),
    ("time", 1, 16, 64, 1, 128), ("time", 1, 8, 32, 1, 128),
    ("time", 1, 24, 32, 4, 32), ("time", 1, 16, 32, 8, 16),
    ("time", 1, 8, 16, 16, 8), ("time", 1, 32, 8, 32, 4),
    ("time", 1, 16, 8, 64, 2), ("time", 3, 24, 5, 3, 64),
    # the frame class 32's heads of 4 and 2 with warps walking many items
    # (the staged kernel's buffer zeroed once, reused past dh)
    ("time", 1, 32, 256, 128, 4), ("time", 1, 24, 128, 256, 2),
    # space: head dims 2 to 128 but 64 on the pre-rotated design (the
    # rotation pre-pass, then the small-head tile up to 32, the wgmma tile
    # built per width at 128); 64 past the float32 wgmma tile's resident K
    # in float32 likewise (in bf16 the configurations' K ring)
    ("space", 1, 2, 256, 1, 128), ("space", 1, 1, 1024, 4, 32),
    ("space", 2, 1, 512, 8, 16), ("space", 1, 1, 256, 16, 8),
    ("space", 1, 1, 384, 32, 4), ("space", 1, 1, 256, 64, 2),
    ("space", 1, 1, 2048, 1, 128), ("space", 2, 2, 1024, 4, 128),
    ("space", 1, 1, 1280, 2, 64), ("space", 1, 2, 2048, 2, 64)]


def _check_class(name, got, plain, route):
    """A class kernel's result against the plain version in float32 on the
    same inputs (bf16 ones widened): bf16 within the kernel's
    ``BF16_LIMITS``, float32 also within its route's limits
    (``_check_float32``). At the classes' narrow heads the bf16 plain
    version's own roundings (the rotary in bf16 with bf16 tables, bf16
    scores) are the larger error, so the float32 plain version is the
    oracle of both types."""
    if got.dtype == torch.float32:
        _check_float32(name, got, plain, route)
    else:
        check_bf16(name, got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("axis,b,f,n,heads,dh", DIVIDED_CLASSES)
def test_divided_classes_match_plain(gen, axis, b, f, n, heads, dh, dtype):
    """Each frame and head-dim class of the time kernel and each head dim
    of the space kernel's pre-rotated design, bf16 and float32, against the
    plain version within the kernel's unchanged limits (``_check_class``)."""
    x, sin, cos = _divided_class_case(gen, axis, b, f, n, heads, dh, dtype)
    name = f"divided_{axis}_attention"
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh) \
        or n % 8   # (a last block short of warps: below the gate)
    run = ((lambda: tdiv.space_attention_cuda(
        x.reshape(b * f, n, -1), sin, cos, heads, dh, dh**-0.5).reshape(
            b, f, n, -1)) if axis == "space" else
        (lambda: tdiv.time_attention_cuda(x, sin, cos, heads, dh, dh**-0.5)))
    got = _launched(name, run)
    x32 = x.float()
    _check_class(name, got,
                 tdiv.divided_attention_reference(x32, sin, cos, axis, heads,
                                                  dh, dh**-0.5,
                                                  use_flash=False),
                 tdiv.divided_attention_float32_route(
                     x32, sin, cos, axis, heads, dh, dh**-0.5,
                     exp2=axis == "space"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,heads,dh", [(256, 64, 2), (384, 32, 4),
                                        (256, 16, 8), (512, 8, 16),
                                        (1024, 4, 32), (1280, 2, 64),
                                        (1024, 4, 128)])
def test_space_rotate_prepass_matches_plain(gen, n, heads, dh, dtype):
    """The pre-rotated space design's first kernel (``space_rotate_kernel``)
    writes its scratch bit for bit as ``space_rotate_reference`` does: q
    rotated and scaled, k rotated, zeros past dh, each rounded to bf16 once.
    The v third is written where the tile reads it from there (float32,
    heads narrower than 8) and left alone elsewhere. Read off the scratch
    the entry point is handed; bf16 at 64 is the configurations' tile."""
    f32 = dtype == torch.float32
    if dh == 64 and not f32:
        pytest.skip("bf16 at head dim 64 is the wgmma tile's, no pre-pass")
    sin, cos = _pair_tables(n, dh)
    qkv = _randn32(gen, 2, n, 3 * heads * dh).to(dtype)
    table = tdiv.rotary_pair_table(sin, cos)
    w = tdiv.space_scratch_width(dh)
    scratch = torch.full((2, n, 3 * heads * w), float("nan"),
                         dtype=torch.bfloat16, device="cuda")
    out = torch.empty(2, n, heads * dh, dtype=dtype, device="cuda")
    lib, _ = tdiv._library(f32, True)
    entry = "divided_space_attention_prerotated" + ("_f32" if f32 else "")
    assert getattr(lib, entry)(
        qkv.data_ptr(), table.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        2, n, heads, dh, dh**-0.5, torch.cuda.current_stream().cuda_stream) \
        == 0
    torch.cuda.synchronize()
    plain = tdiv.space_rotate_reference(qkv, sin, cos, heads, dh, dh**-0.5)
    written = 3 * heads * w if f32 or w != dh else 2 * heads * w
    assert torch.equal(scratch[..., :written], plain[..., :written])
    assert scratch[..., written:].isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,heads,dh", [(1024, 8, 64), (256, 1, 128),
                                        (512, 4, 32), (2048, 2, 64),
                                        (384, 4, 32)])
def test_space_backward_prepass_matches_plain(gen, n, heads, dh, dtype):
    """The space backward's pre-pass writes its scratch (q~, k~ and v), gs
    and dsum bit for bit as ``space_backward_prepass_reference`` does,
    every element of each (the buffers start as NaN), at each head dim it
    serves. Read off the buffers the entry point is handed."""
    f32 = dtype == torch.float32
    sin, cos = _pair_tables(n, dh)
    qkv = _randn32(gen, 2, n, 3 * heads * dh).to(dtype)
    out, g = (_randn32(gen, 2, n, heads * dh).to(dtype) for _ in range(2))
    table = tdiv.rotary_pair_table(sin, cos)
    bufs = tdiv.space_backward_scratch(2, n, heads, dh, "cuda")[:3]
    for t in bufs:
        t.fill_(float("nan"))
    lib, suffix = tdiv._library(f32, dh not in tdiv.SPACE_BACKWARD_HEAD_DIMS,
                                backward=True)
    entry = "divided_space_backward_prepass" + suffix
    assert getattr(lib, entry)(
        *(t.data_ptr() for t in (qkv, table, out, g, *bufs)), 2, n, heads,
        dh, dh**-0.5, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    plain = tbwd.space_backward_prepass_reference(qkv, out, g, sin, cos,
                                                  heads, dh, dh**-0.5)
    for got, want in zip(bufs, plain):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dh", [(8, 64), (4, 128), (16, 32)])
def test_space_backward_is_deterministic(gen, heads, dh, dtype):
    """At train-first-stage's qkv [16, 1024, 3·512] (the AE's 512 channels
    in 8 heads of 64, 4 of 128 and 16 of 32) three calls of the space
    backward give dqkv equal bit for bit: no float atomics, each output
    element summed by one thread in one order, whatever the blocks'
    schedule."""
    n = 1024
    sin, cos = (torch.from_numpy(t).cuda()
                for t in rotary.axial_rotary_sincos(32, 32, dh))
    qkv = _randn32(gen, 16, n, 3 * heads * dh).to(dtype)
    g = _randn32(gen, 16, n, heads * dh).to(dtype)
    out = tdiv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
    run = lambda: tdiv.space_attention_backward_cuda(qkv, out, g, sin, cos,
                                                     heads, dh, dh**-0.5)
    first = _launched("divided_space_attention_backward", run)
    assert first.dtype == dtype and first.isfinite().all()
    for _ in range(2):
        assert torch.equal(first, run())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [8, 24])
def test_time_classes_mask_padded_frames(gen, f, dtype):
    """Clips of 8 and 24 frames run on the 16- and 32-frame tiles with the
    frames past F loaded as zeros. A zero key scores 0, not -inf: with q
    and k built about one direction of opposite signs (every real score
    negative, about -7 on average) an unmasked padded key would take nearly
    all the weight, and a mask applied after the max would leave every
    weight at 0. The
    forward and the backward against the functions of their float32 route
    on the same inputs (scores this large move by whole units when q is
    rounded to bf16, so the route, which rounds where the kernels do, is the
    oracle): within its limits in float32, within ``BF16_LIMITS`` in bf16
    (whose result is rounded once more)."""
    heads, dh, n = 2, 64, 64
    sin, cos = _class_tables("time", f, n, dh)
    c = _randn32(gen, 1, 1, n, heads * dh)
    q = c + 0.5 * _randn32(gen, 1, f, n, heads * dh)
    k = -c + 0.5 * _randn32(gen, 1, f, n, heads * dh)
    v = _randn32(gen, 1, f, n, heads * dh)
    x = torch.cat([q, k, v], dim=-1).to(dtype)
    x32 = x.float()
    route = tdiv.divided_attention_float32_route(x32, sin, cos, "time", heads,
                                                 dh, dh**-0.5)
    got = _launched("divided_time_attention", lambda: tdiv.time_attention_cuda(
        x, sin, cos, heads, dh, dh**-0.5))
    assert route.abs().max() > 0.5   # the output did not collapse
    g = _randn32(gen, 1, f, n, heads * dh).to(dtype)
    dqkv = _launched("divided_time_attention_backward",
                     lambda: tdiv.time_attention_backward_cuda(
                         x, g, sin, cos, heads, dh, dh**-0.5))
    droute = tbwd.divided_attention_backward_float32_route(
        x32, route, g.float(), sin, cos, "time", heads, dh, dh**-0.5)
    if dtype == torch.float32:
        check_float32_route("divided_time_attention", got, route)
        check_float32_route("divided_time_attention_backward", dqkv, droute)
    else:
        check_bf16("divided_time_attention", got, route)
        check_bf16("divided_time_attention_backward", dqkv, droute)


FLASH_CLASSES = [(2, 1024, 8), (2, 1024, 24), (2, 1024, 40), (1, 1280, 48),
                 (2, 1024, 56), (1, 1024, 72), (1, 1536, 96), (1, 1024, 120),
                 (2, 1024, 128), (40, 1024, 24), (16, 2048, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,d", FLASH_CLASSES)
def test_onepass_classes_match_plain(gen, b, n, d, dtype):
    """The one-pass kernel at head dims the configurations do not reach:
    the small-head tile's classes (8 in 16, 24 in 32) and the wgmma tile
    built per width (40 to 128 but 64), bf16 and float32."""
    assert tflash.onepass_attention_viable(n, n, d)
    q, k, v = (_randn32(gen, b, n, d).to(dtype) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    q, k, v = q.float(), k.float(), v.float()
    _check_class("onepass_attention", got,
                 tflash.onepass_attention_reference(q, k, v, d**-0.5),
                 tflash.attention_float32_route(q, k, v, d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,d", [
    (3, 100, 256, 8), (2, 1100, 384, 24), (2, 70, 120, 40), (3, 1, 8, 48),
    (2, 300, 640, 72), (2, 200, 2048, 128), (2, 1000, 128, 96),
    (3, 64, 64, 120)])
def test_fused_classes_match_plain(gen, b, nq, nk, d, dtype):
    """The fused kernel at the same head dims: ragged query chunks, key
    tiles short of 128 and whole ones, Nq != Nk."""
    q = _randn32(gen, b, nq, d).to(dtype)
    k, v = (_randn32(gen, b, nk, d).to(dtype) for _ in range(2))
    got = _launched("fused_attention", lambda: tflash.fused_attention(q, k, v))
    q, k, v = q.float(), k.float(), v.float()
    _check_class("fused_attention", got,
                 tflash.fused_attention_reference(q, k, v, d**-0.5),
                 tflash.attention_float32_route(q, k, v, d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,d", [
    (2, 1024, 1024, 40), (16, 2048, 2048, 48), (2, 1024, 1024, 128),
    (16, 2048, 2048, 128), (4, 1000, 256, 136), (4, 1000, 384, 256),
    (8, 1000, 120, 264), (2, 130, 512, 512), (8, 1000, 512, 512),
    (8, 1000, 256, 576), (8, 1000, 256, 1152)])
def test_wide_tile_matches_plain(gen, b, nq, nk, d, dtype):
    """The wgmma tile built per head width (``csrc/flash_wide{,_f32}.cu``):
    one-pass at head dims 40, 48 and 128 (at 2 and 16 sequences: the grid
    splits rows where 128-row blocks leave the card short), the fused kernel
    past 128, where it raised before (136: a width of its own; 256; 264 and
    512: groups of 256 output columns, each summing S over all of d; 576:
    one consumer, Q resident; 1152: Q streamed per key tile), with ragged
    query chunks and short key tiles; bf16 and float32 against the float32
    plain version (``_check_class``), float32 also against the route's
    function with the kernels' ``ex2`` (``exp2=True``). Against the route
    with ``exp`` a p that lands on the other side of a bf16 rounding
    boundary moves its whole output row (at [2, 130, 512] 5 rows of 260
    differ, and one is more than the thousandth of the output the quantile
    measure looks past); with the kernels' ``ex2`` no row differs
    (``tools/mma_sum.py --wide``), so the fused cases hold a few hundred
    rows and thousands alike."""
    q = _randn32(gen, b, nq, d).to(dtype)
    k, v = (_randn32(gen, b, nk, d).to(dtype) for _ in range(2))
    if nq == nk:
        assert tflash.onepass_attention_viable(nq, nk, d)
        name = "onepass_attention"
        run = lambda: tflash.onepass_attention(q, k, v, d**-0.5)
    else:
        name = "fused_attention"
        run = lambda: tflash.fused_attention(q, k, v)
    assert tflash.attention_source(d, dtype == torch.float32) == (
        "flash_narrow" if d in tflash.NARROW_HEAD_DIMS
        and dtype == torch.bfloat16 else "flash_wide")
    got = _launched(name, run)
    q, k, v = q.float(), k.float(), v.float()
    _check_class(name, got, tflash.fused_attention_reference(q, k, v, d**-0.5),
                 tflash.attention_float32_route(q, k, v, d**-0.5, exp2=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nk", [120, 40])
def test_wide_tile_masks_short_key_tiles(gen, nk, dtype):
    """The fused kernel at head dim 256 (64-key tiles) over 1000 query rows
    (a ragged last chunk) and 120 or 40 keys (a short last tile, zero-filled
    past Nk): with q and k built about one direction of opposite signs
    (every real score about -7, as in the time classes' test) an unmasked
    padded key (score 0, v 0) would take over 98 % of the weight and bring
    every output near 0. Against the float32 route's function on the same
    inputs with the kernels' ``ex2`` (``exp2=True``; it rounds where the
    kernel does): bf16 within ``BF16_LIMITS`` and ``QUANTILE_LIMITS``,
    float32 within ``FLOAT32_ROUTE_LIMITS`` as well (``_check_class``); a
    padded key left in moves the output by its own size. (Scores held this
    close together put a p at a bf16 rounding boundary in more rows than
    random inputs do: against the route with ``exp`` the float32 result
    read 1.8e-4 on the quantile at Nk = 40, 5 rows of 2000 off; against the
    route with the kernels' ``ex2`` no row differs, ``tools/mma_sum.py
    --wide``.)"""
    d = 256
    c = 0.66 * _randn32(gen, 1, 1, d)   # |c|² d^-0.5 about 7
    q = (c + 0.5 * _randn32(gen, 2, 1000, d)).to(dtype)
    k = (-c + 0.5 * _randn32(gen, 2, nk, d)).to(dtype)
    v = _randn32(gen, 2, nk, d).to(dtype)
    route = tflash.attention_float32_route(q.float(), k.float(), v.float(),
                                           d**-0.5, exp2=True)
    got = _launched("fused_attention",
                    lambda: tflash.fused_attention(q, k, v))
    assert route.abs().max() > 0.1   # the output did not collapse
    _check_class("fused_attention", got, route, route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,d", [(4096, 8, 64), (4096, 24, 64),
                                   (4096, 32, 64), (4096, 16, 128),
                                   (4096, 8, 128), (4224, 24, 128),
                                   (130, 32, 128), (130, 8, 64)])
def test_tiny_classes_match_plain(gen, b, l, d, dtype):
    """Tiny-L at every row class (8 and 24 padded) and at head dim 128,
    with a last block short of warps at 130 sequences."""
    q, k, v = (_randn32(gen, b, l, d).to(dtype) for _ in range(3))
    got = _launched("tiny_attention",
                    lambda: tflash.tiny_attention(q, k, v, d**-0.5))
    q, k, v = q.float(), k.float(), v.float()
    _check_class("tiny_attention", got,
                 tflash.tiny_attention_reference(q, k, v, d**-0.5),
                 tflash.attention_float32_route(q, k, v, d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis,b,f,n,heads,dh", [
    ("time", 1, 8, 64, 8, 64), ("time", 1, 24, 32, 8, 64),
    ("time", 1, 32, 32, 8, 64), ("time", 1, 16, 32, 1, 128),
    ("time", 1, 24, 16, 4, 32), ("time", 1, 8, 16, 8, 16),
    ("time", 1, 32, 8, 16, 8), ("time", 1, 16, 8, 64, 2),
    ("time", 1, 24, 5, 3, 64),
    ("space", 1, 1, 256, 1, 128), ("space", 1, 1, 512, 4, 32),
    ("space", 1, 1, 256, 8, 16), ("space", 1, 1, 256, 16, 8),
    ("space", 1, 1, 384, 32, 4), ("space", 1, 1, 256, 64, 2),
    ("space", 1, 1, 2048, 1, 128), ("space", 1, 1, 2048, 4, 32),
    ("space", 1, 1, 256, 4, 32), ("space", 1, 1, 2048, 16, 8),
    ("space", 1, 1, 2048, 2, 64),
    ("space", 1, 1, 1280, 2, 64)])
def test_divided_backward_classes_match_plain(gen, axis, b, f, n, heads, dh,
                                              dtype):
    """The backward kernels at every class the forward has: time at clips
    of 8, 24 and 32 frames and head dims 2 to 128, space at head dims 2 to
    128 but 64 (2 and 4 with the scores' operands split into hi + lo), at
    the gate's edges N = 256 and 2048, and, at 64, past the float32
    forward's resident K (N = 1280, 2048); against the float32 plain
    backward, float32 also against its route, two calls equal bit for
    bit."""
    x, sin, cos = _divided_class_case(gen, axis, b, f, n, heads, dh, dtype)
    g = _randn32(gen, b, f, n, heads * dh).to(dtype)
    out = tdiv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                           dh**-0.5, use_flash=False)
    name = f"divided_{axis}_attention_backward"
    if axis == "space":
        flat = (b * f, n, -1)
        run = lambda: tdiv.space_attention_backward_cuda(
            x.reshape(flat), out.reshape(flat), g.reshape(flat), sin, cos,
            heads, dh, dh**-0.5).reshape(x.shape)
    else:
        run = lambda: tdiv.time_attention_backward_cuda(
            x, g, sin, cos, heads, dh, dh**-0.5)
    got = _launched(name, run)
    assert got.dtype == dtype and torch.equal(got, run())
    args = (x, out, g, sin, cos, axis, heads, dh, dh**-0.5)
    plain = tbwd.divided_attention_backward_reference(*args)
    if dtype == torch.float32:
        _check_float32(name, got, plain,
                       tbwd.divided_attention_backward_float32_route(*args))
    else:
        check_bf16(name, got, plain)


# (B, Nq, Nk, d): one-pass with K resident and past it at each width, at 8
# and 16 sequences; fused with ragged query chunks over one whole and one
# short key tile, a single query row over 8 keys, over resident K and past it
NARROW_CASES = [(2, 1024, 1024, 40), (16, 2048, 2048, 48), (2, 2048, 2048, 56),
                (8, 1024, 1024, 48), (8, 2048, 2048, 40), (2, 1280, 1280, 56),
                (3, 1000, 128, 48), (3, 1000, 120, 48), (3, 1, 8, 40),
                (2, 70, 120, 56), (2, 300, 1024, 48), (2, 1280, 2048, 48),
                (2, 1100, 384, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,d", NARROW_CASES)
def test_narrow_tile_matches_plain(gen, b, nq, nk, d):
    """The bf16 one-pass and fused kernel at head dims 40, 48 and 56 (the
    narrow tile, ``NARROW_ENTRY``): launched through its entry point,
    within ``BF16_LIMITS`` and ``QUANTILE_LIMITS`` of the float32 plain
    version on its inputs, masked shapes included; a second call equal bit
    for bit."""
    q = _randn(gen, b, nq, d)
    k, v = _randn(gen, b, nk, d), _randn(gen, b, nk, d)
    if nq == nk:
        name = "onepass_attention"
        run = lambda: tflash.onepass_attention(q, k, v, d**-0.5)
    else:
        name = "fused_attention"
        run = lambda: tflash.fused_attention(q, k, v)
    before = LAUNCHES_BY_ENTRY[tflash.NARROW_ENTRY]
    got = _launched(name, run)
    assert LAUNCHES_BY_ENTRY[tflash.NARROW_ENTRY] == before + 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, run())
    check_bf16(name, got, tflash.fused_attention_reference(
        q.float(), k.float(), v.float(), d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,heads,dh", [
    (1, 1024, 8, 64), (1, 256, 16, 32), (1, 256, 32, 16), (1, 256, 64, 8),
    (1, 256, 4, 128), (1, 64, 4, 128), (1, 256, 128, 4), (1, 128, 256, 2),
    (2, 100, 2, 64), (1, 5, 3, 128)])
def test_time_staged_at_8_frames_is_the_class_bit_for_bit(gen, b, n, heads,
                                                          dh, dtype):
    """The time kernel staged by cp.async at clips of 8 frames (two items a
    warp's tile, ``STAGED_TIME_ENTRY``), at every head-dim class, with
    warps that walk many items (heads of 4 and 2) and a last tile holding
    one item (15 items): its output equal bit for bit to the classes'
    kernel (the frame class 16, padded and masked) on the same inputs,
    called through its entry point in this checkout's library, which still
    takes 8 frames; within the time kernel's limits of the float32 plain
    version and, in float32, of its route; two calls equal."""
    f, f32 = 8, dtype == torch.float32
    sin, cos = _divided_tables("time", f, n, dh)
    x = _randn32(gen, b, f, n, 3 * heads * dh).to(dtype)
    entry = tdiv.STAGED_TIME_ENTRY + ("_f32" if f32 else "")
    before = LAUNCHES_BY_ENTRY[entry]
    run = lambda: tdiv.time_attention_cuda(x, sin, cos, heads, dh, dh**-0.5)
    got = _launched("divided_time_attention", run)
    assert LAUNCHES_BY_ENTRY[entry] == before + 1
    assert torch.equal(got, run())
    lib, suffix = tdiv._library(f32, True)
    want = torch.full_like(got, float("nan"))
    status = getattr(lib, "divided_time_attention" + suffix)(
        x.data_ptr(), sin.data_ptr(), cos.data_ptr(), want.data_ptr(), b, f,
        n, heads, dh, dh**-0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "divided_time_attention" + suffix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x32 = x.float()
    _check_class("divided_time_attention", got,
                 tdiv.divided_attention_reference(x32, sin, cos, "time",
                                                  heads, dh, dh**-0.5,
                                                  use_flash=False),
                 tdiv.divided_attention_float32_route(x32, sin, cos, "time",
                                                      heads, dh, dh**-0.5))


@pytest.fixture(scope="module")
def time_class_lib():
    """The classes' time kernel the staged kernel replaced at 24 and 32
    frames, built by ``tools/ab_classes.py`` (``TIME_VARIANTS``) from the
    headers of an earlier copy of the repository under
    ``build/before-252b342`` (``git archive 252b342 | tar -x -C
    build/before-252b342``, the last commit before the staged kernel,
    unpacked here from the local history where the directory is missing;
    named after its commit, as other tools' earlier copies are): {"": bf16
    library, "_f32": float32 library}."""
    import pathlib
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    root = pathlib.Path(__file__).resolve().parents[1]
    before = root / "build" / "before-252b342"
    header = before / "moditalker_tpu_torch" / "csrc" / "divided_attention.cuh"
    if not header.is_file():
        before.mkdir(parents=True, exist_ok=True)
        subprocess.run(f"git -C {root} archive 252b342 | tar -x -C {before}",
                       shell=True, capture_output=True)
    if not header.is_file():
        pytest.skip("needs an earlier copy of the repository under "
                    "build/before-252b342, whose time classes it builds, "
                    "and no git history here to unpack it from")
    sys.path.insert(0, str(root / "tools"))
    import ab_classes
    import ctypes

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.time_ab.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        lib.time_ab.restype = i
        return lib

    libs = ab_classes.build_variants(before, ab_classes.TIME_VARIANTS,
                                     ab_classes.TIME_SOURCE, bind)
    return {"": libs["time_class"], "_f32": libs["time_class_f32"]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,f,n,heads,dh", [
    (2, 32, 1024, 8, 64), (2, 24, 1024, 8, 64), (1, 32, 100, 2, 64),
    (1, 24, 256, 16, 32), (1, 32, 256, 32, 16), (1, 32, 256, 64, 8),
    (1, 32, 256, 4, 128), (1, 24, 64, 4, 128), (1, 32, 256, 128, 4),
    (1, 24, 128, 256, 2)])
def test_time_staged_is_the_class_bit_for_bit(gen, time_class_lib, b, f, n,
                                             heads, dh, dtype):
    """The time kernel staged by cp.async (``STAGED_TIME_ENTRY``) at clips
    of 24 and 32 frames, at every head-dim class and with a last block of
    warps short of items: its output equal bit for bit to the classes'
    kernel it replaced on the same inputs (the same arithmetic: the
    rotary in fp32 rounded once, masked frames, ``expf``), within the time
    kernel's limits of the float32 plain version and, in float32, of its
    route; two calls equal."""
    f32 = dtype == torch.float32
    sin, cos = _divided_tables("time", f, n, dh)
    x = _randn32(gen, b, f, n, 3 * heads * dh).to(dtype)
    entry = tdiv.STAGED_TIME_ENTRY + ("_f32" if f32 else "")
    before = LAUNCHES_BY_ENTRY[entry]
    run = lambda: tdiv.time_attention_cuda(x, sin, cos, heads, dh, dh**-0.5)
    got = _launched("divided_time_attention", run)
    assert LAUNCHES_BY_ENTRY[entry] == before + 1
    assert torch.equal(got, run())
    want = torch.empty_like(got)
    lib = time_class_lib["_f32" if f32 else ""]
    assert lib.time_ab(x.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                       want.data_ptr(), b, f, n, heads, dh, dh**-0.5,
                       torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x32 = x.float()
    _check_class("divided_time_attention", got,
                 tdiv.divided_attention_reference(x32, sin, cos, "time",
                                                  heads, dh, dh**-0.5,
                                                  use_flash=False),
                 tdiv.divided_attention_float32_route(x32, sin, cos, "time",
                                                      heads, dh, dh**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,heads,dh", [
    (1, 1024, 8, 64), (1, 256, 16, 32), (1, 256, 32, 16), (1, 256, 64, 8),
    (1, 256, 4, 128), (1, 64, 4, 128), (1, 256, 128, 4), (1, 128, 256, 2),
    (2, 100, 2, 64), (1, 5, 3, 128)])
def test_time_backward_staged_at_8_frames_is_the_class_bit_for_bit(
        gen, b, n, heads, dh, dtype):
    """The time backward staged by cp.async at clips of 8 frames (two items
    a warp's tile, ``STAGED_TIME_BACKWARD_ENTRY``), at every head-dim
    class, with warps that walk many items (heads of 4 and 2) and a last
    tile holding one item (15 items): its dqkv equal bit for bit to the
    classes' time backward (the frame class 16, padded and masked) on the
    same inputs, called through its entry point in this checkout's library,
    which still takes 8 frames; within the time backward's limits of the
    float32 plain backward and, in float32, of its route; two calls
    equal."""
    f, f32 = 8, dtype == torch.float32
    sin, cos = _divided_tables("time", f, n, dh)
    x = _randn32(gen, b, f, n, 3 * heads * dh).to(dtype)
    g = _randn32(gen, b, f, n, heads * dh).to(dtype)
    entry = tdiv.STAGED_TIME_BACKWARD_ENTRY + ("_f32" if f32 else "")
    before = LAUNCHES_BY_ENTRY[entry]
    run = lambda: tdiv.time_attention_backward_cuda(x, g, sin, cos, heads,
                                                    dh, dh**-0.5)
    got = _launched("divided_time_attention_backward", run)
    assert LAUNCHES_BY_ENTRY[entry] == before + 1
    assert got.dtype == dtype and torch.equal(got, run())
    lib, suffix = tdiv._library(f32, True, backward=True)
    want = torch.full_like(got, float("nan"))
    cls = "divided_time_attention_backward" + suffix
    status = getattr(lib, cls)(
        x.data_ptr(), sin.data_ptr(), cos.data_ptr(), g.data_ptr(),
        want.data_ptr(), b, f, n, heads, dh, dh**-0.5,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, cls)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x32 = x.float()
    out = tdiv.divided_attention_reference(x32, sin, cos, "time", heads, dh,
                                           dh**-0.5, use_flash=False)
    args = (x32, out, g.float(), sin, cos, "time", heads, dh, dh**-0.5)
    _check_class("divided_time_attention_backward", got,
                 tbwd.divided_attention_backward_reference(*args),
                 tbwd.divided_attention_backward_float32_route(*args))


# (frames, N, heads, head dim, plan): the narrow space backward's two plans
# at heads of 2 to 16 dims over the gate's lengths, the resident one up to
# the 1024 tokens it holds, at a pass and at two (with a last pass short of
# its keys at 768), and frames that fill the card and leave it idle
NARROW_SPACE_BACKWARD = [
    (1, 256, 64, 2, "resident"), (1, 1024, 32, 4, "resident"),
    (1, 1024, 16, 8, "resident"), (2, 1024, 8, 16, "resident"),
    (1, 384, 32, 4, "resident"), (1, 768, 16, 16, "resident"),
    (3, 512, 4, 8, "resident"), (16, 1024, 32, 16, "resident"),
    (1, 256, 64, 2, "class"), (2, 1024, 8, 16, "class"),
    (1, 2048, 16, 2, "class"), (1, 2048, 8, 16, "class")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bf,n,heads,dh,plan", NARROW_SPACE_BACKWARD)
def test_space_backward_narrow_plans_match_plain(gen, monkeypatch, bf, n,
                                                 heads, dh, plan, dtype):
    """The space backward at heads of 2 to 16 dims on each of its plans
    (``space_backward_narrow_plan`` forced: the resident block per (frame,
    head), ``SPACE_BACKWARD_RESIDENT_ENTRY``, and the class), launched
    through its entry point, at N = 256 to 2048: within the backward's
    limits of the float32 plain backward and, in float32, of its route
    (heads of 2 and 4 with the scores' operands split into hi + lo); two
    calls equal bit for bit."""
    f32 = "_f32" if dtype == torch.float32 else ""
    sin, cos = _pair_tables(n, dh)
    x = _randn32(gen, 1, bf, n, 3 * heads * dh).to(dtype)
    g = _randn32(gen, 1, bf, n, heads * dh).to(dtype)
    out = tdiv.divided_attention_reference(x, sin, cos, "space", heads, dh,
                                           dh**-0.5, use_flash=False)
    monkeypatch.setattr(tdiv, "space_backward_narrow_plan",
                        lambda *a: plan)
    entry = (tdiv.SPACE_BACKWARD_RESIDENT_ENTRY + f32 if plan == "resident"
             else "divided_space_attention_backward_classes" + f32)
    before = LAUNCHES_BY_ENTRY[entry]
    flat = (bf, n, -1)
    run = lambda: tdiv.space_attention_backward_cuda(
        x.reshape(flat), out.reshape(flat), g.reshape(flat), sin, cos, heads,
        dh, dh**-0.5).reshape(x.shape)
    name = "divided_space_attention_backward"
    got = _launched(name, run)
    assert LAUNCHES_BY_ENTRY[entry] == before + 1
    assert got.dtype == dtype and torch.equal(got, run())
    args = (x, out, g, sin, cos, "space", heads, dh, dh**-0.5)
    _check_class(name, got, tbwd.divided_attention_backward_reference(*args),
                 tbwd.divided_attention_backward_float32_route(*args))
