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

The space, time, packed and one-pass kernels also take float32 (cast passes
in front and behind, ``ops/kernels/convert.py``), held to the same limits
against the float32 plain version at the training shapes and smaller; and
each differentiable wrapper's gradient (its ``autograd.Function``: kernel
forward, plain recompute backward) is held against autograd through the
plain version.
"""

import pytest
import torch

from moditalker_tpu_torch.ops import attention, rotary
from moditalker_tpu_torch.ops.kernels import LAUNCHES, check_bf16
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
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
    side = 1 << (n.bit_length() - 1) // 2   # n = side × (n / side)
    while n % side:
        side //= 2
    tables = (rotary.axial_rotary_sincos(side, n // side, dh)
              if axis == "space" else rotary.time_rotary_sincos(f, dh))
    sin, cos = (torch.from_numpy(t).cuda() for t in tables)
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


@pytest.mark.cuda
def test_float32_casts_are_exact(gen):
    """``convert.to_bf16`` rounds as PyTorch does (to nearest even),
    ``to_float32`` is exact; an unaligned view is copied first; a size that
    is not a multiple of 8 raises."""
    from moditalker_tpu_torch.ops.kernels import convert

    x = _randn32(gen, 3, 1000, 40) * 100
    assert torch.equal(convert.to_bf16(x), x.bfloat16())
    y = x.bfloat16()
    assert torch.equal(convert.to_float32(y), y.float())
    view = x.flatten()[1:8001]          # 4 bytes off a 16-byte boundary
    assert torch.equal(convert.to_bf16(view), view.bfloat16())
    with pytest.raises(ValueError, match="multiple of 8"):
        convert.to_bf16(x.flatten()[:12])


@pytest.mark.cuda
@pytest.mark.parametrize("axis,b,f,n,heads", [
    ("space", 2, 2, 1024, 8), ("space", 1, 1, 2048, 2),
    ("time", 2, 16, 128, 2), ("time", 1, 16, 1024, 8)])
def test_divided_kernels_take_float32(gen, axis, b, f, n, heads):
    """A float32 qkv goes through the kernel (bf16 operands, fp32
    accumulators) to a float32 result, held to the limits against the
    float32 plain version."""
    dh = 64
    tables = (rotary.axial_rotary_sincos(32, n // 32, dh) if axis == "space"
              else rotary.time_rotary_sincos(f, dh))
    sin, cos = (torch.from_numpy(t).cuda() for t in tables)
    x = _randn32(gen, b, f, n, 3 * heads * dh)
    name = f"divided_{axis}_attention"
    got = _launched(name, lambda: tdiv.divided_attention(
        x, sin, cos, axis, heads, dh, dh**-0.5))
    assert got.dtype == torch.float32
    want = tdiv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                            dh**-0.5, use_flash=False)
    check_bf16(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(10, 2048), (10, 1024), (1, 1032)])
def test_packed_kernel_takes_float32(gen, b, l):
    x = _randn32(gen, b, l, 384)
    got = _launched("packed_attention",
                    lambda: tpack.packed_attention(x, 8, 0.25))
    assert got.dtype == torch.float32
    check_bf16("packed_attention", got,
               tpack.packed_attention_reference(x, 8, 0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(80, 2048, 32), (4, 1024, 16),
                                   (2, 1280, 64)])
def test_onepass_kernel_takes_float32(gen, b, n, d):
    q, k, v = (_randn32(gen, b, n, d) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    assert got.dtype == torch.float32
    check_bf16("onepass_attention", got,
               tflash.onepass_attention_reference(q, k, v, d**-0.5))


@pytest.mark.cuda
def test_tiny_kernel_refuses_float32_and_fused_refuses_a_gradient(gen):
    """Tiny-L takes bf16 only (no float32 row on any path); the fused kernel
    has no gradient and raises where one is asked, never falling back."""
    q = _randn32(gen, 4096, 16, 64)
    with pytest.raises(TypeError, match="bf16"):
        tflash.tiny_attention(q, q, q, 0.125)
    x = _randn32(gen, 2, 256, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        tflash.fused_attention(x, x, x)


# ------------------------------------------------------------ gradients
# the Function's input gradient against autograd through the plain version
# (float32, TF32 off): the packed and divided backwards are the plain
# version's own vjp, the one-pass and tiny-L ones the JAX package's adjoints
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
    dh, heads, f, n = 64, 8, 16, 1024
    tables = (rotary.axial_rotary_sincos(32, 32, dh) if axis == "space"
              else rotary.time_rotary_sincos(f, dh))
    sin, cos = (torch.from_numpy(t).cuda() for t in tables)
    _check_gradient(
        gen, f"divided_{axis}_attention",
        lambda x: tdiv.divided_attention(x, sin, cos, axis, heads, dh,
                                         dh**-0.5),
        lambda x: tdiv.divided_attention_reference(
            x, sin, cos, axis, heads, dh, dh**-0.5, use_flash=False),
        [_randn32(gen, 1, f, n, 3 * heads * dh)],
        "RecomputeThroughPlainBackward")


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
    ("tiny_attention", (4096, 16, 64), torch.bfloat16)])
def test_flash_gradient_on_the_card(gen, name, shape, dtype):
    """One-pass in float32; tiny-L (bf16 only) against the float32 plain
    gradient within bf16's reach."""
    fn = {"onepass_attention": tflash.onepass_attention,
          "tiny_attention": tflash.tiny_attention}[name]
    sc = shape[-1] ** -0.5
    _check_gradient(
        gen, name, lambda *x: fn(*x, sc),
        lambda *x: tflash.onepass_attention_reference(*x, sc),
        [_randn32(gen, *shape).to(dtype) for _ in range(3)],
        "FlashSdpaBackward")
