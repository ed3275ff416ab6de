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
not full for the tiny-L and the time kernel. The packed and the one-pass
kernel are held on both sides of every choice their launchers make: 256, 128
and 64 query rows per block (B = 2 and B = 1 at L = 2048 and 1024, a large
batch), whole and ragged last tiles, and at D = 64 resident K (N = 1024) and
the K ring (N = 1280, 2048). The fused kernel is held at every edge its two
tiles mask: ragged query chunks (Nq = 1, 100, 1100), key tiles short of 128
(Nk = 8 … 120), one whole key tile (Nk = 128), Nq != Nk on both sides of the
resident-K limit, and D = 16, 32 and 64.
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
