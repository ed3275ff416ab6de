"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a CUDA device (the kernels have no CPU mode).
Imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Inputs are bf16. Kernel and plain version round q, the scores or the
probabilities to bf16 at different places, so each kernel is held to
``BF16_LIMITS``: its max and rms error relative to the plain output's max
and rms. The shapes are those the kernels are built for, at the main
path's sizes and smaller, with a ragged tile for the packed kernel.
"""

import pytest
import torch

from moditalker_tpu_torch.ops import rotary
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
@pytest.mark.parametrize("axis,f,n,heads,dh", [
    ("space", 2, 256, 2, 64), ("space", 2, 1024, 8, 64),
    ("space", 1, 2048, 2, 64), ("time", 16, 128, 2, 64),
    ("time", 16, 1024, 8, 64), ("time", 16, 64, 4, 64)])
def test_divided_kernels_match_plain(gen, axis, f, n, heads, dh):
    side = 1 << (n.bit_length() - 1) // 2   # n = side × (n / side)
    tables = (rotary.axial_rotary_sincos(side, n // side, dh)
              if axis == "space" else rotary.time_rotary_sincos(f, dh))
    sin, cos = (torch.from_numpy(t).cuda() for t in tables)
    x = _randn(gen, 2, f, n, 3 * heads * dh)
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    name = f"divided_{axis}_attention"
    got = _launched(name, lambda: tdiv.divided_attention(
        x, sin, cos, axis, heads, dh, dh**-0.5))
    want = tdiv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                            dh**-0.5, use_flash=False)
    check_bf16(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(2, 1024), (1, 2048), (2, 1032)])
def test_packed_kernel_matches_plain(gen, b, l):
    x = _randn(gen, b, l, 384)
    got = _launched("packed_attention",
                    lambda: tpack.packed_attention(x, 8, 0.25))
    want = tpack.packed_attention_reference(x, 8, 0.25)
    check_bf16("packed_attention", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(16, 2048, 32), (3, 1280, 64),
                                   (2, 1024, 32)])
def test_onepass_kernel_matches_plain(gen, b, n, d):
    q, k, v = (_randn(gen, b, n, d) for _ in range(3))
    got = _launched("onepass_attention",
                    lambda: tflash.onepass_attention(q, k, v, d**-0.5))
    want = tflash.onepass_attention_reference(q, k, v, d**-0.5)
    check_bf16("onepass_attention", got, want)
