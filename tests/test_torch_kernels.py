"""The port's attention ops and kernels vs the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; these tests
hold that plain version against the JAX Pallas kernel run with
``interpret=True`` (as tests/test_pallas.py runs it), at gate-passing small
shapes, in float32. The CUDA kernels themselves are compared with their
plain versions on the card by tests/test_torch_cuda.py and by
``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops import attention as jattn
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu.ops.pallas import packed_attention as jpack
from moditalker_tpu_torch.ops import attention, rotary
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("n,dim", [(16, 64), (4, 8), (100, 32)])
def test_time_rotary_table_exact(n, dim):
    for got, want in zip(rotary.time_rotary_sincos(n, dim),
                         jrot.time_rotary_sincos(n, dim)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,dim", [(32, 32, 64), (4, 4, 8), (16, 8, 32)])
def test_axial_rotary_table_exact(h, w, dim):
    for got, want in zip(rotary.axial_rotary_sincos(h, w, dim),
                         jrot.axial_rotary_sincos(h, w, dim)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_rot_emb_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 3, 16, 64)).astype(np.float32)
    k = rng.normal(size=(2, 3, 16, 64)).astype(np.float32)
    sin, cos = jrot.time_rotary_sincos(16, 64)
    jq, jk = jrot.apply_rot_emb(jnp.asarray(q), jnp.asarray(k), sin, cos)
    tq, tk = rotary.apply_rot_emb(_t(q), _t(k), _t(sin), _t(cos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)


def test_sdpa_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 4, 33, 48)).astype(np.float32)
               for _ in range(3))
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      scale=48**-0.5)
    got = attention.sdpa(_t(q), _t(k), _t(v), scale=48**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _divided_inputs(axis):
    heads, dh = 2, 64
    b, f, n = (1, 2, 256) if axis == "space" else (1, 16, 128)
    rng = np.random.default_rng(7)
    qkv = rng.normal(size=(b, f, n, 3 * heads * dh)).astype(np.float32)
    if axis == "space":
        sin, cos = jrot.axial_rotary_sincos(16, 16, dh)
    else:
        sin, cos = jrot.time_rotary_sincos(f, dh)
    return qkv, sin, cos, heads, dh


@pytest.mark.parametrize("axis", ["space", "time"])
def test_divided_plain_matches_pallas_interpret(axis):
    qkv, sin, cos, heads, dh = _divided_inputs(axis)
    b, f, n, _ = qkv.shape
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    want = jdiv.divided_attention(jnp.asarray(qkv), sin, cos, axis, heads,
                                  dh, dh**-0.5, interpret=True)
    got = tdiv.divided_attention(_t(qkv), _t(sin), _t(cos), axis, heads, dh,
                                 dh**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_packed_plain_matches_pallas_interpret():
    b, l, c, heads = 1, 1024, 128, 8
    assert tpack.packed_attention_viable(l, c, heads)
    qkv = np.random.default_rng(5).normal(size=(b, l, 3 * c)).astype(np.float32)
    scale = (c // heads) ** -0.5
    want = jpack.packed_attention(jnp.asarray(qkv), heads, scale,
                                  interpret=True)
    got = tpack.packed_attention(_t(qkv), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_onepass_plain_matches_pallas_interpret():
    """The UNet joint attention after the last upsample: C = 256, 8 heads,
    dh = 32 (folded batch cut to 2)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 1024, 32)).astype(np.float32)
               for _ in range(3))
    assert tflash.onepass_attention_viable(1024, 1024, 32)
    want = jflash.onepass_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 32**-0.5, interpret=True)
    got = tflash.onepass_attention(_t(q), _t(k), _t(v), 32**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("nq,nk,d", [(2048, 2048, 32), (1024, 1024, 64),
                                     (512, 512, 32), (1280, 1280, 16),
                                     (2048, 1024, 32), (1024, 1024, 136)])
def test_onepass_gate_matches_jax(nq, nk, d):
    assert tflash.onepass_attention_viable(nq, nk, d) \
        == jflash.onepass_attention_viable(nq, nk, d)


@pytest.mark.parametrize("l,c,heads", [
    (1024, 128, 8), (2048, 128, 8), (512, 128, 8), (4096, 128, 8),
    (8192, 128, 8), (1032, 128, 8), (1024, 256, 8), (1024, 96, 6)])
def test_packed_gate_matches_jax(l, c, heads):
    assert tpack.packed_attention_viable(l, c, heads) \
        == jpack.packed_attention_viable(l, c, heads)


@pytest.mark.parametrize("axis,f,n,heads,dh,rot", [
    ("space", 16, 1024, 8, 64, 64), ("time", 16, 1024, 8, 64, 64),
    ("space", 16, 4096, 8, 64, 64), ("space", 16, 64, 2, 8, 8),
    ("time", 4, 64, 2, 8, 8), ("time", 24, 100, 8, 64, 64),
    ("space", 16, 1024, 6, 64, 64), ("time", 16, 1024, 8, 64, 32)])
def test_divided_gate_matches_jax(axis, f, n, heads, dh, rot):
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, rot) \
        == jdiv.divided_attention_viable(axis, f, n, heads, dh, rot)


@pytest.mark.parametrize("name", sorted(tkernels.BF16_LIMITS))
def test_bf16_limits_pass_rounding_and_catch_a_wrong_head(name):
    """The card's kernel-vs-plain limits accept a bf16 rounding of the plain
    output and reject an output with two heads swapped."""
    rng = np.random.default_rng(0)
    qkv = _t(rng.normal(size=(1, 1024, 384)))
    plain = tpack.packed_attention_reference(qkv, 8, 0.25)
    tkernels.check_bf16(name, plain.bfloat16(), plain)
    swapped = torch.cat([plain[..., 16:32], plain[..., :16], plain[..., 32:]],
                        dim=-1)
    with pytest.raises(AssertionError, match=name):
        tkernels.check_bf16(name, swapped, plain)
