"""The port's tiny-L and K-blocked fused attention, its ``sdpa`` routing and
its two gate switches vs the JAX package.

On the CPU a kernel wrapper runs its plain PyTorch version; it is held here
against the JAX Pallas kernel run with ``interpret=True`` (as
tests/test_pallas.py runs it), in float32. The CUDA kernels themselves are
compared with their plain versions on the card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops import attention as jattn
from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu.ops.pallas import packed_attention as jpack
from moditalker_tpu_torch.ops import attention
from moditalker_tpu_torch.ops.kernels import LAUNCHES
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack

TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(shape_q, shape_kv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


@pytest.mark.parametrize("b,l,d", [(256, 16, 64), (128, 8, 16)])
def test_tiny_plain_matches_pallas_interpret(b, l, d):
    q, k, v = _qkv((b, l, d), (b, l, d), seed=b)
    want = jflash.tiny_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), d**-0.5, interpret=True)
    got = tflash.tiny_attention(_t(q), _t(k), _t(v), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((4, 128, 64), (4, 128, 64)), ((4, 256, 64), (4, 256, 64)),
    ((4, 2048, 64), (4, 2048, 64)),
    ((2, 100, 64), (2, 100, 64)),      # ragged: the plain math in both
    ((2, 64, 64), (2, 512, 64)),       # cross-length
    ((2, 100, 64), (2, 64, 64)),       # one key block short of 128
    ((4, 256, 16), (4, 256, 16)), ((2, 100, 16), (2, 384, 16)),
    ((4, 256, 32), (4, 256, 32)), ((2, 100, 32), (2, 384, 32))])
def test_fused_plain_matches_pallas_interpret(q_shape, kv_shape):
    q, k, v = _qkv(q_shape, kv_shape, seed=q_shape[1])
    want = jflash.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True)
    got = tflash.fused_attention(_t(q), _t(k), _t(v))   # scale: D**-0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = tflash.fused_attention(_t(q), _t(k), _t(v), scale=0.2)
    want = jflash.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lead,nq,nk,d", [
    ((2, 3), 64, 512, 64), ((4,), 300, 256, 16), ((2, 2), 40, 40, 32)])
def test_sdpa_fused_matches_jax(lead, nq, nk, d):
    q, k, v = _qkv((*lead, nq, d), (*lead, nk, d), seed=nq)
    want = jattn.sdpa_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            d**-0.5)
    got = attention.sdpa_fused(_t(q), _t(k), _t(v), d**-0.5)
    assert got.shape == (*lead, nq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (b3, nq, nk, d): the model's shapes on both paths, and the gates' edges
SHAPES = [
    (16384, 16, 16, 64),   # modular time attention, B = 2
    (2048, 16, 16, 64),    # the same at 2 heads, B = 1: batch too small
    (4096, 16, 16, 64), (4224, 16, 16, 64), (4100, 16, 16, 64),
    (16384, 32, 32, 128), (16384, 40, 40, 64), (16384, 12, 12, 64),
    (16384, 16, 16, 48), (16384, 16, 16, 192), (16384, 16, 24, 64),
    (256, 1024, 1024, 64),  # modular space attention
    (16, 2048, 2048, 16), (16, 1024, 1024, 16), (16, 2048, 2048, 32),
    (16, 512, 512, 32), (16, 1280, 1280, 64), (16, 1100, 1100, 64),
    (16, 2048, 2048, 136), (16, 2048, 2048, 20), (16, 2048, 1024, 32),
    (8192, 1024, 1024, 64),
    (16, 156, 156, 64), (16, 156, 326, 64),   # AToM self and cross attention
    (2, 64, 512, 64), (2, 100, 100, 64), (4, 300, 256, 16), (4, 300, 260, 16),
    (4, 300, 384, 20), (4, 64, 192, 64),
]


@pytest.mark.parametrize("b3,nq,nk,d", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_route_matches_jax_gates(b3, nq, nk, d, masked):
    if masked:
        want = "plain"                                  # attention.py:146
    elif jflash.onepass_attention_viable(nq, nk, d):    # asked first, :54
        want = "onepass"
    elif jflash.tiny_attention_viable(b3, nq, nk, d):
        want = "tiny"
    else:
        want = "plain"
    assert attention.sdpa_route(b3, nq, nk, d, masked) == want
    assert tflash.tiny_attention_viable(b3, nq, nk, d) \
        == jflash.tiny_attention_viable(b3, nq, nk, d)


@pytest.mark.parametrize("b3,nq,nk,d", SHAPES)
def test_sdpa_fused_route_matches_jax_rule(b3, nq, nk, d):
    """``sdpa_fused`` (attention.py:220) and ``fused_attention``
    (flash_attention.py:221-225) in interpret mode, where the JAX package
    takes the kernel wherever the key length tiles."""
    if nk < 256:
        want = attention.sdpa_route(b3, nq, nk, d, False)
    elif nk % 8 == 0 and d % 8 == 0 and nk % min(128, max(8, nk)) == 0:
        want = "fused"
    else:
        want = "plain"
    assert attention.sdpa_fused_route(b3, nq, nk, d) == want


@pytest.mark.parametrize("route,shape", [
    ("onepass", (2, 1024, 16)), ("tiny", (4096, 8, 64)),
    ("plain", (2, 4, 33, 48))])
def test_sdpa_takes_its_route_on_the_cpu(route, shape):
    """Every route of ``sdpa`` gives the JAX package's result on the CPU, with
    and without a scale, and launches nothing there."""
    q, k, v = _qkv(shape, shape, seed=shape[-2])
    nq, d = shape[-2:]
    assert attention.sdpa_route(int(np.prod(shape[:-2])), nq, nq, d,
                                False) == route
    before = dict(LAUNCHES)
    for scale in (d**-0.5, None):
        want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=scale)
        got = attention.sdpa(_t(q), _t(k), _t(v), scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert LAUNCHES == before


# ------------------------------------------------------------------ switches
DIVIDED = [("space", 16, 1024, 8, 64, 64), ("time", 16, 1024, 8, 64, 64),
           ("space", 16, 64, 2, 8, 8), ("time", 16, 1024, 8, 64, 32)]
PACKED = [(1024, 128, 8), (2048, 128, 8), (512, 128, 8), (1024, 256, 8)]


@pytest.mark.parametrize("value", [None, "1", ""])
def test_switches_flip_the_gates_as_in_jax(monkeypatch, value):
    """Each switch, read at call time, closes its own gate in both packages
    and leaves the other's alone; unset or empty leaves both open."""
    for name in ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN",
                 "MODITALKER_NO_FLASH_ATTN"):
        monkeypatch.delenv(name, raising=False)
    open_div = [jdiv.divided_attention_viable(*a) for a in DIVIDED]
    open_pack = [jpack.packed_attention_viable(*a) for a in PACKED]
    assert any(open_div) and any(open_pack)
    for switch in ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN"):
        if value is None:
            monkeypatch.delenv(switch, raising=False)
        else:
            monkeypatch.setenv(switch, value)
        got_div = [tdiv.divided_attention_viable(*a) for a in DIVIDED]
        got_pack = [tpack.packed_attention_viable(*a) for a in PACKED]
        assert got_div == [jdiv.divided_attention_viable(*a) for a in DIVIDED]
        assert got_pack == [jpack.packed_attention_viable(*a) for a in PACKED]
        if value:
            closed_div = switch == "MODITALKER_NO_DIVIDED_FUSED"
            assert got_div == ([False] * 4 if closed_div else open_div)
            assert got_pack == (open_pack if closed_div else [False] * 4)
        else:
            assert got_div == open_div and got_pack == open_pack
        monkeypatch.delenv(switch, raising=False)


@pytest.mark.parametrize("min_l", [None, "512", "2048"])
def test_packed_min_l_routes_as_in_jax(monkeypatch, min_l):
    """``MODITALKER_PACKED_MIN_L``, read at call time, moves the packed
    gate's floor of L in both packages alike: at 512 the ds = 1 ytxt
    attention [2B, 512, 128] × 8 heads goes to the packed kernel's path
    (its plain version on the CPU), elsewhere head-split through ``sdpa``."""
    for name in ("MODITALKER_NO_PACKED_ATTN", "MODITALKER_NO_FLASH_ATTN",
                 "MODITALKER_PACKED_MIN_L"):
        monkeypatch.delenv(name, raising=False)
    if min_l is not None:
        monkeypatch.setenv("MODITALKER_PACKED_MIN_L", min_l)
    routes = []
    plain = tpack.packed_attention_reference
    monkeypatch.setattr(tpack, "packed_attention_reference",
                        lambda *a, use_flash=False: routes.append(
                            not use_flash) or plain(*a, use_flash=use_flash))
    shapes = PACKED + [(512, 128, 8), (504, 128, 8), (256, 128, 8)]
    want = [jpack.packed_attention_viable(*a) for a in shapes]
    assert [tpack.packed_attention_viable(*a) for a in shapes] == want
    for l, c, heads in shapes:
        qkv = torch.zeros(2, l, 3 * c)
        tpack.packed_attention(qkv, heads, 0.25)
    assert routes == want
    assert want[-3] == (min_l == "512")
    assert want[0] == (min_l != "2048")


@pytest.mark.parametrize("axis", ["space", "time"])
def test_modular_divided_attention_matches_fused(monkeypatch, axis):
    """With the switch set, divided attention goes head-split through
    ``sdpa`` and gives the fused path's result, here and in the JAX
    package."""
    heads, dh = 2, 64
    b, f, n = (1, 1, 1024) if axis == "space" else (1, 16, 128)
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(b, f, n, 3 * heads * dh)).astype(np.float32)
    sin, cos = (jrot.axial_rotary_sincos(32, 32, dh) if axis == "space"
                else jrot.time_rotary_sincos(f, dh))
    args = (axis, heads, dh, dh**-0.5)
    monkeypatch.delenv("MODITALKER_NO_DIVIDED_FUSED", raising=False)
    fused = tdiv.divided_attention(_t(qkv), _t(sin), _t(cos), *args)
    monkeypatch.setenv("MODITALKER_NO_DIVIDED_FUSED", "1")
    modular = tdiv.divided_attention(_t(qkv), _t(sin), _t(cos), *args)
    want = jdiv.divided_attention(jnp.asarray(qkv), sin, cos, *args)
    np.testing.assert_allclose(modular.numpy(), fused.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(modular.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_modular_packed_attention_matches_fused(monkeypatch):
    qkv = np.random.default_rng(12).normal(size=(1, 1024, 384)).astype(
        np.float32)
    monkeypatch.delenv("MODITALKER_NO_PACKED_ATTN", raising=False)
    fused = tpack.packed_attention(_t(qkv), 8, 0.25)
    monkeypatch.setenv("MODITALKER_NO_PACKED_ATTN", "1")
    modular = tpack.packed_attention(_t(qkv), 8, 0.25)
    want = jpack.packed_attention(jnp.asarray(qkv), 8, 0.25)
    np.testing.assert_allclose(modular.numpy(), fused.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(modular.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks ahead of a launch need no card: dtype and shape errors
    come before the library is built."""
    q = torch.zeros(4096, 16, 64)
    with pytest.raises(TypeError, match="bf16"):
        tflash.tiny_attention_cuda(q, q, q, 1.0)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="k and v of shape"):
        tflash.tiny_attention_cuda(qb, qb[:, :8], qb, 1.0)
    with pytest.raises(NotImplementedError, match="tiny-L kernel built for"):
        tflash.tiny_attention_cuda(qb[:, :8], qb[:, :8], qb[:, :8], 1.0)
    with pytest.raises(NotImplementedError, match="fused kernel built for"):
        x = torch.zeros(2, 256, 48, dtype=torch.bfloat16)
        tflash.fused_attention_cuda(x, x, x, 1.0)
    with pytest.raises(ValueError, match="k and v of shape"):
        x = torch.zeros(2, 256, 64, dtype=torch.bfloat16)
        tflash.fused_attention_cuda(x, x, x[:1], 1.0)
    # at head dim 64 above 1152 keys (the K ring) only whole 128-key tiles
    with pytest.raises(ValueError, match="head dim 64"):
        kv = torch.zeros(2, 1160, 64, dtype=torch.bfloat16)
        tflash.fused_attention_cuda(x, kv, kv, 1.0)
    # one-pass: bf16 or float32 (cast on the card), built head dims only,
    # and at head dim 64 (the wgmma tile) above 1152 rows only rows that
    # tile by 128
    x = torch.zeros(2, 1024, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or float32"):
        tflash.onepass_attention_cuda(x, x, x, 1.0)
    with pytest.raises(TypeError, match="bf16 or float32"):
        tflash.onepass_attention_cuda(x.float(), x.float(), x, 1.0)
    with pytest.raises(NotImplementedError, match="one-pass kernel built for"):
        x = torch.zeros(2, 1024, 48, dtype=torch.bfloat16)
        tflash.onepass_attention_cuda(x, x, x, 1.0)
    for n in (1160, 2000):
        with pytest.raises(ValueError, match="head dim 64"):
            x = torch.zeros(2, n, 64, dtype=torch.bfloat16)
            tflash.onepass_attention_cuda(x, x, x, 1.0)
    # packed: bf16 or float32, contiguous q|k|v thirds of whole heads,
    # dh = 16
    with pytest.raises(TypeError, match="bf16 or float32"):
        tpack.packed_attention_cuda(
            torch.zeros(1, 1024, 384, dtype=torch.float16), 8, 0.25)
    qkv = torch.zeros(1, 1024, 384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tpack.packed_attention_cuda(qkv[:, ::2], 8, 0.25)
    with pytest.raises(ValueError, match="thirds"):
        tpack.packed_attention_cuda(qkv[..., :383].contiguous(), 8, 0.25)
    with pytest.raises(ValueError, match="thirds"):
        tpack.packed_attention_cuda(qkv, 5, 0.25)
    with pytest.raises(NotImplementedError, match="packed kernel built for"):
        tpack.packed_attention_cuda(qkv, 4, 0.25)
