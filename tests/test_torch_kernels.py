"""The port's attention ops and kernels vs the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version; these tests
hold that plain version against the JAX Pallas kernel run with
``interpret=True`` (as tests/test_pallas.py runs it), at gate-passing small
shapes, in float32. The CUDA kernels themselves are compared with their
plain versions on the card by tests/test_torch_cuda.py and by
``chip_smoke.py``.
"""

import re

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
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack

from .torch_stubs import stub_launches  # noqa: F401 (fixture)


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


@pytest.mark.parametrize("l", [1024, 1032])
def test_packed_plain_matches_pallas_interpret(l):
    """The xy-plane attention's length, and a ragged one the gate admits
    (L % 8 == 0: the TPU kernel then walks 8-row query blocks, the CUDA
    kernel masks its last 128-key tile)."""
    b, c, heads = 1, 128, 8
    assert tpack.packed_attention_viable(l, c, heads)
    assert jpack.packed_attention_viable(l, c, heads)
    qkv = np.random.default_rng(5).normal(size=(b, l, 3 * c)).astype(np.float32)
    scale = (c // heads) ** -0.5
    want = jpack.packed_attention(jnp.asarray(qkv), heads, scale,
                                  interpret=True)
    got = tpack.packed_attention(_t(qkv), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_onepass_plain_matches_pallas_interpret(d):
    """The head dims the kernel is built for: the UNet's attentions at
    dh = 16 and (after the last upsample: C = 256, 8 heads) dh = 32, the
    AE's dim_head 64 (folded batch cut to 2)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 1024, d)).astype(np.float32)
               for _ in range(3))
    assert d in tflash.HEAD_DIMS
    assert tflash.onepass_attention_viable(1024, 1024, d)
    want = jflash.onepass_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), d**-0.5, interpret=True)
    got = tflash.onepass_attention(_t(q), _t(k), _t(v), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _case_labels(source: str, function: str) -> tuple[int, ...]:
    """The ``case N:`` labels inside ``function`` of a file under csrc/."""
    text = (_build.CSRC / source).read_text()
    body = text[re.search(rf"(int|cudaError_t) {function}\(", text).start():]
    body = body[:body.index("\n}\n")]
    return tuple(int(n) for n in re.findall(r"case (\d+):", body))


def test_built_head_dims_match_the_sources():
    """The head dims a wrapper sends to the configurations' library are the
    instantiations its sources' ``switch`` holds, bf16 and float32 alike, no
    more and no fewer; every other head dim the gates admit goes to the
    classes' library, whose launchers switch on the head-dim classes, or
    (the one-pass and fused kernels above 32) to the wide tile's, whose
    launcher switches on the widths. The one-pass wrapper launches the fused
    kernel at Nq = Nk, so both share its lists."""
    for suffix in ("", "_f32"):
        assert _case_labels(f"flash_attention{suffix}.cu",
                            f"fused_attention{suffix}") \
            == tflash.HEAD_DIMS == (16, 32, 64)
        assert _case_labels(f"packed_attention{suffix}.cu",
                            f"packed_attention{suffix}") \
            == tpack.PACKED_HEAD_DIMS == (16,)
        assert _case_labels(f"flash_classes{suffix}.cu",
                            f"tiny_attention_classes{suffix}") \
            == tflash.TINY_HEAD_DIMS == (64, 128)
    assert _case_labels("smallhead_tile.cuh", "launch_fused_classes") \
        == tflash.FUSED_HEAD_DIM_CLASSES == (16, 32)
    assert _case_labels("wgmma_wide.cuh", "launch_fused_wide") \
        == tflash.WIDE_HEAD_DIMS
    assert not set(tflash.WIDE_HEAD_DIMS) & set(tflash.HEAD_DIMS)
    # bf16 at 40, 48 and 56: the narrow tile, a case each
    assert _case_labels("flash_narrow.cu", "fused_attention_narrow") \
        == tflash.NARROW_HEAD_DIMS == (40, 48, 56)
    assert tflash.NARROW_ENTRY == "fused_attention_narrow"


@pytest.mark.parametrize("source", sorted(
    p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_csrc_includes_name_files_that_exist(source):
    """Every ``#include "..."`` of a kernel source names a header beside it,
    so a header taken out of csrc/ cannot leave a dangling include."""
    text = (_build.CSRC / source).read_text()
    for name in re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M):
        assert (_build.CSRC / name).is_file(), f"{source} includes {name}"


def test_launch_counts_split_by_shape():
    """``count_launch`` adds one to the kernel's count and to the count of
    its shape; a reset clears both."""
    tkernels.reset_launch_counts()
    tkernels.count_launch("packed_attention", torch.Size((2, 2048, 384)))
    tkernels.count_launch("packed_attention", (2, 1024, 384))
    tkernels.count_launch("packed_attention", (2, 1024, 384))
    assert tkernels.LAUNCHES["packed_attention"] == 3
    assert tkernels.LAUNCHES_BY_SHAPE["packed_attention"] == {
        (2, 2048, 384): 1, (2, 1024, 384): 2}
    assert sum(tkernels.LAUNCHES.values()) == 3
    tkernels.reset_launch_counts()
    assert not any(tkernels.LAUNCHES.values())
    assert not any(tkernels.LAUNCHES_BY_SHAPE.values())


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


@pytest.mark.parametrize("name", sorted(tkernels.QUANTILE_LIMITS))
def test_quantile_measure_alone_catches_a_wrong_head(name):
    """The 0.999 quantile of |err| / max |plain| is below its limit for a
    bf16 rounding of the plain output and far above it for two heads
    swapped, and one wrong element does not move it: the measure no single
    element decides still fails a wrong kernel on its own."""
    rng = np.random.default_rng(0)
    qkv = _t(rng.normal(size=(1, 1024, 384)))
    plain = tpack.packed_attention_reference(qkv, 8, 0.25)
    limit = tkernels.QUANTILE_LIMITS[name]
    assert tkernels.relative_errors(plain.bfloat16(), plain)[2] < limit / 2
    swapped = torch.cat([plain[..., 16:32], plain[..., :16], plain[..., 32:]],
                        dim=-1)
    assert tkernels.relative_errors(swapped, plain)[2] > 10 * limit
    one_off = plain.clone()
    one_off[0, 5, 7] += plain.abs().max()
    rel_max, _, rel_q = tkernels.relative_errors(one_off, plain)
    assert rel_max >= 1.0 and rel_q == 0.0


# ---- host-side helpers of the space kernel: what the kernel will read

@pytest.mark.parametrize("h,w,dim", [(32, 32, 64), (16, 16, 64), (32, 64, 64)])
def test_rotary_pair_table_rebuilds_axial_tables(h, w, dim):
    """The half-width (cos, sin) table holds every entry of the JAX
    package's axial tables, and rotating 16-byte chunks with it, as the
    kernel does, is ``apply_rot_emb``."""
    sin, cos = jrot.axial_rotary_sincos(h, w, dim)
    table = tdiv.rotary_pair_table(_t(sin), _t(cos))
    assert table.shape == (h * w, dim // 2, 2) and table.is_contiguous()
    for j in (0, 1):                      # both entries of each pair
        np.testing.assert_array_equal(table[..., 0].numpy(), cos[:, j::2])
        np.testing.assert_array_equal(table[..., 1].numpy(), sin[:, j::2])
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(h * w, dim)))
    # chunk c of row r: pairs 4c..4c+3, i.e. table[r, 4c:4c+4] (32 bytes)
    a, b = x[:, 0::2], x[:, 1::2]
    c, s = table[..., 0], table[..., 1]
    got = torch.stack((a * c - b * s, b * c + a * s), dim=-1).flatten(-2)
    want, _ = rotary.apply_rot_emb(x, x, _t(sin), _t(cos))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_rotary_pair_table_is_memoised_and_rejects_the_time_table():
    sin, cos = (_t(t) for t in rotary.axial_rotary_sincos(16, 16, 64))
    assert tdiv.rotary_pair_table(sin, cos) is tdiv.rotary_pair_table(sin, cos)
    # the time table pairs two frequencies (duplicated by concatenation), so
    # half the width would lose entries: the time kernel stages it whole
    t_sin, t_cos = (_t(t) for t in jrot.time_rotary_sincos(16, 64))
    assert not torch.equal(t_sin[:, 0::2], t_sin[:, 1::2])
    with pytest.raises(ValueError, match="pair"):
        tdiv.rotary_pair_table(t_sin, t_cos)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [2, 4, 8, 32, 128])
def test_space_rotate_reference_matches_jax_apply_rot(dh, dtype):
    """The plain version of the space kernel's rotation pre-pass
    (``space_rotate_reference``: the scratch the pre-rotated design's tiles
    read) against the JAX package's ``_apply_rot`` on each 128-lane block of
    q (scaled) and k, the tables tiled over a block's heads as
    ``_space_fused`` tiles them, on numpy inputs from a seed: equal once
    both are rounded to bf16; v rounded to bf16; the columns past a head of
    2 or 4 dims zeros (the scratch's heads are whole 16-byte chunks)."""
    heads, n, scale = 256 // dh, 256, dh**-0.5
    rng = np.random.default_rng(21)
    qkv = rng.normal(size=(2, n, 3 * heads * dh)).astype(np.float32)
    qkv = np.asarray(_t(qkv).to(dtype).float())
    if dh >= 4:
        sin, cos = jrot.axial_rotary_sincos(16, n // 16, dh)
    else:   # the axial table has no entry below head dim 4
        ang = np.repeat(rng.uniform(-3, 3, size=(n, dh // 2)), 2, axis=-1)
        sin, cos = np.sin(ang).astype(np.float32), np.cos(ang).astype(
            np.float32)
    got = tdiv.space_rotate_reference(_t(qkv).to(dtype), _t(sin), _t(cos),
                                      heads, dh, scale)
    w = tdiv.space_scratch_width(dh)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, 3 * heads * w)
    got = got.float().reshape(2, n, 3, heads, w)
    assert not got[..., dh:].any()
    g = 128 // dh
    sin_t, cos_t = jdiv._tile_tables(sin, cos, g)
    r = jnp.asarray(jdiv._rot_block(g, dh))
    for third, mul in ((0, scale), (1, 1.0)):
        x = qkv[..., third * heads * dh:(third + 1) * heads * dh]
        want = np.concatenate([np.asarray(jdiv._apply_rot(
            jnp.asarray(x[..., j:j + 128]), sin_t, cos_t, r, mul))
            for j in range(0, heads * dh, 128)], axis=-1)
        want = _t(want).bfloat16().float().reshape(2, n, heads, dh)
        assert torch.equal(got[:, :, third, :, :dh], want), third
    v = _t(qkv[..., 2 * heads * dh:]).bfloat16().float()
    assert torch.equal(got[:, :, 2, :, :dh], v.reshape(2, n, heads, dh))


@pytest.mark.parametrize("n", range(256, 2049, 128))
def test_space_gate_by_n(n):
    """Every multiple of 128 from 256 to 2048 passes the space gate, as in
    the JAX package (the kernel keeps K resident or rings it by N on its own
    side); rows that do not tile by 128 on either side of it do not."""
    for rows in (n - 64, n, n + 64):
        want = jdiv.divided_attention_viable("space", 16, rows, 8, 64, 64)
        assert tdiv.divided_attention_viable("space", 16, rows, 8, 64,
                                             64) == want
        assert want == (rows == n)


@pytest.mark.parametrize("n", [0, 128, 200, 1000])
def test_space_kernel_rejects_rows_that_do_not_tile(n):
    """Below the gate, the kernel's wrapper refuses what the tile cannot
    take before it builds or launches anything."""
    assert not tdiv.divided_attention_viable("space", 1, n, 2, 64, 64)
    qkv = torch.zeros(1, n, 3 * 2 * 64, dtype=torch.bfloat16)
    tab = torch.zeros(n, 64)
    with pytest.raises(ValueError, match="128"):
        tdiv.space_attention_cuda(qkv, tab, tab, 2, 64, 0.125)


def test_divided_kernels_reject_unbuilt_shapes(stub_launches):
    """What lies outside the gate has no kernel and raises before anything
    launches: a head dim that does not divide 128 (or of 1, which has no
    rotary pair), 40 frames, a frame count off the 8-frame tiling. Inside
    it, head dim 32 and 8-frame clips (once refused here) launch the
    classes' libraries (the libraries are stubs): space the pre-rotated
    design's entry point, time at 8 frames the staged kernel's."""
    for dh in (48, 1):
        tab = torch.zeros(256, dh)
        with pytest.raises(ValueError, match="head dims dividing 128"):
            tdiv.space_attention_cuda(
                torch.zeros(1, 256, 3 * 4 * dh, dtype=torch.bfloat16), tab,
                tab, 4, dh, 0.125)
    for f in (40, 12):
        tab = torch.zeros(f, 64)
        with pytest.raises(ValueError, match="frames"):
            tdiv.time_attention_cuda(
                torch.zeros(1, f, 8, 3 * 2 * 64, dtype=torch.bfloat16), tab,
                tab, 2, 64, 0.125)
    assert stub_launches == []
    tab = torch.zeros(256, 32)
    tdiv.space_attention_cuda(
        torch.zeros(1, 256, 3 * 4 * 32, dtype=torch.bfloat16), tab, tab, 4,
        32, 0.125)
    tab = torch.zeros(8, 64)
    tdiv.time_attention_cuda(
        torch.zeros(1, 8, 8, 3 * 2 * 64, dtype=torch.bfloat16), tab, tab, 2,
        64, 0.125)
    assert stub_launches == ["divided_space_attention_prerotated",
                             tdiv.STAGED_TIME_ENTRY]
