"""The float32 one-pass and fused kernels at head dim 64 past resident K
(``fused_attention_f32_prerounded``: a pre-pass that rounds K and V to bf16
once per sequence, then the wgmma tile's bf16 K ring on its scratch) on
the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: the pre-pass's plain version and the route
computed from its scratch, equal bit for bit to the float32 route from q,
k and v; the port's one-pass at such a length against the JAX package's
``_onepass`` in interpret mode; the wrappers driven with stub libraries
(past 1152 keys the new entry point with the scratch the wrapper
allocates, at 1024 keys and in bf16 the choice as before); the chooser
against the paired readings that set it; and the entry point and the
tile as the sources state them.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash

from . import torch_stubs
from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENTRY = "fused_attention_f32_prerounded"


def _inputs(b, nq, nk, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, 64)).astype(np.float32)
    k, v = (rng.normal(size=(b, nk, 64)).astype(np.float32)
            for _ in range(2))
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)


@pytest.mark.parametrize("b,nq,nk", [(2, 1280, 1280), (2, 2048, 2048),
                                     (2, 300, 1536)])
def test_route_from_the_prepass_scratch_is_the_route(b, nq, nk):
    """The pre-pass's plain version rounds k and v to bf16 once, into a
    scratch [2, B, Nk, 64]; the float32 route computed from it (in the
    kernels' ``exp2`` form, which these rows are held to) equals the route
    from q, k and v bit for bit: the pre-pass moves no rounding point."""
    q, k, v = _inputs(b, nq, nk)
    kv = tflash.prerounded_kv_reference(k, v)
    assert kv.dtype == torch.bfloat16 and kv.shape == (2, b, nk, 64)
    assert torch.equal(kv[0], k.bfloat16()) and torch.equal(kv[1],
                                                            v.bfloat16())
    got = tflash.attention_float32_route_from_scratch(q, kv, 0.125, exp2=True)
    want = tflash.attention_float32_route(q, k, v, 0.125, exp2=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, want)


def test_onepass_past_resident_k_matches_jax_interpret():
    """At [2, 1280, 64] float32 (past resident K, a length the one-pass gate
    admits) the port's one-pass (its plain version on the CPU) matches the
    JAX package's ``_onepass`` in interpret mode within the tolerance of
    ``test_onepass_plain_matches_pallas_interpret``, and the function the
    kernel computes there (the route from the pre-pass's scratch) within
    the bf16 limits the card holds every kernel to."""
    q, k, v = _inputs(2, 1280, 1280, seed=3)
    assert tflash.onepass_attention_viable(1280, 1280, 64)
    assert jflash.onepass_attention_viable(1280, 1280, 64)
    assert 1280 > tflash.RESIDENT_KEYS_D64
    want = torch.from_numpy(np.array(jflash.onepass_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), 0.125, interpret=True)))
    got = tflash.onepass_attention(q, k, v, 0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    route = tflash.attention_float32_route_from_scratch(
        q, tflash.prerounded_kv_reference(k, v), 0.125, exp2=True)
    tkernels.check_bf16("onepass_attention", route, want)


@pytest.fixture
def recorded(stub_launches, monkeypatch):
    """Each float32 entry point's call (name, arguments) and each scratch
    the wrapper allocated (the K and V scratch and the V scratch)."""
    calls, made = [], []
    monkeypatch.setattr(tflash, "_lib_f32",
                        lambda: torch_stubs.StubLib(stub_launches, calls))
    for name in ("onepass_f32_kv_scratch", "onepass_f32_scratch"):
        allocate = getattr(tflash, name)

        def scratch(*args, allocate=allocate):
            made.append(allocate(*args))
            return made[-1]

        monkeypatch.setattr(tflash, name, scratch)
    return calls, made


@pytest.mark.parametrize("b,nq,nk", [(80, 2048, 2048), (16, 2048, 2048),
                                     (8, 2048, 2048), (2, 2048, 2048),
                                     (80, 1280, 1280), (8, 1536, 1536),
                                     (16, 1000, 2048), (2, 64, 1280)])
def test_float32_past_resident_k_launches_the_prerounded_entry(
        recorded, b, nq, nk):
    """Float32 q [B, Nq, 64] over k, v [B, Nk, 64] past 1152 keys (the
    256-channel UNet's joint attention [80, 2048, 64] at train-diffusion's
    B = 10, few sequences, other lengths, fused query rows) launch
    ``fused_attention_f32_prerounded`` once; the pointer after q, k and v
    is the scratch the wrapper allocated: bf16 [2, B, Nk, 64] on the
    operands' device; the launch counts under that entry point."""
    calls, made = recorded
    q = torch.empty(b, nq, 64)
    k, v = torch.empty(b, nk, 64), torch.empty(b, nk, 64)
    assert tflash.onepass_f32_prerounded(b, nq, nk)
    if nq == nk:
        out = tflash.onepass_attention(q, k, v, 0.125)
        name = "onepass_attention"
    else:
        with torch.no_grad():
            out = tflash.fused_attention(q, k, v, 0.125)
        name = "fused_attention"
    assert out.dtype == torch.float32 and out.shape == (b, nq, 64)
    ((entry, args),) = calls
    (scratch,) = made
    assert entry == ENTRY
    assert scratch.dtype == torch.bfloat16 and scratch.device == q.device
    assert tuple(scratch.shape) == (2, b, nk, 64)
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        scratch.data_ptr(), out.data_ptr())
    assert args[5:10] == (b, nq, nk, 64, 0.125)
    assert tkernels.LAUNCHES[name] == 1
    assert tkernels.LAUNCHES_BY_ENTRY == {ENTRY: 1}


@pytest.mark.parametrize("b,own", [(1280, True), (128, False)])
def test_resident_k_choice_is_unchanged(recorded, b, own):
    """At 1024 keys the choice is as before: the V scratch (the float32
    resident-K kernel) from ``ONEPASS_F32_MIN_SEQS`` sequences, a null
    pointer (the wgmma tile's float32 route) below; never the K and V
    scratch."""
    calls, made = recorded
    x = torch.empty(b, 1024, 64)
    assert not tflash.onepass_f32_prerounded(b, 1024, 1024)
    tflash.onepass_attention(x, x, x, 0.125)
    ((entry, args),) = calls
    assert entry == "fused_attention_f32"
    if own:
        (scratch,) = made
        assert tuple(scratch.shape) == (b, 1024, 64)
        assert args[3] == scratch.data_ptr()
    else:
        assert made == [] and args[3] is None


@pytest.mark.parametrize("n", [2048, 1280])
def test_bf16_past_resident_k_is_unchanged(stub_launches, recorded, n):
    """bf16 q, k, v past resident K launch the bf16 entry point, which
    takes no scratch, and allocate none."""
    calls, made = recorded
    x = torch.empty(80, n, 64, dtype=torch.bfloat16)
    tflash.onepass_attention(x, x, x, 0.125)
    assert stub_launches == ["fused_attention"] and made == [] and not calls
    assert tkernels.LAUNCHES_BY_ENTRY == {"fused_attention": 1}


def test_other_head_dims_past_resident_k_take_no_scratch(stub_launches,
                                                         recorded):
    """Past 1152 keys at head dims 32 (the small-head tile, the same
    library's entry point with a null pointer) and 128 (the wide tile's
    library) the choice is unchanged."""
    calls, made = recorded
    for d in (32, 128):
        x = torch.empty(8, 2048, d)
        tflash.onepass_attention(x, x, x, d**-0.5)
    ((entry, args),) = calls
    assert entry == "fused_attention_f32" and args[3] is None
    assert made == [] and stub_launches[-1] == "fused_attention_wide_f32"


# kernel / route at (sequences, query rows, keys), each the fastest of its
# readings in one call of tools/ab_space_f32.py --onepass --gate on an H100
# (PERF.md; a shape read in several calls has a reading per call)
GATE_READINGS = {
    (80, 2048, 2048): (0.6766,), (16, 2048, 2048): (0.7199,),
    (8, 2048, 2048): (0.9050,), (2, 2048, 2048): (0.8698, 0.8787),
    (1, 2048, 2048): (0.8950,), (80, 1280, 1280): (0.7775,),
    (8, 1280, 1280): (0.9127, 0.9274), (1, 1280, 1280): (0.8953,),
    (80, 1536, 1536): (0.6648,), (8, 1536, 1536): (0.9252,),
    (16, 512, 2048): (0.9580,), (16, 768, 2048): (0.9890,),
    (16, 1000, 2048): (1.0127, 0.9967, 0.9988),
    (16, 1152, 2048): (0.9070,), (16, 1280, 2048): (0.9057,),
    (32, 1000, 2048): (0.7087,), (80, 512, 2048): (0.8039,),
    (80, 1000, 2048): (0.7228,), (80, 1152, 2048): (0.7082,),
    (2, 1000, 2048): (0.8941,), (2, 1152, 2048): (0.8956,),
    (2, 1280, 2048): (0.9022,), (2, 300, 1280): (0.8962,),
    (16, 128, 2048): (0.9695,), (128, 128, 2048): (1.4922,),
    (512, 128, 2048): (1.5823,), (1280, 64, 2048): (1.5987,),
    (128, 256, 2048): (1.1133,), (512, 256, 2048): (1.1268,),
    (128, 512, 2048): (0.8502,)}


def test_onepass_f32_prerounded_where_it_read_faster():
    """The chooser takes the new kernel at every measured shape where it
    read faster than the route in every call, and the route at every one
    where it read slower; at [16, 1000] over 2048 keys the two read even
    (1.0127, 0.9967, 0.9988 in three calls) and the rule gives the kernel.
    With K resident (at or below ``RESIDENT_KEYS_D64``) never, whatever the
    sequences."""
    for (b, nq, nk), ratios in GATE_READINGS.items():
        if max(ratios) < 1:
            assert tflash.onepass_f32_prerounded(b, nq, nk), (b, nq, nk)
        elif min(ratios) > 1:
            assert not tflash.onepass_f32_prerounded(b, nq, nk), (b, nq, nk)
    assert tflash.onepass_f32_prerounded(16, 1000, 2048)
    # every one-pass length past resident K, at any number of sequences
    for b in (1, 8, 80, 1280):
        for n in range(tflash.RESIDENT_KEYS_D64 + 128, 4097, 128):
            assert tflash.onepass_f32_prerounded(b, n, n)
        for n in (256, 1024, tflash.RESIDENT_KEYS_D64):
            assert not tflash.onepass_f32_prerounded(b, n, n)


@pytest.mark.parametrize("b,nq,nk", [(128, 128, 2048), (512, 256, 2048),
                                     (1280, 64, 2048)])
def test_few_query_rows_over_many_keys_keep_the_route(recorded, b, nq, nk):
    """Where the chooser keeps the route (one or two blocks of query rows a
    sequence, many sequences' keys) the fused wrapper launches
    ``fused_attention_f32`` with a null pointer and allocates nothing."""
    calls, made = recorded
    q = torch.empty(b, nq, 64)
    k = torch.empty(b, nk, 64)
    with torch.no_grad():
        tflash.fused_attention(q, k, k, 0.125)
    ((entry, args),) = calls
    assert entry == "fused_attention_f32" and args[3] is None
    assert made == []
    assert tkernels.LAUNCHES_BY_ENTRY == {"fused_attention_f32": 1}


def test_prerounded_route_limits_tell_exp2_from_exp():
    """The new kernel's rows are held to the route's ``exp2`` form within
    ``FLOAT32_ROUTE_LIMITS[PREROUNDED_ENTRY]``: the keys permuted inside
    each 128-key tile (every fp32 sum over the keys in another order) pass;
    the ``exp`` route, the route's result rounded to bf16 and the bf16 plain
    version widened fail; the limits are tighter than the one-pass row's."""
    q, k, v = _inputs(2, 300, 1280, seed=6)
    want = tflash.attention_float32_route(q, k, v, 0.125, exp2=True)
    rng = np.random.default_rng(4)
    perm = torch.from_numpy(np.concatenate(
        [j + rng.permutation(128) for j in range(0, 1280, 128)]))
    back = tflash.attention_float32_route(q, k[:, perm], v[:, perm], 0.125,
                                          exp2=True)
    assert not torch.equal(back, want)
    tkernels.check_float32_route(ENTRY, back, want)
    for other in (tflash.attention_float32_route(q, k, v, 0.125),
                  want.bfloat16().float(),
                  tflash.onepass_attention_reference(
                      q.bfloat16(), k.bfloat16(), v.bfloat16(),
                      0.125).float()):
        with pytest.raises(AssertionError, match="float32 route"):
            tkernels.check_float32_route(ENTRY, other, want)
    tight = tkernels.FLOAT32_ROUTE_LIMITS[ENTRY]
    loose = tkernels.FLOAT32_ROUTE_LIMITS["onepass_attention"]
    assert all(a < b for a, b in zip(tight, loose))


def test_kv_scratch_size():
    """K and V of every sequence as bf16: at train-diffusion's [80, 2048,
    64], 41.9 MB, half the float32 K and V it is rounded from."""
    s = tflash.onepass_f32_kv_scratch(80, 2048, torch.device("meta"))
    assert s.dtype == torch.bfloat16 and s.device.type == "meta"
    assert s.numel() * s.element_size() == 2 * 80 * 2048 * 64 * 2 == 41943040


def test_prerounded_entry_point_and_its_plan():
    """``fused_attention_f32_prerounded`` refuses all but head dim 64 with a
    scratch; ``launch_prerounded`` refuses resident K and ragged key tiles,
    launches the pre-pass, then the wgmma tile's K ring alone
    (``launch_wgmma_ring``) on bf16 K and V at the scratch, with float32 q
    and output; the ring's producer copies bf16 tiles with cp.async (the
    kernel's float32 producer rounds K and V only with K resident)."""
    src = (_build.CSRC / "flash_attention_f32.cu").read_text()
    entry = src[src.index(f"int {ENTRY}("):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (D != mdt::kWgD || kv == nullptr) return cudaErrorInvalidValue;" \
        in entry
    assert "return mdt::launch_prerounded(" in entry
    launch = src[src.index("inline int launch_prerounded("):]
    launch = launch[:launch.index("\n}\n")]
    assert re.search(r"Nk <= kWgMaxKSlots \* kWgTile \|\| Nk % kWgTile\)",
                     launch)
    assert launch.index("round_kv_kernel<<<") < launch.index(
        "launch_wgmma_ring<false>(")
    assert "WgmmaArgsT<bf16, float>{" in launch
    assert "ks + B * kv_seq" in launch
    assert src.count("__global__") == 1
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    ring = tile[tile.index("cudaError_t launch_wgmma_ring("):]
    ring = ring[:ring.index("\n}\n")]
    assert "args.k_slots = kWgRingKSlots;" in ring
    assert "launch_wgmma_plan<ROT, 2>(" in ring
    assert "constexpr bool kCopyK = NC == 2 && !ROT;" in tile
