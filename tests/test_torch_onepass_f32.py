"""The float32 one-pass kernel at head dim 64 with K resident
(``csrc/resident_f32_tile.cuh``'s kernel instantiated without the rotary)
on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); the function it computes at these shapes, the wgmma
tile's float32 route, is held against the JAX package's ``_onepass`` in
interpret mode by ``tests/test_torch_float32_route.py``. Here: the wrapper
driven with stub libraries (float32 q, k, v [B, 1024, 64] from
``ONEPASS_F32_MIN_SEQS`` sequences launch ``fused_attention_f32`` once with
the V scratch the wrapper allocates, fewer with a null pointer, the wgmma
tile's float32 route, and every other shape on that route, but those past
resident K that ``tests/test_torch_prerounded_f32.py`` holds), the chooser
against the paired readings that set its table, and the plan and the
entry point's dispatch as the sources state them.
"""

import re

import pytest
import torch

from moditalker_tpu_torch.ops import attention as tattn
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import _build
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash

from . import torch_stubs
from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADER = _build.CSRC / "resident_f32_tile.cuh"
SCRATCH = "fused_attention_f32 + V scratch"


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.fixture
def recorded(stub_launches, monkeypatch):
    """Each float32 entry point's call (name, arguments) and each V scratch
    the wrapper allocated."""
    calls, made = [], []
    monkeypatch.setattr(tflash, "_lib_f32",
                        lambda: torch_stubs.StubLib(stub_launches, calls))
    allocate = tflash.onepass_f32_scratch

    def scratch(*args):
        made.append(allocate(*args))
        return made[-1]

    monkeypatch.setattr(tflash, "onepass_f32_scratch", scratch)
    return calls, made


def _qkv(b, n, d=64, dtype=torch.float32):
    # never read: the stub libraries launch nothing
    return [torch.empty(b, n, d, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("b", [1280, 192])
def test_float32_onepass_launches_its_kernel_with_the_v_scratch(recorded, b):
    """Float32 q, k, v [B, 1024, 64] at a B the chooser takes (the modular
    train-diffusion's 1280 sequences and the table's least) launch
    ``fused_attention_f32`` once; the pointer after q,
    k and v is the V scratch the wrapper allocated: bf16 [B, 1024, 64] on
    the operands' device; the launch counts under its entry point with the
    scratch."""
    calls, made = recorded
    assert tflash.onepass_f32_own_kernel(b, 1024, 1024)
    q, k, v = _qkv(b, 1024)
    out = tflash.onepass_attention(q, k, v, 0.125)
    assert out.dtype == torch.float32 and out.shape == (b, 1024, 64)
    ((name, args),) = calls
    (scratch,) = made
    assert name == "fused_attention_f32"
    assert scratch.dtype == torch.bfloat16 and scratch.device == q.device
    assert tuple(scratch.shape) == (b, 1024, 64)
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        scratch.data_ptr(), out.data_ptr())
    assert args[5:10] == (b, 1024, 1024, 64, 0.125)
    assert tkernels.FLOAT32_LAUNCHES_BY_SHAPE["onepass_attention"] == {
        (b, 1024, 64): 1}
    assert tkernels.LAUNCHES_BY_ENTRY == {SCRATCH: 1}


@pytest.mark.parametrize("b", [191, 128, 72, 64, 8, 1])
def test_float32_onepass_below_the_threshold_takes_the_route(recorded, b):
    """Below the table's least number of sequences (train-first-stage's 128
    among them) the float32 entry point gets a null pointer where the
    scratch goes (the wgmma tile's float32 route) and nothing is
    allocated."""
    calls, made = recorded
    assert not tflash.onepass_f32_own_kernel(b, 1024, 1024)
    tflash.onepass_attention(*_qkv(b, 1024), 0.125)
    ((name, args),) = calls
    assert name == "fused_attention_f32" and args[3] is None
    assert made == []
    assert tkernels.LAUNCHES_BY_ENTRY == {"fused_attention_f32": 1}


def test_fused_at_equal_lengths_takes_the_kernel(recorded):
    """The fused wrapper reaches the same entry point: at Nq = Nk = 1024 from
    the table's sequences it passes the scratch, as the one-pass wrapper
    does."""
    calls, made = recorded
    with torch.no_grad():
        out = tflash.fused_attention(*_qkv(256, 1024))
    (scratch,) = made
    assert calls[0][1][3] == scratch.data_ptr()
    assert calls[0][1][4] == out.data_ptr()
    assert tkernels.LAUNCHES["fused_attention"] == 1
    assert tkernels.LAUNCHES_BY_ENTRY == {SCRATCH: 1}


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((2, 64, 64), (2, 512, 64)),        # the fused cross-length shape
    ((128, 128, 64), (128, 2048, 64)),  # past resident K: the route's ring
    ((128, 1152, 64), (128, 1152, 64)),     # a length the table lacks
    ((128, 1000, 64), (128, 1024, 64)),     # ragged query rows
    ((128, 1024, 32), (128, 1024, 32)),     # the small-head tile
    ((128, 1024, 128), (128, 1024, 128)),   # the wide tile's library
])
def test_other_float32_shapes_stay_on_their_route(stub_launches, recorded,
                                                  q_shape, kv_shape):
    """Every other float32 shape keeps the kernel it ran before, with no
    scratch: the cross-length and ragged fused shapes, the K ring past 1152
    keys where ``onepass_f32_prerounded`` keeps the route (one block of
    query rows a sequence over many keys) and lengths the table does not
    list at head dim 64 on the wgmma tile's float32 route, head dim 32 on
    the small-head tile (a null pointer: the same entry point), head dim
    128 on the wide tile (another library's entry point, which takes
    none)."""
    calls, made = recorded
    q, k, v = (torch.empty(q_shape), torch.empty(kv_shape),
               torch.empty(kv_shape))
    with torch.no_grad():
        tflash.fused_attention(q, k, v)
    assert made == []
    if q_shape[-1] in tflash.HEAD_DIMS:
        ((name, args),) = calls
        assert name == "fused_attention_f32" and args[3] is None
    else:
        assert calls == [] and len(stub_launches) == 1
        assert stub_launches[0] != "fused_attention_f32"
    assert SCRATCH not in tkernels.LAUNCHES_BY_ENTRY


def test_bf16_onepass_takes_no_scratch(stub_launches, recorded):
    """bf16 q, k, v at the kernel's shape launch the bf16 entry point, which
    takes no scratch, and allocate none."""
    calls, made = recorded
    tflash.onepass_attention(*_qkv(1280, 1024, dtype=torch.bfloat16), 0.125)
    assert stub_launches == ["fused_attention"] and made == [] and not calls
    assert tkernels.LAUNCHES_BY_ENTRY == {"fused_attention": 1}


@pytest.mark.parametrize("b", [2, 1])
def test_modular_space_attention_reaches_the_kernel(recorded, b):
    """With the fused divided kernels switched off the AE's float32 space
    attention is ``sdpa`` over [B·F·H, 1024, 64]: at B = 2 (256 sequences)
    it launches the float32 entry point with the V scratch, at
    train-first-stage's B = 1 (128) with a null pointer, the route."""
    calls, made = recorded
    q = torch.zeros(b, 16, 8, 1024, 64)
    out = tattn.sdpa(q, q, q, scale=0.125)
    assert out.dtype == torch.float32 and out.shape == q.shape
    if b == 2:
        (scratch,) = made
        assert tuple(scratch.shape) == (256, 1024, 64)
        assert calls[0][1][3] == scratch.data_ptr()
    else:
        assert made == [] and calls[0][1][3] is None


# sequences at N = 1024 read by tools/ab_space_f32.py --onepass --gate on an
# H100 (PERF.md): those where the kernel read faster than the wgmma tile's
# float32 route, and those where it did not
# (in two calls; 72 to 128 read faster in one and slower in the other)
READ_FASTER = {1024: (192, 256, 384, 512, 1280)}
READ_SLOWER = {1024: (64, 72, 96, 128)}


def test_onepass_f32_own_kernel_where_it_read_faster():
    """The chooser takes the kernel at every measured (length, sequences)
    where it read faster than the route and the route at every one where it
    did not; each length's threshold lies between the two; the table holds
    only lengths the kernel takes (whole 128-row rounds, K resident), and
    Nq != Nk never takes it."""
    assert set(tflash.ONEPASS_F32_MIN_SEQS) == set(READ_FASTER)
    for n, least in tflash.ONEPASS_F32_MIN_SEQS.items():
        assert n % 128 == 0 and n <= tflash.RESIDENT_KEYS_D64
        assert max(READ_SLOWER[n]) < least <= min(READ_FASTER[n])
        for b in READ_FASTER[n]:
            assert tflash.onepass_f32_own_kernel(b, n, n), (n, b)
            assert not tflash.onepass_f32_own_kernel(b, n, n - 128)
        for b in READ_SLOWER[n]:
            assert not tflash.onepass_f32_own_kernel(b, n, n), (n, b)
    for n in (256, 512, 896, 1152, 2048):
        assert not tflash.onepass_f32_own_kernel(1280, n, n)


def test_onepass_f32_scratch_size():
    """One bf16 [N, 64] slot per sequence: at the modular train-diffusion's
    [1280, 1024, 64], 168 MB, as large as the bf16 V it holds."""
    s = tflash.onepass_f32_scratch(1280, 1024, torch.device("meta"))
    assert s.dtype == torch.bfloat16 and s.device.type == "meta"
    assert s.numel() * s.element_size() == 1280 * 1024 * 64 * 2


def test_one_kernel_two_instantiations_and_a_plan_that_fits():
    """The header holds one kernel body, instantiated for both callers
    through one launcher: the space attention with the rotary and the
    one-pass attention without it, whose plan rounds V in the first round
    with the registers of the block split to suit. Its plan fits a Hopper
    block's shared memory at 9 key tiles for both (1152 keys,
    ``RESIDENT_KEYS_D64``): resident K beside the V ring, two swizzled Q
    tiles and the ring's barriers."""
    text = HEADER.read_text()
    tile = (_build.CSRC / "wgmma_tile.cuh").read_text()
    assert text.count("__global__") == 1
    assert "template <typename Args, int CL = 1>\n__global__" in text
    assert "struct SpaceF32Args {\n  static constexpr bool kRot = true," in text
    # the one-pass plan: V rounded by the producer in the first round, at
    # 104 registers, the consumers at 200: the registers of 384 threads
    # (168 each at launch)
    onepass = text[text.index("struct OnepassF32Args {"):]
    onepass = onepass[:onepass.index("};")]
    producer, consumer = map(int, re.search(
        r"static constexpr bool kRot = false, kVFirst = true;\n  static "
        r"constexpr int kProducerRegs = (\d+), kConsumerRegs = (\d+);",
        onepass).groups())
    consumers = _constant(text, "kRfConsumers")
    assert producer + consumers * consumer == (consumers + 1) * 168
    # each caller's launcher in its entry point's source, so that each
    # library holds its own instantiation alone
    for source, launcher, grid in (
            ("divided_attention_f32.cu", "launch_space_f32", "H, BF, stream"),
            ("flash_attention_f32.cu", "launch_onepass_f32", "1, B, stream")):
        body = (_build.CSRC / source).read_text()
        body = body[body.index(f"inline int {launcher}("):]
        body = body[:body.index("\n}\n")]
        assert "return launch_resident_f32" in body and grid in body
        assert f"{launcher}(" not in text
    # one launcher: a block per (sequence, head) launched as it was, the
    # space caller's cluster plan through cudaLaunchKernelEx
    assert text.count("auto kern = resident_f32_kernel<Args, CL>;") == 1
    assert text.count("kern<<<") == 1
    assert text.count("cudaLaunchKernelEx(&config, kern, a)") == 1
    slots = _constant(tile, "kWgMaxKSlots")
    assert tflash.RESIDENT_KEYS_D64 == 128 * slots
    assert "nkt > kWgMaxKSlots" in text
    tile_bytes = 128 * 64 * 2
    stages = _constant(tile, "kWgVStages")
    smem = (1024 + (slots + stages) * tile_bytes
            + _constant(text, "kRfConsumers") * _constant(tile, "kWgRows")
            * 64 * 2 + 8 * 2 * stages)
    assert smem <= _constant(tile, "kWgSmemLimit")


def test_fused_attention_f32_dispatches_on_the_scratch():
    """The float32 entry point chooses nothing: with the wrapper's scratch
    the resident-K kernel (head dim 64 and Nq = Nk, else refused), without
    one the tiles it ran before, the wgmma tile's route at 64."""
    entry = (_build.CSRC / "flash_attention_f32.cu").read_text()
    assert '#include "resident_f32_tile.cuh"' in entry
    entry = entry[entry.index("int fused_attention_f32("):]
    entry = entry[:entry.index("\n}\n")]
    assert re.search(r"void\* vs, void\* out, int B, int Nq, int Nk, int D,",
                     entry)
    scratch = entry[entry.index("  if (vs != nullptr) {"):]
    scratch = scratch[:scratch.index("\n  }\n")]
    assert "if (D != mdt::kWgD || Nq != Nk) return cudaErrorInvalidValue;" \
        in scratch
    assert "return mdt::launch_onepass_f32(q, k, v, vs, out, B, Nq, scale" \
        in scratch
    assert "launch_wgmma<false, float, float>" in entry
    assert "kRf" not in entry
