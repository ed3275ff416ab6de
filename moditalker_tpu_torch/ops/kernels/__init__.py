"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
calls ``count_launch`` where it launches its kernel and nowhere else, so a
run can show that the main path went through the kernels;
``LAUNCHES_BY_SHAPE`` splits each count by the shape the kernel was given,
``FLOAT32_LAUNCHES_BY_SHAPE`` counts the launches on float32 operands
alone, and ``LAUNCHES_BY_ENTRY`` by the library entry point launched (with
"+ V scratch" where a float32 entry point was given the scratch that runs
the float32 resident-K kernel). ``SOURCES`` names the CUDA source of each
kernel's bf16 entry points (``csrc/<source>.cu``) and ``FLOAT32_SOURCES``
the source of its float32
ones (a library of its own), both for the shapes the configurations reach;
``CLASS_SOURCES`` and ``CLASS_FLOAT32_SOURCES`` name the sources of the
same kernels built per head-dim and row class for every other shape their
gates admit (libraries of their own), ``WIDE_SOURCES`` and
``WIDE_FLOAT32_SOURCES`` those of the one-pass and fused kernels built per
head width above 32, and ``NARROW_SOURCES`` that of their bf16 tile at
head dims 40, 48 and 56; ``BF16_LIMITS`` and ``QUANTILE_LIMITS`` bound
each kernel's error against its plain version, ``FLOAT32_ROUTE_LIMITS`` a
kernel's float32 result against the function its float32 route computes,
and ``bf16_rounded_share`` tells a float32 result from a bf16 one widened. The
backward kernels' rows hold their dqkv to the same three tables, against
the plain backward and their float32 route's function.

``on_card`` and ``cuda_stream`` are the two questions every wrapper asks
the tensor it is given: whether to launch (a CUDA tensor) or run the plain
version (a CPU tensor), and on which stream to launch.
"""

from __future__ import annotations

import threading
from collections import Counter

LAUNCHES: dict[str, int] = {
    "divided_space_attention": 0,
    "divided_time_attention": 0,
    "packed_attention": 0,
    "onepass_attention": 0,
    "tiny_attention": 0,
    "fused_attention": 0,
    "divided_space_attention_backward": 0,
    "divided_time_attention_backward": 0,
}

LAUNCHES_BY_SHAPE: dict[str, Counter] = {name: Counter() for name in LAUNCHES}
FLOAT32_LAUNCHES_BY_SHAPE: dict[str, Counter] = {
    name: Counter() for name in LAUNCHES}
LAUNCHES_BY_ENTRY: Counter = Counter()

SOURCES = {
    "divided_space_attention": "divided_attention",
    "divided_time_attention": "divided_attention",
    "packed_attention": "packed_attention",
    "onepass_attention": "flash_attention",
    "tiny_attention": "tiny_attention",
    "fused_attention": "flash_attention",
    "divided_space_attention_backward": "divided_backward",
    "divided_time_attention_backward": "divided_backward",
}

# every kernel's float32 route: the same tiles instantiated for float32 in
# translation units of their own, so that the bf16 instantiations compile as
# they do alone (built beside them, a float32 instantiation changed the
# compiler's choices for the bf16 space kernel)
FLOAT32_SOURCES = {
    "divided_space_attention": "divided_attention_f32",
    "divided_time_attention": "divided_attention_f32",
    "packed_attention": "packed_attention_f32",
    "onepass_attention": "flash_attention_f32",
    "tiny_attention": "tiny_attention_f32",
    "fused_attention": "flash_attention_f32",
    "divided_space_attention_backward": "divided_backward_f32",
    "divided_time_attention_backward": "divided_backward_f32",
}

# the classes beyond the configurations' shapes: the same kernels
# instantiated per head-dim class (and, for time and tiny-L, row class),
# padded where a shape is not its class, bf16 and float32, in sources of
# their own so that the configurations' libraries hold only their
# instantiations (the packed kernel's gate admits dh = 16 only: no class)
CLASS_SOURCES = {
    "divided_space_attention": "divided_classes",
    "divided_time_attention": "divided_classes",
    "onepass_attention": "flash_classes",
    "tiny_attention": "flash_classes",
    "fused_attention": "flash_classes",
    "divided_space_attention_backward": "divided_backward_classes",
    "divided_time_attention_backward": "divided_backward_classes",
}
CLASS_FLOAT32_SOURCES = {name: source + "_f32"
                         for name, source in CLASS_SOURCES.items()}
# the one-pass and fused kernels at the head dims above 32 but 64: the
# wgmma tile built per width, and in groups of 256 output columns past 256
WIDE_SOURCES = {
    "onepass_attention": "flash_wide",
    "fused_attention": "flash_wide",
}
WIDE_FLOAT32_SOURCES = {name: source + "_f32"
                        for name, source in WIDE_SOURCES.items()}
# the one-pass and fused kernels in bf16 at head dims 40, 48 and 56: the
# D = 64 tile's plan at the head's own width (float32 there is the wide
# tile's)
NARROW_SOURCES = {
    "onepass_attention": "flash_narrow",
    "fused_attention": "flash_narrow",
}


def all_sources() -> list[str]:
    """Every kernel source under csrc/, each built into a library of its
    own (what a build of all the kernels compiles)."""
    return sorted({*SOURCES.values(), *FLOAT32_SOURCES.values(),
                   *CLASS_SOURCES.values(), *CLASS_FLOAT32_SOURCES.values(),
                   *WIDE_SOURCES.values(), *WIDE_FLOAT32_SOURCES.values(),
                   *NARROW_SOURCES.values()})


# Limits of a kernel's bf16 output against its plain version on the same
# bf16 inputs, relative to the plain output: (max |err| / max |plain|,
# rms err / rms plain). Both round q·scale, k and the probabilities to bf16,
# but at different places (the plain version also rounds the scores), so
# they differ by a few bf16 roundings; a kernel that reads a wrong head, row
# or rotary entry differs by the output's own size (ratios near 1). Each
# limit is about twice what chip_smoke.py reads at the main path's shapes
# (H100, randn inputs).
BF16_LIMITS: dict[str, tuple[float, float]] = {
    "divided_space_attention": (2.5e-2, 1.4e-2),
    "divided_time_attention": (1.7e-2, 1e-2),
    "packed_attention": (1.6e-2, 1.1e-2),
    "onepass_attention": (2.3e-2, 1.1e-2),
    "tiny_attention": (1e-2, 7.5e-3),
    "fused_attention": (2.3e-2, 1.1e-2),
    # dqkv against the float32 plain backward: the kernels also round g, P
    # and dS to bf16 as product operands (float32 and bf16 inputs alike).
    # Largest readings of --seed 0..3 (the kernels rows and the gradient
    # phase at [1, 16, 1024, 1536]): space 8.423e-3 / 4.024e-3, time
    # 7.187e-3 / 3.761e-3
    "divided_space_attention_backward": (1.7e-2, 8e-3),
    "divided_time_attention_backward": (1.5e-2, 7.5e-3),
}

# A third measure that one element cannot decide: the QUANTILE-th quantile
# of |out - plain| over max |plain|. The first measure above is set by the
# single largest error, which on some inputs sits near its limit for a right
# kernel (packed reads up to 1.515e-2 of its 1.6e-2); this one moves only
# when a thousandth of the output moves, and a wrong head, row or rotary
# entry moves far more than that (ratios near 0.5). All three measures are
# gates. Each limit here is about twice the largest reading of
# chip_smoke.py --kernels-only --seed 0..3 over the kernel's rows, bf16 and
# float32 (H100): space 5.10e-3, time 2.63e-3, packed 4.31e-3, one-pass
# 4.12e-3, tiny-L 2.55e-3, fused 6.71e-3.
QUANTILE = 0.999
QUANTILE_LIMITS: dict[str, float] = {
    "divided_space_attention": 1e-2,
    "divided_time_attention": 5.5e-3,
    "packed_attention": 9e-3,
    "onepass_attention": 8.5e-3,
    "tiny_attention": 5.5e-3,
    "fused_attention": 1.4e-2,
    # the backwards read up to 1.487e-3 at [1, 16, 1024, 1536] but 1.8e-3 to
    # 2.5e-3 at the card tests' small shapes, where fewer elements make the
    # quantile near the max: twice those
    "divided_space_attention_backward": 5e-3,
    "divided_time_attention_backward": 5e-3,
}


def relative_errors(out, plain) -> tuple[float, float, float]:
    """(max |out - plain| / max |plain|, rms(out - plain) / rms(plain),
    QUANTILE-th quantile of |out - plain| / max |plain|)."""
    out, plain = out.float(), plain.float()
    err = (out - plain).abs().flatten()
    peak = plain.abs().max()
    rel_max = err.max() / peak
    rel_rms = err.square().mean().sqrt() / plain.square().mean().sqrt()
    k = max(1, min(err.numel(), round(QUANTILE * err.numel())))
    rel_q = err.kthvalue(k).values / peak
    return rel_max.item(), rel_rms.item(), rel_q.item()


def check_bf16(name: str, out, plain) -> tuple[float, float, float]:
    """``relative_errors(out, plain)``; raises AssertionError where one is
    past its limit (``BF16_LIMITS[name]``, ``QUANTILE_LIMITS[name]``)."""
    rel_max, rel_rms, rel_q = relative_errors(out, plain)
    lim_max, lim_rms = BF16_LIMITS[name]
    lim_q = QUANTILE_LIMITS[name]
    if not (rel_max <= lim_max and rel_rms <= lim_rms and rel_q <= lim_q):
        raise AssertionError(
            f"{name}: max err / max |plain| {rel_max:.3e} (limit {lim_max}), "
            f"rms err / rms plain {rel_rms:.3e} (limit {lim_rms}), "
            f"{QUANTILE} quantile of err / max |plain| {rel_q:.3e} "
            f"(limit {lim_q})")
    return rel_max, rel_rms, rel_q


# Limits of a kernel's float32 result against the function its float32
# route computes on the same float32 inputs
# (``divided_attention.divided_attention_float32_route``,
# ``packed_attention.packed_attention_float32_route``,
# ``flash_attention.attention_float32_route``), in the three measures of
# ``relative_errors``: (max, rms, quantile). The two round q, k, v and p at
# the same points (p against the running max of each 128-key tile, as the
# kernels' online softmax does) and sum the scores alike (the route as the
# tensor cores do, ``flash_attention.mma_products``); they differ by the
# order of the other fp32 sums and the kernels' ex2, which now and then
# moves a p across a bf16 rounding boundary and its output row with it:
# rare rows, so the max measure reads far above the other two.
# A result rounded to bf16 on its way out reads 1.1e-3 to 2.3e-3 on the rms
# and quantile measures on the CPU tests' inputs and fails them many times
# over. Each
# limit is about twice the largest reading of chip_smoke.py --kernels-only
# --seed 0..3 over the kernel's float32 rows (H100): space 8.473e-4 /
# 4.860e-5 / 5.427e-5, time 1.531e-3 / 3.620e-5 / 1.287e-5, packed 3.763e-4 /
# 3.096e-5 / 4.062e-5, one-pass and fused 9.782e-4 / 3.372e-5 / 7.665e-5,
# tiny-L 1.157e-3 / 1.918e-5 / 1.186e-7 (at L = 16 the kernel's softmax is
# the route's full-row one: all but a few elements agree to fp32 rounding).
FLOAT32_ROUTE_LIMITS: dict[str, tuple[float, float, float]] = {
    "divided_space_attention": (1.7e-3, 1e-4, 1.1e-4),
    "divided_time_attention": (3.1e-3, 7.5e-5, 2.6e-5),
    "packed_attention": (7.5e-4, 6.2e-5, 8.1e-5),
    "onepass_attention": (2e-3, 6.8e-5, 1.55e-4),
    # the one-pass row: the fused kernel is the one-pass kernel at Nq != Nk
    "fused_attention": (2e-3, 6.8e-5, 1.55e-4),
    # the one-pass and fused kernels in float32 at head dim 64 past resident
    # K (the entry point fused_attention_f32_prerounded), held to the
    # route's exp2 form (``attention_float32_route(..., exp2=True)``): about
    # twice the largest of tools/mma_sum.py --prerounded over seeds 0..3 at
    # the card tests' and chip_smoke.py's shapes, 9.80e-5 / 3.11e-6 /
    # 1.37e-6 (against the exp route the same kernel reads up to 4.78e-4 /
    # 2.48e-5 / 7.92e-5)
    "fused_attention_f32_prerounded": (2e-4, 6.5e-6, 2.8e-6),
    "tiny_attention": (2.3e-3, 3.9e-5, 2.4e-7),
    # divided_backward.divided_attention_backward_float32_route: P and dS
    # against their bf16 rounding boundaries as above; readings (the
    # kernels rows and the gradient phase, --seed 0..3): space 9.400e-4 /
    # 5.803e-5 / 3.779e-5 (6.3e-5 / 5.6e-5 on the rms and quantile at
    # [1, 2, 256, 1536]), time 2.725e-3 / 5.131e-5 / 3.776e-6
    "divided_space_attention_backward": (2e-3, 1.3e-4, 1.2e-4),
    "divided_time_attention_backward": (5.5e-3, 1.1e-4, 1e-5),
}


def check_float32_route(name: str, out, oracle) -> tuple[float, float, float]:
    """``relative_errors(out, oracle)`` for a kernel's float32 result;
    raises AssertionError where one is past ``FLOAT32_ROUTE_LIMITS[name]``."""
    errs = relative_errors(out, oracle)
    limits = FLOAT32_ROUTE_LIMITS[name]
    if not all(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError(
            f"{name} float32 route: (max, rms, {QUANTILE} quantile) "
            f"{tuple(f'{e:.3e}' for e in errs)}, limits {limits}")
    return errs


def bf16_rounded_share(t) -> float:
    """The share of ``t``'s elements that equal their own bf16 rounding:
    1.0 for a bf16 result widened to float32, about 2^-16 (and the share of
    exact zeros) for a result computed and stored in float32."""
    import torch

    t = t.detach().float()
    return (t == t.to(torch.bfloat16).float()).float().mean().item()


def on_card(t) -> bool:
    """Whether a wrapper launches its kernel for ``t`` (a CUDA tensor) or
    runs its plain version (a tensor on the CPU)."""
    return t.is_cuda


def cuda_stream(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, where a
    wrapper launches."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


_COUNT_LOCK = threading.Lock()


def count_launch(name: str, shape, float32: bool = False,
                 entry: str | None = None) -> None:
    """One launch of kernel ``name`` on an operand of ``shape``, float32 or
    not, through the library entry point ``entry`` (``name`` where not
    given), from any thread: data-parallel inference drives each card from
    its own."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAUNCHES_BY_SHAPE[name][tuple(shape)] += 1
        if float32:
            FLOAT32_LAUNCHES_BY_SHAPE[name][tuple(shape)] += 1
        LAUNCHES_BY_ENTRY[entry or name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCHES_BY_SHAPE[name].clear()
        FLOAT32_LAUNCHES_BY_SHAPE[name].clear()
    LAUNCHES_BY_ENTRY.clear()
