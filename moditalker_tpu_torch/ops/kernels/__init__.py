"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
calls ``count_launch`` where it launches its kernel and nowhere else, so a
run can show that the main path went through the kernels;
``LAUNCHES_BY_SHAPE`` splits each count by the shape the kernel was given.
``SOURCES`` names the CUDA
source of each kernel (``csrc/<source>.cu``) and ``HELPER_SOURCES`` the
sources the kernels' wrappers launch beside them (the float32 casts);
``BF16_LIMITS`` and ``QUANTILE_LIMITS`` bound each kernel's error against
its plain version.

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
}

LAUNCHES_BY_SHAPE: dict[str, Counter] = {name: Counter() for name in LAUNCHES}

SOURCES = {
    "divided_space_attention": "divided_attention",
    "divided_time_attention": "divided_attention",
    "packed_attention": "packed_attention",
    "onepass_attention": "flash_attention",
    "tiny_attention": "tiny_attention",
    "fused_attention": "flash_attention",
}

# launched by the wrappers' float32 paths (``convert.py``), not a kernel of
# its own: its launches and time count in the row of the kernel it serves
HELPER_SOURCES = ("convert",)


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


def count_launch(name: str, shape) -> None:
    """One launch of kernel ``name`` on an operand of ``shape`` (from any
    thread: data-parallel inference drives each card from its own)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAUNCHES_BY_SHAPE[name][tuple(shape)] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCHES_BY_SHAPE[name].clear()
