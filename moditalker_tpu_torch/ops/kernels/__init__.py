"""Hand-written Hopper kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
calls ``count_launch`` where it launches its kernel and nowhere else, so a
run can show that the main path went through the kernels;
``LAUNCHES_BY_SHAPE`` splits each count by the shape the kernel was given.
``SOURCES`` names the CUDA
source of each kernel (``csrc/<source>.cu``); ``BF16_LIMITS`` bounds each
kernel's error against its plain version.
"""

from __future__ import annotations

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


def relative_errors(out, plain) -> tuple[float, float]:
    """(max |out - plain| / max |plain|, rms(out - plain) / rms(plain))."""
    out, plain = out.float(), plain.float()
    err = out - plain
    rel_max = err.abs().max() / plain.abs().max()
    rel_rms = err.square().mean().sqrt() / plain.square().mean().sqrt()
    return rel_max.item(), rel_rms.item()


def check_bf16(name: str, out, plain) -> tuple[float, float]:
    """``relative_errors(out, plain)``; raises AssertionError where one is
    past ``BF16_LIMITS[name]``."""
    (rel_max, rel_rms), (lim_max, lim_rms) = (relative_errors(out, plain),
                                              BF16_LIMITS[name])
    if not (rel_max <= lim_max and rel_rms <= lim_rms):
        raise AssertionError(
            f"{name}: max err / max |plain| {rel_max:.3e} (limit {lim_max}), "
            f"rms err / rms plain {rel_rms:.3e} (limit {lim_rms})")
    return rel_max, rel_rms


def count_launch(name: str, shape) -> None:
    """One launch of kernel ``name`` on an operand of ``shape``."""
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[name][tuple(shape)] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCHES_BY_SHAPE[name].clear()
