"""Profiling and tracing hooks (port of ``moditalker_tpu/core/profiling.py``).

``step_timer`` times a block on the wall clock and logs ``<name>_seconds``
through the metric logger; on a CUDA device it synchronises the card at
both ends, so the time covers the device work the block issued, not only
its launches. ``trace`` records a ``torch.profiler`` trace of a block
(Chrome trace JSON, which Perfetto and TensorBoard's profile plugin open);
``annotate`` names a region in that trace, and on the card also as an NVTX
range.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def step_timer(logger=None, step: int = 0, name: str = "step", device=None):
    """Wall-clock seconds of the block, logged as ``<name>_seconds`` at
    ``step``; ``device``: a CUDA device is synchronised before and after."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log_scalars(step, {f"{name}_seconds": dt})


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """A ``torch.profiler`` trace of the block (CPU ops, and the card's
    kernels where CUDA is present) written to ``<logdir>/<name>.pt.trace.
    json``. Yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a ``record_function`` span in a ``trace``, and an
    NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
