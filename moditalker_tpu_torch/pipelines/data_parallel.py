"""Data-parallel inference over the cards of one host (the port of the JAX
pipelines' ``mesh`` argument and the CLI's ``--data-parallel``).

The JAX package shards the window batch over a ``data`` mesh: the batch is
padded by repeating its last row to a multiple of the mesh size, one SPMD
program runs, the output is trimmed (``pipelines/mtov_sample.py:172-200``).
Here each card holds a replica of the models and the padded batch is split
into one equal chunk per card. Each card is driven from a host thread of its
own: the UNet step is launch-bound (the host issues thousands of small
kernels per step), so one thread driving N cards in turn would serialise
their launches and scale nothing, while torch releases the GIL in every
kernel launch and copy.

The noise is drawn for the padded batch, as the JAX window program draws
it: the k-th draw of every replica is one draw of the padded batch's shape
from the caller's generator, of which each replica takes its rows
(``SharedDraws``). A run at N cards therefore draws what a run at one card
draws for the same padded batch.
"""

from __future__ import annotations

import concurrent.futures
import threading

import numpy as np
import torch


def inference_devices(device=None,
                      data_parallel: int | None = None) -> list[torch.device]:
    """The devices of an inference pipeline. ``data_parallel``: how many
    (default: every visible card on CUDA, one on the CPU — the JAX CLI's
    ``_inference_mesh`` — and one where ``device`` names a card); on the CPU
    N replicas share the host."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (data_parallel or 1)
    if data_parallel is None and dev.index is not None:
        return [dev]
    n = torch.cuda.device_count() if data_parallel is None else data_parallel
    if n > torch.cuda.device_count():
        raise ValueError(f"--data-parallel {n}: only "
                         f"{torch.cuda.device_count()} cards are visible")
    if n <= 1:
        return [dev]
    return [torch.device("cuda", i) for i in range(n)]


def round_up(batch: int, n: int) -> int:
    """``batch`` rounded up to a multiple of ``n`` (a chunk that divides
    over the cards)."""
    return -(-batch // n) * n


def pad_rows(x, n: int):
    """``x`` (array or tensor) with its last row repeated up to a multiple
    of ``n`` rows."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


class SharedDraws:
    """Hands each of ``n`` replicas its rows of one draw of the padded
    batch: replica r's k-th call ``draw(r)(shape, dtype)`` returns rows
    [r·b, (r+1)·b) of the k-th draw of shape [n·b, ...] from
    ``generator`` (a ``torch.Generator`` or a callable ``(shape, dtype)``,
    as the samplers take), made once, by whichever replica asks first."""

    def __init__(self, generator, n: int):
        self.generator, self.n = generator, n
        self._draws: list[torch.Tensor] = []
        self._lock = threading.Lock()

    def _global(self, k: int, shape, dtype) -> torch.Tensor:
        with self._lock:
            while len(self._draws) <= k:
                full = (shape[0] * self.n, *shape[1:])
                g = self.generator
                if callable(g):
                    d = torch.as_tensor(g(full, dtype))
                else:
                    d = torch.randn(full, generator=g, device=g.device,
                                    dtype=torch.float32).to(dtype)
                self._draws.append(d)
            return self._draws[k]

    def draw(self, r: int):
        count = [0]

        def fn(shape, dtype):
            k, count[0] = count[0], count[0] + 1
            b = shape[0]
            return self._global(k, shape, dtype)[r * b:(r + 1) * b]

        return fn


class ReplicaRunner:
    """One host thread per replica device; ``run(fn)`` calls ``fn(r)`` for
    every replica r, each in its thread with its card current, and returns
    the results in order."""

    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self._pool = (concurrent.futures.ThreadPoolExecutor(len(devices))
                      if len(devices) > 1 else None)

    def run(self, fn):
        def call(r):
            dev = self.devices[r]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fn(r)
            return fn(r)

        futures = [self._pool.submit(call, r)
                   for r in range(len(self.devices))]
        return [f.result() for f in futures]

    def split_run(self, fn, videos, generator, n_real: int):
        """``fn(r, chunk_videos, draws)`` on each replica's equal chunk of
        the padded ``videos`` (None entries pass through), with its rows of
        the shared draws; the outputs concatenated on the first device and
        trimmed to ``n_real`` rows."""
        n = len(self.devices)
        padded = [None if v is None else pad_rows(v, n) for v in videos]
        b = next(v for v in padded if v is not None).shape[0] // n
        shared = SharedDraws(generator, n)

        def one(r):
            chunk = [None if v is None else v[r * b:(r + 1) * b]
                     for v in padded]
            return fn(r, chunk, shared.draw(r))

        outs = self.run(one)
        first = self.devices[0]
        return torch.cat([o.to(first) for o in outs])[:n_real]
