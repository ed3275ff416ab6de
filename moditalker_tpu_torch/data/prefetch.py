"""Host-thread prefetch for sampling-time data (port of ``background_iter``
in ``moditalker_tpu/core/sharding.py``)."""

from __future__ import annotations

import queue
import threading


def background_iter(iterator, depth: int = 2):
    """Run a host-side iterator in a daemon thread with a bounded queue, so
    image decode and rasterization for window k+1 overlap the device's work
    on window k (what the reference gets from DataLoader workers).
    Exceptions re-raise in the consumer. If the consumer abandons the
    generator early, its close/GC sets a latch the producer polls, so the
    thread exits instead of blocking on a full queue forever."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # propagate into the consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        closed.set()  # runs on exhaustion, close() and GC alike
