"""Graceful preemption handling for the train loops (port of
``moditalker_tpu/core/preempt.py``).

A signal sets a latch; the fit loops poll it each step, save a final
checkpoint and wait for pending checkpoint writes before returning, so a
resume continues from the preempted step.
"""

from __future__ import annotations

import signal
import threading


class GracefulStop:
    """A latch the train loops poll once per step.

    ``install()`` registers SIGTERM/SIGINT handlers that set the latch and
    restore the previous handlers, so a second signal behaves as before
    installation (a second Ctrl-C ends the process instead of waiting for
    the graceful save). Handlers can only be installed from the main thread;
    ``request()`` sets the latch from anywhere.
    """

    def __init__(self):
        self._event = threading.Event()
        self._prev: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        self._event.set()

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)):
        def handler(signum, frame):
            self._event.set()
            for s, prev in self._prev.items():
                signal.signal(s, prev)

        for s in signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, handler)
        return self
