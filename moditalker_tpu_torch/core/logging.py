"""Metric logging: an append-only ``log.txt``, ``metrics.jsonl`` and, where
``torch.utils.tensorboard`` imports, TensorBoard scalars (port of
``MetricLogger`` of ``moditalker_tpu/core/logging.py``, ref
MToV/utils.py:18-78).
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = os.path.abspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        self._text = open(os.path.join(self.logdir, "log.txt"), "a")
        self._jsonl = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:   # no tensorboard package on this host
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(self.logdir)

    def log_text(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        self._text.write(f"[{stamp}] {msg}\n")
        self._text.flush()

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._text.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
