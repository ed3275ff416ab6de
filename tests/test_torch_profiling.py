"""The port's profiling hooks (``core/profiling.py``) and the kernel build
cache's key (``ops/kernels/_build.py``), on the CPU.

* ``step_timer`` logs ``<name>_seconds`` through the metric logger;
* ``trace`` writes a Chrome trace holding the ``annotate`` spans;
* the build target of a kernel changes when the toolkit's ``nvcc
  --version`` or the torch version changes (the JAX package's compile
  cache keys its directory by a host fingerprint for the same reason), and
  stays when neither does.
"""

import json
import os
import time

import torch

from moditalker_tpu_torch.core import profiling
from moditalker_tpu_torch.ops.kernels import _build

from .torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _Logger:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, scalars):
        self.rows.append((step, scalars))


def test_step_timer_logs_seconds():
    log = _Logger()
    with profiling.step_timer(log, step=7, name="unet", device="cpu"):
        time.sleep(0.01)
    (step, scalars), = log.rows
    assert step == 7 and set(scalars) == {"unet_seconds"}
    assert 0.01 <= scalars["unet_seconds"] < 5
    with profiling.step_timer(None):   # no logger: times and logs nothing
        pass


def test_trace_writes_a_trace_with_the_annotations(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), name="step") as prof:
        with profiling.annotate("unet_step"):
            (x @ x).sum()
    path = tmp_path / "step.pt.trace.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "unet_step" for e in events)
    assert any(e.key == "unet_step" for e in prof.key_averages())


def test_build_target_follows_the_toolkit_and_torch(monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return type("Done", (), {"stdout": version[0]})()

    version = ["Cuda compilation tools, release 12.4, V12.4.131"]
    monkeypatch.setattr(_build, "_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build, "_toolkit", [])
    first = _build._target("flash_attention")
    assert _build._target("flash_attention") == first
    assert len(calls) == 1 and calls[0][1:] == ["--version"]
    version[0] = "Cuda compilation tools, release 12.8, V12.8.93"
    monkeypatch.setattr(_build, "_toolkit", [])
    second = _build._target("flash_attention")
    assert second != first and second.parent == first.parent
    assert second.name.startswith("flash_attention-")
    monkeypatch.setattr(_build, "_toolkit", [])
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")
    assert _build._target("flash_attention") not in (first, second)
    assert os.path.basename(str(first.parent)) == "kernels"
