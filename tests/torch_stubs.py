"""A fixture for the port's CPU tests of the kernels' launch branch: import
it into a test module (``from .torch_stubs import stub_launches``) and a
test that asks for ``stub_launches`` runs with every kernel wrapper taking
its launch branch for CPU (or meta) tensors, each library, bf16 and
float32, replaced by a stub that records its entry points' calls. The
fixture yields that list of calls; the launch counters start at zero and
are put back to zero after the test.
"""

import pytest

from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack


class StubLib:
    """Stands in for a kernel library: records each entry point's call and
    returns success, writing nothing. ``args``, where given, also gets each
    call's (name, arguments)."""

    def __init__(self, calls, args=None):
        self.calls, self.args = calls, args

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            if self.args is not None:
                self.args.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(tkernels, "on_card", lambda t: True)
    monkeypatch.setattr(tkernels, "cuda_stream", lambda t: 0)
    for mod, names in ((tdiv, ("_lib", "_lib_f32", "_bwd_lib",
                               "_bwd_lib_f32", "_classes_lib",
                               "_classes_lib_f32", "_bwd_classes_lib",
                               "_bwd_classes_lib_f32")),
                       (tpack, ("_lib", "_lib_f32")),
                       (tflash, ("_lib", "_lib_f32", "_tiny_lib",
                                 "_tiny_lib_f32", "_classes_lib",
                                 "_classes_lib_f32", "_wide_lib",
                                 "_wide_lib_f32", "_narrow_lib"))):
        for lib in names:
            monkeypatch.setattr(mod, lib, lambda: StubLib(calls))
    tkernels.reset_launch_counts()
    yield calls
    tkernels.reset_launch_counts()
