"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``moditalker_tpu_torch/csrc/<name>.cu`` compiles, on its own, into
``build/kernels/<name>-<hash>.so`` at the repository root (a directory that
``.gitignore`` lists) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The sources expose a plain C interface (no PyTorch headers), so a build
takes seconds. The file name carries a hash of the sources, the flags, the
toolkit (``nvcc --version``) and the torch version, so an edited kernel, or
one whose toolkit or torch changed, is rebuilt, and an unchanged one is
loaded as it is: a build directory carried to another host never hands it
a stale library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


_toolkit: list[str] = []


def toolkit_fingerprint() -> str:
    """``nvcc --version`` and the torch version, read once per process."""
    if not _toolkit:
        import torch

        out = subprocess.run([_nvcc(), "--version"], check=True,
                             capture_output=True, text=True,
                             timeout=60).stdout
        _toolkit.append(f"{out.strip()}\ntorch {torch.__version__}")
    return _toolkit[0]


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(toolkit_fingerprint().encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen | None]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path,
            proc: subprocess.Popen | None, t0: float) -> tuple[float, str]:
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return time.perf_counter() - t0, log


def build(names: list[str]) -> dict[str, tuple[float, str]]:
    """Compile the named sources, one nvcc each, all started together.
    Returns each build's (seconds until it was collected, compiler output:
    ``-Xptxas -v`` registers, shared memory, spills); the output is empty
    for a library that was already built."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n], t0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
