"""Compare the bf16 kernels of this checkout with another copy of the repo.

A change that adds a route to a shared tile (the float32 route of the space
and time kernels, for one) must leave the bf16 kernels as they were. Two
checks, on a CUDA host, against a copy unpacked from the parent commit
(``git archive <parent> | tar -x -C build/parent``):

1. PTX: every kernel function of each source, bf16 and float32 (the
   ``_f32`` translation units), compiled with ``nvcc -ptx`` in both copies,
   compared after register numbers and labels are normalised;
   prints the count of differing lines per function (template arguments
   matched by the kernels' int and bool parameters).
2. Outputs: the bf16 space (resident K, K ring, N = 256), time, packed,
   one-pass (D = 16, 32 and 64), fused (D = 16 and 32 across lengths, D = 64
   with a ragged Nq over a short key tile) and tiny-L kernels on the same
   seeded inputs in both copies, each in a process of its own; prints
   whether each output is equal bit for bit.

    python3 tools/compare_builds.py build/parent      # from the repo root
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = tuple(f"{name}{suffix}" for suffix in ("", "_f32")
                for name in ("divided_attention", "flash_attention",
                             "tiny_attention", "packed_attention"))
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-ptx"]

OUTPUTS = """
import sys
import torch
sys.path.insert(0, ".")
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
from moditalker_tpu_torch.ops.kernels import flash_attention as fa
from moditalker_tpu_torch.ops.kernels import packed_attention as pk
g = torch.Generator(device="cuda").manual_seed(11)
rnd = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()
out = {}
for axis, b, f, n in (("space", 2, 16, 1024), ("space", 1, 2, 2048),
                      ("space", 2, 2, 256), ("time", 2, 16, 1024),
                      ("time", 1, 16, 64)):
    side = 32 if n >= 1024 else 16
    tabs = (rotary.axial_rotary_sincos(side, n // side, 64)
            if axis == "space" else rotary.time_rotary_sincos(f, 64))
    sin, cos = (torch.from_numpy(t).cuda() for t in tabs)
    heads = 8 if n >= 1024 else 2
    x = rnd(b, f, n, 3 * heads * 64)
    out[f"{axis} {[b, f, n]}"] = dv.divided_attention(x, sin, cos, axis,
                                                      heads, 64, 0.125)
out["one-pass [256, 1024, 64]"] = fa.onepass_attention(
    rnd(256, 1024, 64), rnd(256, 1024, 64), rnd(256, 1024, 64), 0.125)
out["one-pass [4, 1280, 64]"] = fa.onepass_attention(
    rnd(4, 1280, 64), rnd(4, 1280, 64), rnd(4, 1280, 64), 0.125)
out["fused q [16, 1000, 64] k [16, 120, 64]"] = fa.fused_attention(
    rnd(16, 1000, 64), rnd(16, 120, 64), rnd(16, 120, 64), 0.125)
out["tiny-L [16384, 16, 64]"] = fa.tiny_attention(
    rnd(16384, 16, 64), rnd(16384, 16, 64), rnd(16384, 16, 64), 0.125)
for b, l in ((2, 2048), (2, 1024), (1, 1032)):
    out[f"packed [{b}, {l}, 384]"] = pk.packed_attention(rnd(b, l, 384), 8,
                                                         0.25)
for b, n, d in ((16, 2048, 32), (16, 2048, 16), (8, 1024, 16)):
    out[f"one-pass [{b}, {n}, {d}]"] = fa.onepass_attention(
        rnd(b, n, d), rnd(b, n, d), rnd(b, n, d), d**-0.5)
for b, nq, nk, d in ((3, 300, 8, 16), (3, 200, 640, 32)):
    out[f"fused q [{b}, {nq}, {d}] k [{b}, {nk}, {d}]"] = fa.fused_attention(
        rnd(b, nq, d), rnd(b, nk, d), rnd(b, nk, d))
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[1])
"""


def kernels(ptx: str) -> dict[str, list[str]]:
    """Normalised body of each ``.entry`` function, keyed by the kernel's
    name and int/bool template arguments."""
    starts = [m.start() for m in re.finditer(r"\.entry ", ptx)] + [len(ptx)]
    out = {}
    for a, b in zip(starts, starts[1:]):
        body = ptx[a:b]
        name = re.match(r"\.entry (\w+)", body).group(1)
        key = re.match(r"(_ZN3mdt\d+\w+?I(?:L[bi]\d+E)+)", name)
        body = re.sub(r"_ZN3mdt\w+", "SYM", body)
        body = re.sub(r"%(r|rd|f|p|fd|rs)\d+", r"%\1", body)
        body = re.sub(r"\$L__BB\d+_\d+", "L", body)
        out[key.group(1) if key else name] = [
            line.strip() for line in body.splitlines()
            if line.strip() and not line.strip().startswith("//")]
    return out


def ptx(copy: Path, source: str, tmp: Path) -> str:
    dst = tmp / f"{copy.name}-{source}.ptx"
    subprocess.run([*NVCC, "-o", str(dst),
                    str(copy / "moditalker_tpu_torch" / "csrc" /
                        f"{source}.cu")], check=True)
    return dst.read_text()


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for source in SOURCES:
            theirs = kernels(ptx(other, source, tmp))
            for key, ours in kernels(ptx(ROOT, source, tmp)).items():
                if key not in theirs:
                    print(f"ptx {source}: {key} is new")
                    continue
                diff = [line for line in difflib.unified_diff(
                    theirs[key], ours, lineterm="", n=0)
                    if line[:1] in "+-" and line[:3] not in ("+++", "---")]
                print(f"ptx {source}: {key}: {len(diff)} differing lines")
        saved = []
        for copy in (other, ROOT):
            path = tmp / f"{len(saved)}.pt"
            subprocess.run([sys.executable, "-c", OUTPUTS, str(path)],
                           cwd=copy, check=True, timeout=600)
            saved.append(torch.load(path))
        for name, theirs in saved[0].items():
            ours = saved[1][name]
            same = torch.equal(theirs, ours)
            print(f"bf16 {name}: " + ("equal bit for bit" if same else
                  f"{(theirs != ours).sum().item()} elements differ"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
