"""Compare the kernels of this checkout with another copy of the repo.

A change that adds a route to a shared tile (the float32 route of the space
and time kernels, for one) must leave the configurations' kernels as they
were. Three checks, on a CUDA host, against a copy unpacked from the parent
commit (``git archive <parent> | tar -x -C build/parent``):

1. PTX: every kernel function of each source, bf16 and float32 (the
   ``_f32`` translation units), compiled with ``nvcc -ptx`` in both copies,
   compared after register numbers, labels and the repository's symbols
   are normalised; prints the count of differing lines per function
   (template arguments matched by the kernels' int, bool and element-type
   parameters, float or bf16; a
   kernel of this copy that the other lacks is also held against the
   closest of the other's kernels that this copy lacks, as a renamed or
   re-templated kernel is).
2. Outputs: the space (resident K, K ring, N = 256), time, packed,
   one-pass (D = 16, 32 and 64; at 64 also the modular path's [1280 | 128,
   1024, 64]; at 40, 48 and 56, the narrow tile's in bf16), fused (D = 16
   and 32 across lengths, D = 48 over a short key tile and past resident
   K, D = 64
   with a ragged Nq over a short key tile, and past resident K: [80, 2048]
   and [16 | 128, 1280 | 128] over 2048 keys, on both sides of the float32
   chooser) and tiny-L kernels, the one-pass
   and fused kernels' classes and wide tile (D = 24, 48, 128, 136, 256),
   the time kernel at 32 and 24 frames (the staged kernel where a copy
   has it, the classes' kernel before) and at 8 frames in heads of 64 and
   of 8 (the staged kernel's two items a tile where a copy has it, the
   classes' kernel before), the space kernel at 8-frame clips' and
   train-first-stage's qkv [1, 8 | 16, 1024] (the float32 kernel's cluster
   plan and one-block plan, or the wgmma tile's float32 route, as each
   copy's chooser takes them), the space kernel's pre-rotated design
   at 4 x 128 and 16 x 32, and the space and time backward kernels (space
   also at those splits), on the same seeded inputs in both copies,
   bf16 and float32, each type in a process of its own; prints whether each
   output is equal bit for bit (or that a copy raises at that shape).
3. Times: the same calls timed in each process (``chip_smoke.time_ms``: a
   CUDA graph of 20 calls, the median of 5 replays), the copies in turns
   (other, this, this, other; ``--rounds N``: that N times over); prints
   every reading of each copy and the ratio of the faster reading of each.

    python3 tools/compare_builds.py build/parent      # from the repo root
    python3 tools/compare_builds.py build/parent --rounds 2 --no-ptx
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
                             "tiny_attention", "packed_attention",
                             "divided_backward", "flash_classes",
                             "flash_wide", "divided_classes",
                             "divided_backward_classes")) + (
    "flash_narrow",)   # bf16 alone
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-ptx"]

OUTPUTS = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
from moditalker_tpu_torch.ops.kernels import flash_attention as fa
from moditalker_tpu_torch.ops.kernels import packed_attention as pk
torch.set_grad_enabled(False)
dtype = torch.float32 if sys.argv[2] == "float32" else torch.bfloat16
g = torch.Generator(device="cuda").manual_seed(11)
rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
out, ms = {}, {}


class Put(dict):
    # put[name] = fn runs, keeps and times the call (None where this copy
    # raises NotImplementedError at the shape)
    def __setitem__(self, name, fn):
        try:
            out[name] = fn()
        except NotImplementedError:
            out[name] = None
            return
        ms[name] = chip_smoke.time_ms(torch, fn)


put = Put()
for axis, b, f, n in (("space", 2, 16, 1024), ("space", 1, 2, 2048),
                      ("space", 2, 2, 256), ("time", 2, 16, 1024),
                      ("time", 1, 16, 64), ("space", 1, 8, 1024),
                      ("space", 1, 16, 1024), ("time", 1, 8, 1024)):
    side = 32 if n >= 1024 else 16
    tabs = (rotary.axial_rotary_sincos(side, n // side, 64)
            if axis == "space" else rotary.time_rotary_sincos(f, 64))
    sin, cos = (torch.from_numpy(t).cuda() for t in tabs)
    heads = 8 if n >= 1024 else 2
    x = rnd(b, f, n, 3 * heads * 64)
    put[f"{axis} {[b, f, n]}"] = lambda x=x, sin=sin, cos=cos, axis=axis, \
        heads=heads: dv.divided_attention(x, sin, cos, axis, heads, 64, 0.125)
for b, n in ((256, 1024), (4, 1280), (1280, 1024), (128, 1024)):
    t = [rnd(b, n, 64) for _ in range(3)]
    put[f"one-pass [{b}, {n}, 64]"] = lambda t=t: fa.onepass_attention(*t,
                                                                      0.125)
t = [rnd(16, 1000, 64), rnd(16, 120, 64), rnd(16, 120, 64)]
put["fused q [16, 1000, 64] k [16, 120, 64]"] = lambda t=t: fa.fused_attention(
    *t, 0.125)
t = [rnd(16384, 16, 64) for _ in range(3)]
put["tiny-L [16384, 16, 64]"] = lambda t=t: fa.tiny_attention(*t, 0.125)
for b, l in ((2, 2048), (2, 1024), (1, 1032)):
    t = rnd(b, l, 384)
    put[f"packed [{b}, {l}, 384]"] = lambda t=t: pk.packed_attention(t, 8,
                                                                     0.25)
for b, n, d in ((16, 2048, 32), (16, 2048, 16), (8, 1024, 16)):
    t = [rnd(b, n, d) for _ in range(3)]
    put[f"one-pass [{b}, {n}, {d}]"] = lambda t=t, d=d: fa.onepass_attention(
        *t, d**-0.5)
# the classes and the wgmma tile built per width
for b, n, d in ((16, 2048, 24), (16, 2048, 48), (4, 2048, 128)):
    t = [rnd(b, n, d) for _ in range(3)]
    put[f"one-pass [{b}, {n}, {d}]"] = lambda t=t, d=d: fa.onepass_attention(
        *t, d**-0.5)
sin, cos = (torch.from_numpy(t).cuda()
            for t in rotary.time_rotary_sincos(32, 64))
x = rnd(2, 32, 1024, 1536)
put["time [2, 32, 1024]"] = lambda x=x: dv.divided_attention(
    x, sin, cos, "time", 8, 64, 0.125)
# 8 frames in 64 heads of 8 (the staged kernel's where this copy has it)
sin8, cos8 = (torch.from_numpy(t).cuda()
              for t in rotary.time_rotary_sincos(8, 8))
x = rnd(1, 8, 256, 1536)
put["time [1, 8, 256] 64 x 8"] = lambda x=x: dv.divided_attention(
    x, sin8, cos8, "time", 64, 8, 8**-0.5)
# 24 frames (the staged kernel's too where this copy has it) and the bf16
# one-pass and fused kernel at head dims 40 to 56 (the narrow tile where
# this copy has it, float32 the wide tile's)
sin24, cos24 = (torch.from_numpy(t).cuda()
                for t in rotary.time_rotary_sincos(24, 64))
x = rnd(2, 24, 1024, 1536)
put["time [2, 24, 1024]"] = lambda x=x: dv.divided_attention(
    x, sin24, cos24, "time", 8, 64, 0.125)
for b, n, d in ((16, 2048, 40), (16, 2048, 56), (16, 1024, 48)):
    t = [rnd(b, n, d) for _ in range(3)]
    put[f"one-pass [{b}, {n}, {d}]"] = lambda t=t, d=d: fa.onepass_attention(
        *t, d**-0.5)
for b, nq, nk in ((16, 1000, 120), (16, 1280, 2048)):
    t = [rnd(b, nq, 48), rnd(b, nk, 48), rnd(b, nk, 48)]
    put[f"fused q [{b}, {nq}, 48] k [{b}, {nk}, 48]"] = \
        lambda t=t: fa.fused_attention(*t)
for b, nq, nk, d in ((3, 300, 8, 16), (3, 200, 640, 32), (16, 1024, 1024, 136),
                     (16, 1024, 1024, 256)):
    t = [rnd(b, nq, d), rnd(b, nk, d), rnd(b, nk, d)]
    put[f"fused q [{b}, {nq}, {d}] k [{b}, {nk}, {d}]"] = \
        lambda t=t: fa.fused_attention(*t)
# the backward kernels at train-first-stage's qkv
x = rnd(1, 16, 1024, 1536)
g_ = rnd(1, 16, 1024, 512)
ssin, scos = (torch.from_numpy(t).cuda()
              for t in rotary.axial_rotary_sincos(32, 32, 64))
tsin, tcos = (torch.from_numpy(t).cuda()
              for t in rotary.time_rotary_sincos(16, 64))
flat = lambda t: t.reshape(16, 1024, -1)
out_s = dv.space_attention_cuda(flat(x), ssin, scos, 8, 64, 0.125)
put["space backward [1, 16, 1024]"] = lambda: dv.space_attention_backward_cuda(
    flat(x), out_s, flat(g_), ssin, scos, 8, 64, 0.125)
put["time backward [1, 16, 1024]"] = lambda: dv.time_attention_backward_cuda(
    x, g_, tsin, tcos, 8, 64, 0.125)
# the AE's 512 channels in 4 heads of 128 and 16 of 32: the space forward's
# pre-rotated design and the space backward's classes
for heads, d in ((4, 128), (16, 32)):
    psin, pcos = (torch.from_numpy(t).cuda()
                  for t in rotary.axial_rotary_sincos(32, 32, d))
    o = dv.space_attention_cuda(flat(x), psin, pcos, heads, d, d**-0.5)
    put[f"space [16, 1024] {heads} x {d}"] = \
        lambda psin=psin, pcos=pcos, heads=heads, d=d: dv.space_attention_cuda(
            flat(x), psin, pcos, heads, d, d**-0.5)
    put[f"space backward [16, 1024] {heads} x {d}"] = \
        lambda o=o, psin=psin, pcos=pcos, heads=heads, d=d: \
        dv.space_attention_backward_cuda(flat(x), o, flat(g_), psin, pcos,
                                         heads, d, d**-0.5)
# float32 at head dim 64 past resident K: the 256-channel UNet's joint
# attention and query rows over its 2048 keys (the pre-pass and the bf16 K
# ring where this copy's chooser takes it), and a shape the route keeps
for b, nq, nk in ((80, 2048, 2048), (16, 1280, 2048), (128, 128, 2048)):
    t = [rnd(b, nq, 64), rnd(b, nk, 64), rnd(b, nk, 64)]
    put[f"fused q [{b}, {nq}, 64] k [{b}, {nk}, 64]"] = \
        lambda t=t: fa.fused_attention(*t)
torch.save({"out": {k: None if t is None else t.cpu()
                    for k, t in out.items()}, "ms": ms}, sys.argv[1])
"""


def kernels(ptx: str) -> dict[str, list[str]]:
    """Normalised body of each ``.entry`` function, keyed by the kernel's
    name and int/bool template arguments."""
    starts = [m.start() for m in re.finditer(r"\.entry ", ptx)] + [len(ptx)]
    out = {}
    for a, b in zip(starts, starts[1:]):
        body = ptx[a:b]
        name = re.match(r"\.entry (\w+)", body).group(1)
        key = re.match(r"(_ZN3mdt\d+\w+?I(?:L[bi]\d+E|f|13__nv_bfloat16)+)",
                       name)
        body = re.sub(r"_ZZ?N3mdt\w+", "SYM", body)
        body = re.sub(r"%(r|rd|f|p|fd|rs)\d+", r"%\1", body)
        body = re.sub(r"\$L__BB\d+_\d+", "L", body)
        out[key.group(1) if key else name] = [
            line.strip() for line in body.splitlines()
            if line.strip() and not line.strip().startswith("//")]
    return out


def differing(theirs: list[str], ours: list[str]) -> int:
    """Lines of a unified diff of two normalised bodies."""
    return sum(1 for line in difflib.unified_diff(theirs, ours, lineterm="",
                                                  n=0)
               if line[:1] in "+-" and line[:3] not in ("+++", "---"))


def ptx(copy: Path, source: str, tmp: Path) -> str:
    dst = tmp / f"{copy.name}-{source}.ptx"
    subprocess.run([*NVCC, "-o", str(dst),
                    str(copy / "moditalker_tpu_torch" / "csrc" /
                        f"{source}.cu")], check=True)
    return dst.read_text()


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(usage=__doc__)
    ap.add_argument("other", type=Path, help="the other copy of the repo")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the turns (other, this, this, other) run")
    ap.add_argument("--no-ptx", action="store_true",
                    help="skip the PTX comparison")
    args = ap.parse_args()
    other = args.other.resolve()
    import torch

    turns = (other, ROOT, ROOT, other) * args.rounds
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for source in () if args.no_ptx else SOURCES:
            mine = kernels(ptx(ROOT, source, tmp))
            if not (other / "moditalker_tpu_torch" / "csrc" /
                    f"{source}.cu").is_file():
                print(f"ptx {source}: a source the other copy lacks: "
                      f"{', '.join(mine)} new")
                continue
            theirs = kernels(ptx(other, source, tmp))
            gone = [key for key in theirs if key not in mine]
            for key, ours in mine.items():
                if key in theirs:
                    print(f"ptx {source}: {key}: "
                          f"{differing(theirs[key], ours)} differing lines")
                    continue
                print(f"ptx {source}: {key} is new")
                if gone:
                    near = min(gone, key=lambda k: differing(theirs[k], ours))
                    print(f"  against the other copy's {near}: "
                          f"{differing(theirs[near], ours)} differing lines")
        for dtype in ("bfloat16", "float32"):
            saved = []
            for copy in turns:
                path = tmp / f"{dtype}-{len(saved)}.pt"
                subprocess.run([sys.executable, "-c", OUTPUTS, str(path),
                                dtype], cwd=copy, check=True, timeout=600)
                saved.append(torch.load(path))
            for name, theirs in saved[0]["out"].items():
                ours = saved[1]["out"][name]
                if theirs is None or ours is None:
                    print(f"{dtype} {name}: raises in "
                          f"{'the other copy' if theirs is None else 'this'}")
                    continue
                same = torch.equal(theirs, ours)
                print(f"{dtype} {name}: " + ("equal bit for bit" if same else
                      f"{(theirs != ours).sum().item()} elements differ"))
                before = [run["ms"][name] for copy, run in zip(turns, saved)
                          if copy == other]
                after = [run["ms"][name] for copy, run in zip(turns, saved)
                         if copy == ROOT]
                print(f"  ms other {before} this {after} this/other "
                      f"{min(after) / min(before):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
