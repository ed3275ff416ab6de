"""A/B of the space backward kernels' block shape on one card.

The space backward (csrc/divided_backward.cuh) runs a dq kernel and a dk/dv
kernel whose blocks own 16 rows a warp and walk the other operand in tiles
of ``SpaceBwd<DH>::tile`` rows, each tile staged from float32 through
registers with its loads in flight across the block barrier. This times
the float32 and bf16 backward at train-first-stage's qkv [1, 16, 1024,
1536] for the built shape and for variants of it, each built from a copy
of the package under build/ab_space_backward/:

  w8-t128   eight warps (128 rows a block), 128-row tiles: as built;
  w8-t64    eight warps, 64-row tiles;
  w4-t64    four warps (64 rows a block), 64-row tiles;
  w4-t32    four warps, 32-row tiles.

Each variant runs in a process of its own, in turns, ``--reps`` times.

    python3 tools/ab_space_backward.py       # from the repository root
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "moditalker_tpu_torch/csrc/divided_backward.cuh"
# the shape of the head-dim class 64 (SpaceBwd<DH>)
WARPS = "static constexpr int warps = DH == 128 ? 4 : 8;"
TILE = "static constexpr int tile = DH == 128 ? 32 : 128;"
VARIANTS = {
    "w8-t128": [],
    "w8-t64": [(TILE, TILE.replace(": 128;", ": 64;"))],
    "w4-t64": [(WARPS, WARPS.replace(": 8;", ": 4;")),
               (TILE, TILE.replace(": 128;", ": 64;"))],
    "w4-t32": [(WARPS, WARPS.replace(": 8;", ": 4;")),
               (TILE, TILE.replace(": 128;", ": 32;"))],
}

TIME = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
sin, cos = (torch.from_numpy(t).cuda()
            for t in rotary.axial_rotary_sincos(32, 32, 64))
gen = torch.Generator(device="cuda").manual_seed(0)
for dtype in (torch.float32, torch.bfloat16):
    qkv = torch.randn((16, 1024, 1536), generator=gen, device="cuda").to(dtype)
    g = torch.randn((16, 1024, 512), generator=gen, device="cuda").to(dtype)
    out = dv.space_attention_cuda(qkv, sin, cos, 8, 64, 0.125)
    ms = chip_smoke.time_ms(torch, lambda: dv.space_attention_backward_cuda(
        qkv, out, g, sin, cos, 8, 64, 0.125))
    print(str(dtype).replace("torch.", ""), ms)
"""


def variant_dir(name: str, edits) -> Path:
    d = ROOT / "build" / "ab_space_backward" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", d)
    shutil.copytree(ROOT / "moditalker_tpu_torch", d / "moditalker_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = d / HEADER
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {HEADER} once")
        text = text.replace(old, new)
    header.write_text(text)
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    dirs = {name: variant_dir(name, edits) for name, edits in VARIANTS.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    for rep in range(args.reps):
        for name, d in dirs.items():
            out = subprocess.run([sys.executable, "-c", TIME], cwd=d,
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                print(out.stderr[-2000:], file=sys.stderr)
                return 1
            for line in out.stdout.split("\n"):
                if line.strip():
                    dtype, ms = line.split()
                    print(f"rep {rep} {name}: {dtype} space backward at qkv "
                          f"[1, 16, 1024, 1536] {float(ms):.4f} ms",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
