"""A/B of the float32 space kernel's producer on one card.

The float32 route of the divided space kernel (csrc/wgmma_tile.cuh) rounds
V to bf16 in the producer warpgroup's registers on its way into the ring,
with a register split of 56 (producer) and 152 (each of three consumers).
This times the float32 rows at train-diffusion's and train-first-stage's
shapes (qkv [10 | 1, 16, 1024, 1536]) for that design and for variants of
it, each built from a copy of the package under build/ab_space_f32/:

  as-built   the kernel as it is;
  no-V       the producer loads no V (a diagnostic: wrong results; what the
             float32 V stream costs);
  p80-c144   8 chunks in flight a producer thread, 80 / 144 registers;
  p32-c160   2 chunks in flight, 32 / 160 registers (the bf16 split).

Each variant runs in a process of its own, in turns, ``--reps`` times.

    python3 tools/ab_space_f32.py            # from the repository root
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILE = "moditalker_tpu_torch/csrc/wgmma_tile.cuh"
BATCH = "      constexpr int kVBatch = 4;"
PRODUCER = 'asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\\n");'
CONSUMER = 'asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\\n");'
LOAD = "                c[u].load(vsrc + (u0 + u) * 16 * a.in_row);"
VARIANTS = {
    "as-built": [],
    "no-V": [(LOAD, "                c[u].lo = c[u].hi = make_float4("
                    "0.f, 0.f, 0.f, (float)u0);")],
    "p80-c144": [(BATCH, BATCH.replace("4", "8")),
                 (PRODUCER, PRODUCER.replace("56", "80")),
                 (CONSUMER, CONSUMER.replace("152", "144"))],
    "p32-c160": [(BATCH, BATCH.replace("4", "2")),
                 (PRODUCER, PRODUCER.replace("56", "32")),
                 (CONSUMER, CONSUMER.replace("152", "160"))],
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
for b in (10, 1):
    qkv = torch.randn((b, 16, 1024, 1536), generator=gen, device="cuda")
    ms = chip_smoke.time_ms(torch, lambda: dv.divided_attention(
        qkv, sin, cos, "space", 8, 64, 0.125))
    print(b, ms)
"""


def variant_dir(name: str, edits) -> Path:
    d = ROOT / "build" / "ab_space_f32" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", d)
    shutil.copytree(ROOT / "moditalker_tpu_torch", d / "moditalker_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tile = d / TILE
    text = tile.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {TILE} once")
        text = text.replace(old, new)
    tile.write_text(text)
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
                    b, ms = line.split()
                    print(f"rep {rep} {name}: float32 space at qkv "
                          f"[{b}, 16, 1024, 1536] {float(ms):.4f} ms",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
