"""Paired timing of the space backward against an earlier copy of the repo.

The space backward (csrc/divided_backward.cuh) runs a bf16 pre-pass, then a
dq kernel and a dk/dv kernel on wgmma. This times it against the design of
another copy of the repository (``--before``: by default build/before,
unpacked from an earlier commit, e.g. ``git archive 640bd46 | tar -x -C
build/before``, whose space backward is the mma.sync dq and dk/dv kernels
this design replaced), each copy in a process of its own that builds its
own kernels, in turns (before, this, this, before), ``--reps`` times over.
The shapes: train-first-stage's qkv [1, 16, 1024, 1536] (the AE's 512
channels in 8 heads of 64) and its channels split into heads of the other
widths (``--dims``: by default 128 and 32, the variants phase's AEs),
float32 (the trainers') and bf16. Each reading is ``chip_smoke.time_ms``: a CUDA graph of
20 calls, the median of five replays.

``--split`` times this copy's launches apart instead (heads of 32 and more:
the pre-pass, the dq kernel and the dk/dv kernel, each entry point called
directly) beside the whole backward.

``--library`` times this copy's backward beside the library's
(``torch.autograd.grad`` through ``F.scaled_dot_product_attention`` on the
rotated, head-split float32 q, k, v, as ``chip_smoke.py``'s backward rows
take it) and prints each shape's bound, counted as ``chip_smoke.py`` counts
it (qkv, the output and g read, dqkv written, the pair table; five products
of 2·N²·dh), and its ``ex2`` floor (three sweeps of one ex2 per score over
132 SMs x 16 a clock at 1980 MHz).

    python3 tools/ab_space_backward.py                  # from the repo root
    python3 tools/ab_space_backward.py --dims 64,128,32,16,8,4,2 --reps 1
    python3 tools/ab_space_backward.py --split
    python3 tools/ab_space_backward.py --library --dims 16,8,4,2
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TIME = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
gen = torch.Generator(device="cuda").manual_seed(0)
for dh in map(int, sys.argv[1].split(",")):
    heads = 512 // dh
    if dh >= 4:
        sin, cos = (torch.from_numpy(t).cuda()
                    for t in rotary.axial_rotary_sincos(32, 32, dh))
    else:   # the axial table has no entry below head dim 4
        ang = torch.rand(1024, dh // 2, generator=gen, device="cuda")
        ang = (ang * 6 - 3).repeat_interleave(2, dim=-1)
        sin, cos = ang.sin(), ang.cos()
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((16, 1024, 3 * heads * dh), generator=gen,
                          device="cuda").to(dtype)
        g = torch.randn((16, 1024, heads * dh), generator=gen,
                        device="cuda").to(dtype)
        out = dv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
        ms = chip_smoke.time_ms(torch, lambda: dv.space_attention_backward_cuda(
            qkv, out, g, sin, cos, heads, dh, dh**-0.5))
        print(dh, str(dtype).replace("torch.", ""), ms, flush=True)
"""

SPLIT = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
gen = torch.Generator(device="cuda").manual_seed(0)
for dh in map(int, sys.argv[1].split(",")):
    heads = 512 // dh
    sin, cos = (torch.from_numpy(t).cuda()
                for t in rotary.axial_rotary_sincos(32, 32, dh))
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((16, 1024, 3 * heads * dh), generator=gen,
                          device="cuda").to(dtype)
        g = torch.randn((16, 1024, heads * dh), generator=gen,
                        device="cuda").to(dtype)
        out = dv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
        table = dv.rotary_pair_table(sin, cos)
        dqkv = torch.empty_like(qkv)
        sc, gs, dsum, stats = dv.space_backward_scratch(16, 1024, heads, dh,
                                                        "cuda")
        lib, suffix = dv._library(dtype == torch.float32,
                                  dh not in dv.SPACE_BACKWARD_HEAD_DIMS,
                                  backward=True)
        tensors = {"prepass": (qkv, table, out, g, sc, gs, dsum),
                   "dq": (sc, gs, dsum, table, dqkv, stats),
                   "dkdv": (sc, gs, dsum, table, dqkv, stats)}

        def launch(step):
            entry = getattr(lib, f"divided_space_backward_{step}{suffix}")
            ptrs = [t.data_ptr() for t in tensors[step]]
            return lambda: entry(*ptrs, 16, 1024, heads, dh, dh**-0.5,
                                 torch.cuda.current_stream().cuda_stream)

        ms = {step: chip_smoke.time_ms(torch, launch(step))
              for step, _ in dv.SPACE_BACKWARD_STEPS}
        ms["whole"] = chip_smoke.time_ms(
            torch, lambda: dv.space_attention_backward_cuda(
                qkv, out, g, sin, cos, heads, dh, dh**-0.5))
        print(dh, str(dtype).replace("torch.", ""),
              " ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
"""

LIBRARY = TIME.split("for dh in")[0] + """
import torch.nn.functional as F
for dh in map(int, sys.argv[1].split(",")):
    heads = 512 // dh
    if dh >= 4:
        sin, cos = (torch.from_numpy(t).cuda()
                    for t in rotary.axial_rotary_sincos(32, 32, dh))
    else:
        ang = torch.rand(1024, dh // 2, generator=gen, device="cuda")
        ang = (ang * 6 - 3).repeat_interleave(2, dim=-1)
        sin, cos = ang.sin(), ang.cos()
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((16, 1024, 3 * heads * dh), generator=gen,
                          device="cuda").to(dtype)
        g = torch.randn((16, 1024, heads * dh), generator=gen,
                        device="cuda").to(dtype)
        out = dv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
        ms = chip_smoke.time_ms(torch, lambda: dv.space_attention_backward_cuda(
            qkv, out, g, sin, cos, heads, dh, dh**-0.5))
        q, k, v = (t.float().reshape(16, 1024, heads, dh).transpose(1, 2)
                   for t in qkv.chunk(3, -1))
        q, k = rotary.apply_rot_emb(q, k, sin, cos)
        q, k, v = (t.contiguous().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(q, k, v, scale=dh**-0.5)
        lg = torch.randn(lo.shape, generator=gen, device="cuda")
        lib = chip_smoke.device_ms(torch, lambda: torch.autograd.grad(
            lo, (q, k, v), lg, retain_graph=True))
        nbytes = (2 * qkv.numel() + g.numel() + out.numel()) * \\
            qkv.element_size() + sin.numel() * 4
        bound, by = chip_smoke.bound_ms(nbytes,
                                        10.0 * 16 * heads * 1024**2 * dh)
        floor = 3 * 16 * heads * 1024**2 / (132 * 16 * 1.98e9) * 1e3
        print(dh, str(dtype).replace("torch.", ""), ms, lib, bound, by,
              floor, flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=ROOT / "build" / "before",
                    help="the earlier copy of the repository")
    ap.add_argument("--dims", default="64,128,32",
                    help="head dims, comma-separated (512 channels each)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--split", action="store_true",
                    help="time this copy's three launches apart")
    ap.add_argument("--library", action="store_true",
                    help="time this copy beside the library's backward")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    if args.library:
        out = subprocess.run([sys.executable, "-c", LIBRARY, args.dims],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        for line in out.stdout.split("\n"):
            if line.strip():
                dh, dtype, ms, lib, bound, by, floor = line.split()
                print(f"{dtype} space backward, 512 channels in heads of "
                      f"{dh}, qkv [1, 16, 1024, 1536]: {float(ms):.4f} ms, "
                      f"library {float(lib):.4f}, bound {float(bound):.4f} "
                      f"({by}), ex2 floor {float(floor):.4f}")
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
        return out.returncode
    if args.split:
        out = subprocess.run([sys.executable, "-c", SPLIT, args.dims],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        for line in out.stdout.split("\n"):
            if line.strip():
                dh, dtype, *ms = line.split()
                print(f"{dtype} space backward, 512 channels in heads of "
                      f"{dh}, qkv [1, 16, 1024, 1536], ms: {' '.join(ms)}")
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
        return out.returncode
    copies = {"before": args.before.resolve(), "this": ROOT}
    readings: dict = {}
    for rep in range(args.reps):
        for name in ("before", "this", "this", "before"):
            out = subprocess.run([sys.executable, "-c", TIME, args.dims],
                                 cwd=copies[name], capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            for line in out.stdout.split("\n"):
                if line.strip():
                    dh, dtype, ms = line.split()
                    readings.setdefault((int(dh), dtype, name), []).append(
                        float(ms))
                    print(f"rep {rep} {name}: {dtype} space backward, 512 "
                          f"channels in heads of {dh}, qkv [1, 16, 1024, "
                          f"{3 * 512}]: {float(ms):.4f} ms", flush=True)
    for dh in map(int, args.dims.split(",")):
        for dtype in ("float32", "bfloat16"):
            before = readings[(dh, dtype, "before")]
            this = readings[(dh, dtype, "this")]
            print(f"head dim {dh} {dtype}: before {before} this {this} "
                  f"this/before {min(this) / min(before):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
