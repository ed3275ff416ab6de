"""Paired timing of the float32 attention kernels at head dim 64 on one card.

The float32 resident-K kernel (csrc/resident_f32_tile.cuh) is timed where
its two callers run it: the divided space attention (the entry point
``divided_space_attention_f32``) at train-diffusion's and
train-first-stage's shapes, qkv [10 | 1, 16, 1024, 1536] float32 (8 heads
of 64), or with ``--onepass`` the one-pass attention (``fused_attention_f32``
through ``onepass_attention``) at the modular path's head-split shapes of
the same, q, k, v [1280 | 128, 1024, 64] float32 (``--shapes`` for others;
past 1152 keys the one-pass and fused kernels' pre-pass and bf16 K ring,
``fused_attention_f32_prerounded``).
Each copy of the kernel runs in a process of its own that builds it, in
turns. Each reading is ``chip_smoke.time_ms``: a CUDA graph of 20 calls, the
median of five replays. Each process also checks the output against the
float32 route (space: ``exp2``; one-pass: the form ``chip_smoke.py`` holds
it to) at its shapes of 16 frames (128 sequences) or fewer, and prints the
kernel's ``-Xptxas -v`` line. Modes:

* by default, this checkout against an earlier copy of the repository
  (``--before``: build/before, unpacked from an earlier commit, e.g.
  ``git archive 78a7fb9 | tar -x -C build/before``, whose float32 space
  kernel is the wgmma tile's bf16 design instantiated for float32, or
  ``git archive 1be23a7`` for the one-pass kernel's), in the turns before,
  this, this, before, ``--reps`` times over;
* ``--variants``: design alternatives of this checkout's kernel, each a copy
  under build/ab_space_f32/ with the header edited (``VARIANTS``; ``--pick``
  names some): each caller's plan set to either caller's (V rounded in the
  prologue, or by the producer in the first round with 2, 4 or 8 chunks a
  thread in flight, at 40 / 232 or 104 / 200 registers), the prologue's
  batches doubled, Q read by S from shared memory, three consumer
  warpgroups at 160 registers, four at 112 (Q in registers or in shared
  memory);
* ``--split``: this checkout's kernel with the rounds a block walks capped,
  built in: at none (the prologue alone), one and all; the differences time
  the prologue, the first round and the rest, each cut run on its own (so
  its phases meet no other blocks' phases);
* ``--clock``: a ``clock64`` account of a block in the full run: the
  prologue, the first round and the other rounds, the mean over blocks,
  written over each block's scratch slot once nothing reads it (this
  checkout, and the other caller's plan in its place);
* ``--gate``: every side of the wrapper's choice (``space_f32_own_kernel``'s
  three plans, in turns route, block, cluster, cluster, block, route: the
  wgmma tile's float32 route, the kernel of its own at one block and at a
  cluster of two per (frame, head); with ``--onepass``
  ``onepass_f32_own_kernel`` with K resident and
  ``onepass_f32_prerounded`` past it, in turns route, kernel, kernel,
  route) in this checkout, each forced at every shape, by default over 64
  to 1280 (frame, head) pairs and N = 256 to 1152 (``GATE_SHAPES``; one-pass: 64
  to 1280 sequences at N = 1024, ``ONEPASS_GATE_SHAPES``, and past
  resident K the one-pass and fused shapes of ``PREROUNDED_GATE_SHAPES``,
  B x Nq x Nk for the fused kernel), with the side the wrapper takes at
  each; ``--bf16`` also times the bf16 tile at each one-pass shape first,
  the yardstick.

The header edits of ``--variants``, ``--split`` and ``--clock`` change the
kernel of both callers; ``--onepass`` times the one-pass caller's.

    python3 tools/ab_space_f32.py             # from the repository root
    python3 tools/ab_space_f32.py --variants --reps 1
    python3 tools/ab_space_f32.py --split --reps 1
    python3 tools/ab_space_f32.py --clock
    python3 tools/ab_space_f32.py --gate --reps 1
    python3 tools/ab_space_f32.py --onepass --before build/before
    python3 tools/ab_space_f32.py --onepass --gate --reps 1
    python3 tools/ab_space_f32.py --onepass --gate --bf16 --shapes 80x2048
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "moditalker_tpu_torch/csrc/resident_f32_tile.cuh"
ROUNDS = "  const int rounds = (N + kRfRoundRows - 1) / kRfRoundRows;"
NC = "constexpr int kRfConsumers = 2;"
# each caller's plan: where V is rounded (kVFirst: by the producer in the
# first round; else in the prologue) and the producer's and each
# consumer's registers
PLANS = ("  static constexpr bool kRot = true, kVFirst = false;\n"
         "  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;\n",
         "  static constexpr bool kRot = false, kVFirst = true;\n"
         "  static constexpr int kProducerRegs = 104, kConsumerRegs = 200;\n")
VFIRST_BATCH = "constexpr int kRfVFirstBatch = 8; "


def plan(v_first: bool, producer: int, consumer: int, batch: int = 8):
    """Both callers' plan set alike: V rounded in the first round (with
    ``batch`` of a thread's eight chunks of a tile in flight together) or in
    the prologue, the producer at ``producer`` registers and each consumer
    at ``consumer``."""
    edits = [(VFIRST_BATCH, VFIRST_BATCH.replace("8", str(batch)))]
    for old in PLANS:
        rot = "true" if "kRot = true" in old else "false"
        edits.append((old, (
            f"  static constexpr bool kRot = {rot}, kVFirst = "
            f"{'true' if v_first else 'false'};\n"
            f"  static constexpr int kProducerRegs = {producer}, "
            f"kConsumerRegs = {consumer};\n")))
    return edits


KB = "constexpr int kRfKBatch = 4; "
VB = "constexpr int kRfVBatch = 8; "
SPLIT = ("  __syncthreads();  // also makes the scratch's V visible to the "
         "producer\n")


def cut(rounds: int):
    """The rounds a block walks capped at ``rounds``, built in."""
    return [(ROUNDS, ROUNDS.replace("=", "= min(", 1).replace(
                ";", f", {rounds});")),
            (SPLIT, SPLIT + "  if (rounds == 0) return;\n")]


Q0 = "      const int q0 = (round * NC + wg) * kWgRows;\n"
IDLE = """      if (q0 >= N) {
        // no rows left for this warpgroup: it only hands the tiles back
        for (int j = 0; j < nkt; ++j, ++it) {
          const int vs = it % kWgVStages;
          mbar_wait(full_v(vs), (it / kWgVStages) & 1);
          if (lane == 0) mbar_arrive(empty_v(vs));
        }
        continue;
      }
"""


def consumers(n: int, regs: int, batches: tuple[int, int]):
    """n consumer warpgroups at regs registers (the producer at 32, V
    rounded in the prologue), the prologue's batches cut to fit the
    registers of n + 1 warpgroups; a warpgroup past the last row of a round
    hands the tiles back."""
    return [(NC, NC.replace("2", str(n))), (Q0, Q0 + IDLE),
            (KB, KB.replace("4", str(batches[0]))),
            (VB, VB.replace("8", str(batches[1])))] + plan(False, 32, regs)


# S = Q·Kᵀ with Q as the shared-memory A operand (its swizzled tile), where
# the kernel takes Q's register fragments
SS_PTX = """// d[64] (+)= A (shared, K-major, 64 x 16) · Bᵀ (shared, K-major, 128 x 16).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int accum) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accum)
      : "memory");
}

"""
GRID = "// block 384, dynamic shared memory"
S_RS = ("          wgmma_m64n128k16(s, qa[kk], wgmma_desc(kt + kk * 32), "
        "kk > 0);")
S_SS = [(GRID, SS_PTX + GRID),
        (S_RS, "          wgmma_m64n128k16_ss(s, wgmma_desc(q_tile + kk * 32), "
               "wgmma_desc(kt + kk * 32), kk > 0);")]

SPLITS = {"prologue": cut(0), "first round": cut(1), "all": []}
VARIANTS = {
    "as built": [],
    # the space kernel's plan, and PR 19's "V in the first round"
    "V in the prologue, 40 / 232": plan(False, 40, 232),
    "V in the first round, 2 chunks, 40 / 232": plan(True, 40, 232, 2),
    # the one-pass kernel's plan, and the steps to it
    "V in the first round, 8 chunks, 104 / 200": plan(True, 104, 200, 8),
    "V in the first round, 4 chunks, 104 / 200": plan(True, 104, 200, 4),
    "V in the prologue, 104 / 200": plan(False, 104, 200),
    "prologue batches 8, 16": [(KB, KB.replace("4", "8")),
                               (VB, VB.replace("8", "16"))],
    "3 consumers at 160": consumers(3, 160, (4, 8)),
    "4 consumers at 112": consumers(4, 112, (4, 8)),
    "4 consumers at 112, Q from shared memory":
        consumers(4, 112, (4, 8)) + S_SS,
    "Q from shared memory": S_SS,
}

# --clock: clock64 at the kernel's start, after the prologue, after the
# block's first round and at the end, by thread 0 (consumer warpgroup 0),
# written over 32 bytes of the block's scratch slot once this block reads
# it no more (a cluster's blocks: rank 0's first 32 bytes, rank 1's next)
CLOCK = [
    ("  const int tid = threadIdx.x, wg = tid >> 7;\n",
     "  const int tid = threadIdx.x, wg = tid >> 7;\n"
     "  const long long clk0 = clock64();\n"),
    ("  __syncthreads();  // also makes the scratch's V visible to the "
     "producer\n",
     "  __syncthreads();  // also makes the scratch's V visible to the "
     "producer\n  const long long clk1 = clock64();\n"),
    ("    constexpr float kLog2e = 1.4426950408889634f;\n    int it = 0;\n",
     "    constexpr float kLog2e = 1.4426950408889634f;\n    int it = 0;\n"
     "    long long clk2 = 0;\n"),
    ("      // finish the row sums across the quad",
     "      if (round == rank) clk2 = clock64();\n"
     "      // finish the row sums across the quad"),
    ("              o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);\n"
     "      }\n    }\n  }\n}\n",
     "              o[4 * nd + 2 * r] * inv, o[4 * nd + 2 * r + 1] * inv);\n"
     "      }\n    }\n    if (tid == 0) {\n"
     "      long long* rec = reinterpret_cast<long long*>(vsc) + 4 * rank;\n"
     "      rec[0] = clk1 - clk0;\n      rec[1] = clk2 - clk1;\n"
     "      rec[2] = clock64() - clk2;\n"
     "      rec[3] = (rounds - rank + CL - 1) / CL;\n    }\n"
     "  }\n}\n"),
]

CLOCK_RUN = """
import sys
import torch
sys.path.insert(0, ".")
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
from moditalker_tpu_torch.ops.kernels import flash_attention as fa
onepass = sys.argv[1] == "onepass"
mod, name = (fa, "onepass_f32_scratch") if onepass else (dv, "space_f32_scratch")
sin, cos = (torch.from_numpy(t).cuda()
            for t in rotary.axial_rotary_sincos(32, 32, 64))
gen = torch.Generator(device="cuda").manual_seed(0)
kept, allocate = [], getattr(mod, name)
setattr(mod, name, lambda *a: kept.append(allocate(*a)) or kept[-1])
# space: each plan of the kernel forced at train-diffusion's, train-first-
# stage's and 8-frame clips' qkv (a cluster's blocks recorded apart)
runs = ([(b, 16, None) for b in (10, 1)] if onepass else
        [(b, f, plan) for plan in ("block", "cluster")
         for b, f in ((10, 16), (1, 16), (1, 8))])
for b, f, plan in runs:
    dv.space_f32_own_kernel = lambda *a: plan
    qkv = torch.randn((b, f, 1024, 1536), generator=gen, device="cuda")
    q, k, v = (t.reshape(b * f, 1024, 8, 64).transpose(1, 2)
               .reshape(b * f * 8, 1024, 64).contiguous() for t in qkv.chunk(3, -1))
    for _ in range(3):
        kept.clear()
        if onepass:
            fa.onepass_attention(q, k, v, 0.125)
        else:
            dv.divided_attention(qkv, sin, cos, "space", 8, 64, 0.125)
    torch.cuda.synchronize()
    slot = kept[0].view(kept[0].shape[0], -1).view(torch.int64)
    for rank in range(2 if plan == "cluster" else 1):
        rec = slot[:, 4 * rank:4 * rank + 4].double()
        print(f"{b}x{f}", plan or "", rank, *rec[:, :3].mean(0).tolist(),
              rec[:, 3].mean().item(), flush=True)
"""

TIME = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from moditalker_tpu_torch.ops import rotary
from moditalker_tpu_torch.ops.kernels import _build, check_float32_route
from moditalker_tpu_torch.ops.kernels import divided_attention as dv
from moditalker_tpu_torch.ops.kernels import flash_attention as fa
onepass = sys.argv[4] == "onepass"
source = "flash_attention_f32" if onepass else "divided_attention_f32"
# the kernel's registers and spills: the resident-K kernel of the caller
# timed (an earlier copy's: the space kernel of its own, or the wgmma tile's
# float32 instantiation without the rotary and resident K), and past
# resident K the bf16 K ring on float32 q and output
kernel = (("OnepassF32Args", "wgmma_attention_kernelILb0ELi3EffE",
           "wgmma_attention_kernelILb0ELi2E13__nv_bfloat16fE")
          if onepass else ("SpaceF32Args", "space_f32_kernel"))
for name, (secs, log) in _build.build([source]).items():
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in kernel):
            print("#", lines[i + 1].strip(), lines[i + 2].strip())
        if "serialized" in line:
            print("#", line.strip())
side = sys.argv[3]
if side in ("kernel", "route", "block", "cluster"):
    # --gate: one side of the wrapper's choice
    own = lambda *a: side != "route"
    if onepass:
        # with resident K the float32 resident-K kernel; past it the
        # pre-pass and the bf16 K ring (each against the wgmma tile's
        # float32 route)
        resident = fa.RESIDENT_KEYS_D64
        fa.onepass_f32_own_kernel = lambda b, nq, nk: own() and nk <= resident
        fa.onepass_f32_prerounded = lambda b, nq, nk: own() and nk > resident
    else:
        # the space kernel's plans: one block or a cluster of two per
        # (frame, head), or the route
        dv.space_f32_own_kernel = lambda *a: None if side == "route" else side
gen = torch.Generator(device="cuda").manual_seed(0)
torch.set_grad_enabled(False)
for shape in sys.argv[2].split(","):
    if onepass:
        # B x N (one-pass) or B x Nq x Nk (fused); side "bf16": the bf16
        # tile at the shape, the yardstick
        dims = list(map(int, shape.split("x")))
        b, nq, nk = dims if len(dims) == 3 else (dims[0], dims[1], dims[1])
        dtype = torch.bfloat16 if side == "bf16" else torch.float32
        q = torch.randn((b, nq, 64), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, nk, 64), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        call = ((lambda: fa.onepass_attention(q, k, v, 0.125)) if nq == nk
                else (lambda: fa.fused_attention(q, k, v, 0.125)))
        if sys.argv[1] == "1" and side != "bf16" and b * nq * nk <= 2**27:
            exp2 = nk > fa.RESIDENT_KEYS_D64
            check_float32_route(
                "onepass_attention" if nq == nk else "fused_attention",
                call(), fa.attention_float32_route(q, k, v, 0.125, exp2=exp2))
        print(shape, chip_smoke.time_ms(torch, call), flush=True)
        continue
    b, f, n = map(int, shape.split("x"))
    rows = 32 if n % 32 == 0 and n >= 1024 else 16  # the axial grid's
    sin, cos = (torch.from_numpy(t).cuda()
                for t in rotary.axial_rotary_sincos(rows, n // rows, 64))
    qkv = torch.randn((b, f, n, 1536), generator=gen, device="cuda")
    call = lambda: dv.divided_attention(qkv, sin, cos, "space", 8, 64, 0.125)
    if sys.argv[1] == "1" and b * f <= 16:
        check_float32_route("divided_space_attention", call(),
                            dv.divided_attention_float32_route(
                                qkv, sin, cos, "space", 8, 64, 0.125,
                                exp2=True))
    print(shape, chip_smoke.time_ms(torch, call), flush=True)
"""


# --gate: 64 (8-frame clips), 128, 256 and 1280 (frame, head) pairs over
# every length the kernel takes, and 32, 80 and 96 pairs at the
# configurations' 1024 tokens
GATE_SHAPES = ",".join(
    [f"{b}x{f}x{n}" for b, f in ((1, 8), (1, 16), (2, 16), (10, 16))
     for n in range(256, 1153, 128)]
    + [f"1x{f}x1024" for f in (4, 10, 12)])
# --onepass --gate: 64 to 1280 sequences at the one-pass gate's resident-K
# length (B x N); past resident K 2 to 80 sequences of 2048 (the 256-channel
# UNet's joint attention at B = 10, 2 and 1, and fewer), 1280 and 1536 keys,
# and fused shapes, Nq query rows over Nk keys (B x Nq x Nk), on both sides
# of onepass_f32_prerounded's query blocks and keys
ONEPASS_GATE_SHAPES = ",".join(
    [f"{b}x1024" for b in (64, 72, 96, 128, 256, 1280)])
PREROUNDED_GATE_SHAPES = ",".join(
    [f"{b}x2048" for b in (80, 16, 8, 2)]
    + [f"{b}x{n}" for n in (1280, 1536) for b in (80, 8)]
    + [f"{b}x{nq}x2048" for b, nq in ((16, 1000), (16, 128), (128, 128),
                                      (128, 256), (128, 512), (80, 1000))]
    + ["2x300x1280"])


def own_kernel(shape: str, onepass: bool):
    """The wrapper's choice at a shape: ``space_f32_own_kernel``'s plan
    (None: the route), or whether ``onepass_f32_own_kernel`` (past resident
    K ``onepass_f32_prerounded``) takes the kernel."""
    sys.path.insert(0, str(ROOT))
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    if onepass:
        dims = list(map(int, shape.split("x")))
        b, nq, nk = dims if len(dims) == 3 else (dims[0], dims[1], dims[1])
        if nk > fa.RESIDENT_KEYS_D64:
            return fa.onepass_f32_prerounded(b, nq, nk)
        return fa.onepass_f32_own_kernel(b, nq, nk)
    b, f, n = map(int, shape.split("x"))
    return dv.space_f32_own_kernel(b * f, n, 8)


def copy_with(name: str, edits, group: str) -> Path:
    slug = name.replace(" ", "_").replace("/", "-").replace(",", "")
    d = ROOT / "build" / "ab_space_f32" / group / slug
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


def run(copy: Path, check: bool, shapes: str, side: str = "",
        onepass: bool = False) -> dict[str, float]:
    """One process: this copy's build line of the kernel (printed), its
    output checked against the route at each shape of 16 frames (128
    sequences) or fewer (where ``check``), and its readings by shape;
    ``side`` (``kernel`` or ``route``) forces that side of the wrapper's
    choice (``bf16``: the bf16 tile at the one-pass shapes);
    ``onepass``: the one-pass caller's kernel at [B, N, 64] (and the fused
    one at [B, Nq, 64] over [B, Nk, 64])."""
    out = subprocess.run([sys.executable, "-c", TIME, str(int(check)),
                          shapes, side, "onepass" if onepass else "space"],
                         cwd=copy, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        print(out.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{copy}: rc {out.returncode}")
    lines = [line for line in out.stdout.split("\n") if line.strip()]
    for line in lines:
        if line.startswith("#"):
            print(f"  {copy.name} {line[1:].strip()}")
    return {shape: float(ms) for shape, ms in
            (line.split() for line in lines if not line.startswith("#"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=ROOT / "build" / "before")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--shapes", default=None,
                    help="qkv shapes BxFxN (8 heads of 64), comma-separated "
                         "(default 10x16x1024,1x16x1024; with --gate "
                         "GATE_SHAPES); with --onepass q shapes BxN of 64, "
                         "or BxNqxNk for the fused kernel (default "
                         "1280x1024,128x1024; with --gate "
                         "ONEPASS_GATE_SHAPES and PREROUNDED_GATE_SHAPES)")
    ap.add_argument("--onepass", action="store_true",
                    help="the one-pass caller's kernel")
    ap.add_argument("--bf16", action="store_true",
                    help="with --onepass --gate: the bf16 tile at each "
                         "shape too, the yardstick, first in each rep")
    ap.add_argument("--pick", default=None,
                    help="with --variants: the names to run, separated by "
                         "'|' (default all)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--split", action="store_true")
    mode.add_argument("--variants", action="store_true")
    mode.add_argument("--clock", action="store_true")
    mode.add_argument("--gate", action="store_true")
    args = ap.parse_args()
    if args.shapes is None:
        args.shapes = (
            (ONEPASS_GATE_SHAPES + "," + PREROUNDED_GATE_SHAPES if args.gate
             else "1280x1024,128x1024")
            if args.onepass else
            (GATE_SHAPES if args.gate else "10x16x1024,1x16x1024"))
    what = ("float32 one-pass at [{}, 64]" if args.onepass else
            "float32 space at qkv [{}, 1536]")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    if args.clock:
        # the other caller's plan beside this one's
        other = ("V in the prologue, 40 / 232" if args.onepass else
                 "V in the first round, 8 chunks, 104 / 200")
        clocks = {"as built": CLOCK, other: VARIANTS[other] + CLOCK}
        for name, edits in clocks.items():
            copy = copy_with(name, edits, "clock")
            out = subprocess.run(
                [sys.executable, "-c", CLOCK_RUN,
                 "onepass" if args.onepass else "space"], cwd=copy,
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            for line in out.stdout.split("\n"):
                if line.strip():
                    words = line.split()
                    shape, rank, (pro, first, rest, rounds) = (
                        words[0], words[-5], map(float, words[-4:]))
                    plan = f" {words[1]} plan," if len(words) == 7 else ""
                    rank = f" rank {rank}" if words[1:2] == ["cluster"] else ""
                    print(f"{name}:{plan} qkv [{shape.replace('x', ', ')}, "
                          f"1024, 1536]{rank}, clocks a block (mean): "
                          f"prologue {pro:.0f}, first round {first:.0f}, the "
                          f"other {rounds - 1:.0f} rounds {rest:.0f}",
                          flush=True)
        return 0
    if args.split or args.variants:
        table = SPLITS if args.split else VARIANTS
        if args.variants and args.pick:
            table = {name: table[name] for name in args.pick.split("|")}
        group = "split" if args.split else "variants"
        copies = {name: copy_with(name, edits, group)
                  for name, edits in table.items()}
        turns = list(copies.items())
    elif args.gate and not args.onepass:
        turns = [(side, ROOT) for side in ("route", "block", "cluster",
                                           "cluster", "block", "route")]
    elif args.gate:
        turns = ([("bf16", ROOT)] if args.bf16 else []) + [
            ("route", ROOT), ("kernel", ROOT), ("kernel", ROOT),
            ("route", ROOT)]
    else:
        if not (args.before / HEADER.replace("resident_f32_tile",
                                             "wgmma_tile")).exists():
            print(f"{args.before}: no earlier copy of the repository",
                  file=sys.stderr)
            return 2
        turns = [("before", args.before), ("this", ROOT), ("this", ROOT),
                 ("before", args.before)]
    readings: dict[tuple[str, str], list[float]] = {}
    for rep in range(args.reps):
        for name, copy in turns:
            for shape, ms in run(copy, not args.split, args.shapes,
                                 name if args.gate else "",
                                 args.onepass).items():
                readings.setdefault((name, shape), []).append(ms)
                print(f"rep {rep} {name}: "
                      + what.format(shape.replace("x", ", "))
                      + f" {ms:.4f} ms", flush=True)
    for shape in args.shapes.split(","):
        best = {name: min(readings[(name, shape)]) for name, _ in turns
                if (name, shape) in readings}
        line = ", ".join(f"{name} {ms:.4f}" for name, ms in best.items())
        print(f"{shape}, fastest reading: {line}")
        if args.split:
            print(f"{shape}: prologue {best['prologue']:.4f} ms, first round "
                  f"{best['first round'] - best['prologue']:.4f}, the rest "
                  f"{best['all'] - best['first round']:.4f}")
        elif args.gate and not args.onepass:
            b, f, n = map(int, shape.split("x"))
            ranked = sorted(best, key=best.get)
            print(f"{shape} ({b * f * 8} pairs): block / route "
                  f"{best['block'] / best['route']:.4f}, cluster / route "
                  f"{best['cluster'] / best['route']:.4f}; fastest "
                  f"{ranked[0]}, the wrapper takes "
                  f"{own_kernel(shape, False) or 'route'}")
        elif args.gate:
            dims = list(map(int, shape.split("x")))
            count = (f"{dims[0]} sequences" if args.onepass else
                     f"{dims[0] * dims[1] * 8} pairs")
            print(f"{shape} ({count}): kernel / route "
                  f"{best['kernel'] / best['route']:.4f}, the wrapper takes "
                  + ("the kernel" if own_kernel(shape, args.onepass) else
                     "the route")
                  + (f"; kernel / bf16 tile {best['kernel'] / best['bf16']:.4f}"
                     if "bf16" in best else ""))
        elif not args.variants:
            print(f"{shape}: this / before "
                  f"{best['this'] / best['before']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
