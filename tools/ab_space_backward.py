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
of 2·N²·dh), and its ``ex2`` floor (one ex2 per score in each sweep over
S, over 132 SMs x 16 a clock at 1980 MHz: three sweeps, two where the
narrow heads' resident plan runs).

    python3 tools/ab_space_backward.py                  # from the repo root
    python3 tools/ab_space_backward.py --dims 64,128,32,16,8,4,2 --reps 1
    python3 tools/ab_space_backward.py --split
    python3 tools/ab_space_backward.py --library --dims 16,8,4,2
    python3 tools/ab_space_backward.py --gate
    python3 tools/ab_space_backward.py --gate --gate-dims 8,2 \
        --lengths 384,1024 --pairs 64,128,256
    python3 tools/ab_space_backward.py --clock

``--clock`` builds a copy of this checkout's headers under
build/ab_space_backward/ with ``clock64`` stamps in the resident narrow
kernel (one block's stamps per (frame, head), from a ``__device__`` array)
and prints each phase's mean cycles a block: loading the operands, sweep 1
(the row statistics), sweep 2 (S, dP, P, dS once; dq, dk, dv), float32 at
heads of 16 dims over N = 1024, 512 and 768.

``--gate`` times the narrow space backward's two plans in this copy
(``divided_attention.space_backward_narrow_plan`` forced: the class, the
resident block per (frame, head), the resident, the class) at heads of 16
dims (``--gate-dims`` for others) over N = 256 to 1024 and 32 to 2048
(frame, head) pairs (``--lengths``, ``--pairs``), float32 and bf16, each
result held bit for bit across its two calls, and prints for each head dim
the table (``SPACE_BACKWARD_RESIDENT_MIN_PAIRS``) its readings give: by
length, the least pairs from which the resident plan read faster in both
types at that count and every larger one.
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

GATE = TIME.split("for dh in")[0] + """
dh = int(sys.argv[3])
if dh >= 4:
    sin_all, cos_all = (torch.from_numpy(t).cuda()
                        for t in rotary.axial_rotary_sincos(32, 32, dh))
else:
    ang = torch.rand(1024, dh // 2, generator=gen, device="cuda")
    ang = (ang * 6 - 3).repeat_interleave(2, dim=-1)
    sin_all, cos_all = ang.sin(), ang.cos()
chooser = dv.space_backward_narrow_plan
for n in map(int, sys.argv[1].split(",")):
    sin, cos = sin_all[:n].contiguous(), cos_all[:n].contiguous()
    for pairs in map(int, sys.argv[2].split(",")):
        heads = 32 if pairs >= 32 else pairs
        bf = pairs // heads
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((bf, n, 3 * heads * dh), generator=gen,
                              device="cuda").to(dtype)
            g = torch.randn((bf, n, heads * dh), generator=gen,
                            device="cuda").to(dtype)
            out = dv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
            fns = {}
            for plan in ("class", "resident"):
                def fn(plan=plan):
                    dv.space_backward_narrow_plan = lambda *a: plan
                    try:
                        return dv.space_attention_backward_cuda(
                            qkv, out, g, sin, cos, heads, dh, dh**-0.5)
                    finally:
                        dv.space_backward_narrow_plan = chooser
                assert torch.equal(fn(), fn())
                fns[plan] = fn
            ms = {"class": [], "resident": []}
            for plan in ("class", "resident", "resident", "class"):
                ms[plan].append(chip_smoke.time_ms(torch, fns[plan]))
            print(dh, n, pairs, str(dtype).replace("torch.", ""),
                  min(ms["class"]), min(ms["resident"]), flush=True)
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
        sweeps = 2 if dv.space_backward_narrow_plan(16, 1024, heads) \\
            == "resident" and dh <= dv.SPACE_BACKWARD_NARROW_MAX else 3
        floor = sweeps * 16 * heads * 1024**2 / (132 * 16 * 1.98e9) * 1e3
        print(dh, str(dtype).replace("torch.", ""), ms, lib, bound, by,
              floor, flush=True)
"""


def clock() -> int:
    """``--clock``: the resident narrow kernel's phases in SM cycles."""
    import ctypes
    import shutil

    import torch

    sys.path.insert(0, str(ROOT))
    from moditalker_tpu_torch.ops.kernels import _build
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv

    out = ROOT / "build" / "ab_space_backward"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    h = (out / "divided_backward.cuh").read_text()
    head = "space_resident_bwd_kernel(const SpaceClassArgs<T> a) {"
    k0 = h.index(head)
    stamps = [
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
         "  const long long clk0 = clock64();\n"),
        ("  // sweep 1: each row's log2-sum-exp", "  const long long clk1 = "
         "clock64();\n"),
        ("  // sweep 2: per query tile, S, dP, P and dS once",
         "  const long long clk2 = clock64();\n")]
    body = h[k0:]
    for anchor, stamp in stamps:
        i = body.index(anchor)
        if stamp.startswith("  const long long clk0"):
            i += len(anchor)
        body = body[:i] + stamp + body[i:]
    end = body.index("\n}\n\n// dqkv [BF, N, 3")
    body = (body[:end] + "\n  __syncthreads();\n  if (threadIdx.x == 0) {\n"
            "    long long* c = mdt_clk + 4 * (blockIdx.y * gridDim.x + "
            "blockIdx.x);\n    c[0] = clk0; c[1] = clk1; c[2] = clk2; "
            "c[3] = clock64();\n  }" + body[end:])
    decl = h[:k0].rindex("template <typename T>")
    h = (h[:decl] + "__device__ long long mdt_clk[4 * 65536];\n"
         + h[decl:k0] + body)
    (out / "divided_backward.cuh").write_text(h)
    (out / "clock.cu").write_text('''#include "divided_backward.cuh"
extern "C" {
int run(const void* qkv, const void* rot, const void* o, const void* g,
        void* d, int BF, int N, int H, int dh, float scale, void* st) {
  return mdt::launch_space_backward_resident<float>(
      qkv, rot, o, g, d, BF, N, H, dh, scale, static_cast<cudaStream_t>(st));
}
int clocks(long long* host, int n) {
  return cudaMemcpyFromSymbol(host, mdt::mdt_clk, n * 4 * sizeof(long long));
}
}
''')
    so = out / "clock.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(out / "clock.cu")], capture_output=True,
                           text=True)
    if built.returncode:
        print(built.stdout, built.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [p] * 5 + [i, i, i, i, ctypes.c_float, p]
    lib.clocks.argtypes = [p, i]
    gen = torch.Generator(device="cuda").manual_seed(0)
    dh, heads = 16, 32
    for bf, n in ((16, 1024), (4, 1024), (16, 512), (8, 768)):
        qkv = torch.randn((bf, n, 3 * heads * dh), generator=gen,
                          device="cuda")
        g = torch.randn((bf, n, heads * dh), generator=gen, device="cuda")
        ang = torch.rand(n, dh // 2, generator=gen, device="cuda")
        sin, cos = (f(ang.repeat_interleave(2, -1)) for f in (torch.sin,
                                                              torch.cos))
        o = dv.space_attention_cuda(qkv, sin, cos, heads, dh, dh**-0.5)
        tab = dv.rotary_pair_table(sin, cos)
        d = torch.empty_like(qkv)
        for _ in range(3):
            rc = lib.run(qkv.data_ptr(), tab.data_ptr(), o.data_ptr(),
                         g.data_ptr(), d.data_ptr(), bf, n, heads, dh,
                         dh**-0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                print(f"launch failed: {rc}", file=sys.stderr)
                return 1
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (4 * bf * heads))()
        if lib.clocks(buf, bf * heads):
            return 1
        c = torch.tensor(list(buf), dtype=torch.float64).reshape(-1, 4)
        ph = c[:, 1:] - c[:, :-1]
        print(f"float32, N = {n}, {bf * heads} (frame, head) pairs of 16 "
              f"dims: cycles a block: load {ph[:, 0].mean():.0f}, sweep 1 "
              f"{ph[:, 1].mean():.0f}, sweep 2 {ph[:, 2].mean():.0f}, "
              f"total {(c[:, 3] - c[:, 0]).mean():.0f}", flush=True)
    return 0


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
    ap.add_argument("--gate", action="store_true",
                    help="time the narrow plans against each other")
    ap.add_argument("--clock", action="store_true",
                    help="the resident narrow kernel's phases in cycles")
    ap.add_argument("--gate-dims", default="16",
                    help="--gate's head dims, comma-separated")
    ap.add_argument("--lengths", default="256,384,512,640,768,896,1024")
    ap.add_argument("--pairs", default="32,64,128,256,512,1024,2048")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    if args.clock:
        return clock()
    if args.gate:
        for dh in args.gate_dims.split(","):
            out = subprocess.run([sys.executable, "-c", GATE, args.lengths,
                                  args.pairs, dh], cwd=ROOT,
                                 capture_output=True, text=True, timeout=1800)
            faster: dict = {}
            for line in out.stdout.split("\n"):
                if line.strip():
                    _, n, pairs, dtype, cls, res = line.split()
                    print(f"{dtype} narrow space backward, N = {n}, {pairs} "
                          f"(frame, head) pairs of {dh} dims: class "
                          f"{float(cls):.4f} ms, resident {float(res):.4f} "
                          f"ms, resident/class "
                          f"{float(res) / float(cls):.4f}", flush=True)
                    faster.setdefault(int(n), {}).setdefault(
                        int(pairs), []).append(float(res) < float(cls))
            # the least pairs from which the resident plan read faster in
            # both types at that count and every larger one
            table = {}
            for n, by in sorted(faster.items()):
                for pairs in sorted(by, reverse=True):
                    if not all(by[pairs]):
                        break
                    table[n] = pairs
            print(f"heads of {dh} dims: SPACE_BACKWARD_RESIDENT_MIN_PAIRS = "
                  f"{table}", flush=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
        return 0
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
