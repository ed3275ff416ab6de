"""The kernels' classes against the configurations' instantiations, at the
configurations' shapes, on one card.

Every kernel is built twice: for the shapes the shipped YAMLs reach
(``csrc/<source>{,_f32}.cu``) and per head-dim and row class for the rest
of its gate (``csrc/*_classes{,_f32}.cu``, padded, masked and with the
plain version's ``expf`` and rounded rotary products). This calls both
entry points on the same inputs at the configurations' shapes, times them
in turns (shipped, class, class, shipped; CUDA graphs of 20 calls, the
median of 5 replays each, ``chip_smoke.time_ms``) and holds the class's
result to the kernel's limits against its plain version (and, in float32,
its route). Prints one JSON line per case: both times and their ratio.
Space in bf16 and the space backward have no class at head dim 64 (the
configurations' wgmma tile and backward are the only kernels built there).

Then the one-pass kernel's two tiles above head dim 32, paired the same way
at [16, 2048, d] for d = 40 to 128 and at [4, 2048, 128], bf16 and float32:
the small-head tile's class 64 or 128 against the wgmma tile built for the
width (``csrc/wgmma_wide.cuh``), each held to the limits (the class
kept bf16 40-56 until the narrow tile, ``--narrow``). And the wgmma tile
built for d = 64 against the configurations'
instantiation at 64 (``csrc/wgmma_tile.cuh``'s tile in
``csrc/flash_attention{,_f32}.cu``) at [16, 2048, 64] (K through a ring) and
[128, 1024, 64] (K resident). The libraries hold only what the wrappers
launch, so this builds the variants it compares for itself, under
``build/ab_classes/`` (one nvcc each, started together, the libraries'
flags): the small-head classes 64 and 128 at every width, and the wide tile
at 40, 48, 56 and 64.

Then the divided space kernel at the head dims other than 64 (``--space``):
the small-head class with the rotary (what ``launch_space_classes`` ran
before the pre-rotated design) against the pre-rotated design
(``divided_space_attention_prerotated``: the rotation pre-pass, then the
small-head tile up to head dim 32 and the wgmma tile built per width at
128) at the AE's 512 channels, qkv [32, 1024, 1536], in 2 to 128 heads of
each width, bf16 and float32, and in float32 at head dim 64 over 2048
tokens (qkv [2, 2048, 1536]), paired (class, new, new, class). Beside the
pair, each timed once: the same class without the rotary on the same packed
layout (a diagnostic with wrong results: what the rotary costs the class),
the pre-pass alone, the one-pass kernel at the head-split shape
[BF·H, N, dh] (what the tile costs without the packed layout) and the
library's attention on the head-split rotated q, k, v. At head dims 16 and
32 the design is also paired (new, wide, wide, new) with the same pre-pass
feeding the wgmma tile built at n = dh in place of the small-head tile. The
class, its rotary-free twin, the pre-pass alone and that wgmma variant are
built here as well.

Then the bf16 one-pass and fused kernel at head dims 40, 48 and 56
(``--narrow``): the small-head class 64 it replaced against the narrow tile
(``csrc/wgmma_narrow.cuh``, ``flash_attention.NARROW_ENTRY``), paired
(class, new, new, class) at [16, 2048 | 1024, d] and [8, 2048, d] and at
fused shapes of 48 (ragged query rows over a whole and a short key tile,
over resident K and past it), with the library call and the bound. And the time
kernel at clips of 32 and 24 frames (``--time32``): the classes' kernel it
replaced against the staged kernel (``csrc/time_staged.cuh``,
``divided_attention.STAGED_TIME_ENTRY``), bit for bit at every head-dim
class, paired at qkv [2, 32 | 24, 1024, 1536], bf16 and float32, with the
library call and the bound. And the time kernel at clips of 8 frames
(``--time8``): the classes' kernel (the frame class 16, padded and masked;
this checkout's ``divided_time_attention_classes``, which still takes 8
frames) against the staged kernel's two ways in, the frame class 16 padded
(``time_staged.cuh``'s kernel without ``PAIR``, built here from this
checkout's headers) and two items of 8 frames a tile (``PAIR``, what
``STAGED_TIME_ENTRY`` runs at 8 frames), each bit for bit against the
class at every head-dim class, in turns (class, padded, pair, pair,
padded, class) at qkv [1, 8, 1024, 1536], bf16 and float32, with the
library call and the bound; then its backward likewise: the classes'
backward (``divided_time_attention_backward_classes``) against the staged
backward (``divided_attention.STAGED_TIME_BACKWARD_ENTRY``), bit for bit at
every head-dim class, in turns (class, staged, staged, class) with the
library's backward and the bound.

The replaced designs (the small-head class 128 and the class with the
rotary) are no longer in this checkout's headers: those variants are built
against the headers of an earlier copy of the repository (``--before``,
default ``build/before``), unpacked as ``tools/compare_builds.py``'s is,
from a commit whose ``smallhead_tile.cuh`` still has its ``ROT`` branch and
class 128 (1f27cc7 or earlier):

    git archive 1f27cc7 | tar -x -C build/before   # once, on the host
    python3 tools/ab_classes.py [--wide | --space | --narrow | --time32 |
                                 --time8] [--before DIR]
                                          # repository root, on a card;
                                          # a mode: that part alone

(``--narrow`` and ``--time32`` build the class 64 and the time classes at
32 frames from the --before copy too: any commit before they were replaced,
252b342 or earlier; ``--time8`` alone needs no --before copy.)
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


# the variants compared above head dim 32, each a library of its own (the
# float32 ones apart from the bf16 ones, as the shipped libraries are):
# name -> (header, built against the --before copy's headers, body)
VARIANTS = {
    "class": ("smallhead_tile.cuh", True, """
  if (D < 8 || D > 128 || D % 8) return cudaErrorInvalidValue;
  const long q_seq = (long)Nq * D, kv_seq = (long)Nk * D;
  const mdt::SmallHeadArgsT<T> a{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), q_seq, kv_seq, D,
      q_seq, D, 0, Nq, Nk, scale, nullptr, D};
  return D <= 64 ? mdt::launch_smallhead<64, T, false, true>(a, B, 1, st)
                 : mdt::launch_smallhead<128, T, false, true>(a, B, 1, st);
"""),
    "wide": ("wgmma_wide.cuh", False, """
  const mdt::WideArgsT<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<T*>(out),
                            (long)Nq * D, (long)Nk * D, D, Nq, Nk, scale,
                            0, 0, 0, 0};
  switch (D) {
    case 40: return mdt::launch_wide<40, T>(a, B, st);
    case 48: return mdt::launch_wide<48, T>(a, B, st);
    case 56: return mdt::launch_wide<56, T>(a, B, st);
    case 64: return mdt::launch_wide<64, T>(a, B, st);
  }
  return cudaErrorInvalidValue;
"""),
}
# the space variants (a library each, bf16 and float32): the class with the
# rotary as it was launched (the --before copy's tile), the same tile
# without it, the pre-pass alone
SPACE_CLASS = """
  if (dh < 2 || dh > 128 || 128 % dh || N < 256 || N % 128)
    return cudaErrorInvalidValue;
  const T* base = static_cast<const T*>(qkv);
  const long hd = (long)H * dh;
  const mdt::SmallHeadArgsT<T> a{{base, base + hd, base + 2 * hd,
                                 static_cast<T*>(out), N * 3 * hd,
                                 N * 3 * hd, 3 * hd, N * hd, hd, dh, N, N,
                                 scale, static_cast<const float*>(rot), dh}};
  switch (dh < 16 ? 16 : dh) {{
    case 16: return mdt::launch_smallhead<16, T, {rot}, true>(a, BF, H, st);
    case 32: return mdt::launch_smallhead<32, T, {rot}, true>(a, BF, H, st);
    case 64: return mdt::launch_smallhead<64, T, {rot}, true>(a, BF, H, st);
    case 128: return mdt::launch_smallhead<128, T, {rot}, true>(a, BF, H, st);
  }}
  return cudaErrorInvalidValue;
"""
SPACE_VARIANTS = {
    "space_class": ("smallhead_tile.cuh", True,
                    SPACE_CLASS.format(rot="true")),
    "space_norot": ("smallhead_tile.cuh", True,
                    SPACE_CLASS.format(rot="false")),
    "space_prepass": ("divided_space.cuh", False, """
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int w = mdt::space_scratch_width(dh);
  return mdt::launch_space_rotate<T>(
      static_cast<const T*>(qkv), static_cast<const float*>(rot),
      static_cast<mdt::bf16*>(scratch), BF, N, H, dh, kF32 || w != dh,
      scale, st);
"""),
    # the pre-rotated design with wgmma at n = dh in place of the
    # small-head tile at head dims 16 and 32
    "space_wide": ("divided_space.cuh", False, """
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (dh != 16 && dh != 32) return cudaErrorInvalidValue;
  mdt::bf16* s = static_cast<mdt::bf16*>(scratch);
  cudaError_t err = mdt::launch_space_rotate<T>(
      static_cast<const T*>(qkv), static_cast<const float*>(rot), s, BF, N,
      H, dh, kF32, scale, st);
  if (err != cudaSuccess) return err;
  const long hw = (long)H * dh, row = 3 * hw;
  const mdt::bf16* v =
      kF32 ? s + 2 * hw : static_cast<const mdt::bf16*>(qkv) + 2 * hw;
  const mdt::WideSpaceArgs a{
      {s, s + hw, v, static_cast<mdt::bf16*>(out), N * row, N * row, dh, N,
       N, 1.f, 0, 0, 0, 0},
      (long)N * H * dh, (int)row, H * dh, H};
  return dh == 16 ? mdt::launch_wide<16, mdt::bf16, true, T>(a, BF * H, st)
                  : mdt::launch_wide<32, mdt::bf16, true, T>(a, BF * H, st);
"""),
}
SPACE_SOURCE = """#include "{header}"
using T = {type};
extern "C" {{
int space_ab(const void* qkv, const void* rot, void* scratch, void* out,
             int BF, int N, int H, int dh, float scale, void* stream) {{
  cudaStream_t st = static_cast<cudaStream_t>(stream);{body}}}
const char* kernel_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
}}
"""
# the bf16 one-pass and fused kernel at head dims 40, 48 and 56 (--narrow):
# the small-head class 64 it replaced (the --before copy's
# launch_fused_classes, bf16 branch), a bf16 library of its own
NARROW_VARIANTS = {
    "class64": ("smallhead_tile.cuh", True, """
  if (D < 8 || D > 64 || D % 8) return cudaErrorInvalidValue;
  const long q_seq = (long)Nq * D, kv_seq = (long)Nk * D;
  const mdt::SmallHeadArgsT<T> a{static_cast<const T*>(q),
                                 static_cast<const T*>(k),
                                 static_cast<const T*>(v),
                                 static_cast<T*>(out), q_seq, kv_seq, D, q_seq,
                                 D, 0, Nq, Nk, scale, D};
  return mdt::launch_smallhead<64, T, true>(a, B, 1, st);
"""),
    # the narrow tile built at 64 (never shipped), against the D = 64 tile
    "narrow64": ("wgmma_narrow.cuh", False, """
  const mdt::NarrowArgs a{static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<T*>(out), Nq,
                          Nk, scale, 0, 0};
  return D == 64 ? mdt::launch_narrow<64>(a, B, st) : cudaErrorInvalidValue;
"""),
}
BF16_ONLY = (("", "mdt::bf16"),)
# the time kernel at clips of 24 and 32 frames (--time32): the classes'
# kernel it replaced there (the --before copy's launch_time_classes), bf16
# and float32
TIME_VARIANTS = {
    "time_class": ("divided_attention.cuh", True, """
  return mdt::launch_time_classes<T>(qkv, sin_t, cos_t, out, B, F, N, H, dh,
                                     scale, st);
"""),
}
# the staged kernel at 8 frames padded to the frame class 16 (--time8), one
# instantiation per head-dim class from this checkout's header
TIME8_VARIANTS = {
    "time_padded": ("time_staged.cuh", False, """
  if (F != 8) return cudaErrorInvalidValue;
  switch (dh < 16 ? 16 : dh) {
    case 16: return mdt::launch_time_staged<16, 16, T>(
        qkv, sin_t, cos_t, out, B, F, N, H, dh, scale, st);
    case 32: return mdt::launch_time_staged<16, 32, T>(
        qkv, sin_t, cos_t, out, B, F, N, H, dh, scale, st);
    case 64: return mdt::launch_time_staged<16, 64, T>(
        qkv, sin_t, cos_t, out, B, F, N, H, dh, scale, st);
    case 128: return mdt::launch_time_staged<16, 128, T>(
        qkv, sin_t, cos_t, out, B, F, N, H, dh, scale, st);
  }
  return cudaErrorInvalidValue;
"""),
}
TIME_SOURCE = """#include "{header}"
using T = {type};
extern "C" {{
int time_ab(const void* qkv, const void* sin_t, const void* cos_t, void* out,
            int B, int F, int N, int H, int dh, float scale, void* stream) {{
  cudaStream_t st = static_cast<cudaStream_t>(stream);{body}}}
const char* kernel_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
}}
"""
SOURCE = """#include "{header}"
using T = {type};
extern "C" {{
int fused_attention_ab(const void* q, const void* k, const void* v, void* out,
                       int B, int Nq, int Nk, int D, float scale,
                       void* stream) {{
  cudaStream_t st = static_cast<cudaStream_t>(stream);{body}}}
const char* kernel_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
}}
"""


def build_variants(before: Path, variants=None, source=SOURCE,
                   bind=None, types=(("", "mdt::bf16"),
                                     ("_f32", "float"))) -> dict:
    """Build ``variants`` (default ``VARIANTS``) from ``source`` in bf16 and
    float32 under build/ab_classes/ and load them, each bound by ``bind``
    (default: the fused entry point): {"class", "class_f32", "wide",
    "wide_f32"} -> library, each in the element ``types`` (suffix, C++
    type). A variant marked so includes the headers of the
    copy at ``before``. Prints each kernel's registers and stack
    (``-Xptxas -v``), one JSON line per variant."""
    import ctypes

    from moditalker_tpu_torch.ops.kernels import _build
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    variants = VARIANTS if variants is None else variants
    bind = bind or (lambda lib: fa._bind(lib, "_ab"))
    out = ROOT / "build" / "ab_classes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    csrc_before = before / "moditalker_tpu_torch" / "csrc"
    for name, (header, old, body) in variants.items():
        for suffix, type_ in types:
            src = out / f"{name}{suffix}.cu"
            src.write_text(source.format(header=header, type=type_,
                                         body=body))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(csrc_before if old else _build.CSRC), "-o",
                   str(src.with_suffix(".so")), str(src)]
            procs[name + suffix] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        kernels, name = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "Used" in line and name:
                words = line.split()
                kernels.append({"kernel": name, "registers": int(
                    words[words.index("registers,") - 1]), "stack_bytes": int(
                    words[words.index("cumulative") - 2])
                    if "cumulative" in words else 0})
        print(json.dumps({"variant": key, "ptxas": kernels}), flush=True)
        lib = ctypes.CDLL(str(out / f"{key}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[key] = bind(lib)
    return libs


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--wide", action="store_true",
                    help="only the comparisons above head dim 32")
    ap.add_argument("--space", action="store_true",
                    help="only the space kernel's comparisons")
    ap.add_argument("--narrow", action="store_true",
                    help="only the bf16 one-pass and fused kernel at head "
                         "dims 40 to 56: the narrow tile against the "
                         "small-head class 64 it replaced")
    ap.add_argument("--time32", action="store_true",
                    help="only the time kernel at clips of 24 and 32 "
                         "frames: the staged kernel against the classes' "
                         "kernel it replaced")
    ap.add_argument("--time8", action="store_true",
                    help="only the time kernel at clips of 8 frames: the "
                         "staged kernel's two ways in against the classes' "
                         "kernel")
    ap.add_argument("--before", type=Path, default=ROOT / "build" / "before",
                    help="an earlier copy of the repository, whose headers "
                         "build the replaced designs")
    args = ap.parse_args()
    only = (args.wide or args.space or args.narrow or args.time32
            or args.time8)
    before = not only or args.wide or args.space or args.narrow or args.time32
    if before and not (
            args.before / "moditalker_tpu_torch" / "csrc" /
            "smallhead_tile.cuh").is_file():
        print(f"{args.before}: no earlier copy of the repository (git "
              f"archive 1f27cc7 | tar -x -C {args.before})", file=sys.stderr)
        return 2
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def run(name, shipped, cls, check):
        times = {"shipped": [], "class": []}
        for which in ("shipped", "class", "class", "shipped"):
            fn = shipped if which == "shipped" else cls
            times[which].append(chip_smoke.time_ms(torch, fn))
        a = sorted(times["shipped"])[0]
        b = sorted(times["class"])[0]
        errs = check()
        print(json.dumps({"case": name, "shipped_ms": times["shipped"],
                          "class_ms": times["class"],
                          "class_over_shipped": b / a,
                          "class_errors": [float(f"{e:.4g}") for e in errs]}),
              flush=True)

    def status(lib, rc, entry):
        if rc:
            raise RuntimeError(f"{entry}: {lib.kernel_error_string(rc)}")

    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    if not only:
        shipped_against_classes(torch, rnd, run, status)
    if args.wide or not only:
        wide_against_classes(torch, rnd, status, args.before)
    if args.space or not only:
        space_against_classes(torch, rnd, status, args.before)
    if args.narrow or not only:
        narrow_against_class(torch, rnd, status, args.before)
    if args.time32 or not only:
        time32_against_class(torch, rnd, status, args.before)
    if args.time8 or not only:
        time8_against_class(torch, rnd, status)
        time8_backward_against_class(torch, rnd, status)
    return 0


def shipped_against_classes(torch, rnd, run, status) -> None:
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    # time forward and backward: [B, 16, 1024, 3·8·64]
    sin, cos = (torch.from_numpy(t).cuda() for t in rotary.time_rotary_sincos(16, 64))
    for dtype, b in ((torch.bfloat16, 2), (torch.float32, 1)):
        f32 = dtype == torch.float32
        qkv = rnd(b, 16, 1024, 1536, dtype=dtype)
        out = torch.empty(b, 16, 1024, 512, dtype=dtype, device="cuda")

        def fwd(classes, out=out, qkv=qkv, f32=f32, b=b):
            lib, suffix = dv._library(f32, classes)
            entry = "divided_time_attention" + suffix
            status(lib, getattr(lib, entry)(
                qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(),
                b, 16, 1024, 8, 64, 0.125, cuda_stream(qkv)), entry)
            return out

        def check(qkv=qkv, fwd=fwd, f32=f32):
            got = fwd(True).clone()
            x = qkv.float()
            plain = dv.divided_attention_reference(x, sin, cos, "time", 8, 64,
                                                   0.125, use_flash=False)
            errs = check_bf16("divided_time_attention", got, plain)
            if f32:
                errs = check_float32_route(
                    "divided_time_attention", got,
                    dv.divided_attention_float32_route(x, sin, cos, "time", 8,
                                                       64, 0.125))
            return errs

        run(f"time {list(qkv.shape)} {dtype}".replace("torch.", ""),
            lambda fwd=fwd: fwd(False), lambda fwd=fwd: fwd(True), check)

        g = rnd(b, 16, 1024, 512, dtype=dtype)
        dqkv = torch.empty_like(qkv)

        def bwd(classes, qkv=qkv, g=g, dqkv=dqkv, f32=f32, b=b):
            lib, suffix = dv._library(f32, classes, backward=True)
            entry = "divided_time_attention_backward" + suffix
            status(lib, getattr(lib, entry)(
                qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(), g.data_ptr(),
                dqkv.data_ptr(), b, 16, 1024, 8, 64, 0.125, cuda_stream(qkv)),
                entry)
            return dqkv

        def check_bwd(qkv=qkv, g=g, bwd=bwd, f32=f32):
            got = bwd(True).clone()
            x = qkv.float()
            out = dv.divided_attention_reference(x, sin, cos, "time", 8, 64,
                                                 0.125, use_flash=False)
            args = (x, out, g.float(), sin, cos, "time", 8, 64, 0.125)
            errs = check_bf16("divided_time_attention_backward", got,
                              db.divided_attention_backward_reference(*args))
            if f32:
                errs = check_float32_route(
                    "divided_time_attention_backward", got,
                    db.divided_attention_backward_float32_route(*args))
            return errs

        run(f"time backward {list(qkv.shape)} {dtype}".replace("torch.", ""),
            lambda bwd=bwd: bwd(False), lambda bwd=bwd: bwd(True), check_bwd)

    # space float32 at head dim 64, N = 1024: the wgmma tile (resident K)
    # against the small-head tile with the rotary
    side = rotary.axial_rotary_sincos(32, 32, 64)
    ssin, scos = (torch.from_numpy(t).cuda() for t in side)
    table = dv.rotary_pair_table(ssin, scos)
    qkv = rnd(16, 1024, 1536, dtype=torch.float32)
    out = torch.empty(16, 1024, 512, device="cuda")

    def space(classes):
        lib, suffix = dv._library(True, classes)
        entry = "divided_space_attention" + suffix
        status(lib, getattr(lib, entry)(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), 16, 1024, 8, 64,
            0.125, cuda_stream(qkv)), entry)
        return out

    def check_space():
        got = space(True).clone()
        x = qkv.float().reshape(1, 16, 1024, 1536)
        plain = dv.divided_attention_reference(x, ssin, scos, "space", 8, 64,
                                               0.125, use_flash=False)
        check_bf16("divided_space_attention", got.reshape(plain.shape), plain)
        return check_float32_route(
            "divided_space_attention", got.reshape(plain.shape),
            dv.divided_attention_float32_route(x, ssin, scos, "space", 8, 64,
                                               0.125))

    run("space [16, 1024, 1536] float32", lambda: space(False),
        lambda: space(True), check_space)

    # tiny-L and one-pass at the configurations' shapes
    for dtype, b, l in ((torch.bfloat16, 16384, 16), (torch.float32, 81920, 16)):
        f32 = dtype == torch.float32
        q, k, v = (rnd(b, l, 64, dtype=dtype) for _ in range(3))
        o = torch.empty_like(q)

        def tiny(classes, q=q, k=k, v=v, o=o, f32=f32, b=b, l=l):
            if classes:
                lib = fa._classes_lib_f32() if f32 else fa._classes_lib()
                entry = "tiny_attention_classes" + ("_f32" if f32 else "")
            else:
                lib = fa._tiny_lib_f32() if f32 else fa._tiny_lib()
                entry = "tiny_attention" + ("_f32" if f32 else "")
            status(lib, getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
                64, 0.125, cuda_stream(q)), entry)
            return o

        def check_tiny(q=q, k=k, v=v, tiny=tiny, f32=f32):
            got = tiny(True).clone()
            x = [t.float() for t in (q, k, v)]
            errs = check_bf16("tiny_attention", got,
                              fa.tiny_attention_reference(*x, 0.125))
            if f32:
                errs = check_float32_route(
                    "tiny_attention", got, fa.attention_float32_route(*x, 0.125))
            return errs

        run(f"tiny-L [{b}, {l}, 64] {dtype}".replace("torch.", ""),
            lambda tiny=tiny: tiny(False), lambda tiny=tiny: tiny(True),
            check_tiny)

    for dtype, b, n, d in ((torch.bfloat16, 16, 2048, 32),
                           (torch.bfloat16, 16, 2048, 16),
                           (torch.bfloat16, 16, 2048, 64),
                           (torch.float32, 80, 1024, 32),
                           (torch.float32, 80, 2048, 16)):
        f32 = dtype == torch.float32
        q, k, v = (rnd(b, n, d, dtype=dtype) for _ in range(3))
        o = torch.empty_like(q)

        def onepass(classes, q=q, k=k, v=v, o=o, f32=f32, b=b, n=n, d=d):
            suffix = ("_classes" if classes else "") + ("_f32" if f32 else "")
            lib = {"": fa._lib, "_f32": fa._lib_f32,
                   "_classes": fa._classes_lib,
                   "_classes_f32": fa._classes_lib_f32}[suffix]()
            entry = "fused_attention" + suffix
            # the shipped float32 entry point's V scratch: none, its route
            scratch = [None] if entry == "fused_attention_f32" else []
            status(lib, getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *scratch,
                o.data_ptr(), b, n, n, d, d**-0.5, cuda_stream(q)), entry)
            return o

        def check_onepass(q=q, k=k, v=v, onepass=onepass, f32=f32, d=d):
            got = onepass(True).clone()
            x = [t.float() for t in (q, k, v)]
            errs = check_bf16("onepass_attention", got,
                              fa.onepass_attention_reference(*x, d**-0.5))
            if f32:
                errs = check_float32_route(
                    "onepass_attention", got,
                    fa.attention_float32_route(*x, d**-0.5))
            return errs

        run(f"one-pass [{b}, {n}, {d}] {dtype}".replace("torch.", ""),
            lambda f=onepass: f(False), lambda f=onepass: f(True),
            check_onepass)



def wide_against_classes(torch, rnd, status, before: Path) -> None:
    import chip_smoke
    from moditalker_tpu_torch.ops.kernels import (
        check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    # above head dim 32: the small-head class against the wgmma tile, and
    # the wgmma tile built for 64 against the configurations' tile
    ab = build_variants(before)
    cases = [("class", "wide", 16, 2048, d)
             for d in (40, 48, 56, 72, 80, 96, 112, 128)]
    cases += [("class", "wide", 4, 2048, 128),
              ("shipped", "wide", 16, 2048, 64),
              ("shipped", "wide", 128, 1024, 64)]
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        for first, second, b, n, d in cases:
            q, k, v = (rnd(b, n, d, dtype=dtype) for _ in range(3))
            o = torch.empty_like(q)
            # the wide tile above 64 is the library the wrappers load
            shipped_wide = d > 64
            libs = {"class": ab["class" + suffix],
                    "wide": ((fa._wide_lib_f32() if f32 else fa._wide_lib())
                             if shipped_wide else ab["wide" + suffix]),
                    "shipped": fa._lib_f32() if f32 else fa._lib()}
            entries = {"class": "fused_attention_ab",
                       "wide": ("fused_attention_wide" + suffix
                                if shipped_wide else "fused_attention_ab"),
                       "shipped": "fused_attention" + suffix}

            def tile(which, q=q, k=k, v=v, o=o, b=b, n=n, d=d, libs=libs,
                     entries=entries):
                lib, entry = libs[which], entries[which]
                # the shipped float32 entry point's V scratch: none, the
                # wgmma tile's route
                scratch = [None] if entry == "fused_attention_f32" else []
                status(lib, getattr(lib, entry)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), *scratch,
                    o.data_ptr(), b, n, n, d, d**-0.5, cuda_stream(q)), entry)
                return o

            times = {first: [], second: []}
            for which in (first, second, second, first):
                times[which].append(chip_smoke.time_ms(
                    torch, lambda t=tile, w=which: t(w)))
            x = [t.float() for t in (q, k, v)]
            errs, outs = {}, {}
            for which in (first, second):
                outs[which] = got = tile(which).clone()
                errs[which] = check_bf16("onepass_attention", got,
                                         fa.onepass_attention_reference(
                                             *x, d**-0.5))
                if f32:
                    errs[which] = check_float32_route(
                        "onepass_attention", got,
                        fa.attention_float32_route(*x, d**-0.5))
            a_ms, b_ms = min(times[first]), min(times[second])
            print(json.dumps({
                "case": f"one-pass [{b}, {n}, {d}] {dtype}".replace(
                    "torch.", ""),
                f"{first}_ms": times[first], f"{second}_ms": times[second],
                f"{second}_over_{first}": b_ms / a_ms,
                "faster": second if b_ms < a_ms else first,
                "equal_bit_for_bit": bool(torch.equal(outs[first],
                                                      outs[second])),
                "errors": {w: [float(f"{e:.4g}") for e in errs[w]]
                           for w in errs}}), flush=True)


def space_against_classes(torch, rnd, status, before: Path) -> None:
    import ctypes

    import torch.nn.functional as F

    import chip_smoke
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.space_ab.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.space_ab.restype = i
        return lib

    ab = build_variants(before, SPACE_VARIANTS, SPACE_SOURCE, bind)
    # (head dim, frames x batch, tokens): the AE's 512 channels
    cases = [(dh, 32, 1024) for dh in (128, 32, 16, 8, 4, 2)]
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        for dh, bf, n in cases + ([(64, 2, 2048)] if f32 else []):
            heads, scale = 512 // dh, dh**-0.5
            side = 32 if n == 1024 else 64
            if dh >= 4:
                sin, cos = (torch.from_numpy(t).cuda() for t in
                            rotary.axial_rotary_sincos(side, n // side, dh))
            else:   # the axial table has no entry below head dim 4
                g = torch.Generator().manual_seed(3)
                ang = (torch.rand(n, 1, generator=g) * 6 - 3).repeat(1, 2)
                sin, cos = ang.sin().cuda(), ang.cos().cuda()
            table = dv.rotary_pair_table(sin, cos)
            qkv = rnd(bf, n, 3 * heads * dh, dtype=dtype)
            out = torch.empty(bf, n, heads * dh, dtype=dtype, device="cuda")
            scratch = torch.empty(bf, n, 3 * heads * dv.space_scratch_width(
                dh), dtype=torch.bfloat16, device="cuda")
            new_lib = dv._classes_lib_f32() if f32 else dv._classes_lib()
            new_entry = "divided_space_attention_prerotated" + suffix

            def variant(name):
                lib = ab[name + suffix]
                status(lib, lib.space_ab(
                    qkv.data_ptr(), table.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), bf, n, heads, dh, scale,
                    cuda_stream(qkv)), name)
                return out

            def new():
                status(new_lib, getattr(new_lib, new_entry)(
                    qkv.data_ptr(), table.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), bf, n, heads, dh, scale,
                    cuda_stream(qkv)), new_entry)
                return out

            fns = {"class": lambda: variant("space_class"), "new": new}
            if dh in (16, 32):   # wgmma at n = dh, paired with the new
                fns["wide"] = lambda: variant("space_wide")
            times = {which: [] for which in fns}
            for which in ("class", "new", "new", "class"):
                times[which].append(chip_smoke.time_ms(torch, fns[which]))
            if "wide" in fns:
                for which in ("new", "wide", "wide", "new"):
                    times[which].append(chip_smoke.time_ms(torch,
                                                           fns[which]))
            x = qkv.float().reshape(1, bf, n, -1)
            plain = dv.divided_attention_reference(
                x, sin, cos, "space", heads, dh, scale, use_flash=False)
            route = dv.divided_attention_float32_route(
                x, sin, cos, "space", heads, dh, scale, exp2=True)
            errs, outs = {}, {}
            for which, fn in fns.items():
                outs[which] = got = fn().clone().reshape(plain.shape)
                errs[which] = check_bf16("divided_space_attention", got,
                                         plain)
                if f32:
                    errs[which] = check_float32_route(
                        "divided_space_attention", got, route)
            del plain, route, x
            # once each: the class without the rotary, the pre-pass alone,
            # the one-pass kernel at the head-split shape, the library call
            once = {}
            if dh >= 8:
                once["class_norot_ms"] = chip_smoke.time_ms(
                    torch, lambda: variant("space_norot"))
            once["prepass_ms"] = chip_smoke.time_ms(
                torch, lambda: variant("space_prepass"))
            q, k, v = (t.reshape(bf, n, heads, dh).transpose(1, 2)
                       for t in qkv.chunk(3, -1))
            q, k = rotary.apply_rot_emb(q, k, sin.to(dtype), cos.to(dtype))
            q, k, v = (t.contiguous() for t in (q, k, v))
            once["library_ms"] = chip_smoke.time_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                              scale=scale))
            if fa.onepass_attention_viable(n, n, dh):
                hs = [t.reshape(bf * heads, n, dh) for t in (q, k, v)]
                once["onepass_head_split_ms"] = chip_smoke.time_ms(
                    torch, lambda: fa.onepass_attention(*hs, scale))
            a_ms, b_ms = min(times["class"]), min(times["new"][:2])
            pair = {}
            if "wide" in fns:   # the second pair: new, wide, wide, new
                pair = {"wide_ms": times["wide"], "wide_over_new":
                        min(times["wide"]) / min(times["new"][2:])}
            print(json.dumps({
                "case": f"space [{bf}, {n}, {3 * heads * dh}] {heads} heads "
                        f"of {dh} {dtype}".replace("torch.", ""),
                "class_ms": times["class"], "new_ms": times["new"],
                "new_over_class": b_ms / a_ms,
                "faster": "new" if b_ms < a_ms else "class", **pair, **once,
                "new_equals_class_bit_for_bit": bool(torch.equal(
                    outs["new"], outs["class"])),
                "errors": {w: [float(f"{e:.4g}") for e in errs[w]]
                           for w in errs}}), flush=True)


def paired(torch, fns, first, second, times=None):
    """``fns[first]`` and ``fns[second]`` timed in turns (first, second,
    second, first; ``chip_smoke.time_ms`` each), added to ``times``."""
    import chip_smoke

    times = times if times is not None else {}
    for which in (first, second, second, first):
        times.setdefault(which, []).append(chip_smoke.time_ms(torch,
                                                              fns[which]))
    return times


def narrow_against_class(torch, rnd, status, before: Path) -> None:
    """The bf16 one-pass kernel at [16, 2048 | 1024, d] and [8, 2048, d]
    for d = 40, 48, 56, and the fused kernel at 48 over a whole and a short
    key tile (ragged query chunks), past resident K and with K resident:
    the small-head class 64 against the narrow tile (``fa.NARROW_ENTRY``),
    paired (class, new, new, class); the library call once. Each result
    held to the float32 plain version on its inputs (``check_bf16``). The
    class at
    d = 64 is timed once beside each [16, 2048, d] pair: what the class pays
    for a head of 64 columns (its padding). Last, the narrow tile built at
    64 (``narrow64``, never shipped) against the D = 64 tile at
    [16, 2048 | 1024, 64], in the rows' "class" place (ROADMAP G1)."""
    import torch.nn.functional as F

    import chip_smoke
    from moditalker_tpu_torch.ops.kernels import check_bf16, cuda_stream
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    ab = build_variants(before, NARROW_VARIANTS, types=BF16_ONLY)
    new_lib = fa._narrow_lib()
    cases = [(b, n, n, d) for d in fa.NARROW_HEAD_DIMS
             for b, n in ((16, 2048), (16, 1024), (8, 2048))]
    cases += [(16, 1000, 128, 48), (16, 1000, 120, 48), (16, 1280, 2048, 48),
              (16, 300, 1024, 48)]
    # the narrow tile built at 64 against the D = 64 tile (ROADMAP G1): "class"
    # is the D = 64 tile in these rows
    cases += [(16, 2048, 2048, 64), (16, 1024, 1024, 64)]
    bf16 = torch.bfloat16
    for b, nq, nk, d in cases:
        q = rnd(b, nq, d, dtype=bf16)
        k, v = rnd(b, nk, d, dtype=bf16), rnd(b, nk, d, dtype=bf16)
        o = torch.empty_like(q)
        sc = d**-0.5

        def call(lib, entry, q=q, k=k, v=v, o=o, b=b, nq=nq, nk=nk, d=d,
                 sc=sc):
            status(lib, getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, nq,
                nk, d, sc, cuda_stream(q)), entry)
            return o

        fns = {"class": lambda: call(ab["class64"], "fused_attention_ab"),
               "new": lambda: call(new_lib, fa.NARROW_ENTRY)}
        if d == 64:   # the D = 64 tile (the shipped library) is "class"
            fns["class"] = lambda: call(fa._lib(), "fused_attention")
            fns["new"] = lambda: call(ab["narrow64"], "fused_attention_ab")
        times = paired(torch, fns, "class", "new")
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        library_ms = chip_smoke.time_ms(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          scale=sc))
        once = {}
        if nq == nk == 2048 and b == 16 and d != 64:
            q64, k64, v64 = (rnd(b, nq, 64, dtype=bf16) for _ in range(3))
            o64 = torch.empty_like(q64)
            lib64 = ab["class64"]
            once["class_at_64_ms"] = chip_smoke.time_ms(
                torch, lambda: status(lib64, lib64.fused_attention_ab(
                    q64.data_ptr(), k64.data_ptr(), v64.data_ptr(),
                    o64.data_ptr(), b, nq, nk, 64, 0.125, cuda_stream(q64)),
                    "class at 64"))
        plain = fa.onepass_attention_reference(q.float(), k.float(),
                                               v.float(), sc)
        name = "onepass_attention" if nq == nk else "fused_attention"
        errs = {which: check_bf16(name, fn().clone(), plain)
                for which, fn in fns.items()}
        keys = min(nk, 128) if nk < 128 else nk
        bound, by = chip_smoke.bound_ms(2 * (2 * b * nq * d + 2 * b * nk * d),
                                        4.0 * b * nq * keys * d)
        a_ms, b_ms = min(times["class"]), min(times["new"][:2])
        print(json.dumps({
            "case": f"{name} q [{b}, {nq}, {d}] k/v [{b}, {nk}, {d}] bf16",
            "class_ms": times["class"], "new_ms": times["new"],
            "new_over_class": b_ms / a_ms,
            "faster": "new" if b_ms < a_ms else "class",
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "scores": b * nq * nk, **once,
            "errors": {w: [float(f"{e:.4g}") for e in errs[w]]
                       for w in errs}}), flush=True)


def time32_against_class(torch, rnd, status, before: Path) -> None:
    """The time kernel at clips of 32 and 24 frames, bf16 and float32: the
    classes' kernel (the --before copy's ``launch_time_classes``) against
    the staged kernel (``dv.STAGED_TIME_ENTRY``), bit for bit at every
    head-dim class; at qkv [2, 32 | 24, 1024, 1536] (8 heads of 64) paired
    (class, new, new, class), with the library call, the bound and each held
    to the float32 plain version (and in float32 to its route)."""
    import ctypes

    import torch.nn.functional as F

    import chip_smoke
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        bf16_rounded_share, check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.time_ab.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        lib.time_ab.restype = i
        return lib

    ab = build_variants(before, TIME_VARIANTS, TIME_SOURCE, bind)
    # (b, frames, tokens, heads, head dim); the first two timed
    cases = [(2, 32, 1024, 8, 64), (2, 24, 1024, 8, 64),
             (1, 32, 256, 16, 32), (1, 24, 256, 32, 16),
             (1, 32, 256, 64, 8), (1, 32, 256, 4, 128), (1, 24, 256, 4, 128),
             (1, 32, 256, 128, 4), (1, 24, 256, 256, 2)]
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        new_lib = dv._classes_lib_f32() if f32 else dv._classes_lib()
        entry = dv.STAGED_TIME_ENTRY + suffix
        for b, f, n, heads, dh in cases:
            sin, cos = (torch.from_numpy(t).cuda()
                        for t in rotary.time_rotary_sincos(f, dh))
            qkv = rnd(b, f, n, 3 * heads * dh, dtype=dtype)
            out = torch.empty(b, f, n, heads * dh, dtype=dtype,
                              device="cuda")
            sc = dh**-0.5

            def args(qkv=qkv, sin=sin, cos=cos, out=out, b=b, f=f, n=n,
                     heads=heads, dh=dh, sc=sc):
                # the stream read at each call: time_ms captures on its own
                return (qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                        out.data_ptr(), b, f, n, heads, dh, sc,
                        cuda_stream(qkv))

            lib = ab["time_class" + suffix]
            fns = {"class": lambda lib=lib, args=args, out=out: (status(
                       lib, lib.time_ab(*args()), "time class"), out)[1],
                   "new": lambda args=args, out=out: (status(
                       new_lib, getattr(new_lib, entry)(*args()), entry),
                       out)[1]}
            outs = {w: fn().clone() for w, fn in fns.items()}
            row = {"case": f"time [{b}, {f}, {n}, {3 * heads * dh}] {heads} "
                           f"heads of {dh} {dtype}".replace("torch.", ""),
                   "new_equals_class_bit_for_bit": bool(torch.equal(
                       outs["new"], outs["class"]))}
            if n == 1024:
                times = paired(torch, fns, "class", "new")
                x = qkv.float()
                plain = dv.divided_attention_reference(
                    x, sin, cos, "time", heads, dh, sc, use_flash=False)
                errs = check_bf16("divided_time_attention", outs["new"],
                                  plain)
                del plain
                if f32:
                    errs = check_float32_route(
                        "divided_time_attention", outs["new"],
                        dv.divided_attention_float32_route(
                            x, sin, cos, "time", heads, dh, sc))
                    row["bf16_rounded_share"] = bf16_rounded_share(
                        outs["new"])
                del x
                qh, kh, vh = (t.reshape(b, f, n, heads, dh).permute(
                    0, 2, 3, 1, 4).reshape(b * n, heads, f, dh)
                    for t in qkv.chunk(3, -1))
                qh, kh = rotary.apply_rot_emb(qh, kh, sin.to(dtype),
                                              cos.to(dtype))
                qh, kh, vh = (t.contiguous() for t in (qh, kh, vh))
                bound, by = chip_smoke.bound_ms(
                    (qkv.numel() + out.numel()) * qkv.element_size()
                    + 2 * sin.numel() * 4,
                    4.0 * b * n * heads * f * f * dh)
                a_ms, b_ms = min(times["class"]), min(times["new"])
                row.update({
                    "class_ms": times["class"], "new_ms": times["new"],
                    "new_over_class": b_ms / a_ms,
                    "faster": "new" if b_ms < a_ms else "class",
                    "library_ms": chip_smoke.time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, scale=sc)),
                    "bound_ms": bound, "bound_by": by,
                    "errors": [float(f"{e:.4g}") for e in errs]})
            print(json.dumps(row), flush=True)
            if not row["new_equals_class_bit_for_bit"]:
                raise AssertionError(f"{row['case']}: the staged kernel "
                                     f"differs from the class")



def time8_against_class(torch, rnd, status) -> None:
    """The time kernel at clips of 8 frames, bf16 and float32: the classes'
    kernel (``divided_time_attention_classes``, the frame class 16 padded)
    against the staged kernel padded the same way (``TIME8_VARIANTS``) and
    the staged kernel's two items a tile (``dv.STAGED_TIME_ENTRY``), each
    bit for bit against the class at every head-dim class, a last tile
    holding one item among them; at qkv [1, 8, 1024, 1536] (8 heads of 64)
    in turns (class, padded, pair, pair, padded, class), with the library
    call, the bound and each held to the float32 plain version (and in
    float32 to its route)."""
    import ctypes

    import torch.nn.functional as F

    import chip_smoke
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        bf16_rounded_share, check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.time_ab.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        lib.time_ab.restype = i
        return lib

    ab = build_variants(ROOT, TIME8_VARIANTS, TIME_SOURCE, bind)
    # (b, tokens, heads, head dim): every head-dim class, warps that walk
    # many items (heads of 4 and 2), an odd count of items
    cases = [(1, 1024, 8, 64), (1, 256, 16, 32), (1, 256, 32, 16),
             (1, 256, 64, 8), (1, 256, 4, 128), (1, 256, 128, 4),
             (1, 128, 256, 2), (2, 64, 2, 64), (1, 5, 3, 128)]
    f = 8
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        lib = dv._classes_lib_f32() if f32 else dv._classes_lib()
        entries = {"class": (lib, "divided_time_attention_classes" + suffix),
                   "padded": (ab["time_padded" + suffix], "time_ab"),
                   "pair": (lib, dv.STAGED_TIME_ENTRY + suffix)}
        for b, n, heads, dh in cases:
            sin, cos = (torch.from_numpy(t).cuda()
                        for t in rotary.time_rotary_sincos(f, dh))
            qkv = rnd(b, f, n, 3 * heads * dh, dtype=dtype)
            sc = dh**-0.5
            outs, fns = {}, {}
            for which, (lb, entry) in entries.items():
                out = torch.full((b, f, n, heads * dh), float("nan"),
                                 dtype=dtype, device="cuda")

                def call(lb=lb, entry=entry, out=out, qkv=qkv, sin=sin,
                         cos=cos, b=b, n=n, heads=heads, dh=dh, sc=sc):
                    status(lb, getattr(lb, entry)(
                        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                        out.data_ptr(), b, f, n, heads, dh, sc,
                        cuda_stream(qkv)), entry)
                    return out

                fns[which] = call
                outs[which] = call().clone()
            row = {"case": f"time [{b}, {f}, {n}, {3 * heads * dh}] {heads} "
                           f"heads of {dh} {dtype}".replace("torch.", ""),
                   **{f"{w}_equals_class_bit_for_bit": bool(torch.equal(
                       outs[w], outs["class"])) for w in ("padded", "pair")}}
            if n == 1024:
                times = {}
                for which in ("class", "padded", "pair", "pair", "padded",
                              "class"):
                    times.setdefault(which, []).append(
                        chip_smoke.time_ms(torch, fns[which]))
                x = qkv.float()
                errs = check_bf16("divided_time_attention", outs["pair"],
                                  dv.divided_attention_reference(
                                      x, sin, cos, "time", heads, dh, sc,
                                      use_flash=False))
                if f32:
                    errs = check_float32_route(
                        "divided_time_attention", outs["pair"],
                        dv.divided_attention_float32_route(
                            x, sin, cos, "time", heads, dh, sc))
                    row["bf16_rounded_share"] = bf16_rounded_share(
                        outs["pair"])
                qh, kh, vh = (t.reshape(b, f, n, heads, dh).permute(
                    0, 2, 3, 1, 4).reshape(b * n, heads, f, dh)
                    for t in qkv.chunk(3, -1))
                qh, kh = rotary.apply_rot_emb(qh, kh, sin.to(dtype),
                                              cos.to(dtype))
                qh, kh, vh = (t.contiguous() for t in (qh, kh, vh))
                bound, by = chip_smoke.bound_ms(
                    (qkv.numel() + outs["pair"].numel()) * qkv.element_size()
                    + 2 * sin.numel() * 4,
                    4.0 * b * n * heads * f * f * dh)
                best = {w: min(t) for w, t in times.items()}
                row.update({
                    **{f"{w}_ms": times[w] for w in times},
                    "pair_over_class": best["pair"] / best["class"],
                    "padded_over_class": best["padded"] / best["class"],
                    "faster": min(best, key=best.get),
                    "library_ms": chip_smoke.time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, scale=sc)),
                    "bound_ms": bound, "bound_by": by,
                    "errors": [float(f"{e:.4g}") for e in errs]})
            print(json.dumps(row), flush=True)



def time8_backward_against_class(torch, rnd, status) -> None:
    """The time backward at clips of 8 frames, bf16 and float32: the classes'
    kernel (``divided_time_attention_backward_classes``, the frame class 16
    padded and masked) against the staged kernel's two items a tile
    (``dv.STAGED_TIME_BACKWARD_ENTRY``), bit for bit at every head-dim
    class, a last tile holding one item among them; at qkv [1, 8, 1024,
    1536] (8 heads of 64) in turns (class, staged, staged, class), with the
    library's
    backward (``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention`` on the rotated, head-split q, k, v),
    the bound (qkv and g read, dqkv written, the tables) and each held to
    the float32 plain backward (and in float32 to its route)."""
    import torch.nn.functional as F

    import chip_smoke
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        bf16_rounded_share, check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db

    cases = [(1, 1024, 8, 64), (1, 256, 16, 32), (1, 256, 32, 16),
             (1, 256, 64, 8), (1, 256, 4, 128), (1, 256, 128, 4),
             (1, 128, 256, 2), (2, 64, 2, 64), (1, 5, 3, 128)]
    f = 8
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        lib = dv._bwd_classes_lib_f32() if f32 else dv._bwd_classes_lib()
        entries = {"class": (lib, "divided_time_attention_backward_classes"
                             + suffix),
                   "staged": (lib, dv.STAGED_TIME_BACKWARD_ENTRY + suffix)}
        for b, n, heads, dh in cases:
            sin, cos = (torch.from_numpy(t).cuda()
                        for t in rotary.time_rotary_sincos(f, dh))
            qkv = rnd(b, f, n, 3 * heads * dh, dtype=dtype)
            cot = rnd(b, f, n, heads * dh, dtype=dtype)
            sc = dh**-0.5
            outs, fns = {}, {}
            for which, (lb, entry) in entries.items():
                dqkv = torch.full_like(qkv, float("nan"))

                def call(lb=lb, entry=entry, dqkv=dqkv, qkv=qkv, cot=cot,
                         sin=sin, cos=cos, b=b, n=n, heads=heads, dh=dh,
                         sc=sc):
                    status(lb, getattr(lb, entry)(
                        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                        cot.data_ptr(), dqkv.data_ptr(), b, f, n, heads, dh,
                        sc, cuda_stream(qkv)), entry)
                    return dqkv

                fns[which] = call
                outs[which] = call().clone()
            row = {"case": f"time backward [{b}, {f}, {n}, "
                           f"{3 * heads * dh}] {heads} heads of {dh} "
                           f"{dtype}".replace("torch.", ""),
                   **{f"{w}_equals_class_bit_for_bit": bool(torch.equal(
                       outs[w], outs["class"])) for w in outs if w != "class"}}
            if n == 1024:
                times = {}
                for which in ("class", "staged", "staged", "class"):
                    times.setdefault(which, []).append(
                        chip_smoke.time_ms(torch, fns[which]))
                x = qkv.float()
                out = dv.divided_attention_reference(
                    x, sin, cos, "time", heads, dh, sc, use_flash=False)
                args = (x, out, cot.float(), sin, cos, "time", heads, dh, sc)
                name = "divided_time_attention_backward"
                errs = check_bf16(name, outs["staged"],
                                  db.divided_attention_backward_reference(
                                      *args))
                if f32:
                    errs = check_float32_route(
                        name, outs["staged"],
                        db.divided_attention_backward_float32_route(*args))
                    row["bf16_rounded_share"] = bf16_rounded_share(
                        outs["staged"])
                qh, kh, vh = (t.float().reshape(b, f, n, heads, dh).permute(
                    0, 2, 3, 1, 4).reshape(b * n, heads, f, dh)
                    for t in qkv.chunk(3, -1))
                qh, kh = rotary.apply_rot_emb(qh, kh, sin, cos)
                qh, kh, vh = (t.contiguous().requires_grad_()
                              for t in (qh, kh, vh))
                lo = F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
                lg = torch.randn(lo.shape, device="cuda")
                bound, by = chip_smoke.bound_ms(
                    (2 * qkv.numel() + cot.numel()) * qkv.element_size()
                    + 2 * sin.numel() * 4,
                    10.0 * b * n * heads * f * f * dh)
                best = {w: min(t) for w, t in times.items()}
                row.update({
                    **{f"{w}_ms": times[w] for w in times},
                    "staged_over_class": best["staged"] / best["class"],
                    "library_ms": chip_smoke.device_ms(
                        torch, lambda: torch.autograd.grad(
                            lo, (qh, kh, vh), lg, retain_graph=True)),
                    "bound_ms": bound, "bound_by": by,
                    "errors": [float(f"{e:.4g}") for e in errs]})
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
