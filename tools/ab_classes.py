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

    python3 tools/ab_classes.py       # from the repository root, on a card
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (
        check_bf16, check_float32_route, cuda_stream)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

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
            status(lib, getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n,
                n, d, d**-0.5, cuda_stream(q)), entry)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
