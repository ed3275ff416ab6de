"""How the tensor cores sum the kernels' scores, read off the kernels on one
card.

The float32 route rounds p to bf16 for P·V, so a score that differs from
the kernel's by one fp32 ulp now and then moves a p across its rounding
boundary and the whole output row with it: at a few thousand output rows
one such row decides the 0.999 quantile of ``FLOAT32_ROUTE_LIMITS``. This
runs the tiny-L and the one-pass/fused kernels (float32) on seeded inputs,
and the wgmma tile built per width past head dim 128 on random inputs and
on the masked-edge check's (``--wide``: these alone), and compares each
with the route's function computed from scores summed six ways: a
float32 ``matmul`` (cuBLAS), the exact sum rounded once, and the
tensor-core model of ``flash_attention.mma_products`` (per step of
``block`` products plus the accumulator, aligned to the largest, cut to
``bits`` bits, the sum rounded toward zero) at (16, 24..27) and (8, 26).
Prints, per case and variant, the output rows that differ from the
kernel's by more than 2e-6 of the output's peak and, of those, the rows
that hold a p (as the exact sum gives it) within 2e-6 of a bf16 rounding
midpoint, and the three measures of ``relative_errors``, and the same for
``attention_float32_route`` itself, with ``exp`` and with ``exp2``
(the kernels' ex2); per case, the
rows a thousandth of the output holds (as many rows off decide the
quantile measure). ``--space``: the float32 divided space kernels alone,
each at two frames of qkv [1, 2, N, 3·H·dh]: the configurations' D = 64
tile (8 heads of 64, 1024 tokens) and the pre-rotated design (4 heads of
128, 16 of 32 and 32 of 16 over 1024 tokens, 8 of 64 over 2048), against
the same routes from the rotated q and k (the rotary in fp32, each product
and sum rounded, as ``divided_attention_float32_route`` takes it); then the
three measures ``FLOAT32_ROUTE_LIMITS`` bounds, against the route with
``exp2`` and with ``exp``, over seeds 0–3 at the float32 space shapes of
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (one JSON line each, and
the largest reading per design last). ``--space --fma``: also against the
``exp2`` route with the rotary contracted into FMAs, both ways nvcc may
contract ``a·c − b·s`` (and ``b·c + a·s``): the first product or the second
kept exact and the other rounded before the one rounding of the sum (the
exact product in float64, rounded once: a true FMA but for rare double
roundings). The tile that rounds as the plain rotary does should sit on
the plain route and off these. ``--prerounded``: the float32 one-pass and
fused kernels at head dim 64 past resident K (the pre-pass and the bf16 K
ring, ``fused_attention_f32_prerounded``, forced at every shape), the three
measures against ``attention_float32_route`` with ``exp2`` and with
``exp`` over seeds 0–3 at the shapes of ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` (one JSON line each, the largest reading last).

    python3 tools/mma_sum.py [--seeds 3] [--wide | --space [--fma] |
                             --prerounded]          # repo root, on a card
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

L2E = 1.4426950408889634


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--wide", action="store_true",
                    help="only the wgmma tile built per width")
    ap.add_argument("--space", action="store_true",
                    help="only the divided space kernels")
    ap.add_argument("--fma", action="store_true",
                    help="with --space: also the routes with an FMA rotary")
    ap.add_argument("--prerounded", action="store_true",
                    help="only the float32 one-pass and fused kernels past "
                         "resident K")
    args = ap.parse_args()
    import torch

    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import QUANTILE, relative_errors

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    def model(q, k, block, bits):
        q, k = q.double(), k.double()
        acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float64,
                          device=q.device)
        for c in range(0, q.shape[-1], block):
            terms = torch.cat([acc[..., None], q[..., :, None, c:c + block]
                               * k[..., None, :, c:c + block]], dim=-1)
            _, e = torch.frexp(terms.abs().amax(dim=-1, keepdim=True))
            ulp = torch.ldexp(torch.ones_like(terms[..., :1]), e - bits)
            acc = fa._round_to_zero32((torch.trunc(terms / ulp) * ulp).sum(-1))
        return acc.float()

    variants = {
        "float32 matmul": lambda q, k: torch.matmul(q, k.transpose(-1, -2)),
        "exact": lambda q, k: torch.matmul(q.double(),
                                           k.double().transpose(-1, -2)).float(),
        **{f"block 16, {b} bits": (lambda q, k, b=b: model(q, k, 16, b))
           for b in (24, 25, 26, 27)},
        "block 8, 26 bits": lambda q, k: model(q, k, 8, 26)}

    def route(s, v, ex2, tile):
        # attention_float32_route from the scores on: the kernels' online
        # softmax over `tile`-key tiles; ex2: p = 2^(s·log2e − m·log2e), the
        # small-head and wgmma tiles' form (tiny-L takes expf)
        v = v.float().bfloat16().float()
        m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=s.device)
        rs = torch.zeros_like(m)
        out = torch.zeros(s.shape[:-1] + v.shape[-1:], device=s.device)
        near = torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)
        for j in range(0, s.shape[-1], tile):
            sj = s[..., j:j + tile]
            mn = torch.maximum(m, sj.amax(-1, keepdim=True))
            if ex2:
                a = torch.exp2((m - mn) * L2E)
                p = torch.exp2((sj.double() * L2E - (mn * L2E).double()).float())
            else:
                a, p = torch.exp(m - mn), torch.exp(sj - mn)
            rs = rs * a + p.sum(-1, keepdim=True)
            out = out * a + torch.matmul(p.bfloat16().float(),
                                         v[..., j:j + tile, :])
            m = mn
            # p within 2e-6 of the midpoint between two bf16 neighbours
            mid = ((p.contiguous().view(torch.int32) & ~0xFFFF) | 0x8000
                   ).view(torch.float32)
            near |= ((p - mid).abs() <= 2e-6 * p).any(-1)
        return out / rs, near

    def case(tag, got, q, k, v, scale, ex2):
        qs = (q * scale).bfloat16().float()
        kb = k.bfloat16().float()
        tile = fa.key_tile(q.shape[-1]) if ex2 else 128
        rows = got.numel() // got.shape[-1]
        # the output rows a thousandth of the output holds: as many rows
        # off (each moved as a whole) decide the quantile measure
        print(f"{tag}: {rows} rows, {tile}-key tiles, the quantile's "
              f"thousandth {(1 - QUANTILE) * rows:.2f} rows", flush=True)
        _, near = route(variants["exact"](qs, kb), v, ex2, tile)
        # the six sums, then the route function itself (its scores are
        # mma_products'), with exp and with the kernels' ex2
        routes = {name: (lambda s=scores: route(s(qs, kb), v, ex2, tile)[0])
                  for name, scores in variants.items()}
        routes["route, exp"] = lambda: fa.attention_float32_route(
            q, k, v, scale)
        routes["route, exp2"] = lambda: fa.attention_float32_route(
            q, k, v, scale, exp2=True)
        for name, r in routes.items():
            r = r()
            off = (got - r).abs().amax(-1) > 2e-6 * r.abs().max()
            print("   %-18s rows off %5d (near a midpoint %5d)  max %.3e "
                  "rms %.3e quantile %.3e"
                  % (name, off.sum().item(), (off & near).sum().item(),
                     *relative_errors(got, r)), flush=True)

    if args.prerounded:
        prerounded_limits(torch)
        return 0
    if args.space:
        from moditalker_tpu_torch.ops import rotary
        from moditalker_tpu_torch.ops.kernels import divided_attention as dv

        for seed in range(args.seeds):
            for heads, dh, n in ((8, 64, 1024), (4, 128, 1024),
                                 (16, 32, 1024), (32, 16, 1024),
                                 (8, 64, 2048)):
                g = torch.Generator(device="cuda").manual_seed(seed)
                sin, cos = (torch.from_numpy(t).cuda() for t in
                            rotary.axial_rotary_sincos(32, n // 32, dh))
                qkv = torch.randn(1, 2, n, 3 * heads * dh, generator=g,
                                  device="cuda")
                got = dv.divided_attention(qkv, sin, cos, "space", heads,
                                           dh, dh**-0.5)

                def split(t):   # [1, 2, N, H·dh] -> [2, H, N, dh]
                    return t.reshape(2, n, heads, dh).transpose(1, 2)

                q, k, v = (split(t) for t in qkv.chunk(3, -1))
                q, k = rotary.apply_rot_emb(q, k, sin, cos)
                design = ("pre-rotated" if dv.space_prerotated(dh, n, True)
                          else "D = 64 tile")
                case(f"space [1, 2, {n}, {3 * heads * dh}] {heads} heads of "
                     f"{dh} float32 ({design}), seed {seed}", split(got), q,
                     k, v, dh**-0.5, True)
        space_limits(torch, args.fma)
        return 0
    for seed in range(args.seeds):
        if not args.wide:
            for b, l, d in ((130, 32, 128), (4224, 24, 128), (4096, 32, 64),
                            (4096, 16, 64)):
                g = torch.Generator(device="cuda").manual_seed(seed)
                q, k, v = (torch.randn(b, l, d, generator=g, device="cuda")
                           for _ in range(3))
                case(f"tiny-L {[b, l, d]} float32, seed {seed}",
                     fa.tiny_attention(q, k, v, d**-0.5), q, k, v, d**-0.5,
                     False)
            for b, nq, nk, d in ((3, 64, 64, 120), (3, 64, 64, 128),
                                 (2, 200, 2048, 128), (1, 1024, 1024, 120),
                                 (3, 64, 64, 56), (3, 64, 64, 64),
                                 (2, 1024, 1024, 64), (2, 1024, 1024, 32)):
                g = torch.Generator(device="cuda").manual_seed(seed)
                q = torch.randn(b, nq, d, generator=g, device="cuda")
                k, v = (torch.randn(b, nk, d, generator=g, device="cuda")
                        for _ in range(2))
                case(f"fused q {[b, nq, d]} k {[b, nk, d]} float32, "
                     f"seed {seed}", fa.fused_attention(q, k, v), q, k, v,
                     d**-0.5, True)
        # the wgmma tile built per width (64-key tiles past head dim 128;
        # past 256 groups of 256 output columns): random inputs, and the
        # masked-edge inputs of the card test and chip_smoke.py (q and k
        # about one direction of opposite signs, scores about -7; a short
        # last key tile)
        for b, nq, nk, d, tight in ((2, 130, 512, 512, False),
                                    (8, 1000, 512, 512, False),
                                    (4, 1000, 384, 256, False),
                                    (2, 1000, 120, 256, True),
                                    (2, 1000, 40, 256, True)):
            g = torch.Generator(device="cuda").manual_seed(seed)
            randn = lambda *shape: torch.randn(shape, generator=g,
                                               device="cuda")
            if tight:
                c = 0.66 * randn(1, 1, d)
                q, k = c + 0.5 * randn(b, nq, d), -c + 0.5 * randn(b, nk, d)
            else:
                q, k = randn(b, nq, d), randn(b, nk, d)
            v = randn(b, nk, d)
            case(f"fused q {[b, nq, d]} k {[b, nk, d]} float32"
                 f"{', scores about -7' if tight else ''}, seed {seed}",
                 fa.fused_attention(q, k, v), q, k, v, d**-0.5, True)
    return 0


def fma_rotary(x, sin, cos, first: bool):
    """The rotary on [..., N, dh] with each pair's two sums contracted into
    an FMA: ``first``, fma(a, c, −fl(b·s)) and fma(b, c, fl(a·s)); else
    fma(−b, s, fl(a·c)) and fma(a, s, fl(b·c)). The fused product is exact
    in float64; the sum is rounded to float32 once."""
    import torch

    a, b = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., 0::2], sin[..., 0::2]

    def fma(u, w, rest):
        return (u.double() * w.double() + rest.double()).float()

    if first:
        x0, x1 = fma(a, c, -(b * s)), fma(b, c, a * s)
    else:
        x0, x1 = fma(-b, s, a * c), fma(a, s, b * c)
    return torch.stack((x0, x1), dim=-1).flatten(-2)


def space_limits(torch, fma: bool = False) -> None:
    """The float32 space kernels' three measures against their route, with
    ``exp2`` and with ``exp`` (``fma``: also ``exp2`` with each FMA form of
    the rotary), over seeds 0–3 at the card tests' shapes (axial tables, or
    angles drawn per pair as the classes' tests draw them) and the kernels
    phase's."""
    import json

    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import relative_errors
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    def fma_route(x, sin, cos, heads, dh, first):
        b, f, n, _ = x.shape
        q, k, v = (t.reshape(b, f, n, heads, dh).permute(0, 3, 1, 2, 4)
                   for t in x.chunk(3, dim=-1))
        q, k = (fma_rotary(t, sin, cos, first) for t in (q, k))
        out = fa.attention_float32_route(q, k, v, dh**-0.5, exp2=True)
        return out.permute(0, 2, 3, 1, 4).reshape(b, f, n, heads * dh)

    def axial(n, dh):
        side = 1 << (n.bit_length() - 1) // 2
        while n % side:
            side //= 2
        return [torch.from_numpy(t).cuda()
                for t in rotary.axial_rotary_sincos(side, n // side, dh)]

    def pairs(n, dh, seed):
        g = torch.Generator().manual_seed(seed)
        ang = (torch.rand(n, dh // 2, generator=g) * 6 - 3).repeat_interleave(
            2, dim=-1)
        return ang.sin().cuda(), ang.cos().cuda()

    # (b, f, n, heads, dh, table)
    cases = [(2, 2, 1024, 8, 64, "axial"), (1, 1, 1152, 2, 64, "axial"),
             (2, 16, 1024, 8, 64, "axial"), (1, 16, 1024, 8, 64, "axial"),
             (1, 1, 256, 2, 64, "axial"), (10, 16, 1024, 8, 64, "axial"),
             (2, 16, 1024, 4, 128, "axial"), (2, 16, 1024, 16, 32, "axial"),
             (2, 16, 1024, 32, 16, "axial"), (2, 1, 2048, 8, 64, "axial"),
             (1, 2, 256, 1, 128, "pairs"), (1, 1, 1024, 4, 32, "pairs"),
             (2, 1, 512, 8, 16, "pairs"), (1, 1, 256, 16, 8, "pairs"),
             (1, 1, 384, 32, 4, "pairs"), (1, 1, 256, 64, 2, "pairs"),
             (1, 1, 2048, 1, 128, "pairs"), (2, 2, 1024, 4, 128, "pairs"),
             (1, 1, 1280, 2, 64, "pairs"), (1, 2, 2048, 2, 64, "pairs")]
    worst = {}
    for seed in range(4):
        for b, f, n, heads, dh, tab in cases:
            g = torch.Generator(device="cuda").manual_seed(seed)
            sin, cos = axial(n, dh) if tab == "axial" else pairs(n, dh, seed)
            x = torch.randn((b, f, n, 3 * heads * dh), generator=g,
                            device="cuda")
            got = dv.divided_attention(x, sin, cos, "space", heads, dh,
                                       dh**-0.5)
            design = ("pre-rotated" if dv.space_prerotated(dh, n, True)
                      else "D = 64 tile")
            errs = {}
            for route in ("exp2", "exp") + (("exp2, fma first",
                                              "exp2, fma second")
                                             if fma else ()):
                if route.startswith("exp2, fma"):
                    want = fma_route(x, sin, cos, heads, dh,
                                     route.endswith("first"))
                else:
                    want = dv.divided_attention_float32_route(
                        x, sin, cos, "space", heads, dh, dh**-0.5,
                        exp2=route == "exp2")
                errs[route] = relative_errors(got, want)
                w = worst.setdefault(f"{design}, {route}", [0.0] * 3)
                worst[f"{design}, {route}"] = [max(a, e) for a, e in
                                               zip(w, errs[route])]
            print(json.dumps({"seed": seed, "shape": [b, f, n], "heads":
                              [heads, dh], "design": design, **errs}),
                  flush=True)
    print(json.dumps({"largest": worst}), flush=True)


def prerounded_limits(torch) -> None:
    """The float32 one-pass and fused kernels past resident K, forced at
    every shape here, against ``attention_float32_route`` with ``exp2`` and
    with ``exp``: the three measures of ``relative_errors`` over seeds 0–3
    at (B, Nq, Nk) of the card tests and the kernels phase."""
    import json

    from moditalker_tpu_torch.ops.kernels import relative_errors
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    fa.onepass_f32_prerounded = lambda *a: True
    cases = [(80, 2048, 2048), (2, 1280, 1280), (8, 1536, 1536),
             (16, 2048, 2048), (16, 1280, 2048), (16, 1000, 2048),
             (2, 300, 1280)]
    worst = {}
    for seed in range(4):
        for b, nq, nk in cases:
            g = torch.Generator(device="cuda").manual_seed(seed)
            q = torch.randn(b, nq, 64, generator=g, device="cuda")
            k, v = (torch.randn(b, nk, 64, generator=g, device="cuda")
                    for _ in range(2))
            got = fa.fused_attention(q, k, v, 0.125)
            errs = {}
            for route in ("exp2", "exp"):
                errs[route] = relative_errors(got, fa.attention_float32_route(
                    q, k, v, 0.125, exp2=route == "exp2"))
                worst[route] = [max(a, e) for a, e in
                                zip(worst.get(route, [0.0] * 3), errs[route])]
            print(json.dumps({"seed": seed, "shape": [b, nq, nk], **errs}),
                  flush=True)
    print(json.dumps({"largest": worst}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
