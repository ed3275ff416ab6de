#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, each of which must pass (any failure exits nonzero, and the final
``{"ok": true, ...}`` line is printed only after all of them):

1. build   — compile every kernel source (``moditalker_tpu_torch/csrc``),
             one nvcc per source, all started together;
2. kernels — each hand-written kernel against its plain PyTorch version at
             the main path's shapes in bf16 (max and rms error, relative to
             the plain output's, within the kernel's ``BF16_LIMITS``),
             timed with CUDA events beside the plain
             version, one PyTorch library call computing the same attention
             (``library_ms``, a yardstick the port never calls) and the
             card's bound;
3. reference — one DDIM-2 window at a small depth but full spatial size (so
             every kernel gate passes) on the card in bf16 against the same
             weights and draws on the CPU in float32 through the plain path,
             within REF_FACTOR times the error of a bf16 CPU run;
4. main path — at the full shipped width with weights drawn from ``--seed``:
             ``sample_independent`` over 2 windows at batch 2 (DDIM-100) and
             the fast-mode ``sample_long`` over 3 autoregressive windows at
             B = 1 (renoise ratio 0.25 from the reference window), each
             timed warm, after one untimed run of the same call. Every
             kernel's launch counter is zeroed just before each path and must
             be above zero just after; outputs must be uint8 frames of the
             right shape that are not constant;
5. profile — one UNet step, one extract and one decode at B = 2: host
             time, the device's busy time and top kernels (torch.profiler).

Without a CUDA device, or run outside the repository, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# window on the card (bf16, kernels) vs the CPU in fp32 (plain path): the
# card's error may be at most this many times that of the CPU's own bf16 run
REF_FACTOR = 2.0

H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def kernel_phase(torch, batch: int, seed: int) -> list[dict]:
    import torch.nn.functional as F

    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import BF16_LIMITS, check_bf16
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, dh, f, n = 8, 64, 16, 1024        # shipped AE: 256², patch 8
    hd = heads * dh
    scale = dh**-0.5

    def errors(name, kern, plain):
        out, want = kern(), plain()
        rel_max, rel_rms = check_bf16(name, out, want)
        return dict(max_abs_err=(out.float() - want.float()).abs().max().item(),
                    rel_max_err=rel_max, rel_rms_err=rel_rms)

    def tables(sin_cos):
        return [torch.from_numpy(t).to(dev) for t in sin_cos]

    def head_split_rotated(qkv, sin, cos, axis):
        """q, k (rotated), v as [seqs, H, seq, dh] for the library call."""
        b_, f_, n_, _ = qkv.shape
        q, k, v = (t.reshape(b_, f_, n_, heads, dh) for t in qkv.chunk(3, -1))
        if axis == "space":
            q, k, v = (t.permute(0, 1, 3, 2, 4).reshape(b_ * f_, heads, n_, dh)
                       for t in (q, k, v))
        else:
            q, k, v = (t.permute(0, 2, 3, 1, 4).reshape(b_ * n_, heads, f_, dh)
                       for t in (q, k, v))
        q, k = rotary.apply_rot_emb(q, k, sin.bfloat16(), cos.bfloat16())
        return q.contiguous(), k.contiguous(), v.contiguous()

    rows = []
    s_sin, s_cos = tables(rotary.axial_rotary_sincos(32, 32, dh))
    t_sin, t_cos = tables(rotary.time_rotary_sincos(f, dh))
    for axis, sin, cos in (("space", s_sin, s_cos), ("time", t_sin, t_cos)):
        qkv = torch.randn((batch, f, n, 3 * hd), generator=gen,
                          device=dev).bfloat16()
        kern = lambda: dv.divided_attention(qkv, sin, cos, axis, heads, dh, scale)
        plain = lambda: dv.divided_attention_reference(
            qkv, sin, cos, axis, heads, dh, scale, use_flash=False)
        name = f"divided_{axis}_attention"
        err = errors(name, kern, plain)
        q, k, v = head_split_rotated(qkv, sin, cos, axis)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        seq = n if axis == "space" else f
        nseq = batch * f * n // seq
        nbytes = qkv.numel() * 2 + batch * f * n * hd * 2 + 2 * sin.numel() * 4
        flops = 4.0 * nseq * heads * seq * seq * dh
        rows.append(dict(
            name=name, route="cuda",
            source="moditalker_tpu_torch/csrc/divided_attention.cu",
            replaces=("moditalker_tpu/ops/pallas/divided_attention.py:121"
                      if axis == "space" else
                      "moditalker_tpu/ops/pallas/divided_attention.py:177"),
            shape=list(qkv.shape), **err,
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lib), nbytes=nbytes, flops=flops))

    c, l = 128, 2048                        # UNet joint attention at ds = 1
    for ll in (1024, l):                    # xy-plane attention, then joint
        qkv = torch.randn((batch, ll, 3 * c), generator=gen,
                          device=dev).bfloat16()
        kern = lambda: pk.packed_attention(qkv, heads, (c // heads) ** -0.5)
        plain = lambda: pk.packed_attention_reference(
            qkv, heads, (c // heads) ** -0.5)
        err = errors("packed_attention", kern, plain)
        if ll != l:
            log(f"packed_attention at [{batch}, {ll}, {3 * c}]: max abs err "
                f"{err['max_abs_err']:.3e}, relative max "
                f"{err['rel_max_err']:.3e}, rms {err['rel_rms_err']:.3e}")
    q, k, v = (t.reshape(batch, l, heads, c // heads).transpose(1, 2).contiguous()
               for t in qkv.chunk(3, -1))
    lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                 scale=(c // heads) ** -0.5)
    rows.append(dict(
        name="packed_attention", route="cuda",
        source="moditalker_tpu_torch/csrc/packed_attention.cu",
        replaces="moditalker_tpu/ops/pallas/packed_attention.py:78",
        shape=list(qkv.shape), **err,
        ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lib),
        nbytes=qkv.numel() * 2 + batch * l * c * 2,
        flops=4.0 * batch * heads * l * l * (c // heads)))

    # one-pass: the UNet joint attention right after the last upsample
    # (C = 256, 8 heads → [B·8, 2048, 32])
    d = 32
    q, k, v = (torch.randn((batch * heads, l, d), generator=gen,
                           device=dev).bfloat16() for _ in range(3))
    kern = lambda: fa.onepass_attention(q, k, v, d**-0.5)
    plain = lambda: fa.onepass_attention_reference(q, k, v, d**-0.5)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5)
    rows.append(dict(
        name="onepass_attention", route="cuda",
        source="moditalker_tpu_torch/csrc/flash_attention.cu",
        replaces="moditalker_tpu/ops/pallas/flash_attention.py:104",
        shape=list(q.shape), **errors("onepass_attention", kern, plain),
        ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lib), nbytes=4 * q.numel() * 2,
        flops=4.0 * batch * heads * l * l * d))

    for row in rows:
        row["bound_ms"], row["bound_by"] = bound_ms(row.pop("nbytes"),
                                                    row.pop("flops"))
        log(f"{row['name']} at {row['shape']}: max abs err "
            f"{row['max_abs_err']:.3e}, relative max {row['rel_max_err']:.3e}"
            f" and rms {row['rel_rms_err']:.3e} (limits "
            f"{BF16_LIMITS[row['name']]}), kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


# ------------------------------------------------------------------ models
def random_states(torch, ae_cfg, unet_cfg, seed: int):
    """State dicts of two AEs (rgb, landmark) and the UNet, drawn from
    ``seed`` on the CPU."""
    from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder

    torch.manual_seed(seed)
    return (ViTAutoencoder(ae_cfg).state_dict(),
            ViTAutoencoder(ae_cfg).state_dict(),
            TriplaneUNet(unet_cfg).state_dict())


def make_windows(cfg, n: int, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.timesteps, cfg.resolution, cfg.resolution, 3)
    return [{k: rng.integers(0, 256, shape, dtype=np.uint8)
             for k in ("x_l", "masked_x", "x_ref")} for _ in range(n)]


def reference_phase(torch, seed: int) -> None:
    """A small-depth window on the card (bf16, kernels) against the CPU in
    float32 (plain path), with the same weights and the same draws. The
    same window on the CPU in bf16 (plain path) measures what bf16 alone
    costs; the card may differ from float32 by at most REF_FACTOR times
    that, in mean and in max."""
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovUNetConfig)
    from moditalker_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    # channel_mult (1, 2): the last upsample lands C = 256 at ds = 1, so the
    # joint attention there takes the one-pass kernel, as in the full UNet
    unet_cfg = MtovUNetConfig(num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,))
    diff_cfg = MtovDiffusionConfig(sampling_timesteps=2)
    states = random_states(torch, ae_cfg, unet_cfg, seed)
    w = make_windows(ae_cfg, 1, 1, seed)[0]
    outs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32),
                          ("cpu", torch.bfloat16)):
        pipe = MtovSamplePipeline(*states, ae_cfg, unet_cfg, diff_cfg,
                                  dtype=dtype, device=device)
        g = torch.Generator().manual_seed(seed)
        draws = lambda shape, dt, g=g: torch.randn(shape, generator=g)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.window_step(w["x_l"], w["masked_x"], w["x_ref"], draws)
        outs[device, dtype] = out.float().cpu()
        log(f"reference window on {device} ({dtype}): "
            f"{time.perf_counter() - t0:.2f} s, launches {dict(LAUNCHES)}")
        if device == "cuda" and not all(LAUNCHES.values()):
            raise AssertionError(f"a kernel did not launch: {LAUNCHES}")
    fp32 = outs["cpu", torch.float32]
    card = (outs["cuda", torch.bfloat16] - fp32).abs()
    bf16 = (outs["cpu", torch.bfloat16] - fp32).abs()
    log(f"reference vs cpu fp32, decoded video: card bf16 mean abs "
        f"{card.mean().item():.3e} max {card.max().item():.3e}; cpu bf16 "
        f"mean abs {bf16.mean().item():.3e} max {bf16.max().item():.3e} "
        f"(card within {REF_FACTOR}x)")
    if not (torch.isfinite(outs["cuda", torch.bfloat16]).all()
            and card.mean() <= REF_FACTOR * bf16.mean()
            and card.max() <= REF_FACTOR * bf16.max()):
        raise AssertionError("card window disagrees with the CPU reference")


def check_frames(video, frames: int, cfg, what: str) -> None:
    want = (1, frames, cfg.resolution, cfg.resolution, 3)
    if video.dtype != np.uint8 or video.shape != want:
        raise AssertionError(f"{what}: got {video.dtype} {video.shape}, "
                             f"want uint8 {want}")
    per_window = video.reshape(-1, cfg.timesteps, *want[2:])
    if any(int(w.max()) == int(w.min()) for w in per_window):
        raise AssertionError(f"{what}: a window is constant")


def main_path_phase(torch, seed: int) -> dict:
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovUNetConfig)
    from moditalker_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg, unet_cfg = MtovAEConfig(), MtovUNetConfig()
    diff_cfg = MtovDiffusionConfig(sampling_timesteps=100, w=0.0)
    t0 = time.perf_counter()
    pipe = MtovSamplePipeline(*random_states(torch, ae_cfg, unet_cfg, seed),
                              ae_cfg, unet_cfg, diff_cfg)
    log(f"full-width pipeline built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    launches = {}

    def drive(name, fn, frames):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[name] = dict(LAUNCHES)
        log(f"{name}: {frames} frames in {dt:.3f} s = {frames / dt:.3f} "
            f"frames/s; launches {launches[name]}")
        if not all(LAUNCHES.values()):
            raise AssertionError(f"{name}: a kernel did not launch: {LAUNCHES}")
        check_frames(video, frames, ae_cfg, name)
        return frames / dt

    t = ae_cfg.timesteps
    # each path runs twice: the first pass meets its shapes for the first
    # time (cuBLAS/cuDNN plans, the allocator) and is not timed
    for label in ("sample_independent (warm-up)", "sample_independent"):
        fps_ind = drive(label, lambda: pipe.sample_independent(
            make_windows(ae_cfg, 2, 1, seed), gen, batch=2), 2 * t)
    for label in ("sample_long (warm-up)", "sample_long"):
        fps_long = drive(label, lambda: pipe.sample_long(
            make_windows(ae_cfg, 3, 1, seed + 1), gen,
            noised_start_ratio=0.25, noised_start_source="ref"), 3 * t)
    return {"launches": launches, "sample_independent_fps": fps_ind,
            "sample_long_fps": fps_long, "pipe": pipe}


def profile_phase(torch, pipe, seed: int) -> dict:
    """Where a window's time goes: one UNet step at B = 2 and one AE extract
    and decode at B = 2, each timed on the host clock (after a warm-up, over
    3 runs, synchronised) and traced once with torch.profiler for the
    device's busy time, its kernel count and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(seed)
    cfg = pipe.ae_cfg
    b, L = 2, cfg.latent_len
    x = torch.randn((b, 4, L), generator=g, device="cuda")
    cond = torch.randn((b, 8, L), generator=g, device="cuda").bfloat16()
    ic = torch.randn((b, 4, L), generator=g, device="cuda").bfloat16()
    t = torch.full((b,), 500, dtype=torch.long, device="cuda")
    video = torch.randint(0, 256, (b, cfg.timesteps, cfg.resolution,
                                   cfg.resolution, 3), generator=g,
                          device="cuda", dtype=torch.uint8)
    parts = {
        "unet_step": lambda: pipe.ddpm.model(x, cond, ic, t),
        "extract": lambda: pipe.ae_rgb.extract(pipe._in(video)),
        "decode": lambda: pipe.ae_rgb.decode_from_sample(x),
    }
    cuda = torch.autograd.DeviceType.CUDA
    result = {}
    with torch.inference_mode():
        for name, fn in parts.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 3 * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == cuda]
            busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
            result[name] = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "kernels": sum(e.count for e in kern),
                "top": [(e.key[:60], e.self_device_time_total / 1e3)
                        for e in top]}
            log(f"profile {name} at B={b}: wall {wall_ms:.2f} ms, device "
                f"busy {busy_ms:.2f} ms, {result[name]['kernels']} kernels; "
                f"top {result[name]['top']}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from moditalker_tpu_torch.ops.kernels import SOURCES, _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(sorted(set(SOURCES.values())))
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (secs, out) in logs.items():
        regs = [int(w) for line in out.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in out.splitlines()
                     if "spill stores" in line)
        log(f"  {name}: {secs:.1f} s, {len(regs)} kernels, max "
            f"{max(regs, default=0)} "
            f"registers, {spills} bytes of spill stores")

    rows = kernel_phase(torch, batch=2, seed=args.seed)
    reference_phase(torch, args.seed)
    result = main_path_phase(torch, args.seed)
    prof = profile_phase(torch, result.pop("pipe"), args.seed)

    timed = {path: counts for path, counts in result["launches"].items()
             if "warm-up" not in path}
    for row in rows:
        row.pop("shape")
        row["launches_by_path"] = {p: c[row["name"]] for p, c in timed.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"frames_per_s": {
        "sample_independent": result["sample_independent_fps"],
        "sample_long": result["sample_long_fps"]}, "card": card,
        "profile": prof}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
