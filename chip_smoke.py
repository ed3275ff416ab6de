#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, each of which must pass (any failure exits nonzero, and the final
``{"ok": true, ...}`` line is printed only after all of them):

1. build   — compile every kernel source (``moditalker_tpu_torch/csrc``),
             one nvcc per source, all started together;
2. kernels — each of the six hand-written kernels against its plain PyTorch
             version at the shapes the paths give it, in bf16 (max and rms
             error, relative to the plain output's, within the kernel's
             ``BF16_LIMITS``), timed on the device (20 calls replayed from
             a CUDA graph between two events, the median of five replays:
             no host time in it) beside the plain
             version, one PyTorch library call computing the same attention
             (``library_ms``, a yardstick the port never calls) and the
             card's bound. The divided, packed and one-pass kernels are
             also held at B = 1 (``sample_long``'s shapes), the space kernel
             at the edges of its gate (N = 256, where K stays resident in
             shared memory, and 2048, where it goes through a ring); the
             rows of redesigned kernels name the design kept, and the log
             line sets the time of the kernels they replaced beside this
             run's. Beside each bound the log line gives the softmax floor:
             the row's scores over the card's ex2 rate (16 per clock per SM)
             at the SM clock ``nvidia-smi`` reads under load.
             The K-blocked fused kernel is driven here through the public op
             ``sdpa_fused`` (no model calls it), and with ragged query rows
             against one whole and one short 128-key tile through its own
             op ``fused_attention`` (``sdpa_fused`` sends fewer than 256 keys
             to ``sdpa``);
3. reference — one DDIM-2 window at a small depth but full spatial size (so
             every kernel gate passes) on the card in bf16 against the same
             weights and draws on the CPU in float32 through the plain path,
             within REF_FACTOR times the error of a bf16 CPU run. Once on
             the fused path, once on the modular-attention path (both gate
             switches set: MODITALKER_NO_DIVIDED_FUSED and
             MODITALKER_NO_PACKED_ATTN), there at B = 2 and 4 heads so that
             the time attention passes the tiny-L gate;
4. main path — at the full shipped width with weights drawn from ``--seed``:
             ``sample_independent`` over 2 windows at batch 2 (DDIM-100) and
             the fast-mode ``sample_long`` over 3 autoregressive windows at
             B = 1 (renoise ratio 0.25 from the reference window), then
             ``sample_independent`` again on the modular-attention path,
             each timed warm, after one untimed run of the same call. The
             launch counters are zeroed just before each path and read just
             after: the fused paths must have launched the divided space and
             time, packed and one-pass kernels and no other; the modular path
             the tiny-L and one-pass kernels and no other; each count is also
             split by the shape the kernel was given. Outputs must be
             uint8 frames of the right shape that are not constant;
5. cli     — the port's ``sample`` command at full width: a real argument
             list through the CLI's own parser (batch 2, independent
             windows, DDIM-25, no checkpoints) and the command's function of
             (arguments, windows) on synthetic uint8 windows (reading frames
             from disk needs PIL, which a CUDA host may lack); the video file
             it writes is checked;
6. atom    — AToM inference at full width in float32: a DDIM-2 run on the
             card against the CPU with the same weights and draws, and one
             decoder forward likewise (within ATOM_LIMIT), then
             ``run_directory`` over 4 synthetic identities at DDIM-50 with
             CFG, timed warm; the landmark files are checked.
             AToM's attentions are outside every kernel gate: no launch;
7. profile — one UNet step, one extract and one decode at B = 2: host
             time, the device's busy time and top kernels (torch.profiler).

Without a CUDA device, or run outside the repository, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# window on the card (bf16, kernels) vs the CPU in fp32 (plain path): the
# card's error may be at most this many times that of the CPU's own bf16 run
REF_FACTOR = 2.0

# AToM on the card vs the CPU, both float32 with TF32 off, same weights,
# inputs and draws, at full width: max abs difference over max |cpu| of one
# decoder forward (unclipped) and of a DDIM-2 residual (clipped to [-1, 1],
# which with random weights hides most of the difference: hence both). The
# two differ by the order of float32 sums through the 8-layer decoder; the
# limit is about ten times the readings (1.3e-6 and 3.0e-6 on an H100).
ATOM_LIMIT = 2e-5

# which kernels each kind of path launches; the others must stay at zero
FUSED_PATH = {"divided_space_attention", "divided_time_attention",
              "packed_attention", "onepass_attention"}
MODULAR_PATH = {"tiny_attention", "onepass_attention"}
SWITCHES = ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN")

# what the kernels that were replaced took at the same shape on an H100 80GB
# HBM3 at 700 W, by (kernel, shape of its first operand), for the log line
# only: the kernels line holds what this run measured. The divided, packed
# and one-pass kernels' first designs were timed as 20 launches from Python
# between two events; the fused kernel's first tile as this script times
# (device time from a CUDA graph)
BEFORE_REDESIGN_MS = {
    ("fused_attention", (16, 2048, 16)): 0.0501,
    ("fused_attention", (256, 1024, 64)): 0.5882,
    ("fused_attention", (2, 64, 64)): 0.0195,
    ("divided_space_attention", (2, 16, 1024, 1536)): 0.8307,
    ("divided_time_attention", (2, 16, 1024, 1536)): 0.4438,
    ("packed_attention", (2, 2048, 384)): 0.0570,
    ("onepass_attention", (16, 2048, 32)): 0.0763,
    ("onepass_attention", (256, 1024, 64)): 0.6035,
    ("onepass_attention", (16, 2048, 16)): 0.0538,
    ("onepass_attention", (16, 1024, 16)): 0.0224,
}

H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
H100_EX2_PER_CLOCK_PER_SM = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sm_clock_mhz_under_load(torch, fn, launches: int = 1500) -> float:
    """The SM clock ``nvidia-smi`` reads while ``launches`` calls of ``fn``
    keep the card busy (an idle card reads a lower clock)."""
    probe = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(launches):
        fn()
    out, _ = probe.communicate(timeout=60)
    torch.cuda.synchronize()
    if probe.returncode != 0:
        raise RuntimeError("nvidia-smi could not read clocks.sm")
    return float(out.strip().splitlines()[0])


def time_ms(torch, fn, iters: int = 20, sets: int = 5, warmup: int = 3) -> float:
    """Milliseconds of device time per call: ``iters`` calls captured into one
    CUDA graph, CUDA events around a replay, the median of ``sets`` replays.
    Launched call by call from Python, a kernel shorter than the host's
    20–30 us per call would read as the host's time, not its own."""
    for _ in range(warmup):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(sets):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[sets // 2]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def modular_attention():
    """Both gate switches set for the block, and put back after it."""
    old = {name: os.environ.get(name) for name in SWITCHES}
    os.environ.update({name: "1" for name in SWITCHES})
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


def check_launches(what: str, expected: set) -> dict:
    """The launch counts since the last reset; raises unless exactly the
    ``expected`` kernels were launched."""
    from moditalker_tpu_torch.ops.kernels import LAUNCHES

    counts = dict(LAUNCHES)
    missing = sorted(k for k in expected if not counts[k])
    extra = sorted(k for k, n in counts.items() if n and k not in expected)
    if missing or extra:
        raise AssertionError(f"{what}: kernels not launched {missing}, "
                             f"launched off their path {extra}: {counts}")
    return counts


def launches_by_shape() -> dict:
    """The launch counts since the last reset, split by the shape each kernel
    was given: {kernel: {"[shape]": launches}}, launched kernels only."""
    from moditalker_tpu_torch.ops.kernels import LAUNCHES_BY_SHAPE

    return {name: {str(list(shape)): n for shape, n in sorted(by.items())}
            for name, by in LAUNCHES_BY_SHAPE.items() if by}


# ------------------------------------------------------------------ kernels
def kernel_phase(torch, batch: int, seed: int) -> list[dict]:
    import torch.nn.functional as F

    from moditalker_tpu_torch.ops import attention, rotary
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

    def library_sdpa(q, k, v, sc):
        """The yardstick on [B, N, D]: with a head axis of one, since the
        library's fused kernels take 4-D tensors only (3-D ones fall to its
        unfused math)."""
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=sc)

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
    t_sin, t_cos = tables(rotary.time_rotary_sincos(f, dh))

    # the rows added beside the main-path shapes draw from a generator of
    # their own, so the main-path rows see the inputs they always saw
    gen_more = torch.Generator(device=dev).manual_seed(seed + 1)

    def divided_row(axis, b_, f_, n_, g=gen_more):
        if axis == "space":
            sin, cos = tables(rotary.axial_rotary_sincos(32, n_ // 32, dh)
                              if n_ >= 1024 else
                              rotary.axial_rotary_sincos(16, n_ // 16, dh))
        else:
            sin, cos = t_sin, t_cos
        qkv = torch.randn((b_, f_, n_, 3 * hd), generator=g,
                          device=dev).bfloat16()
        kern = lambda: dv.divided_attention(qkv, sin, cos, axis, heads, dh,
                                            scale)
        plain = lambda: dv.divided_attention_reference(
            qkv, sin, cos, axis, heads, dh, scale, use_flash=False)
        name = f"divided_{axis}_attention"
        err = errors(name, kern, plain)
        q, k, v = head_split_rotated(qkv, sin, cos, axis)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        seq = n_ if axis == "space" else f_
        nseq = b_ * f_ * n_ // seq
        nbytes = qkv.numel() * 2 + b_ * f_ * n_ * hd * 2 + 2 * sin.numel() * 4
        flops = 4.0 * nseq * heads * seq * seq * dh
        return dict(
            name=name, route="cuda",
            source="moditalker_tpu_torch/csrc/divided_attention.cu",
            replaces=("moditalker_tpu/ops/pallas/divided_attention.py:121"
                      if axis == "space" else
                      "moditalker_tpu/ops/pallas/divided_attention.py:177"),
            shape=list(qkv.shape), **err,
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lib), nbytes=nbytes, flops=flops,
            scores=nseq * heads * seq * seq)

    # the main path's shape first (its row of the kernels line); then
    # sample_long's B = 1 and the space gate's edges
    rows.append(dict(divided_row("space", batch, f, n, g=gen),
                     design="wgmma, K resident in shared memory (rotated "
                            "once per (frame, head)) up to N = 1152, a K "
                            "ring above"))
    rows.append(dict(divided_row("time", batch, f, n, g=gen),
                     design="one warp per (b, n, head), mma.sync"))
    rows += [divided_row("space", 1, f, n), divided_row("time", 1, f, n),
             divided_row("space", batch, 1, 256),
             divided_row("space", batch, 1, 2048)]

    c, l = 128, 2048                        # UNet joint attention at ds = 1

    def packed_row(b_, l_, g=gen_more):
        qkv = torch.randn((b_, l_, 3 * c), generator=g, device=dev).bfloat16()
        sc = (c // heads) ** -0.5
        kern = lambda: pk.packed_attention(qkv, heads, sc)
        plain = lambda: pk.packed_attention_reference(qkv, heads, sc)
        err = errors("packed_attention", kern, plain)
        q, k, v = (t.reshape(b_, l_, heads, c // heads).transpose(1, 2)
                   .contiguous() for t in qkv.chunk(3, -1))
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=sc)
        return dict(
            name="packed_attention", route="cuda",
            source="moditalker_tpu_torch/csrc/packed_attention.cu",
            replaces="moditalker_tpu/ops/pallas/packed_attention.py:78",
            shape=list(qkv.shape), **err,
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lib),
            nbytes=qkv.numel() * 2 + b_ * l_ * c * 2,
            flops=4.0 * b_ * heads * l_ * l_ * (c // heads),
            scores=b_ * heads * l_ * l_)

    # the xy-plane attention, then the joint one (the row of the kernels
    # line), drawn in the order they always were; then sample_long's B = 1
    small_head = ("mma.sync on ldmatrix fragments, K and V behind a "
                  "cp.async ring of 128-key tiles, 256, 128 or 64 query "
                  "rows per block by the grid they give")
    xy_plane = packed_row(batch, 1024, g=gen)
    rows += [dict(packed_row(batch, l, g=gen), design=small_head), xy_plane,
             packed_row(1, l), packed_row(1, 1024)]

    def sdpa_row(name, replaces, source, kern, plain, q, k, v, sc):
        lib = library_sdpa(q, k, v, sc)
        b_, nq_, d_ = q.shape
        return dict(
            name=name, route="cuda",
            source=f"moditalker_tpu_torch/csrc/{source}.cu",
            replaces=f"moditalker_tpu/ops/pallas/flash_attention.py:{replaces}",
            shape=[list(q.shape), list(k.shape)], **errors(name, kern, plain),
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lib),
            nbytes=2 * (2 * q.numel() + 2 * k.numel()),
            flops=4.0 * b_ * nq_ * k.shape[1] * d_,
            scores=b_ * nq_ * k.shape[1])

    def randn(*shape, g=gen):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    # one-pass: the UNet joint attention right after the last upsample
    # (C = 256, 8 heads → [B·8, 2048, 32]); then the modular path's shapes:
    # TimeSformer space attention, the UNet's dh = 16 joint and xy-plane
    # attentions; then sample_long's B = 1
    def onepass_row(b_, n_, d_, g=gen):
        q, k, v = (randn(b_, n_, d_, g=g) for _ in range(3))
        return sdpa_row(
            "onepass_attention", 104, "flash_attention",
            lambda: fa.onepass_attention(q, k, v, d_**-0.5),
            lambda: fa.onepass_attention_reference(q, k, v, d_**-0.5),
            q, k, v, d_**-0.5)

    rows.append(dict(onepass_row(batch * heads, l, 32),
                     design=small_head + "; at D = 64 the wgmma tile without "
                                         "the rotary"))
    rows += [onepass_row(batch * heads * f, n, dh),
             onepass_row(batch * heads, l, 16),
             onepass_row(batch * heads, 1024, 16),
             onepass_row(heads, l, 32, g=gen_more)]

    # tiny-L: the modular path's TimeSformer time attention
    q, k, v = (randn(batch * heads * n, f, dh) for _ in range(3))
    rows.append(sdpa_row(
        "tiny_attention", 146, "tiny_attention",
        lambda: fa.tiny_attention(q, k, v, scale),
        lambda: fa.tiny_attention_reference(q, k, v, scale), q, k, v, scale))

    # K-blocked fused, through the public op: self-attention at a UNet and
    # an AE shape, and query rows against a longer key sequence
    wgmma_fused = ("the one-pass kernel's wgmma tile at Nq query rows over "
                   "Nk keys: K resident up to Nk = 1152, a K ring above; "
                   "ragged query chunks and a short key tile masked")
    for (b_, nq_, nk_, d_), design in (
            ((batch * heads, l, l, 16), "the one-pass kernel's small-head "
                                        "tile at Nq query rows over Nk keys"),
            ((batch * heads * f, n, n, dh), wgmma_fused),
            ((2, 64, 512, 64), wgmma_fused)):
        q, k, v = randn(b_, nq_, d_), randn(b_, nk_, d_), randn(b_, nk_, d_)
        rows.append(dict(sdpa_row(
            "fused_attention", 33, "flash_attention",
            lambda: attention.sdpa_fused(q, k, v, d_**-0.5),
            lambda: fa.fused_attention_reference(q, k, v, d_**-0.5),
            q, k, v, d_**-0.5), design=design))
    # ragged query chunks against one whole 128-key tile and one short of
    # it (zero-filled and masked), through the kernel's own op
    for nk_ in (128, 120):
        q = randn(2 * heads, 1000, dh, g=gen_more)
        k, v = (randn(2 * heads, nk_, dh, g=gen_more) for _ in range(2))
        rows.append(sdpa_row(
            "fused_attention", 33, "flash_attention",
            lambda: fa.fused_attention(q, k, v, scale),
            lambda: fa.fused_attention_reference(q, k, v, scale),
            q, k, v, scale))

    # the softmax floor: one ex2 per score at the clock the SMs hold under
    # load (read while the space kernel keeps the card busy)
    qkv = torch.randn((batch, f, n, 3 * hd), generator=gen_more,
                      device=dev).bfloat16()
    s_sin, s_cos = tables(rotary.axial_rotary_sincos(32, n // 32, dh))
    mhz = sm_clock_mhz_under_load(torch, lambda: dv.divided_attention(
        qkv, s_sin, s_cos, "space", heads, dh, scale))
    ex2_per_ms = (torch.cuda.get_device_properties(0).multi_processor_count
                  * H100_EX2_PER_CLOCK_PER_SM * mhz * 1e3)
    log(f"SM clock under load: {mhz:.0f} MHz")

    for row in rows:
        row["bound_ms"], row["bound_by"] = bound_ms(row.pop("nbytes"),
                                                    row.pop("flops"))
        # a computed yardstick for the log only: the kernels line holds
        # what the run measured, and of computed values the bound alone
        floor_ms = row.pop("scores") / ex2_per_ms
        first = row["shape"][0] if isinstance(row["shape"][0], list) \
            else row["shape"]
        before = BEFORE_REDESIGN_MS.get((row["name"], tuple(first)))
        log(f"{row['name']} at {row['shape']}: max abs err "
            f"{row['max_abs_err']:.3e}, relative max {row['rel_max_err']:.3e}"
            f" and rms {row['rel_rms_err']:.3e} (limits "
            f"{BF16_LIMITS[row['name']]}), kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), softmax "
            f"floor {floor_ms:.4f} ms"
            + (f", {row['design']}" if "design" in row else "")
            + (f", before the redesign {before:.4f} ms" if before else ""))
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


def reference_phase(torch, seed: int, what: str, expected: set,
                    heads: int = 2, batch: int = 1) -> None:
    """A small-depth window on the card (bf16, kernels) against the CPU in
    float32 (plain path), with the same weights and the same draws. The
    same window on the CPU in bf16 (plain path) measures what bf16 alone
    costs; the card may differ from float32 by at most REF_FACTOR times
    that, in mean and in max. On the card exactly the ``expected`` kernels
    must launch."""
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovUNetConfig)
    from moditalker_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=heads, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    # channel_mult (1, 2): the last upsample lands C = 256 at ds = 1, so the
    # joint attention there takes the one-pass kernel, as in the full UNet
    unet_cfg = MtovUNetConfig(num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,))
    diff_cfg = MtovDiffusionConfig(sampling_timesteps=2)
    states = random_states(torch, ae_cfg, unet_cfg, seed)
    w = make_windows(ae_cfg, 1, batch, seed)[0]
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
        log(f"{what} reference window on {device} ({dtype}): "
            f"{time.perf_counter() - t0:.2f} s, launches {dict(LAUNCHES)}")
        if device == "cuda":
            check_launches(f"{what} reference window", expected)
    fp32 = outs["cpu", torch.float32]
    card = (outs["cuda", torch.bfloat16] - fp32).abs()
    bf16 = (outs["cpu", torch.bfloat16] - fp32).abs()
    log(f"{what} reference vs cpu fp32, decoded video: card bf16 mean abs "
        f"{card.mean().item():.3e} max {card.max().item():.3e}; cpu bf16 "
        f"mean abs {bf16.mean().item():.3e} max {bf16.max().item():.3e} "
        f"(card within {REF_FACTOR}x)")
    if not (torch.isfinite(outs["cuda", torch.bfloat16]).all()
            and card.mean() <= REF_FACTOR * bf16.mean()
            and card.max() <= REF_FACTOR * bf16.max()):
        raise AssertionError(f"{what}: the card's window disagrees with the "
                             "CPU reference")


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
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg, unet_cfg = MtovAEConfig(), MtovUNetConfig()
    diff_cfg = MtovDiffusionConfig(sampling_timesteps=100, w=0.0)
    t0 = time.perf_counter()
    pipe = MtovSamplePipeline(*random_states(torch, ae_cfg, unet_cfg, seed),
                              ae_cfg, unet_cfg, diff_cfg)
    log(f"full-width pipeline built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    launches, by_shape = {}, {}

    def drive(name, fn, frames, expected=FUSED_PATH):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[name] = check_launches(name, expected)
        by_shape[name] = launches_by_shape()
        log(f"{name}: {frames} frames in {dt:.3f} s = {frames / dt:.3f} "
            f"frames/s; launches {launches[name]}, by shape {by_shape[name]}")
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
    with modular_attention():
        for label in ("modular sample_independent (warm-up)",
                      "modular sample_independent"):
            fps_mod = drive(label, lambda: pipe.sample_independent(
                make_windows(ae_cfg, 2, 1, seed), gen, batch=2), 2 * t,
                MODULAR_PATH)
    return {"launches": launches, "launches_by_shape": by_shape,
            "sample_independent_fps": fps_ind,
            "sample_long_fps": fps_long,
            "modular_sample_independent_fps": fps_mod, "pipe": pipe}


def cli_phase(torch, seed: int) -> dict:
    """The ``sample`` command at full width, from its own parser to the
    video file, on synthetic uint8 windows."""
    from moditalker_tpu_torch import cli
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts

    windows, steps = 4, 25
    with tempfile.TemporaryDirectory() as tmp:
        args = cli.build_parser().parse_args([
            "sample", "--frames-dir", "-", "--aligned-dir", "-", "--batch",
            "2", "--no-last-as-reference", "--sampling-steps", str(steps),
            "--seed", str(seed), "--out-dir", tmp])
        ae_cfg = cli._sample_configs(args)[0]
        reset_launch_counts()
        t0 = time.perf_counter()
        path = cli.sample_windows(args, make_windows(ae_cfg, windows, 1, seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = check_launches("cli sample", FUSED_PATH)
        frames = windows * ae_cfg.timesteps
        if not path.startswith(tmp) or os.path.getsize(path) == 0:
            raise AssertionError(f"cli sample: no video at {path}")
        if path.endswith(".npz"):   # no ffmpeg on this host: a frame dump
            with np.load(path) as dump:
                check_frames(dump["frames"][None], frames, ae_cfg, "cli sample")
        elif not path.endswith(".mp4"):
            raise AssertionError(f"cli sample: unexpected file {path}")
    log(f"cli sample (pipeline built from the seed, {windows} windows at "
        f"batch 2, DDIM-{steps}): {frames} frames in {dt:.2f} s incl. the "
        f"build, wrote {os.path.basename(path)}; launches {counts}")
    return {"launches": counts, "seconds_with_build": dt}


def atom_phase(torch, seed: int) -> dict:
    """AToM inference at full width (float32, TF32 off): the card against
    the CPU on a DDIM-2 run, then ``run_directory`` timed warm."""
    from moditalker_tpu_torch.config import (AtomDiffusionConfig,
                                             AtomModelConfig)
    from moditalker_tpu_torch.models.atom import MotionDecoder
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.pipelines.atom_infer import (
        AtomInferencePipeline, prepare_condition)
    from moditalker_tpu_torch.preprocess.bfm import Face3DHelper

    mc = AtomModelConfig()
    torch.manual_seed(seed)
    state = MotionDecoder(mc).state_dict()
    rng = np.random.default_rng(seed)
    ids = {f"id{i}": (rng.normal(scale=0.3, size=(68, 3)),
                      rng.normal(size=(2 * mc.horizon, mc.cond_feature_dim)))
           for i in range(4)}
    face, cond = (np.concatenate(parts) for parts in zip(
        *(prepare_condition(*ids[n], mc.horizon) for n in sorted(ids)[:2])))
    reset_launch_counts()

    x = rng.normal(size=(2, mc.horizon, mc.repr_dim)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        pipe = AtomInferencePipeline(
            state, mc, AtomDiffusionConfig(sampling_steps=2), device=device)
        g = torch.Generator().manual_seed(seed)
        draws = lambda shape, dt, g=g: torch.randn(shape, generator=g)
        t0 = time.perf_counter()
        on = lambda a: torch.as_tensor(a).to(pipe.device)
        with torch.inference_mode():
            forward = pipe.diff.model(
                on(x), on(face), on(cond), on(np.array([999, 20])),
                keep_mask=on(np.array([True, False])))
        outs[device] = (forward.cpu(),
                        pipe.generate_residual(draws, face, cond).cpu())
        log(f"atom forward and DDIM-2 at B = 2 on {device}: "
            f"{time.perf_counter() - t0:.2f} s")
    errs = {}
    for what, card, cpu in zip(("forward", "DDIM-2"), *outs.values()):
        errs[what] = ((card - cpu).abs().max() / cpu.abs().max()).item()
        log(f"atom {what}, card vs cpu in float32: max abs err over max "
            f"|cpu| {errs[what]:.3e} (limit {ATOM_LIMIT}), max |cpu| "
            f"{cpu.abs().max().item():.3f}")
        if not (torch.isfinite(card).all() and errs[what] <= ATOM_LIMIT):
            raise AssertionError(f"atom {what}: the card disagrees with "
                                 "the CPU")

    pipe = AtomInferencePipeline(state, mc, AtomDiffusionConfig(),
                                 face3d=Face3DHelper.synthetic(seed))
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("atom run_directory (warm-up)", "atom run_directory"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = pipe.run_directory(ids, os.path.join(tmp, label),
                                       seed=seed)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"{label}: {len(ids)} sequences of {mc.horizon} frames, "
                f"DDIM-50 with CFG, in {dt:.3f} s = {len(ids) / dt:.3f} "
                f"sequences/s")
        for name in ids:
            want = os.path.join(tmp, label, "frontalized_npy", name, "atom.npy")
            lm = np.load(paths[name])
            if (paths[name] != want or lm.shape != (mc.horizon, 68, 3)
                    or not np.isfinite(lm).all() or lm.std() == 0):
                raise AssertionError(f"atom: bad landmarks for {name}: "
                                     f"{paths[name]} {lm.shape}")
    counts = check_launches("atom", set())
    log(f"atom: attentions outside every kernel gate, launches {counts}")
    return {"launches": counts, "sequences_per_s": len(ids) / dt,
            "card_vs_cpu_rel_max_err": errs}


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
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and kernels phases (a short "
                         "check of a kernel change; prints no result line)")
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
        for line in out.splitlines():   # per kernel: registers, spills
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"    {line.strip()}")
        regs = [int(w) for line in out.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in out.splitlines()
                     if "spill stores" in line)
        log(f"  {name}: {secs:.1f} s, {len(regs)} kernels, max "
            f"{max(regs, default=0)} "
            f"registers, {spills} bytes of spill stores")

    rows = kernel_phase(torch, batch=2, seed=args.seed)
    if args.kernels_only:
        return 0
    reference_phase(torch, args.seed, "fused", FUSED_PATH)
    with modular_attention():
        # 2·4·1024 = 8192 folded sequences: the time attention passes the
        # tiny-L gate (at B = 1 and 2 heads it would not)
        reference_phase(torch, args.seed, "modular", MODULAR_PATH, heads=4,
                        batch=2)
    result = main_path_phase(torch, args.seed)
    cli_result = cli_phase(torch, args.seed)
    atom = atom_phase(torch, args.seed)
    prof = profile_phase(torch, result.pop("pipe"), args.seed)

    timed = {path: counts for path, counts in result["launches"].items()
             if "warm-up" not in path}
    timed["cli sample"] = cli_result["launches"]
    timed["atom run_directory"] = atom["launches"]
    # one line entry per kernel: its first row, the shape its main path
    # gives it; the rows at its other shapes go under "other_shapes"
    kernels = {}
    for row in rows:
        if row["name"] in kernels:
            kernels[row["name"]].setdefault("other_shapes", []).append(
                {k: row[k] for k in ("shape", "max_abs_err", "rel_max_err",
                                     "rel_rms_err", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")})
            continue
        kernels[row["name"]] = row
        row["launches_by_path"] = {p: c[row["name"]] for p, c in timed.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        row["launches_by_shape"] = {
            p: by[row["name"]] for p, by in result["launches_by_shape"].items()
            if "warm-up" not in p and row["name"] in by}
    kernels["fused_attention"]["note"] = (
        "op-level only: reached through ops.attention.sdpa_fused, which no "
        "model path calls; launched by the kernels phase")
    print(json.dumps({"frames_per_s": {
        "sample_independent": result["sample_independent_fps"],
        "sample_long": result["sample_long_fps"],
        "modular_sample_independent":
            result["modular_sample_independent_fps"]},
        "atom_sequences_per_s": atom["sequences_per_s"],
        "atom_card_vs_cpu_rel_max_err": atom["card_vs_cpu_rel_max_err"],
        "cli_sample_seconds_with_build": cli_result["seconds_with_build"],
        "card": card, "profile": prof}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
