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
             ``BF16_LIMITS``, and the 0.999 quantile of the error over the
             plain output's max within ``QUANTILE_LIMITS``; the space, time,
             packed and one-pass kernels also in float32 at
             train-diffusion's shapes and at B = 1 (train-first-stage's and
             the golden record's), through the cast passes of
             ``ops/kernels/convert.py``, whose share each such row gives; the
             256-channel UNet's one-pass shapes), timed on the device (20 calls replayed from
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
   gradients — each differentiable wrapper's input gradient (its
             ``autograd.Function``) against autograd through the plain
             version in float32 (within GRAD_LIMIT), its ``grad_fn``, and
             the peak memory of the recomputing backward;
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
7. audio   — HuBERT-large (``HubertConfig()``: 24 layers, width 1024) in
             float32 with weights from ``--seed``: a 2 s clip on the card
             against the CPU (within AUDIO_LIMIT), then the ``process-audio``
             command on a 16-bit wav of one whole 20 s clip (320 080
             samples) plus a 3 s tail, and the same chain
             (``normalize_like_wav2vec2``, ``extract_hubert_features`` over
             ``hubert_forward``) timed warm: seconds of audio per second,
             features [expected T, 1024]; then those features through AToM
             (``run_directory``, one identity) to a landmark file: wav →
             landmarks on one card. Masked attention: no launch;
8. align   — the ``align-motion`` stack as ``build_detectors`` makes it from
             state_dicts (S3FD, FAN with 4 modules, ReconNet at full width,
             float32, weights from ``--seed``, S3FD's face logit a filter
             that finds the frames' "face"): the three nets and the
             fused chunk on 2 frames on the card against the CPU (within
             ALIGN_LIMIT), then ``MotionAligner.align_sequence`` over HORIZON
             = 156 synthetic 512 × 512 driving frames (noise in the central
             256² on black) and the landmarks of the audio phase, timed
             warm: frames per second, aligned landmarks [156, 68, 2],
             finite, inside the frame. No launch;
9. train-diffusion — ``LatentDiffusionLoop.fit`` at full width, B = 10,
             float32 (TF32 off), synthetic videos, AE and UNet weights from
             ``--seed``: one untimed step, 5 timed (steps/s, clips/s, peak
             memory, launches by kernel and shape: the divided space and
             time, packed and one-pass kernels and no other), finite losses,
             one step traced; then a step at small depth but full spatial
             size on the card against the CPU (same weights, batch and
             draws) within TRAIN_LIMITS, and the same step with the gradient
             cut at the attentions, which must fall outside them;
10. train-atom — ``AtomTrainer.fit`` at full width, batch 64, float32:
             one untimed step, 5 timed (sequences/s), one traced, no
             launch; three steps at batch 8 on the card against the CPU
             (losses within ATOM_LIMIT, parameters within ATOM_PARAM_LIMIT
             but at ill-conditioned Adan elements, which are counted);
11. train-first-stage — ``FirstStageTrainer.fit`` at base_gan.yaml's
             operating point (AE 384 wide, depth 8, 256² × 16 frames;
             LPIPS-VGG16, 2D and 3D PatchGANs ndf 64, 3 layers; disc_start
             −1, so G and D alternate every cycle; B = 1, accumulation 3,
             float32, a synthetic clip, weights from ``--seed``): one G and
             one D cycle untimed, two of each timed (iterations/s, clips/s,
             peak memory, launches by shape: the divided space and time
             kernels and no other), G and D micro-steps timed apart, one G
             step traced with the device time of the space and time
             backwards (the plain version's vjp, recomputed) in it; then a
             G and a D cycle at small depth but full spatial size on the
             card against the CPU (same weights, clips and frame draws)
             within FIRST_STAGE_LIMITS, and the G cycle with the gradient
             cut at the attentions, which must fall outside them;
12. i3d    — InceptionI3d (random He-scaled weights) on [2, 16, 224, 224, 3]
             on the card against the CPU within I3D_LIMIT, and the FVD
             between two sets of 8 synthetic clips through the card's I3D
             against the CPU's within FVD_LIMIT;
13. golden  — reference-layout files at full width (the reference's key
             names and shapes, made from seeded weights) through ``golden
             --mode convert``, each converted file the weights it came
             from, the converted LPIPS card vs CPU; ``golden --mode record``
             at full width on the card (float32; launches of the space,
             time, packed and one-pass kernels) and ``--mode check`` at the
             JAX harness's 1e-4, a perturbed golden failing; a small-depth
             record on the CPU checked on the card against the reference
             phase's limit (``golden_phase``);
14. distributed — NCCL at world size 1 (tcp:// on localhost): a
             small-depth train-diffusion step through the gradient
             all-reduce equal to the same step without a group, exactly;
             ``tp.py`` on a 1×1 mesh (head-parallel attention through the
             one-pass kernel); ``sample --data-parallel 1`` writing what
             ``sample`` writes;
15. profile — one UNet step, one extract and one decode at B = 2: host
             time, the device's busy time and top kernels (torch.profiler);
16. profiling — ``core/profiling.py``: ``trace`` around one UNet step
             writes a Chrome trace holding the ``annotate`` span and the
             card's kernels; ``step_timer`` logs the step.

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

# HuBERT-large on the card vs the CPU, both float32 with TF32 off, same
# weights and 2 s clip: max abs difference over max |cpu| of the features;
# about twice the reading on an H100 (1.678e-6)
AUDIO_LIMIT = 4e-6

# the alignment nets on the card vs the CPU in float32 on the same 2 frames
# (S3FD's 12 maps, FAN's last heatmaps on the same crops, ReconNet's 257
# coefficients on the same crops), and the fused chunk's continuous rows:
# max abs difference over max |cpu| of each; about twice the largest
# reading on an H100 (S3FD's maps, 1.12e-5; the rest 1e-7 to 4e-6)
ALIGN_LIMIT = 2.5e-5
# of the fused chunk's 136 landmarks at least this share within 1e-2 px of
# the CPU's: each is an argmax of a random-weight heatmap, which a 1e-6
# difference can move by a cell (the POS params and the coefficients are
# compared on the frames whose landmarks all agree)
ALIGN_POINTS_SHARE = 0.95
# gain of S3FD's synthetic face detector (``align_states``)
FACE_GAIN = 1.0

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

# train-diffusion's batch (MtovTrainConfig.diffusion_batch_size): the float32
# rows of the kernels phase are at the shapes it gives the kernels
TRAIN_BATCH = 10

# a kernel wrapper's input gradient on the card (its autograd.Function: the
# kernel forward, the plain version recomputed backward) against autograd
# through the plain version, float32, TF32 off: max abs difference over max
# |plain gradient|. The packed and divided backwards are the plain version's
# own vjp (they read 0), the one-pass and tiny-L ones the JAX package's
# adjoints, which sum in another order (one-pass at [80, 2048, 32] reads
# 1.57e-6 to 2.12e-6 over --seed 0..3 on an H100)
GRAD_LIMIT = 5e-6

# one train-diffusion step at a small depth (float32, TF32 off) on the card
# against the CPU: relative errors of the loss, and of the UNet's gradient
# and update over all its parameters (L2 of the difference over L2 of the
# CPU's). The card's attentions run bf16 operands with fp32 accumulators,
# the CPU's float32 throughout. AdamW's first step moves each element by
# about lr in the direction of its gradient's sign, so the update's error
# counts the signs rounding flips. About twice the readings on an H100
# (1.19e-5, 3.36e-4, 2.41e-2); the same step with the gradient cut at the
# attentions reads 0.725 and 1.06 on the gradient and the update, and must
# exceed these.
TRAIN_LIMITS = {"loss": 3e-5, "grad": 1e-3, "update": 5e-2}

# AToM training card vs CPU (float32, TF32 off): the largest relative error
# of a step's loss terms is held to ATOM_LIMIT, every parameter to
# ATOM_PARAM_LIMIT (DESIGN.md §6's AToM tolerance) but at ill-conditioned
# Adan elements: sqrt(n̂) below ADAN_ILL, or a step above ADAN_BIG·lr
ATOM_PARAM_LIMIT = 2e-4
ADAN_ILL = 1e-4
ADAN_BIG = 25

# which kernels the first-stage trainer launches: its AE's divided space and
# time attention (the AE's pooling transformer, LPIPS and the
# discriminators reach none)
FIRST_STAGE_PATH = {"divided_space_attention", "divided_time_attention"}

# one first-stage G cycle and D cycle at a small depth (float32, TF32 off)
# on the card against the CPU: relative errors of the loss terms (largest
# over the micro-steps), and of the AE's and the discriminators' mean
# gradients (the discriminators' clipped per micro-step) and updates over
# all their parameters (L2 of the difference over L2 of the CPU's). The
# card's attentions run bf16 operands with fp32 accumulators; LPIPS's max
# pools route a gradient to whichever element of a near-tied window the
# rounding favours; AdamW's first step moves each element by about lr in
# the direction of its gradient's sign, so the updates count the signs
# rounding flips. About twice the readings on an H100 (2.01e-4, 8.65e-3,
# 0.199, 1.64e-2, 0.111); the G cycle with the gradient cut at the
# attentions reads 0.549 and 0.755 on the AE's gradient and update, and
# must exceed these.
FIRST_STAGE_LIMITS = {"loss": 4e-4, "ae_grad": 1.7e-2, "ae_update": 0.4,
                      "disc_grad": 3.3e-2, "disc_update": 0.22}

# InceptionI3d on the card vs the CPU, float32, TF32 off: max abs difference
# of the logits over max |cpu|; and the relative difference of the FVD of
# two synthetic sets through each. About twice the readings on an H100
# (2.49e-6, 2.09e-6)
I3D_LIMIT = 5e-6
FVD_LIMIT = 5e-6

# the golden harness on the card: a full-width record must check at the JAX
# harness's defaults (max |err| ≤ atol + rtol·max |golden|, both 1e-4), and
# fail with one probe moved by GOLDEN_PERTURB
GOLDEN_TOL = 1e-4
GOLDEN_PERTURB = 1e-2

H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12     # float32 outside the tensor cores (TF32 is off)
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
    from moditalker_tpu_torch.ops.kernels import (BF16_LIMITS, QUANTILE,
                                                  QUANTILE_LIMITS, check_bf16)
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
        if out.dtype != want.dtype:
            raise AssertionError(f"{name}: {out.dtype} out of a "
                                 f"{want.dtype} input")
        rel_max, rel_rms, rel_q = check_bf16(name, out, want)
        return dict(max_abs_err=(out.float() - want.float()).abs().max().item(),
                    rel_max_err=rel_max, rel_rms_err=rel_rms, rel_q_err=rel_q,
                    dtype=str(out.dtype).replace("torch.", ""))

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
        q, k = rotary.apply_rot_emb(q, k, sin.to(qkv.dtype), cos.to(qkv.dtype))
        return q.contiguous(), k.contiguous(), v.contiguous()

    rows = []
    t_sin, t_cos = tables(rotary.time_rotary_sincos(f, dh))

    # the rows added beside the main-path shapes draw from a generator of
    # their own, so the main-path rows see the inputs they always saw
    gen_more = torch.Generator(device=dev).manual_seed(seed + 1)

    def divided_row(axis, b_, f_, n_, g=gen_more, dtype=torch.bfloat16):
        if axis == "space":
            sin, cos = tables(rotary.axial_rotary_sincos(32, n_ // 32, dh)
                              if n_ >= 1024 else
                              rotary.axial_rotary_sincos(16, n_ // 16, dh))
        else:
            sin, cos = t_sin, t_cos
        qkv = torch.randn((b_, f_, n_, 3 * hd), generator=g,
                          device=dev).to(dtype)
        size = qkv.element_size()
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
        nbytes = (qkv.numel() + b_ * f_ * n_ * hd) * size + 2 * sin.numel() * 4
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

    def packed_row(b_, l_, g=gen_more, dtype=torch.bfloat16):
        qkv = torch.randn((b_, l_, 3 * c), generator=g, device=dev).to(dtype)
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
            nbytes=(qkv.numel() + b_ * l_ * c) * qkv.element_size(),
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
            nbytes=q.element_size() * (2 * q.numel() + 2 * k.numel()),
            flops=4.0 * b_ * nq_ * k.shape[1] * d_,
            scores=b_ * nq_ * k.shape[1])

    def randn(*shape, g=gen, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # one-pass: the UNet joint attention right after the last upsample
    # (C = 256, 8 heads → [B·8, 2048, 32]); then the modular path's shapes:
    # TimeSformer space attention, the UNet's dh = 16 joint and xy-plane
    # attentions; then sample_long's B = 1
    def onepass_row(b_, n_, d_, g=gen, dtype=torch.bfloat16):
        q, k, v = (randn(b_, n_, d_, g=g, dtype=dtype) for _ in range(3))
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

    # the 256-channel UNet's one-pass shapes at B = 2 (bf16, inference): the
    # ds = 1 attentions at dh = 32 and the joint attention after the last
    # upsample at C = 512 (the wgmma tile's K ring without the rotary)
    gen_b2 = torch.Generator(device=dev).manual_seed(seed + 2)
    rows += [onepass_row(16, 1024, 32, g=gen_b2),
             onepass_row(16, 2048, 64, g=gen_b2)]
    # float32 in and out, at the shapes train-diffusion gives the kernels at
    # B = diffusion_batch_size: the frozen AEs' extract and the UNet's
    # packed and one-pass attentions. bf16 operands through the cast passes
    # of convert.py, whose time counts in the row; held to the same limits
    # against the float32 plain version
    gen_f32 = torch.Generator(device=dev).manual_seed(seed + 3)
    tb = TRAIN_BATCH
    rows += [divided_row("space", tb, f, n, g=gen_f32, dtype=torch.float32),
             divided_row("time", tb, f, n, g=gen_f32, dtype=torch.float32),
             packed_row(tb, l, g=gen_f32, dtype=torch.float32),
             packed_row(tb, 1024, g=gen_f32, dtype=torch.float32),
             onepass_row(tb * heads, l, 32, g=gen_f32, dtype=torch.float32)]
    # float32 at B = 1, the shape train-first-stage gives them: its AE
    # trains through them, so beside each row the backward of one call as
    # RecomputeThroughPlain runs it (the plain version recomputed, then its
    # vjp), which a backward kernel would replace
    gen_fs = torch.Generator(device=dev).manual_seed(seed + 5)
    for axis in ("space", "time"):
        row = divided_row(axis, 1, f, n, g=gen_fs, dtype=torch.float32)
        sin, cos = (tables(rotary.axial_rotary_sincos(32, n // 32, dh))
                    if axis == "space" else (t_sin, t_cos))
        x = torch.randn((1, f, n, 3 * hd), generator=gen_fs,
                        device=dev).requires_grad_()
        cot = torch.randn((1, f, n, hd), generator=gen_fs, device=dev)
        plain = lambda t, sin=sin, cos=cos, axis=axis: \
            dv.divided_attention_reference(t, sin, cos, axis, heads, dh,
                                           scale, use_flash=False)
        row["plain_backward_ms"] = device_ms(
            torch, lambda: torch.autograd.grad(plain(x), x, cot))
        rows.append(row)
        del x, cot
    # float32 at B = 1, the shapes a full-width golden record gives the
    # UNet's packed and one-pass kernels
    rows += [packed_row(1, l, g=gen_fs, dtype=torch.float32),
             packed_row(1, 1024, g=gen_fs, dtype=torch.float32),
             onepass_row(heads, l, 32, g=gen_fs, dtype=torch.float32)]

    # the cast passes' share of each float32 row: the time of convert.py's
    # two passes alone on tensors of the row's input and output sizes
    from moditalker_tpu_torch.ops.kernels import convert

    for row in rows:
        if row["dtype"] != "float32":
            continue
        shapes = ([row["shape"][0], row["shape"][1], row["shape"][1]]
                  if isinstance(row["shape"][0], list) else [row["shape"]])
        ins = [torch.randn(sh, device=dev) for sh in shapes]
        out_numel = (int(np.prod(shapes[0])) if len(shapes) == 3
                     else int(np.prod(shapes[0])) // 3)
        out = torch.empty(out_numel, dtype=torch.bfloat16, device=dev)
        row["cast_ms"] = (
            time_ms(torch, lambda: [convert.to_bf16(t) for t in ins])
            + time_ms(torch, lambda: convert.to_float32(out)))
        del ins, out

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
        log(f"{row['name']} at {row['shape']} {row['dtype']}: max abs err "
            f"{row['max_abs_err']:.3e}, relative max {row['rel_max_err']:.3e}"
            f", rms {row['rel_rms_err']:.3e} and {QUANTILE} quantile "
            f"{row['rel_q_err']:.3e} (limits {BF16_LIMITS[row['name']]}, "
            f"{QUANTILE_LIMITS[row['name']]}), kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), softmax "
            f"floor {floor_ms:.4f} ms"
            + (f", {row['design']}" if "design" in row else "")
            + (f", of which the cast passes {row['cast_ms']:.4f} ms"
               if "cast_ms" in row else "")
            + (f"; the plain version's backward of one call "
               f"{row['plain_backward_ms']:.4f} ms"
               if "plain_backward_ms" in row else "")
            + (f", before the redesign {before:.4f} ms" if before else ""))
    return rows


def gradient_phase(torch, seed: int) -> list[dict]:
    """Each differentiable kernel wrapper under a gradient, float32: its
    output must carry the ``autograd.Function``'s ``grad_fn`` and the kernel
    must have launched once; its input gradients must agree with autograd
    through the plain version within GRAD_LIMIT. Packed and one-pass at the
    shapes train-diffusion's UNet gives them, space and time at B = 1 (the
    frozen AEs run them forward only). The packed, space and time backwards
    are the plain version's vjp, so for them this checks the wiring only;
    one-pass's backward is ``sdpa_adjoints``, written out, an independent
    computation."""
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import LAUNCHES
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    heads, dh, f, n = 8, 64, 16, 1024

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def tables(sin_cos):
        return [torch.from_numpy(t).to(dev) for t in sin_cos]

    def divided(axis, sin, cos):
        return ([randn(1, f, n, 3 * heads * dh)],
                lambda x: dv.divided_attention(x, sin, cos, axis, heads, dh,
                                               dh**-0.5),
                lambda x: dv.divided_attention_reference(
                    x, sin, cos, axis, heads, dh, dh**-0.5, use_flash=False))

    cases = {
        "divided_space_attention": divided(
            "space", *tables(rotary.axial_rotary_sincos(32, n // 32, dh))),
        "divided_time_attention": divided(
            "time", *tables(rotary.time_rotary_sincos(f, dh))),
        "packed_attention": (
            [randn(TRAIN_BATCH, 2048, 384)],
            lambda x: pk.packed_attention(x, heads, 0.25),
            lambda x: pk.packed_attention_reference(x, heads, 0.25)),
        "onepass_attention": (
            [randn(TRAIN_BATCH * heads, 2048, 32) for _ in range(3)],
            lambda *x: fa.onepass_attention(*x, 32**-0.5),
            lambda *x: fa.onepass_attention_reference(*x, 32**-0.5)),
    }
    rows = []
    for name, (inputs, kern, plain) in cases.items():
        grads, peaks, cot, fn_name = {}, {}, None, None
        for which, fn in (("kernel", kern), ("plain", plain)):
            xs = [x.detach().requires_grad_() for x in inputs]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = LAUNCHES[name]
            out = fn(*xs)
            if which == "kernel":
                fn_name = type(out.grad_fn).__name__
                if (LAUNCHES[name] != before + 1
                        or fn_name not in ("RecomputeThroughPlainBackward",
                                           "FlashSdpaBackward")):
                    raise AssertionError(
                        f"{name}: launches {LAUNCHES[name] - before}, "
                        f"grad_fn {fn_name}")
            if cot is None:
                cot = torch.randn(out.shape, generator=gen, device=dev)
            grads[which] = torch.autograd.grad(out, xs, cot)
            torch.cuda.synchronize()
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(grads["kernel"], grads["plain"]))
        log(f"gradient {name} at {[list(x.shape) for x in inputs]} float32: "
            f"grad_fn {fn_name}, input gradient vs autograd through the "
            f"plain version {err:.3e} (limit {GRAD_LIMIT}); peak memory "
            f"{peaks['kernel']:.2f} GiB through the kernel, "
            f"{peaks['plain']:.2f} through the plain version")
        if not err <= GRAD_LIMIT:
            raise AssertionError(f"{name}: the gradient through the kernel "
                                 f"disagrees with the plain version's")
        rows.append({"name": name, "shape": [list(x.shape) for x in inputs],
                     "grad_fn": fn_name, "rel_max_err": err,
                     "peak_gib": peaks})
    return rows


# ------------------------------------------------------------------ training
@contextlib.contextmanager
def gradient_cut():
    """The kernel wrappers with their ``autograd.Function``s taken out: the
    kernel's output then carries no ``grad_fn`` (what the wrappers returned
    before they had one), so the gradient stops at every attention."""
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    class Recompute:
        @staticmethod
        def apply(x, forward, plain):
            return forward(x.detach())

    class Flash:
        @staticmethod
        def apply(q, k, v, scale, forward):
            return forward(q.detach(), k.detach(), v.detach(), scale)

    kept = pk.RecomputeThroughPlain, dv.RecomputeThroughPlain, fa.FlashSdpa
    pk.RecomputeThroughPlain = dv.RecomputeThroughPlain = Recompute
    fa.FlashSdpa = Flash
    try:
        yield
    finally:
        pk.RecomputeThroughPlain, dv.RecomputeThroughPlain, fa.FlashSdpa = kept


def seeded_state(torch, build, seed: int) -> dict:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build().state_dict()


def train_step_check(torch, seed: int) -> dict:
    """One train-diffusion step at a small depth but the full spatial size
    (so that every kernel gate passes; B = 2) on the card and on the CPU
    from the same AE and UNet weights, batch and draws, float32: the loss,
    the UNet's gradient and its update within TRAIN_LIMITS, and the same
    step with the gradient cut at the attentions (``gradient_cut``) outside
    them."""
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovTrainConfig, MtovUNetConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    # channel_mult (1, 2): the last upsample lands C = 256 at ds = 1, so the
    # joint attention there takes the one-pass kernel, as in the full UNet
    unet_cfg = MtovUNetConfig(num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,))
    tc = MtovTrainConfig(seed=seed)
    aes = [seeded_state(torch, lambda: ViTAutoencoder(ae_cfg), seed + i)
           for i in (11, 12)]
    unet = seeded_state(torch, lambda: TriplaneUNet(unet_cfg), seed)
    batch = synthetic_mtov_batch(2, ae_cfg.timesteps, ae_cfg.resolution, seed)
    diff_cfg = MtovDiffusionConfig()
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, diff_cfg.timesteps, (2,), generator=g)
    noise = torch.randn((2, 4, ae_cfg.latent_len), generator=g)

    def step(device, cut=False):
        trainer = MtovDiffusionTrainer(unet_cfg, diff_cfg, tc, device=device,
                                       state_dict=unet)
        models = []
        for state in aes:
            m = ViTAutoencoder(ae_cfg)
            m.load_state_dict(state)
            models.append(m)
        loop = LatentDiffusionLoop(trainer, *models)
        reset_launch_counts()
        with gradient_cut() if cut else contextlib.nullcontext():
            m = loop.train_step(batch, draws=(t.to(device),
                                              noise.to(device)))
        out = {"loss": m["loss"].item(), "launches": launches_by_shape()}
        for name, p in trainer.model.named_parameters():
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            out.setdefault("grad", {})[name] = grad.detach().cpu()
            out.setdefault("update", {})[name] = (p.detach().cpu()
                                                  - unet[name])
        return out

    def rel(a, b):
        num = sum(float((a[k] - b[k]).square().sum()) for k in b)
        den = sum(float(b[k].square().sum()) for k in b)
        return (num / den) ** 0.5

    cpu = step("cpu")
    result = {}
    for label, cut in (("card", False), ("card, gradient cut", True)):
        card = step("cuda", cut)
        errs = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "grad": rel(card["grad"], cpu["grad"]),
                "update": rel(card["update"], cpu["update"])}
        within = all(errs[k] <= TRAIN_LIMITS[k] for k in errs)
        log(f"train-diffusion step at small depth ({label}) vs cpu, float32:"
            f" loss {card['loss']:.6f} vs {cpu['loss']:.6f}, relative "
            f"errors {errs} (limits {TRAIN_LIMITS}); launches "
            f"{card['launches']}")
        if cut == within:
            raise AssertionError(
                f"train-diffusion ({label}): " + (
                    "the step with the gradient cut at the attentions "
                    "passes the card-vs-cpu limits" if cut else
                    "the card's step disagrees with the cpu's"))
        if not cut and set(card["launches"]) != FUSED_PATH:
            raise AssertionError(f"train-diffusion step: launches "
                                 f"{card['launches']}")
        result[label] = errs
    return result


def train_diffusion_phase(torch, seed: int) -> dict:
    """``LatentDiffusionLoop.fit`` at the full width (config.py: AE 384 wide,
    depth 8, 256² × 16 frames; UNet 128 channels) at B =
    diffusion_batch_size, float32, on a synthetic batch with AE and UNet
    weights from ``seed``: one untimed step, then 5 timed (steps/s, video
    clips/s, the peak memory, the launches by kernel and shape: the divided
    space and time, packed and one-pass kernels and no other), every loss
    finite; then ``train_step_check``."""
    import itertools

    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovTrainConfig, MtovUNetConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import ViTAutoencoder
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    ae_cfg, unet_cfg = MtovAEConfig(), MtovUNetConfig()
    tc = MtovTrainConfig(seed=seed)
    b, steps = tc.diffusion_batch_size, 5
    models = []
    for i in (11, 12):
        m = ViTAutoencoder(ae_cfg)
        m.load_state_dict(seeded_state(torch, lambda: ViTAutoencoder(ae_cfg),
                                       seed + i))
        models.append(m)
    trainer = MtovDiffusionTrainer(unet_cfg, MtovDiffusionConfig(), tc)
    loop = LatentDiffusionLoop(trainer, *models)
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)

    class Losses:
        def __init__(self):
            self.seen = []

        def log_scalars(self, step, scalars):
            self.seen.append(scalars["loss"])

    losses = Losses()
    loop.fit(itertools.repeat(batch), max_steps=1, logger=losses,
             log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    loop.fit(itertools.repeat(batch), max_steps=steps, logger=losses,
             log_every=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = check_launches("train-diffusion", FUSED_PATH)
    by_shape = launches_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (len(losses.seen) == steps + 1
            and all(np.isfinite(losses.seen))):
        raise AssertionError(f"train-diffusion: losses {losses.seen}")
    per_step = {k: v / steps for k, v in counts.items() if v}
    log(f"train-diffusion (full width, B = {b}, float32): {steps} steps in "
        f"{dt:.3f} s = {steps / dt:.4f} steps/s = {steps * b / dt:.3f} clips/s"
        f"; peak memory {peak:.2f} GiB; losses {losses.seen}; launches per "
        f"step {per_step}, by shape over the {steps} steps {by_shape}")
    dev = loop.to_device(batch)
    traced = trace(torch, lambda: loop.train_step(dev))
    log_trace("train-diffusion step (batch on the card)", traced)
    del loop, trainer, models, dev
    torch.cuda.empty_cache()
    check = train_step_check(torch, seed)
    return {"launches": counts, "launches_by_shape": by_shape,
            "steps_per_s": steps / dt, "clips_per_s": steps * b / dt,
            "peak_gib": peak, "losses": losses.seen, "card_vs_cpu": check,
            "trace": traced}


def train_atom_phase(torch, seed: int) -> dict:
    """``AtomTrainer.fit`` at the full width (d = 512, 8 layers, horizon 156)
    at batch 64, float32, on a synthetic batch: one untimed step, then 5
    timed (sequences/s); no kernel launches. Then three steps on the card
    against the CPU at batch 8 from the same weights, batch and draws,
    dropout off: each step's losses within ATOM_LIMIT of the CPU's, and
    every parameter within ATOM_PARAM_LIMIT but at ill-conditioned Adan
    elements (``align_adan``)."""
    from moditalker_tpu_torch.config import (AtomDiffusionConfig,
                                             AtomModelConfig, AtomTrainConfig)
    from moditalker_tpu_torch.data.atom_dataset import synthetic_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.atom import AtomTrainer, host_batch

    mc, dc = AtomModelConfig(), AtomDiffusionConfig()
    tc = AtomTrainConfig(seed=seed)
    steps = 5

    class Repeat:
        def __init__(self, batch):
            self.batch = batch

        def iter_epoch(self, batch_size, seed=0):
            while True:
                yield self.batch

    trainer = AtomTrainer(mc, dc, tc)
    data = Repeat(synthetic_batch(tc.batch_size, mc.horizon, seed))
    trainer.fit(data, epochs=1, max_steps=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(data, epochs=1, max_steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = check_launches("train-atom", set())
    log(f"train-atom (full width, batch {tc.batch_size}, float32): {steps} "
        f"steps in {dt:.3f} s = {steps * tc.batch_size / dt:.3f} sequences/s"
        f" ({steps / dt:.4f} steps/s); step {state['step']}; launches "
        f"{counts}")
    dev = trainer.to_device(host_batch(data.batch, mc.horizon))
    traced = trace(torch, lambda: trainer.train_step(dev))
    log_trace("train-atom step (batch on the card)", traced)
    del trainer, state, dev

    small = AtomTrainConfig(batch_size=8, seed=seed)
    batch = synthetic_batch(small.batch_size, mc.horizon, seed + 1)
    card, cpu = AtomTrainer(mc, dc, small), AtomTrainer(mc, dc, small,
                                                        device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = host_batch(batch, mc.horizon)["residual"]
    errs, aligned = [], 0
    for step in (1, 2, 3):
        draws = card.diff.draw_loss_inputs(g, x)
        before = {k: q.detach().clone()
                  for k, q in cpu.model.named_parameters()}
        a = card.step(batch, [d.cuda() for d in draws], deterministic=True)
        b = cpu.step(batch, draws, deterministic=True)
        errs.append(max(abs(a[k].item() - b[k].item()) / abs(b[k].item())
                        for k in a))
        aligned += align_adan(torch, card, cpu, step, before)
    n = sum(p.numel() for p in cpu.model.parameters())
    log(f"train-atom card vs cpu, three steps at batch 8 (dropout off, TF32 "
        f"off): largest relative loss error per step {errs} (limit "
        f"{ATOM_LIMIT}); parameters within {ATOM_PARAM_LIMIT} but "
        f"{aligned} of {n} elements at ill-conditioned Adan steps, aligned")
    if max(errs) > ATOM_LIMIT:
        raise AssertionError("train-atom: the card's losses disagree with "
                             "the cpu's")
    return {"launches": counts, "sequences_per_s": steps * tc.batch_size / dt,
            "card_vs_cpu_loss_rel_err": errs, "adan_aligned": aligned,
            "parameters": n, "trace": traced}


def align_adan(torch, card, cpu, step: int, before: dict) -> int:
    """Holds every parameter of the card's AToM trainer within
    ATOM_PARAM_LIMIT of the CPU's, except where the CPU's Adan step is
    ill-conditioned: sqrt(n̂) below ADAN_ILL (a gradient at the noise floor,
    stepped by about lr in the direction of its rounding) or a step larger
    than ADAN_BIG·lr (on step 2, where n is one cancellation squared). Those
    elements are set to the CPU's values, parameters, EMA and Adan state,
    so the next step starts from one state. ``before``: the CPU's
    parameters before this step. Returns their count."""
    lr = cpu.train_cfg.learning_rate
    aligned = 0
    with torch.no_grad():
        for (name, p), q in zip(card.model.named_parameters(),
                                cpu.model.parameters()):
            st_p, st_q = card.opt.state[p], cpu.opt.state[q]
            nhat = st_q["n"] / (1.0 - 0.99**step)
            moved = q - before[name]
            off = (p.cpu() - q).abs() > ATOM_PARAM_LIMIT
            ill = (nhat.sqrt() < ADAN_ILL) | (moved.abs() > ADAN_BIG * lr)
            if (off & ~ill).any():
                raise AssertionError(
                    f"train-atom step {step} {name}: "
                    f"{int((off & ~ill).sum())} well-conditioned elements "
                    f"off by up to "
                    f"{float((p.cpu() - q).abs()[~ill].max()):.3e}")
            if off.any():
                aligned += int(off.sum())
                idx = off.to(p.device)
                p[idx] = q.to(p.device)[idx]
                card.ema[name][idx] = cpu.ema[name].to(p.device)[idx]
                for k in ("m", "v", "n", "prev_grad"):
                    st_p[k][idx] = st_q[k].to(p.device)[idx]
    return aligned


@contextlib.contextmanager
def plain_backward_events(torch):
    """Every ``RecomputeThroughPlain`` backward in the block between two CUDA
    events: yields the list of (start, end) pairs."""
    from moditalker_tpu_torch.ops.kernels.autograd import \
        RecomputeThroughPlain as fn

    events, kept = [], vars(fn)["backward"]

    def backward(ctx, g):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = kept.__func__(ctx, g)
        pair[1].record()
        events.append(pair)
        return out

    fn.backward = staticmethod(backward)
    try:
        yield events
    finally:
        fn.backward = kept


def first_stage_check(torch, seed: int) -> dict:
    """One G cycle and one D cycle of ``FirstStageTrainer`` at a small depth
    but the full spatial size (AE 64 wide, depth 1, 2 heads of 64, so that
    the space and time gates pass; the published discriminators and full
    LPIPS-VGG16; B = 1, accumulation 3, disc_start −1) on the card and on
    the CPU from the same weights, clips and frame draws, float32: every
    loss term, the mean gradients and the updates within
    FIRST_STAGE_LIMITS; the same G cycle with the gradient cut at the
    attentions (``gradient_cut``) outside them. The card launches the space
    and time kernels and no other."""
    from moditalker_tpu_torch.config import (MtovAEConfig, MtovLossConfig,
                                             MtovTrainConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    loss_cfg, tc = MtovLossConfig(disc_start=-1), MtovTrainConfig(seed=seed)
    k = tc.accum_iter
    videos = [synthetic_mtov_batch(1, ae_cfg.timesteps, ae_cfg.resolution,
                                   seed + i)["x"] for i in range(k)]
    g = torch.Generator().manual_seed(seed)
    draws = [torch.randint(0, ae_cfg.timesteps, (1,), generator=g)
             for _ in range(2 * k)]

    def params(tr, what):
        nets = {"ae": [tr.ae], "disc": [tr.disc2d, tr.disc3d]}[what]
        return {f"{i}.{n}": p for i, m in enumerate(nets)
                for n, p in m.named_parameters()}

    def cycles(device, cut=False):
        tr = FirstStageTrainer(ae_cfg, loss_cfg, tc, device=device)
        before = {w: {n: p.detach().cpu().clone()
                      for n, p in params(tr, w).items()}
                  for w in ("ae", "disc")}
        out = {"losses": []}
        reset_launch_counts()
        with gradient_cut() if cut else contextlib.nullcontext():
            for i in range(k if cut else 2 * k):
                m = tr.step(videos[i % k], draws[i])
                out["losses"].append({n: v.item() for n, v in m.items()})
        out["launches"] = launches_by_shape()
        for w in ("ae",) if cut else ("ae", "disc"):
            now = params(tr, w)
            out[f"{w}_grad"] = {n: p.grad.cpu() for n, p in now.items()}
            out[f"{w}_update"] = {n: p.detach().cpu() - before[w][n]
                                  for n, p in now.items()}
        return out

    def rel(a, b):
        num = sum(float((a[n] - b[n]).square().sum()) for n in b)
        den = sum(float(b[n].square().sum()) for n in b)
        return (num / den) ** 0.5

    cpu = cycles("cpu")
    result = {}
    for label, cut in (("card", False), ("card, gradient cut", True)):
        card = cycles("cuda", cut)
        errs = {"loss": max(abs(a[n] - b[n]) / abs(b[n])
                            for a, b in zip(card["losses"], cpu["losses"])
                            for n in b)}
        for w in ("ae",) if cut else ("ae", "disc"):
            for q in ("grad", "update"):
                errs[f"{w}_{q}"] = rel(card[f"{w}_{q}"], cpu[f"{w}_{q}"])
        within = all(errs[n] <= FIRST_STAGE_LIMITS[n] for n in errs)
        log(f"train-first-stage G{'' if cut else ' and D'} cycle at small "
            f"depth ({label}) vs cpu, float32: relative errors {errs} "
            f"(limits {FIRST_STAGE_LIMITS}); launches {card['launches']}")
        if cut == within:
            raise AssertionError(
                f"train-first-stage ({label}): " + (
                    "the G cycle with the gradient cut at the attentions "
                    "passes the card-vs-cpu limits" if cut else
                    "the card's cycles disagree with the cpu's"))
        if not cut and set(card["launches"]) != FIRST_STAGE_PATH:
            raise AssertionError(f"train-first-stage cycles: launches "
                                 f"{card['launches']}")
        result[label] = errs
    return result


def train_first_stage_phase(torch, seed: int) -> dict:
    """``FirstStageTrainer.fit`` at configs/autoencoder/base_gan.yaml's
    operating point (config.py's AE: 384 wide, depth 8, 256² × 16 frames;
    disc_start −1; B = batch_size = 1, accum_iter = 3; float32), weights
    from ``seed``, on a synthetic clip: one G and one D cycle untimed, then
    two of each timed (iterations/s, clips/s, peak memory, launches by
    shape: the divided space and time kernels and no other), every loss
    finite; each micro-step of one more G and D cycle timed apart; one G
    step traced, with the device time of the space and time backwards in
    it (``plain_backward_events``); then ``first_stage_check``."""
    import itertools

    from moditalker_tpu_torch.config import (MtovAEConfig, MtovLossConfig,
                                             MtovTrainConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    ae_cfg, tc = MtovAEConfig(), MtovTrainConfig(seed=seed)
    trainer = FirstStageTrainer(ae_cfg, MtovLossConfig(disc_start=-1), tc)
    b, k, cycles = tc.batch_size, tc.accum_iter, 2
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)

    class Losses:
        def __init__(self):
            self.seen = []

        def log_scalars(self, step, scalars):
            self.seen.append(scalars)

    losses = Losses()
    trainer.fit(itertools.repeat(batch), max_steps=2 * k, logger=losses,
                log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    iters = 2 * k * cycles
    t0 = time.perf_counter()
    trainer.fit(itertools.repeat(batch), max_steps=2 * k + iters,
                logger=losses, log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = check_launches("train-first-stage", FIRST_STAGE_PATH)
    by_shape = launches_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = [v for row in losses.seen for v in row.values()]
    if len(losses.seen) != 2 * k + iters or not np.isfinite(values).all():
        raise AssertionError(f"train-first-stage: losses {losses.seen}")
    video = trainer.to_device(batch["x"])
    step_ms = {"g": [], "d": []}
    for _ in range(2 * k):
        kind = "d" if trainer._disc_phase else "g"
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.step(video)
        torch.cuda.synchronize()
        step_ms[kind].append((time.perf_counter() - t) * 1e3)
    with plain_backward_events(torch) as events:
        traced = trace(torch, lambda: trainer.step(video))
    backward_ms = sum(s.elapsed_time(e) for s, e in events)
    share = backward_ms / traced["device_busy_ms"]
    per_iter = {n: c / iters for n, c in counts.items() if c}
    g_ms, d_ms = (float(np.mean(step_ms[n])) for n in ("g", "d"))
    log(f"train-first-stage (full width, B = {b}, accumulation {k}, "
        f"float32): {iters} iterations ({cycles} G and {cycles} D cycles) "
        f"in {dt:.3f} s = {iters / dt:.4f} iterations/s = "
        f"{iters * b / dt:.4f} clips/s; G micro-step {g_ms:.2f} ms, D "
        f"micro-step {d_ms:.2f} ms (each {step_ms}); peak memory "
        f"{peak:.2f} GiB; launches per iteration {per_iter}, by shape over "
        f"the {iters} iterations {by_shape}; last losses {losses.seen[-2:]}")
    log_trace("train-first-stage G step (clip on the card)", traced)
    log(f"train-first-stage G step: {len(events)} space and time backwards "
        f"(the plain version's vjp, recomputed) take {backward_ms:.2f} ms of "
        f"its {traced['device_busy_ms']:.2f} ms device time ({share:.3f})")
    del trainer, video
    torch.cuda.empty_cache()
    check = first_stage_check(torch, seed)
    return {"launches": counts, "launches_by_shape": by_shape,
            "iterations_per_s": iters / dt, "clips_per_s": iters * b / dt,
            "g_step_ms": g_ms, "d_step_ms": d_ms, "peak_gib": peak,
            "plain_backward_ms": backward_ms,
            "plain_backward_share": share, "card_vs_cpu": check,
            "trace": traced}


def i3d_phase(torch, seed: int) -> dict:
    """InceptionI3d in float32 with random He-scaled weights: logits of
    [2, 16, 224, 224, 3] clips on the card against the CPU (within
    I3D_LIMIT), and the FVD of two sets of 8 synthetic clips through each
    (within FVD_LIMIT of each other); no kernel launch."""
    from moditalker_tpu_torch.evals.fvd import frechet_distance
    from moditalker_tpu_torch.evals.i3d import InceptionI3d, i3d_apply
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts

    model = InceptionI3d()
    _he_init(torch, model, torch.Generator().manual_seed(seed))
    cpu = model.eval()
    card = InceptionI3d().cuda().eval()
    card.load_state_dict(cpu.state_dict())
    on_card, on_cpu = i3d_apply(card), i3d_apply(cpu)
    rng = np.random.default_rng(seed)
    reset_launch_counts()
    x = rng.uniform(-1, 1, (2, 16, 224, 224, 3)).astype(np.float32)
    want = on_cpu(x)
    err = rel_err(on_card(x), want)
    real = rng.uniform(-1, 1, (8, 16, 224, 224, 3)).astype(np.float32)
    fake = np.clip(0.8 * real + rng.normal(scale=0.2, size=real.shape),
                   -1, 1).astype(np.float32)

    def embed(apply, videos):
        return np.concatenate([apply(videos[i:i + 4])
                               for i in range(0, len(videos), 4)])

    fvds = {name: frechet_distance(embed(apply, real), embed(apply, fake))
            for name, apply in (("card", on_card), ("cpu", on_cpu))}
    fvd_err = abs(fvds["card"] - fvds["cpu"]) / abs(fvds["cpu"])
    xt = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        ms = device_ms(torch, lambda: card(xt))
    counts = check_launches("i3d", set())
    log(f"i3d: logits of [2, 16, 224, 224, 3] card vs cpu in float32, max "
        f"abs err over max |cpu| {err:.3e} (limit {I3D_LIMIT}), max |cpu| "
        f"{np.abs(want).max():.3f}; FVD of two sets of 8 clips: card "
        f"{fvds['card']:.6f}, cpu {fvds['cpu']:.6f}, relative difference "
        f"{fvd_err:.3e} (limit {FVD_LIMIT}); {ms:.2f} ms per call of 2 clips "
        f"on the card; launches {counts}")
    if not (err <= I3D_LIMIT and fvd_err <= FVD_LIMIT and fvds["cpu"] > 0):
        raise AssertionError("i3d: the card disagrees with the CPU")
    return {"card_vs_cpu_rel_max_err": err, "fvd": fvds,
            "fvd_rel_err": fvd_err, "ms_per_2_clips": ms}


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


def trace(torch, fn) -> dict:
    """One synchronised call of ``fn`` under torch.profiler: its host time,
    the device's busy time (the sum of its kernels' times), the device's
    idle share of the call, the kernel count and the top kernels. The
    profiler's own host cost falls in the host time, so the idle share
    reads high for launch-bound code."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "kernels": sum(e.count for e in kern),
            "top": [(e.key[:60], e.self_device_time_total / 1e3)
                    for e in top]}


def log_trace(what: str, traced: dict) -> None:
    log(f"profile {what}: traced {traced['traced_wall_ms']:.2f} ms, device "
        f"busy {traced['device_busy_ms']:.2f} ms (idle share "
        f"{traced['idle_share']:.3f}), {traced['kernels']} kernels; top "
        f"{traced['top']}")


def device_ms(torch, fn, reps: int = 3) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls after a warm-up one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_flops(torch, model, fn, attention=()) -> float:
    """FLOPs of the convolutions and linear layers of ``model`` in one call
    of ``fn`` (2 per multiply-add, from the shapes each layer meets), and
    the two products of the self-attention in each module of a class in
    ``attention`` (input [B, T, D]: 4·B·T²·D)."""
    total = [0.0]

    def hook(m, inputs, out):
        if isinstance(m, attention):
            b, t, d = inputs[0].shape
            total[0] += 4.0 * b * t * t * d
        elif isinstance(m, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features
        else:
            total[0] += (2.0 * out.numel() * m.in_channels / m.groups
                         * float(np.prod(m.kernel_size)))

    kinds = (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d, *attention)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def rel_err(card, cpu) -> float:
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    if not np.isfinite(card).all():
        raise AssertionError("non-finite values on the card")
    return float(np.abs(card - cpu).max() / np.abs(cpu).max())


def audio_phase(torch, seed: int) -> dict:
    """HuBERT-large in float32: the card against the CPU on a 2 s clip, the
    ``process-audio`` command, the same chain timed warm, and the features
    through AToM to a landmark file."""
    import wave

    from moditalker_tpu_torch import cli
    from moditalker_tpu_torch.config import (AtomDiffusionConfig,
                                             AtomModelConfig)
    from moditalker_tpu_torch.models.atom import MotionDecoder
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.pipelines.atom_infer import \
        AtomInferencePipeline
    from moditalker_tpu_torch.preprocess import audio, hubert
    from moditalker_tpu_torch.preprocess.bfm import Face3DHelper

    torch.manual_seed(seed)
    model = hubert.HubertEncoder(hubert.HubertConfig()).eval()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    clip = audio.normalize_like_wav2vec2(rng.normal(size=32000))
    with torch.inference_mode():
        cpu = model(torch.from_numpy(clip[None]))[0].numpy()
    reset_launch_counts()
    card_fn = audio.hubert_forward(model, "cuda")
    err = rel_err(card_fn(clip[None]), cpu)
    log(f"audio: HuBERT-large ({n_params / 1e6:.1f} M parameters) on a 2 s "
        f"clip, card vs cpu in float32: max abs err over max |cpu| "
        f"{err:.3e} (limit {AUDIO_LIMIT}), max |cpu| {np.abs(cpu).max():.3f}")
    if err > AUDIO_LIMIT:
        raise AssertionError("audio: the card disagrees with the CPU")

    # one whole clip (20 s, T = 1000 frames) plus a 3 s tail, 16-bit mono
    n = audio.CLIP_LENGTH - audio.STRIDE + audio.KERNEL + 48000
    pcm = np.clip(rng.normal(scale=0.1, size=n) * 32767, -32767, 32767)
    with tempfile.TemporaryDirectory() as tmp:
        wav_path, out = os.path.join(tmp, "a.wav"), os.path.join(tmp, "h.npy")
        with wave.open(wav_path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.astype(np.int16).tobytes())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["process-audio", "--audio", wav_path, "--out", out,
                  "--seed", str(seed)])
        dt_cli = time.perf_counter() - t0
        from_cli = np.load(out)
        speech = audio.normalize_like_wav2vec2(cli._read_wav(wav_path))
    want_t = audio.expected_num_frames(n)
    for label in ("audio features (warm-up)", "audio features"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = audio.extract_hubert_features(speech, card_fn)
        dt = time.perf_counter() - t0
    rate = n / 16000 / dt
    traced = trace(torch, lambda: audio.extract_hubert_features(speech,
                                                                 card_fn))
    log_trace("audio features", traced)
    # the operations of the chain as it runs (the tail chunk bucketed)
    cfg = model.cfg
    flops = layer_flops(
        torch, model, lambda: audio.extract_hubert_features(speech, card_fn),
        attention=(hubert.EncoderLayerStableLN,))
    audio_bound_ms = flops / H100_FP32_FLOPS * 1e3
    x = torch.randn((1, 1000, cfg.hidden_size), device="cuda")
    wave_clip = torch.randn((1, audio.CLIP_LENGTH - audio.STRIDE
                             + audio.KERNEL), device="cuda")
    with torch.inference_mode():
        part_ms = {
            "feature_extractor": device_ms(
                torch, lambda: model.feature_extractor(wave_clip)),
            "pos_conv": device_ms(torch, lambda: model.pos_conv(x)),
            "24 layers": cfg.num_layers * device_ms(
                torch, lambda: model.layer_0(x))}
    log(f"audio: {flops / 1e12:.3f} TFLOP over {n / 16000:.2f} s of audio: "
        f"{flops / dt / 1e12:.2f} TFLOP/s in the timed run, bound "
        f"{audio_bound_ms:.2f} ms (operations, float32 at "
        f"{H100_FP32_FLOPS / 1e12:.0f} TFLOP/s); device ms per 20 s clip by "
        f"part: {part_ms}")
    log(f"{label}: {n} samples ({n / 16000:.2f} s of audio, chunks "
        f"{audio.chunk_bounds(n)}) → {list(feats.shape)} in {dt:.3f} s = "
        f"{rate:.2f} s of audio per s; the process-audio command (weights "
        f"drawn on the CPU, wav read, run) {dt_cli:.2f} s")
    width = model.cfg.hidden_size
    if feats.shape != (want_t, width) or not np.isfinite(feats).all():
        raise AssertionError(f"audio: features {feats.shape}, want "
                             f"[{want_t}, {width}]")
    cli_err = rel_err(from_cli, feats)
    if from_cli.shape != feats.shape or cli_err > AUDIO_LIMIT:
        raise AssertionError(f"audio: process-audio wrote {from_cli.shape}, "
                             f"{cli_err:.3e} from the chain's features")
    counts = check_launches("audio", set())

    mc = AtomModelConfig()
    torch.manual_seed(seed)
    pipe = AtomInferencePipeline(MotionDecoder(mc).state_dict(), mc,
                                 AtomDiffusionConfig(),
                                 face3d=Face3DHelper.synthetic(seed))
    with tempfile.TemporaryDirectory() as tmp:
        paths = pipe.run_directory(
            {"id0": (rng.normal(scale=0.3, size=(68, 3)), feats)}, tmp,
            seed=seed)
        lm = np.load(paths["id0"])
    if (lm.shape != (mc.horizon, 68, 3) or not np.isfinite(lm).all()
            or lm.std() == 0):
        raise AssertionError(f"audio → atom: bad landmarks {lm.shape}")
    counts_atom = check_launches("audio → atom", set())
    log(f"audio → atom: {want_t} HuBERT frames → landmarks {list(lm.shape)}; "
        f"launches {counts} and {counts_atom}")
    return {"launches": counts, "audio_s_per_s": rate,
            "card_vs_cpu_rel_max_err": err, "lm68_atom": lm,
            "trace": traced, "tflop": flops / 1e12,
            "bound_ms": audio_bound_ms, "clip_device_ms": part_ms}


def _he_init(torch, module, gen) -> None:
    """Variance-keeping random weights (normal, std sqrt(2 / fan in)) for
    every conv and linear layer, zero biases: deep ReLU stacks at torch's
    default init shrink their activations layer by layer, and the argmaxes
    this phase compares across devices need outputs that vary with the
    input."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()


def align_states(torch, seed: int, frame: np.ndarray, face: tuple) -> tuple:
    """S3FD, FAN and ReconNet state_dicts drawn from ``seed``, but for two
    heads. S3FD's face score is a synthetic detector of ``frame``'s "face"
    (the square ``face`` = (lo, hi) of the uint8 frame): its stride-4 face
    logit is FACE_GAIN · û · (f − (μ_face + μ_rest) / 2), f the
    L2-normalised conv3_3 feature at the anchor, μ the mean f over the face
    and over the rest of the frame, û the unit vector along their
    difference; every other conf weight is zero. So every frame detects, at
    an anchor on its face, with a clear best anchor (a random head picks one
    anywhere, often where the frame's zero padding meets a flat border).
    ReconNet's zero-initialised heads get small weights, so that the
    coefficients are not all zero."""
    from moditalker_tpu_torch.preprocess.fan import FAN
    from moditalker_tpu_torch.preprocess.recon_net import ReconNet
    from moditalker_tpu_torch.preprocess.s3fd import S3FD, preprocess_frames

    gen = torch.Generator().manual_seed(seed)
    s3fd_net, fan_net, recon_net = S3FD(), FAN(num_modules=4), ReconNet()
    for net in (s3fd_net, fan_net, recon_net):
        _he_init(torch, net, gen)
    with torch.inference_mode():
        f3 = s3fd_net.features(preprocess_frames(
            torch.from_numpy(frame[None])))["f3"][0]          # [256, h, w]
    inside = torch.zeros(f3.shape[1:], dtype=torch.bool)
    lo, hi = (v // 4 for v in face)                        # stride 4
    inside[lo:hi, lo:hi] = True
    mu_face, mu_rest = f3[:, inside].mean(dim=1), f3[:, ~inside].mean(dim=1)
    u = (mu_face - mu_rest) / (mu_face - mu_rest).norm()
    s3fd, fan, recon = (net.state_dict()
                        for net in (s3fd_net, fan_net, recon_net))
    for key in s3fd:
        if "_mbox_conf" in key:
            s3fd[key].zero_()
    # [4, 256, 3, 3]: output 3 is the face logit (0-2 are maxed into the
    # background), at the center tap
    s3fd["conv3_3_norm_mbox_conf.weight"][3, :, 1, 1] = FACE_GAIN * u
    s3fd["conv3_3_norm_mbox_conf.bias"][3] = -FACE_GAIN * float(
        u @ (mu_face + mu_rest) / 2)
    for key in recon:
        if key.startswith("head_") and key.endswith("weight"):
            recon[key].copy_(torch.randn(recon[key].shape, generator=gen)
                             * 2e-3)
    return s3fd, fan, recon


def align_phase(torch, seed: int, lm68_atom: np.ndarray) -> dict:
    """The alignment stack at full width in float32: nets and the fused
    chunk on the card against the CPU, then ``align_sequence`` over 156
    frames timed warm."""
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.preprocess import fused_align
    from moditalker_tpu_torch.preprocess.drivers import build_detectors
    from moditalker_tpu_torch.preprocess.motion_align import (HORIZON,
                                                              MotionAligner)
    from moditalker_tpu_torch.preprocess.s3fd import preprocess_frames

    # driving frames: noise (the "face") in a central square on black,
    # where a talking head sits
    side, lo, hi = 512, 128, 384
    rng = np.random.default_rng(seed)
    frames = np.zeros((HORIZON, side, side, 3), np.uint8)
    frames[:, lo:hi, lo:hi] = rng.integers(0, 256, (HORIZON, hi - lo,
                                                    hi - lo, 3))
    states = align_states(torch, seed, frames[0], (lo, hi))
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, state in zip(("s3fd", "fan", "recon"), states):
            paths.append(os.path.join(tmp, f"{name}.pt"))
            torch.save(state, paths[-1])
        t0 = time.perf_counter()
        landmark_fn, coeff_fn, lm3d_std, _, fused = build_detectors(
            *paths, device="cuda")
        log(f"align: build_detectors from state_dicts in "
            f"{time.perf_counter() - t0:.2f} s")
    cpu = fused_align.FusedAligner(*states, lm3d_std, device="cpu")

    # the nets on the same inputs, then the fused chunk, card vs cpu
    two = frames[:2]
    errs = {}
    with torch.inference_mode():
        got_rows = fused.chunk_rows(two)
        want_rows = cpu.chunk_rows(two)
        maps = [m.cpu() for m in fused.s3fd(preprocess_frames(
            torch.from_numpy(two).cuda()))]
        errs["s3fd maps"] = max(rel_err(g, w) for g, w in zip(
            maps, cpu.s3fd(preprocess_frames(torch.from_numpy(two)))))
        got = fused_align.FusedAligner.unpack(got_rows.cpu().numpy())
        want = fused_align.FusedAligner.unpack(want_rows.numpy())
        crops = torch.round(fused_align._sample_bilinear(
            torch.from_numpy(two).float(), *fused_align._crop256_coords(
                torch.from_numpy(want["center"]).float(),
                torch.from_numpy(want["scale"]).float(), side, side)))
        crops = crops.clamp(0, 255) / 255.0
        errs["fan heatmaps"] = rel_err(fused.fan(crops.cuda())[-1].cpu(),
                                       cpu.fan(crops)[-1])
        x224 = torch.from_numpy(rng.uniform(0, 1, (2, 224, 224, 3))).float()
        errs["recon coefficients"] = rel_err(fused.recon(x224.cuda()).cpu(),
                                             cpu.recon(x224))
    if not (got["detected"].all() and want["detected"].all()):
        raise AssertionError(f"align: not every frame detected: card "
                             f"{got['detected']}, cpu {want['detected']}")
    for k in ("boxes", "scores", "center", "scale"):
        errs[k] = rel_err(got[k], want[k])
    near = np.abs(got["lm68"] - want["lm68"]).max(axis=-1) < 1e-2
    agree = near.all(axis=1)
    for k in ("t", "s", "coeff"):
        if agree.any():
            errs[k] = rel_err(got[k][agree], want[k][agree])
    log(f"align: card vs cpu in float32, max abs err over max |cpu|: "
        f"{errs} (limit {ALIGN_LIMIT}); landmarks within 1e-2 px "
        f"{int(near.sum())} of {near.size} (limit {ALIGN_POINTS_SHARE:.0%}),"
        f" POS params and coefficients compared on {int(agree.sum())} of 2 "
        f"frames")
    if max(errs.values()) > ALIGN_LIMIT or near.mean() < ALIGN_POINTS_SHARE:
        raise AssertionError("align: the card disagrees with the CPU")

    aligner = MotionAligner(landmark_fn, coeff_fn, lm3d_std, fused=fused)
    if not fused.process(frames)["detected"].all():
        raise AssertionError("align: a frame missed its detection (the "
                             "modular fallback needs PIL)")
    for label in ("align_sequence (warm-up)", "align_sequence"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligned = aligner.align_sequence(lm68_atom, frames)
        dt = time.perf_counter() - t0
    fps = HORIZON / dt
    log(f"{label}: {HORIZON} frames of {side}×{side} in {dt:.3f} s = "
        f"{fps:.2f} frames/s (chunks of {fused.chunk})")
    traced = trace(torch, lambda: aligner.align_sequence(lm68_atom, frames))
    log_trace("align_sequence", traced)
    # one chunk's device time, whole and by net (the nets on inputs of the
    # chunk's shapes)
    chunk = frames[:fused.chunk]
    dev = torch.from_numpy(chunk).cuda()
    x256 = torch.rand((fused.chunk, 256, 256, 3), device="cuda")
    x224 = torch.rand((fused.chunk, 224, 224, 3), device="cuda")
    with torch.inference_mode():
        net_ms = {
            "chunk": device_ms(torch, lambda: fused.chunk_rows(chunk)),
            "s3fd": device_ms(torch, lambda: fused.s3fd(
                preprocess_frames(dev))),
            "fan": device_ms(torch, lambda: fused.fan(x256)),
            "recon": device_ms(torch, lambda: fused.recon(x224))}
        net_flops = {
            "s3fd": layer_flops(torch, fused.s3fd, lambda: fused.s3fd(
                preprocess_frames(dev))),
            "fan": layer_flops(torch, fused.fan, lambda: fused.fan(x256)),
            "recon": layer_flops(torch, fused.recon,
                                 lambda: fused.recon(x224))}
    rates = {k: round(f / (net_ms[k] * 1e9), 2) for k, f in net_flops.items()}
    chunk_bound_ms = sum(net_flops.values()) / H100_FP32_FLOPS * 1e3
    log(f"align: device ms per chunk of {fused.chunk} frames: {net_ms}; "
        f"TFLOP {({k: round(f / 1e12, 3) for k, f in net_flops.items()})}, "
        f"TFLOP/s {rates}; the nets' bound {chunk_bound_ms:.1f} ms "
        f"(operations, float32)")
    if (aligned.shape != (HORIZON, 68, 2) or not np.isfinite(aligned).all()
            or aligned.min() < 0 or aligned.max() > side - 1):
        raise AssertionError(f"align: aligned landmarks {aligned.shape} "
                             f"in [{aligned.min():.1f}, {aligned.max():.1f}]"
                             f", want [{HORIZON}, 68, 2] inside the frame")
    counts = check_launches("align", set())
    log(f"align: aligned landmarks in [{aligned.min():.1f}, "
        f"{aligned.max():.1f}] px; launches {counts}")
    return {"launches": counts, "frames_per_s": fps,
            "card_vs_cpu_rel_max_err": errs, "trace": traced,
            "chunk_device_ms": net_ms, "chunk_tflop_per_s": rates,
            "chunk_bound_ms": chunk_bound_ms}


def profile_phase(torch, pipe, seed: int) -> dict:
    """Where a window's time goes: one UNet step at B = 2 and one AE extract
    and decode at B = 2, each timed on the host clock (after a warm-up, over
    3 runs, synchronised) and traced once with torch.profiler for the
    device's busy time, its kernel count and its top kernels."""
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
            traced = trace(torch, fn)
            result[name] = {"wall_ms": wall_ms, **{
                k: traced[k] for k in ("device_busy_ms", "kernels", "top")}}
            busy_ms = traced["device_busy_ms"]
            log(f"profile {name} at B={b}: wall {wall_ms:.2f} ms, device "
                f"busy {busy_ms:.2f} ms, {result[name]['kernels']} kernels; "
                f"top {result[name]['top']}")
    return result


# ------------------------------------------------------------------ golden
def golden_phase(torch, seed: int) -> dict:
    """The reference-checkpoint loaders and the golden harness on the card.

    1. Reference-layout files at full width (the reference's key names and
       shapes, made by ``tests/torch_reference_layout.py`` from the port's
       seeded weights: AToM, both AEs, the UNet with head-major qkv rows,
       LPIPS's vgg.pth and torchvision trunk) → ``golden --mode convert``
       (``convert_all``), each result equal to the weights it came from; the
       converted LPIPS on the card against the CPU.
    2. ``golden --mode record`` at full width on the card from the
       converted weights (float32; the launches of space, time, packed and
       one-pass counted), ``golden --mode check`` against it at GOLDEN_TOL,
       and a golden with one probe perturbed, which must fail.
    3. A small-depth record on the CPU (float32), checked on the card in
       bf16 against the window's card-vs-CPU limit (the reference phase's:
       the card within REF_FACTOR times the CPU's own bf16 error), AToM and
       ReconNet within ATOM_LIMIT and ALIGN_LIMIT."""
    from pathlib import Path

    from moditalker_tpu_torch import cli, golden
    from moditalker_tpu_torch.config import (AtomModelConfig, MtovAEConfig,
                                             MtovUNetConfig)
    from moditalker_tpu_torch.models.atom import MotionDecoder
    from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
    from moditalker_tpu_torch.models.mtov.losses import LPIPS
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from tests.torch_reference_layout import (ae_reference_sd,
                                              atom_reference_sd, flax_tree,
                                              unet_reference_sd,
                                              write_vgg_files)

    mc, ae_cfg, unet_cfg = AtomModelConfig(), MtovAEConfig(), MtovUNetConfig()
    ae_ref = lambda t: ae_reference_sd(t, ae_cfg.depth, ae_cfg.quant_depth)
    sources = {   # file name: (the port's module, its reference layout)
        "atom.pt": (lambda: MotionDecoder(mc),
                    lambda t: atom_reference_sd(t, mc.num_layers)),
        "autoencoder_rgb.pth": (lambda: ViTAutoencoder(ae_cfg), ae_ref),
        "autoencoder_motion.pth": (lambda: ViTAutoencoder(ae_cfg), ae_ref),
        "diffusion_model.pth": (lambda: TriplaneUNet(unet_cfg),
                                lambda t: unet_reference_sd(t, unet_cfg)),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref, conv = Path(tmp) / "ckpts", Path(tmp) / "converted"
        ref.mkdir()
        t0 = time.perf_counter()
        states = {}
        for i, (name, (build, to_ref)) in enumerate(sources.items()):
            states[name] = seeded_state(torch, build, seed + i)
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in to_ref(flax_tree(states[name])).items()},
                       ref / name)
        write_vgg_files(ref, seed=seed)
        cli.main(["golden", "--mode", "convert", "--ckpt-dir", str(ref),
                  "--out-dir", str(conv)])
        for name, state in states.items():
            got = torch.load(conv / (name.split(".")[0] + ".pt"),
                             weights_only=True)
            if set(got) != set(state) or not all(
                    torch.equal(got[k], v) for k, v in state.items()):
                raise AssertionError(f"golden convert: {name} does not give "
                                     "back the weights it was made from")
        out["convert_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        x, y = (torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(
            np.float32)) for _ in range(2))
        dist = {}
        for dev in ("cpu", "cuda"):
            lp = LPIPS()
            lp.load_state_dict(torch.load(conv / "vgg.pt", weights_only=True))
            with torch.no_grad():
                dist[dev] = lp.to(dev).eval()(x.to(dev), y.to(dev)).cpu()
        out["lpips_card_vs_cpu_rel_err"] = rel_err(dist["cuda"], dist["cpu"])
        log(f"golden convert: 4 kinds from reference-layout files at full "
            f"width in {out['convert_s']:.1f} s, each the weights it was made "
            f"from; LPIPS card vs cpu {out['lpips_card_vs_cpu_rel_err']:.3e}"
            f" (limit {FIRST_STAGE_LIMITS['loss']})")
        if out["lpips_card_vs_cpu_rel_err"] > FIRST_STAGE_LIMITS["loss"]:
            raise AssertionError("golden: the converted LPIPS disagrees "
                                 "between the card and the CPU")

        gold = Path(tmp) / "goldens.npz"
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["golden", "--mode", "record", "--params-dir", str(conv),
                  "--golden", str(gold)])
        torch.cuda.synchronize()
        out["record_s"] = time.perf_counter() - t0
        out["launches"] = check_launches("golden record", FUSED_PATH)
        out["launches_by_shape"] = launches_by_shape()
        t0 = time.perf_counter()
        cli.main(["golden", "--mode", "check", "--params-dir", str(conv),
                  "--golden", str(gold), "--rtol", str(GOLDEN_TOL),
                  "--atol", str(GOLDEN_TOL)])   # exits 1 on a mismatch
        out["check_s"] = time.perf_counter() - t0
        with np.load(gold) as g:
            bad = {k: g[k] for k in g.files}
        bad["mtov_window"] = bad["mtov_window"] + GOLDEN_PERTURB
        np.savez_compressed(Path(tmp) / "bad.npz", **bad)
        if golden.check(str(Path(tmp) / "bad.npz"), str(conv)):
            raise AssertionError("golden: a perturbed golden passes the check")
        log(f"golden record at full width on the card: {out['record_s']:.1f}"
            f" s, check {out['check_s']:.1f} s (passes at {GOLDEN_TOL}), a "
            f"probe moved by {GOLDEN_PERTURB} fails; launches "
            f"{out['launches']}, by shape {out['launches_by_shape']}")

        # the small probes' UNet and ReconNet from a params dir in which
        # every tensor the seeded init leaves at zero (the UNet's output
        # layers, ReconNet's heads) is drawn, so that every layer reaches
        # the probes
        small_dir = Path(tmp) / "small"
        small_dir.mkdir()
        _, _, unet_small = golden.probe_configs("small")
        from moditalker_tpu_torch.preprocess.recon_net import ReconNet
        gen = torch.Generator().manual_seed(seed)
        for stem, build in (("diffusion_model",
                             lambda: TriplaneUNet(unet_small)),
                            ("epoch_20", ReconNet)):
            state = seeded_state(torch, build, seed)
            torch.save({k: 0.02 * torch.randn(v.shape, generator=gen)
                        if v.is_floating_point() and not v.any() else v
                        for k, v in state.items()},
                       small_dir / f"{stem}.pt")
        small = Path(tmp) / "small.npz"
        t0 = time.perf_counter()
        cpu = golden.record(str(small), str(small_dir), size="small",
                            device="cpu")
        cpu16 = golden.run_probes(str(small_dir), size="small", device="cpu",
                                  dtype=torch.bfloat16)
        card = golden.run_probes(str(small_dir), size="small",
                                 dtype=torch.bfloat16)
        out["small_s"] = time.perf_counter() - t0
    if not all(np.abs(v).max() > 0 for v in cpu.values()):
        raise AssertionError("golden: a small-depth probe reads zero")
    errs = {}
    for name in ("mtov_window", "mtov_extract"):
        c = np.abs(card[name] - cpu[name])
        b = np.abs(cpu16[name] - cpu[name])
        errs[name] = {"card_mean": float(c.mean()), "card_max": float(c.max()),
                      "cpu_bf16_mean": float(b.mean()),
                      "cpu_bf16_max": float(b.max())}
        if not (np.isfinite(card[name]).all()
                and c.mean() <= REF_FACTOR * b.mean()
                and c.max() <= REF_FACTOR * b.max()):
            raise AssertionError(f"golden {name}: the card's small-depth "
                                 f"probe disagrees with the CPU's: {errs}")
    for name, limit in (("atom_sequence", ATOM_LIMIT),
                        ("recon_coeff", ALIGN_LIMIT)):
        errs[name] = rel_err(card[name], cpu[name])
        if errs[name] > limit:
            raise AssertionError(f"golden {name}: card vs cpu {errs[name]:.3e}"
                                 f" (limit {limit})")
    out["small_card_vs_cpu"] = errs
    log(f"golden small-depth record on the cpu, checked on the card (bf16 "
        f"MToV): {errs} in {out['small_s']:.1f} s")
    return out


# ------------------------------------------------------------- distributed
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_phase(torch, seed: int) -> dict:
    """The distribution wiring at world size 1 on the card.

    1. A small-depth train-diffusion step (the train-diffusion phase's
       configs) with no process group, then ``init_distributed`` with NCCL
       (a ``tcp://`` rendezvous on localhost, no torchrun) and the same step
       from the same weights through the gradient all-reduce: loss, gradient
       and update exactly equal (cuDNN deterministic for the two steps).
    2. ``tp.py`` over a 1×1 mesh: column → row dense against the dense ops
       (float32), and head-parallel attention at the UNet's one-pass shape
       through the one-pass kernel (its launch counted) against the plain
       version within the kernel's bf16 limits.
    3. ``sample --data-parallel 1`` against ``sample`` with the default
       (every visible card: one here), the same frames."""
    from moditalker_tpu_torch import cli
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovTrainConfig, MtovUNetConfig)
    from moditalker_tpu_torch.core import sharding
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
    from moditalker_tpu_torch.ops.attention import plain_sdpa
    from moditalker_tpu_torch.ops.kernels import (LAUNCHES, check_bf16,
                                                  reset_launch_counts)
    from moditalker_tpu_torch.parallel import tp
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
    unet_cfg = MtovUNetConfig(num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,))
    tc = MtovTrainConfig(seed=seed)
    aes = [seeded_state(torch, lambda: ViTAutoencoder(ae_cfg), seed + i)
           for i in (11, 12)]
    unet = seeded_state(torch, lambda: TriplaneUNet(unet_cfg), seed)
    batch = synthetic_mtov_batch(2, ae_cfg.timesteps, ae_cfg.resolution, seed)
    out = {}

    def step():
        trainer = MtovDiffusionTrainer(unet_cfg, MtovDiffusionConfig(), tc,
                                       state_dict=unet)
        models = []
        for state in aes:
            m = ViTAutoencoder(ae_cfg)
            m.load_state_dict(state)
            models.append(m)
        m = LatentDiffusionLoop(trainer, *models).train_step(batch)
        return {"loss": m["loss"].cpu(), **{
            f"{what}.{k}": (p.grad if what == "grad" else p).detach().cpu()
            for k, p in trainer.model.named_parameters()
            for what in ("grad", "param")}}

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # one host: the rendezvous and NCCL's bootstrap stay on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        alone = step()
        t0 = time.perf_counter()
        if not sharding.init_distributed(f"localhost:{free_port()}", 1, 0):
            raise AssertionError("init_distributed started no group")
        out["init_s"] = time.perf_counter() - t0
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the card's group is not NCCL")
        wired = step()
        diff = [k for k in alone if not torch.equal(alone[k], wired[k])]
        out["step_exact"] = not diff
        log(f"distributed: NCCL group of 1 in {out['init_s']:.2f} s; a "
            f"train-diffusion step through the all-reduce equals the step "
            f"without it exactly: {not diff} (loss {float(alone['loss']):.6f})")
        if diff:
            raise AssertionError(f"distributed: {len(diff)} tensors differ "
                                 f"through the all-reduce, e.g. {diff[:3]}")

        mesh = tp.make_2d_mesh(1, 1)
        g = torch.Generator(device="cuda").manual_seed(seed)
        rnd = lambda *s, dt=torch.float32: torch.randn(
            s, generator=g, device="cuda").to(dt)
        x, w1, b1, w2, b2 = rnd(8, 32), rnd(32, 64), rnd(64), rnd(64, 16), \
            rnd(16)
        y = tp.row_parallel_dense(mesh)(
            tp.column_parallel_dense(mesh)(x, w1, b1), w2, b2)
        dense_err = float(((y - ((x @ w1 + b1) @ w2 + b2)).abs().max()))
        q, k, v = (rnd(2, 2048, 8, 32, dt=torch.bfloat16) for _ in range(3))
        reset_launch_counts()
        attn = tp.head_parallel_attention(mesh, 8)(q, k, v)
        torch.cuda.synchronize()
        out["tp_launches"] = check_launches("head_parallel_attention",
                                            {"onepass_attention"})
        heads = lambda t: t.transpose(1, 2).reshape(16, 2048, 32)
        plain = plain_sdpa(heads(q) * 32**-0.5, heads(k), heads(v))
        errs = check_bf16("onepass_attention", heads(attn), plain)
        out["tp"] = {"dense_max_abs_err": dense_err, "attention_rel": errs}
        log(f"tp over a 1x1 mesh: column→row dense vs dense max abs "
            f"{dense_err:.3e}; head-parallel attention [2, 2048, 8, 32] bf16 "
            f"vs plain {errs}; launches {dict(LAUNCHES)}")
        if dense_err > 1e-4:
            raise AssertionError("tp: column→row dense disagrees with dense")
    finally:
        sharding.shutdown()
        torch.backends.cudnn.deterministic = old

    frames = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in ([], ["--data-parallel", "1"]):
            args = cli.build_parser().parse_args([
                "sample", "--frames-dir", "-", "--aligned-dir", "-",
                "--batch", "2", "--no-last-as-reference", "--sampling-steps",
                "2", "--seed", str(seed), "--out-dir",
                os.path.join(tmp, str(len(flag))), *flag])
            reset_launch_counts()
            path = cli.sample_windows(args, make_windows(
                cli._sample_configs(args)[0], 2, 1, seed))
            out["sample_launches"] = check_launches(
                "sample --data-parallel 1", FUSED_PATH)
            if path.endswith(".npz"):   # no ffmpeg on this host
                with np.load(path) as dump:
                    frames[len(flag)] = dump["frames"]
            else:
                with open(path, "rb") as f:
                    frames[len(flag)] = np.frombuffer(f.read(), np.uint8)
    cli._SAMPLE_PIPE_CACHE.clear()
    if not np.array_equal(frames[0], frames[2]):
        raise AssertionError("sample --data-parallel 1 differs from sample")
    log(f"sample --data-parallel 1 (2 windows, DDIM-2) writes the same file "
        f"as sample; launches {out['sample_launches']}")
    return out


# ------------------------------------------------------------------ profiling
def profiling_phase(torch, pipe, seed: int) -> dict:
    """``core/profiling.py`` on the card: ``trace`` around one UNet step at
    B = 2 under ``annotate`` writes a non-empty Chrome trace holding the
    annotation and the card's kernels; ``step_timer`` (synchronising the
    card) logs the step's seconds."""
    from moditalker_tpu_torch.core import profiling

    g = torch.Generator(device="cuda").manual_seed(seed)
    L = pipe.ae_cfg.latent_len
    x = torch.randn((2, 4, L), generator=g, device="cuda")
    cond = torch.randn((2, 8, L), generator=g, device="cuda").bfloat16()
    ic = torch.randn((2, 4, L), generator=g, device="cuda").bfloat16()
    t = torch.full((2,), 500, dtype=torch.long, device="cuda")

    class Rows:
        rows = []

        def log_scalars(self, step, scalars):
            self.rows.append(scalars)

    rows = Rows()
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        pipe.ddpm.model(x, cond, ic, t)
        with profiling.step_timer(rows, name="unet_step", device="cuda"):
            with profiling.trace(tmp, name="unet_step"):
                with profiling.annotate("unet_step"):
                    pipe.ddpm.model(x, cond, ic, t)
        path = os.path.join(tmp, "unet_step.pt.trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    annotated = any(e.get("name") == "unet_step" for e in events)
    out = {"trace_bytes": size, "events": len(events), "kernel_events": kernels,
           "annotation_found": annotated,
           "unet_step_seconds": rows.rows[0]["unet_step_seconds"]}
    log(f"profiling: trace of one UNet step {size} bytes, {len(events)} "
        f"events, {kernels} kernel events, annotation found {annotated}; "
        f"step_timer {out['unet_step_seconds']:.3f} s (with the profiler)")
    if not (size and kernels and annotated):
        raise AssertionError(f"profiling: the trace lacks what it must hold: "
                             f"{out}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build, kernels and gradient "
                         "phases (a short check of a kernel change; prints "
                         "no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from moditalker_tpu_torch.ops.kernels import (HELPER_SOURCES,
                                                      SOURCES, _build)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(sorted({*SOURCES.values(), *HELPER_SOURCES}))
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

    # every comparison on the card in float32 runs full float32 (the
    # matmul default; cuDNN's convolutions would default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = kernel_phase(torch, batch=2, seed=args.seed)
    grads = gradient_phase(torch, args.seed)
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
    audio = audio_phase(torch, args.seed)
    align = align_phase(torch, args.seed, audio.pop("lm68_atom"))
    train_diff = train_diffusion_phase(torch, args.seed)
    train_atom = train_atom_phase(torch, args.seed)
    first_stage = train_first_stage_phase(torch, args.seed)
    i3d = i3d_phase(torch, args.seed)
    gold = golden_phase(torch, args.seed)
    distributed = distributed_phase(torch, args.seed)
    pipe = result.pop("pipe")
    prof = profile_phase(torch, pipe, args.seed)
    profiling = profiling_phase(torch, pipe, args.seed)

    timed = {path: counts for path, counts in result["launches"].items()
             if "warm-up" not in path}
    timed["cli sample"] = cli_result["launches"]
    timed["atom run_directory"] = atom["launches"]
    timed["audio"] = audio["launches"]
    timed["align"] = align["launches"]
    timed["train-diffusion"] = train_diff["launches"]
    timed["train-atom"] = train_atom["launches"]
    timed["train-first-stage"] = first_stage["launches"]
    timed["golden record"] = gold["launches"]
    timed["head_parallel_attention"] = distributed["tp_launches"]
    timed["sample --data-parallel 1"] = distributed["sample_launches"]
    # one line entry per kernel: its first row, the shape its main path
    # gives it; the rows at its other shapes go under "other_shapes"
    kernels = {}
    for row in rows:
        if row["name"] in kernels:
            kernels[row["name"]].setdefault("other_shapes", []).append(
                {k: row[k] for k in ("shape", "dtype", "max_abs_err",
                                     "rel_max_err", "rel_rms_err",
                                     "rel_q_err", "ms", "cast_ms",
                                     "plain_ms", "plain_backward_ms",
                                     "library_ms", "bound_ms",
                                     "bound_by") if k in row})
            continue
        kernels[row["name"]] = row
        row["launches_by_path"] = {p: c[row["name"]] for p, c in timed.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        by_path = {**result["launches_by_shape"],
                   "train-diffusion": train_diff["launches_by_shape"],
                   "train-first-stage": first_stage["launches_by_shape"],
                   "golden record": gold["launches_by_shape"]}
        row["launches_by_shape"] = {
            p: by[row["name"]] for p, by in by_path.items()
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
        "audio_seconds_per_s": audio["audio_s_per_s"],
        "audio_card_vs_cpu_rel_max_err": audio["card_vs_cpu_rel_max_err"],
        "align_frames_per_s": align["frames_per_s"],
        "align_card_vs_cpu_rel_max_err": align["card_vs_cpu_rel_max_err"],
        "align_chunk_device_ms": align["chunk_device_ms"],
        "align_chunk_tflop_per_s": align["chunk_tflop_per_s"],
        "align_chunk_bound_ms": align["chunk_bound_ms"],
        "audio_tflop": audio["tflop"], "audio_bound_ms": audio["bound_ms"],
        "audio_clip_device_ms": audio["clip_device_ms"],
        "audio_trace": audio["trace"], "align_trace": align["trace"],
        "train_diffusion": {k: train_diff[k] for k in (
            "steps_per_s", "clips_per_s", "peak_gib", "losses",
            "card_vs_cpu", "trace")},
        "train_atom": {k: train_atom[k] for k in (
            "sequences_per_s", "card_vs_cpu_loss_rel_err", "adan_aligned",
            "parameters", "trace")},
        "train_first_stage": {k: first_stage[k] for k in (
            "iterations_per_s", "clips_per_s", "g_step_ms", "d_step_ms",
            "peak_gib", "plain_backward_ms", "plain_backward_share",
            "card_vs_cpu", "trace")},
        "i3d": i3d,
        "golden": {k: gold[k] for k in (
            "convert_s", "lpips_card_vs_cpu_rel_err", "record_s", "check_s",
            "small_s", "small_card_vs_cpu")},
        "distributed": {k: distributed[k] for k in ("init_s", "step_exact",
                                                    "tp")},
        "profiling": profiling,
        "gradients": grads, "card": card, "profile": prof}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
