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
             plain output's max within ``QUANTILE_LIMITS``; the 256-channel
             UNet's one-pass shapes) and in float32 at the shapes the
             float32 paths give them (train-diffusion's at B = 10, on both
             attention paths, and the 256-channel UNet's joint attention,
             2048 keys at head dim 64, through a K and V pre-pass and
             the wgmma tile's bf16 K ring beside the tile's float32 K ring
             forced, bit for bit; train-first-stage's and the golden
             record's at B = 1; the fused kernel at one cross-length shape
             and at query rows over 2048 keys; the 256-channel
             train-diffusion's xy-plane attention, [80, 1024, 32]). Every
             kernel reads and writes float32 itself, with no cast pass, and
             each float32 row is also held to its float32 route's function
             (``divided_attention_float32_route``,
             ``packed_attention_float32_route``,
             ``attention_float32_route``; within ``FLOAT32_ROUTE_LIMITS``)
             with under 1 % of its result equal to its own bf16 rounding.
             Each row is timed on the device (20 calls replayed from
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
             to ``sdpa``). The divided space and time backward kernels at
             train-first-stage's qkv [1, 16, 1024, 1536], float32 and bf16:
             dqkv against the float32 plain backward (the written-out
             adjoints) within the same three limits, in float32 also
             against ``divided_attention_backward_float32_route`` within
             ``FLOAT32_ROUTE_LIMITS``, two calls equal bit for bit; each
             timed beside the plain backward, the recompute that ran
             before (``recompute_ms``) and the library's attention backward
             alone. The classes beyond the configurations' shapes (every
             shape the JAX gates admit runs a kernel) at the shapes the
             variants phase gives them, bf16 and float32 each: time at
             clips of 32 and 8 frames (the staged kernel, its own entry
             in the kernels line, two calls bit for bit; 24 frames too; at
             8 frames bit for bit the classes' kernel it replaced there,
             timed beside it for the log line),
             tiny-L at 32 rows, one-pass at head dims 24 and 48 (bf16 48:
             the narrow tile, its own entry; 40 and 56 beside it, and the
             fused kernel at 48 with ragged query rows over a whole and a
             short key tile, over resident K and past it), the time
             backward at 8 frames (the staged backward, its own entry,
             bit for bit the classes' backward it replaced there, timed
             beside it for the log line); packed and one-pass at the 3072 tokens
             of 32-frame clips. The wgmma tile
             built per head width (``csrc/flash_wide{,_f32}.cu``), bf16 and
             float32 against the float32 plain version: one-pass at
             [B·2, 2048, 128] (base.yaml with num_heads: 2) and
             [16, 2048, 128], fused at [16, 1024, d] for d = 136, 256 and
             512 (two groups of 256 columns). The float32 space kernel
             at head dim 64 (``csrc/resident_f32_tile.cuh``) on its cluster
             plan (an entry of its own) at train-diffusion's,
             train-first-stage's and 8-frame clips' qkv, each bit for bit
             the design it replaced there (the one-block plan; at 8-frame
             clips the wgmma tile's float32 route), timed beside it for the
             log line; each also two calls bit for bit. The
             space kernel's
             pre-rotated design (``csrc/divided_space.cuh``: a rotation
             pre-pass, then the wgmma tile built per width or the
             small-head tile) at qkv [2, 16, 1024, 1536] in 4 heads of 128,
             16 of 32 and 32 of 16, bf16 and float32, and in float32 at
             head dim 64 over 2048 tokens; the space backward's classes at
             train-first-stage's qkv in 4 heads of 128 and 16 of 32, and in
             heads of 16, 8, 4 and 2 (the resident plan, timed there beside
             the class and the library, held to the plain backward and its
             route at one frame). Every
             float32 space row is held to the route in the kernels' ex2
             form (``exp2=True``);
   masked padding — the time kernels at clips of 8 and 24 frames (padded
             to the 16- and 32-frame tiles; 24: the staged kernel's) with
             every real score large and
             negative, forward and backward against their float32 route;
             the fused kernel at head dim 256 with ragged query rows over
             120 and 40 keys (a short 64-key tile, zero-filled and masked)
             likewise;
   gradients — each differentiable wrapper's input gradient (its
             ``autograd.Function``) against autograd through the plain
             version in float32, its ``grad_fn``, and the peak memory of
             the backward: the packed, one-pass and tiny-L ones within
             GRAD_LIMIT; the space and time ones, which launch their
             backward kernels once a gradient, within their rows' limits
             and those of their float32 route, two gradients equal bit for
             bit;
3. reference — (the 256-channel DDIM-2 below runs first, the windows after
             the cli phase) one DDIM-2 window at a small depth but full
             spatial size (so
             every kernel gate passes) on the card in bf16 against the same
             weights and draws on the CPU in float32 through the plain path,
             within REF_FACTOR times the error of a bf16 CPU run. Once on
             the fused path, once on the modular-attention path (both gate
             switches set: MODITALKER_NO_DIVIDED_FUSED and
             MODITALKER_NO_PACKED_ATTN), there at B = 2 and 4 heads so that
             the time attention passes the tiny-L gate. Both again with
             the 256-channel UNet (base_longvid.yaml's width, one res block,
             channel_mult (1, 2): head dim 32 at ds = 1, 64 after the
             upsample), whose attentions never reach the packed kernel;
             then base_longvid.yaml's UNet at full width alone: a DDIM-2
             run on seeded latents at B = 1, card bf16 against the CPU in
             float32 within REF_FACTOR of the CPU's own bf16 error
             (``longvid_unet_check``);
4. main path — at the full shipped width with weights drawn from ``--seed``:
             ``sample_independent`` over 2 windows at batch 2 (DDIM-100) and
             the fast-mode ``sample_long`` over 3 autoregressive windows at
             B = 1 (renoise ratio 0.25 from the reference window), then
             ``sample_independent`` again on the modular-attention path,
             each timed warm, after one untimed run of the same call at
             DDIM-2 (the shapes of DDIM-100 in a fiftieth of its time). The
             launch counters are zeroed just before each path and read just
             after: the fused paths must have launched the divided space and
             time, packed and one-pass kernels and no other; the modular path
             the tiny-L and one-pass kernels and no other; each count is also
             split by the shape the kernel was given. Outputs must be
             uint8 frames of the right shape that are not constant. Then
             ``sample_independent`` and ``sample_long`` as above with the
             UNet of configs/latent-diffusion/base_longvid.yaml (256
             channels; the divided space and time and one-pass kernels and
             no other, each count by shape exactly as predicted) and one of
             its UNet steps profiled;
5. cli     — the port's ``sample`` command at full width: a real argument
             list through the CLI's own parser (batch 2, independent
             windows, DDIM-25, no checkpoints) and the command's function of
             (arguments, windows) on synthetic uint8 windows (reading frames
             from disk needs PIL, which a CUDA host may lack); the video file
             it writes is checked; before it, the same with ``--config
             configs/latent-diffusion/base_longvid.yaml``;
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
   audio bf16 — the same weights with the bf16 trunk
             (``HubertEncoder(dtype=torch.bfloat16)``, the JAX package's TPU
             eval mode): the 2 s clip on the card against the CPU's
             float32 within REF_FACTOR times the error bf16 alone costs on
             the CPU, then the chain timed warm beside the float32 rate,
             with TFLOP/s and the bf16 bound. No launch;
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
   align bf16 — ``FusedAligner(dtype=torch.bfloat16)`` from the same
             state_dicts, FAN's last head made a discriminant of the check's
             crops (``fan_discriminant``) so that landmarks are determined:
             S3FD's maps, FAN's heatmaps and ReconNet's
             coefficients on the float32 check's inputs against the CPU's
             float32 within REF_FACTOR times the CPU's own bf16 error, the
             2 frames' detection flags equal to the CPU bf16 chunk's, every
             determined landmark (``determined_points``) within 1e-2 px of
             the CPU bf16 decode's; then ``align_sequence`` over the 156
             frames timed warm, and device ms and TFLOP/s per net per
             chunk, beside the float32 figures. No launch;
9. train-diffusion — ``LatentDiffusionLoop.fit`` at full width, B = 10,
             float32 (TF32 off), synthetic videos, AE and UNet weights from
             ``--seed``: one untimed step, 5 timed (steps/s, clips/s, peak
             memory, launches by kernel and shape: the divided space and
             time, packed and one-pass kernels and no other), finite losses,
             one step traced; then a step at small depth but full spatial
             size on the card against the CPU (same weights, batch and
             draws) within TRAIN_LIMITS, and the same step with the gradient
             cut at the attentions, which must fall outside them. Then the
             same on the modular-attention path (both gate switches set
             inside the phase and put back after it; 3 timed steps): the
             tiny-L and one-pass kernels and no other, each launch on
             float32 operands, tiny-L and one-pass at head dims 16, 32 and
             64 among them, and the small-depth step against the CPU within
             TRAIN_LIMITS. Then with base_longvid.yaml's UNet (256
             channels, full width, B = 10, float32): 3 timed steps with
             ``remat`` off and 3 with it on (steps/s, peak memory, launches
             by shape and dtype as predicted; with ``remat`` the recompute
             launches the UNet's kernels again and the counts show it), one
             step traced, the gradient of one step with ``remat`` on
             against the same step with it off within REMAT_LIMIT, and a
             small-depth 256-channel step against the CPU within
             TRAIN_LIMITS;
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
             kernels and their backward kernels, 16 + 16 of those per G
             micro-step and none per D micro-step, and no other, every one
             on float32 operands; no
             ``RecomputeThroughPlain`` backward), G and D micro-steps timed
             apart, one G step traced with the device time of the space
             and time backward kernels in it; then a
             G and a D cycle at small depth but full spatial size on the
             card against the CPU (same weights, clips and frame draws)
             within FIRST_STAGE_LIMITS, and the G cycle with the gradient
             cut at the attentions, which must fall outside them. Then the
             two operating points run before it, each loaded from its file:
             configs/autoencoder/base.yaml (discriminators off,
             disc_start 1e8: every micro-step a G step) and
             base_ldmk.yaml with ``freeze_decoder`` (``train-first-stage
             --landmark``: the landmark AE, decoder frozen), at full width:
             one cycle untimed, two timed (iterations/s, peak memory,
             launches by shape), every loss finite, the discriminators
             unmoved, for the landmark AE its decoder and ``to_pixel``
             unmoved; a micro-step traced; and a small-depth copy of each
             against the CPU within FIRST_STAGE_LIMITS (the gradient-cut
             copy outside them);
12. variants — shipped configurations changed by one key each, read from
             temporary YAMLs by ``load_config`` (VARIANTS): the ``sample``
             command at clips of 32 frames on the fused and the modular path
             (2 windows at batch 2, DDIM-2 warm-up, DDIM-25 timed; the time
             kernel's every launch through the staged kernel's entry point,
             tiny-L at 32 rows, the UNet's
             launches by shape as VARIANT_UNET_PER_CALL predicts, every
             launch at a shape its gate admits) and a small-depth window of
             such clips on each path against the CPU within REF_FACTOR;
             train-first-stage at clips of 8 frames (base_gan.yaml's
             operating point: one G and one D cycle timed, the time kernels
             and their backwards at [1, 8, 1024, 1536], every space launch
             the float32 space kernel's cluster plan and every time launch
             the staged kernel, by entry point, a small-depth G and
             D cycle against the CPU within FIRST_STAGE_LIMITS); a
             small-depth window of the 192-channel UNet against the CPU
             (one-pass at head dims 24 and 48, 48 through the narrow tile's
             entry point), and one of the UNet with
             num_heads: 2 (one-pass at head dims 64 and 128); base.yaml's
             AE with its 512 attention channels in 4 heads of 128 and in
             16 of 32 (the space kernel's pre-rotated design): a
             full-width extract and decode at B = 2 in bf16, timed with
             their launches, a small-depth window against the CPU within
             REF_FACTOR and a small-depth G and D cycle of the first stage
             against the CPU within FIRST_STAGE_LIMITS (the space
             backward's classes at head dims 128 and 32);
13. i3d    — InceptionI3d (random He-scaled weights) on [2, 16, 224, 224, 3]
             on the card against the CPU within I3D_LIMIT, and the FVD
             between two sets of 8 synthetic clips through the card's I3D
             against the CPU's within FVD_LIMIT;
14. golden  — reference-layout files at full width (the reference's key
             names and shapes, made from seeded weights) through ``golden
             --mode convert``, each converted file the weights it came
             from, the converted LPIPS card vs CPU; ``golden --mode record``
             at full width on the card (float32; launches of the space,
             time, packed and one-pass kernels) and ``--mode check`` at the
             JAX harness's 1e-4, a perturbed golden failing; a small-depth
             record on the CPU checked on the card against the reference
             phase's limit (``golden_phase``);
15. distributed — NCCL at world size 1 (tcp:// on localhost): a
             small-depth train-diffusion step through the gradient
             all-reduce equal to the same step without a group, exactly;
             ``tp.py`` on a 1×1 mesh (head-parallel attention through the
             one-pass kernel); ``sample --data-parallel 1`` writing what
             ``sample`` writes;
16. profile — one UNet step, one extract and one decode at B = 2: host
             time, the device's busy time and top kernels (torch.profiler);
17. profiling — ``core/profiling.py``: ``trace`` around one UNet step
             writes a Chrome trace holding the ``annotate`` span and the
             card's kernels; ``step_timer`` logs the step.

Each phase logs its seconds on the host clock ("phase <name>: ... s"),
and the result line keeps them under ``phase_seconds``. After the kernels
and gradient phases (whose device times a busy host could stretch), the
CPU halves of the small-depth checks (the reference windows, the
train-diffusion steps, the first-stage cycles) run in one spawned worker
process while the card's phases run (``CpuReferences``; the worker and this
process on disjoint halves of the host's cores); each check takes
its result when it gets there. The reference windows run after the
sampling paths and the ``cli`` phase, so that the worker has them ready. Without a CUDA
device, or run outside the repository, it exits nonzero and prints no
result.
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
# the 256-channel UNet (configs/latent-diffusion/base_longvid.yaml): 8 heads
# of 32, 64 and 128, never 16, so the packed gate never passes and every
# gated attention goes head-split to the one-pass kernel
LONGVID_PATH = {"divided_space_attention", "divided_time_attention",
                "onepass_attention"}
LONGVID_YAML = "configs/latent-diffusion/base_longvid.yaml"
# its one-pass launches per UNet call at batch B, by (sequence, head dim)
# of [B·8, sequence, head dim]: the joint attention and the xy plane's at
# ds = 1 (C = 256; 2 each on the way down, 3 each on the way up), and the
# joint attention after the last upsample (C = 512); the yt and xt planes'
# 512 tokens and everything at ds ≥ 2 pass no gate
LONGVID_ONEPASS_PER_CALL = {(2048, 32): 5, (1024, 32): 5, (2048, 64): 1}
SWITCHES = ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN")
# the variants phase: shipped configurations each changed in one section,
# written to a temporary YAML that load_config reads (nothing is added
# under configs/): (shipped file, section, {key: value}). Clips of 32
# frames for ``sample``, of 8 for train-first-stage, a 192-channel UNet,
# the UNet in 2 heads, the AE's 512 attention channels in 4 heads of 128
# and in 16 of 32 (the space kernel's pre-rotated design)
VARIANT_CLIP_FRAMES = 32
VARIANT_TRAIN_FRAMES = 8
VARIANT_CHANNELS = 192
# two UNet heads: at 128 channels heads of 64, after the last upsample of
# 128, both through the one-pass kernel (no head is 16 wide)
VARIANT_UNET_HEADS = 2
VARIANT_AE_HEADS = ((4, 128), (16, 32))   # (heads, dim_head)
VARIANTS = {
    "clip32": ("configs/latent-diffusion/base.yaml", "mtov_ae",
               {"timesteps": VARIANT_CLIP_FRAMES}),
    "clip8": ("configs/autoencoder/base_gan.yaml", "mtov_ae",
              {"timesteps": VARIANT_TRAIN_FRAMES}),
    "channels192": ("configs/latent-diffusion/base.yaml", "mtov_unet",
                    {"model_channels": VARIANT_CHANNELS}),
    "num_heads2": ("configs/latent-diffusion/base.yaml", "mtov_unet",
                   {"num_heads": VARIANT_UNET_HEADS}),
    **{f"ae_heads{h}x{d}": ("configs/autoencoder/base.yaml", "mtov_ae",
                            {"heads": h, "dim_head": d})
       for h, d in VARIANT_AE_HEADS},
}
# the UNet's launches per call at batch 2, by kernel and shape, on each
# path (held on the CPU against the JAX gates:
# tests/test_torch_kernel_classes.py). At clips of 32 frames latent_t is
# 32: the joint attention has 32² + 2·32·32 = 3072 tokens, the yt and xt
# planes 1024 each (batched as [4, 1024, 384]); at 192 channels no head is
# 16 wide, the packed gate never opens and the head-split attentions go to
# the one-pass kernel at head dims 24 (ds = 1) and 48 (after the last
# upsample)
VARIANT_UNET_PER_CALL = {
    ("clip32", "fused"): {
        "packed_attention": {(2, 1024, 384): 5, (4, 1024, 384): 5,
                             (2, 3072, 384): 5},
        "onepass_attention": {(16, 3072, 32): 1}},
    ("clip32", "modular"): {
        "onepass_attention": {(16, 1024, 16): 5, (32, 1024, 16): 5,
                              (16, 3072, 16): 5, (16, 3072, 32): 1}},
    ("channels192", "fused"): {
        "onepass_attention": {(16, 1024, 24): 5, (16, 2048, 24): 5,
                              (16, 2048, 48): 1}},
    ("num_heads2", "fused"): {
        "onepass_attention": {(4, 1024, 64): 5, (4, 2048, 64): 5,
                              (4, 2048, 128): 1}},
}

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
    # the small-head class 64 and the classes' time kernel at 24 and 32
    # frames, which the narrow tile and the staged time kernel replaced
    # (bf16 and float32; the rows added beside them as tools/ab_classes.py
    # --narrow --time32 timed the class, a fused row keyed by its q and k)
    ("onepass_attention", (16, 2048, 48)): 0.0619,
    ("onepass_attention", (16, 2048, 40)): 0.0635,
    ("onepass_attention", (16, 2048, 56)): 0.0637,
    ("fused_attention", ((16, 1000, 48), (16, 128, 48))): 0.0051,
    ("fused_attention", ((16, 1000, 48), (16, 120, 48))): 0.0052,
    ("fused_attention", ((16, 300, 48), (16, 1024, 48))): 0.0144,
    ("fused_attention", ((16, 1280, 48), (16, 2048, 48))): 0.0619,
    ("divided_time_attention", (2, 32, 1024, 1536)): 0.2129,
    ("divided_time_attention", (2, 32, 1024, 1536), "float32"): 0.2666,
    ("divided_time_attention", (2, 24, 1024, 1536)): 0.1798,
    ("divided_time_attention", (2, 24, 1024, 1536), "float32"): 0.2179,
}

# train-diffusion's batch (MtovTrainConfig.diffusion_batch_size): the float32
# rows of the kernels phase are at the shapes it gives the kernels
TRAIN_BATCH = 10

# a kernel wrapper's input gradient on the card (its autograd.Function: the
# kernel forward, the plain version recomputed backward) against autograd
# through the plain version, float32, TF32 off: max abs difference over max
# |plain gradient|. The packed backward is the plain version's own vjp (it
# reads 0), the one-pass and tiny-L ones the JAX package's adjoints, which
# sum in another order (one-pass at [80, 2048, 32] reads 1.57e-6 to 2.12e-6
# over --seed 0..3 on an H100). The divided space and time backwards are
# kernels of their own, held to their rows' limits instead (``BF16_LIMITS``,
# ``QUANTILE_LIMITS`` and ``FLOAT32_ROUTE_LIMITS``)
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

# the 256-channel UNet's train-diffusion step with ``remat`` against the
# same step without it, on the card (same weights, batch and draws; cuDNN
# deterministic): the relative error of the loss and of each parameter's
# gradient (L2 of the difference over L2 of the step without remat; a
# gradient that is zero must stay zero). The recompute runs the same
# kernels on the same inputs, so anything above float32 rounding is a fault
REMAT_LIMIT = 1e-6

# AToM training card vs CPU (float32, TF32 off): the largest relative error
# of a step's loss terms is held to ATOM_LIMIT, every parameter to
# ATOM_PARAM_LIMIT (DESIGN.md §6's AToM tolerance) but at ill-conditioned
# Adan elements: sqrt(n̂) below ADAN_ILL, or a step above ADAN_BIG·lr
ATOM_PARAM_LIMIT = 2e-4
ADAN_ILL = 1e-4
ADAN_BIG = 25

# which kernels the first-stage trainer launches: its AE's divided space and
# time attention, forward and backward (the AE's pooling transformer, LPIPS
# and the discriminators reach none); the backwards once per attention of a
# G micro-step, never in a D micro-step (the AE runs there without a graph)
FIRST_STAGE_PATH = {"divided_space_attention", "divided_time_attention",
                    "divided_space_attention_backward",
                    "divided_time_attention_backward"}
FIRST_STAGE_BACKWARDS = ("divided_space_attention_backward",
                         "divided_time_attention_backward")
SPACE_BACKWARD_DESIGN = (
    "a bf16 pre-pass (q~, k~, v, g; D), then a dq kernel (row statistics, "
    "then dq) and a dk/dv kernel on wgmma: two consumer warpgroups of 64 "
    "rows with their operands resident, 64-row tiles streamed through a "
    "four-slot ring by a producer warpgroup")

# the float32 space kernel at head dim 64 (csrc/resident_f32_tile.cuh): its
# one-block plan, which the cluster plan below replaced at 1024 tokens,
# timed beside it for the log line
SPACE_F32_DESIGN = (
    "the one-block plan (space_f32_own_kernel names it at 1152 tokens from "
    "1280 (frame, head) pairs): one block per (frame, head) with K "
    "resident; before the roles split every thread rotates K and rounds V "
    "to bf16 into the block's scratch slot, from which a producer warpgroup "
    "copies V in every round; two consumer warpgroups of 64 rows at 232 "
    "registers (rounds of 128 rows: none sits one out), the wgmma tile's "
    "products and 128-key softmax")
# the same kernel (csrc/resident_f32_tile.cuh) on the one-pass attention's
# float32 q, k, v at head dim 64, Nq = Nk with K resident: the modular
# path's AE space attention, head-split in PyTorch
ONEPASS_F32_DESIGN = (
    "at 1024 tokens from 192 sequences (onepass_f32_own_kernel): the float32 "
    "space kernel without its rotary, one block per sequence with K "
    "resident; before the roles split every thread rounds K, then a "
    "producer warpgroup at 104 registers rounds V to bf16 in the first "
    "round, on its way into the ring and into the block's scratch slot, "
    "from which it copies V in every later round; two consumer warpgroups "
    "of 64 rows at 200 registers, the wgmma tile's products and 128-key "
    "softmax (elsewhere the tile's float32 route)")
# the wgmma tile's float32 route without the rotary, which the float32
# one-pass attention at head dim 64 runs where the kernel above does not:
# train-first-stage's B = 1 on the modular path, [128, 1024, 64]
ONEPASS_F32_ROUTE_DESIGN = (
    "the wgmma tile instantiated for float32 without the rotary: one block "
    "per sequence with K rounded into shared memory, three consumer "
    "warpgroups of 64 rows, V rounded to bf16 in the producer's registers "
    "in every round")
# the wgmma tile's float32 route, which the float32 space attention at head
# dim 64 runs where the kernel above does not (space_f32_own_kernel): the
# design the cluster plan below replaced at 8-frame clips, timed beside it
# for the log line
SPACE_F32_ROUTE_DESIGN = (
    "the wgmma tile instantiated for float32: one block per 192 query rows "
    "of a (frame, head) with K rotated and rounded into shared memory, "
    "three consumer warpgroups of 64 rows, V rounded to bf16 in the "
    "producer's registers in every round")
# the same kernel's cluster plan (divided_attention.SPACE_F32_CLUSTER_ENTRY):
# at 1024 tokens from 64 (frame, head) pairs (8-frame clips' 64, too few
# for a block each to fill the card, train-first-stage's 128,
# train-diffusion's 1280)
SPACE_F32_CLUSTER_DESIGN = (
    "where space_f32_own_kernel names the cluster plan (at 1024 tokens from "
    "64 (frame, head) pairs): a thread-block cluster of two blocks per "
    "(frame, head), each "
    "rotating half of K into its own and its peer's shared memory (mapa + "
    "st.shared::cluster) before a cluster barrier, then walking every other "
    "round of 128 query rows; each producer rounds V on its way into the "
    "ring in its first round and half of V into the pair's scratch slot, "
    "which both copy from in their later rounds once the peer has arrived "
    "on a cluster-scope mbarrier; two consumer warpgroups at 200 registers")
SPACE_F32_CLUSTER_SOURCE = "moditalker_tpu_torch/csrc/divided_attention_f32.cu"
# the float32 one-pass and fused attention at head dim 64 past resident K
# (fused_attention_f32_prerounded): the 256-channel UNet's joint attention
# [B·8, 2048, 64] in train-diffusion
PREROUNDED_DESIGN = (
    "past 1152 keys (onepass_f32_prerounded): a pre-pass rounds K and V to "
    "bf16 once per sequence into a scratch, then the wgmma tile's bf16 K "
    "ring on it: two consumer warpgroups of 64 query rows (q read as "
    "float32, scaled and rounded once; the output stored as float32), a "
    "producer at 104 registers copying K and V tiles with cp.async "
    "(elsewhere the tile's float32 route, whose producer rounds every K and "
    "V tile in each block)")
# its entry point's source (the float32 library of the one-pass kernel)
PREROUNDED_SOURCE = "moditalker_tpu_torch/csrc/flash_attention_f32.cu"
# the bf16 one-pass and fused kernel at head dims 40, 48 and 56
# (flash_attention.NARROW_ENTRY) and the time kernel at clips of 24 and 32
# frames (divided_attention.STAGED_TIME_ENTRY), each an entry of its own in
# the kernels line
NARROW_DESIGN = (
    "the D = 64 tile's plan at the head's own width (csrc/wgmma_narrow.cuh): "
    "Q in registers, S = Q·Kᵀ in ceil(d / 16) wgmma k16 steps over K's "
    "128-byte swizzled tiles (the chunk past d zeros in shared memory "
    "only), P·V at n = d; K resident up to 1152 keys, a K ring above; two "
    "consumer warpgroups at 232 registers on both plans; a tile's S started "
    "with the last tile's P·V")
NARROW_SOURCE = "moditalker_tpu_torch/csrc/flash_narrow.cu"
STAGED_TIME_DESIGN = (
    "the frame class 32 staged by cp.async (csrc/time_staged.cuh): a warp "
    "copies its (b, n, head)'s raw q, k, v rows into shared memory, every "
    "copy in flight at once, rotates q and k there (the class's "
    "arithmetic), mma.sync products; resident blocks, warps walk items "
    "grid-stride; at 8 frames two items in a warp's 16-row tile, each "
    "item's keys in their own n8 tile of S, the other's scoring -inf")
# the classes' time kernel at 8 frames (the frame class 16, padded and
# masked), which the staged kernel replaced there, timed beside it for the
# log line
TIME_CLASS_DESIGN = (
    "the classes' time kernel: one warp per (b, n, head), its 8 frames "
    "padded to a 16-row tile and masked, loaded through registers")
STAGED_TIME_SOURCE = "moditalker_tpu_torch/csrc/divided_classes.cu"
# the time backward at 8 frames (divided_attention.STAGED_TIME_BACKWARD_ENTRY),
# an entry of its own in the kernels line, and the classes' time backward it
# replaced there, timed beside it for the log line
STAGED_TIME_BACKWARD_DESIGN = (
    "the forward's staged design carried over (csrc/time_staged_backward.cuh):"
    " two items a warp's 16-row tile, each item's keys in their own n8 tile "
    "of S and dP, the other's scoring -inf; a pair's raw rows copied by "
    "cp.async into one of two stages while the warp computes on the other, "
    "rotated there with the class's arithmetic; bf16 dqkv rows through "
    "shared memory, 16 bytes a lane; resident blocks, warps walk pairs "
    "grid-stride, dealt warp-major")
TIME_BACKWARD_CLASS_DESIGN = (
    "the classes' time backward: one warp per (b, n, head), its 8 frames "
    "padded to a 16-row tile and masked, loaded through registers")
STAGED_TIME_BACKWARD_SOURCE = (
    "moditalker_tpu_torch/csrc/divided_backward_classes.cu")
# the space backward at heads of 2 to 16 dims: the resident plan (one block
# per (frame, head)), and the class it replaced at 1024 tokens
SPACE_BACKWARD_RESIDENT_DESIGN = (
    "heads of 2 to 16 dims up to 1024 tokens (space_backward_narrow_plan): "
    "one block of 16 warps per (frame, head), q~, k~, v and g read, rotated "
    "and rounded once and resident in bf16; the row statistics, then one "
    "sweep works S, P, dP and dS out once per (query tile, key tile): dk and "
    "dv in the registers of the warp that owns the keys (two 16-key tiles a "
    "pass), dq = dS·k~ from the same dSᵀ transposed in registers "
    "(movmatrix), summed across the warps through shared memory in one "
    "fixed order; two ex2 per score")
SPACE_BACKWARD_CLASS_DESIGN = (
    "the mma.sync class: a dq kernel (row statistics, then dq) and a dk/dv "
    "kernel over 128-row blocks, each block reading, rotating and rounding "
    "the walked operand again; three ex2 per score")
# the fused kernel's float32 row past resident K: (B, Nq, Nk) at head dim
# 64, query rows over the 256-channel UNet's 2048 keys
FUSED_PREROUNDED = (16, 1280, 2048)

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


PHASE_SECONDS: dict[str, float] = {}


def phase(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one phase of the run: its seconds on the
    host clock are logged and kept under ``name`` in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


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


def active_switches() -> tuple:
    """The gate switches set now (``modular_attention`` sets both)."""
    return tuple(name for name in SWITCHES if os.environ.get(name))


# The small-depth checks hold a run on the card to the same run on the CPU.
# The CPU halves need no card, so main() hands them to one worker process at
# the start (``CpuReferences``), in the order the phases will ask for them
# (``cpu_reference_jobs``), and each check takes its result when it gets
# there: the CPU work runs while the card's phases do. A check whose CPU
# half was not handed over computes it where it stands.
CPU_REFS = None


def _worker_init(cpus: list) -> None:
    import torch

    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(len(cpus))


def _pin_threads(cpus) -> None:
    """Every thread of this process (torch's pool and the CUDA driver's
    included) onto ``cpus``; threads started later inherit the calling
    thread's set."""
    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(ProcessLookupError):
            os.sched_setaffinity(int(tid), cpus)


class _Array:
    """A tensor's values on their way out of the worker."""

    def __init__(self, values):
        self.values = values


def _tree(x, leaf):
    """``x`` with ``leaf`` applied to every value that is not a dict, list
    or tuple."""
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, leaf) for v in x)
    return leaf(x)


def _cpu_job(fn, kwargs: dict):
    """In the worker: ``fn(**kwargs)``, its tensors as numpy arrays (sent
    through the pipe by value, not through shared memory)."""
    import torch

    out = fn(**kwargs)
    return _tree(out, lambda v: _Array(v.numpy())
                 if isinstance(v, torch.Tensor) else v)


def _job_key(fn, kwargs: dict) -> str:
    """``fn`` and its arguments with the defaults filled in."""
    import inspect

    bound = inspect.signature(fn).bind(**kwargs)
    bound.apply_defaults()
    return f"{fn.__name__}{sorted(bound.arguments.items())!r}"


class CpuReferences:
    """One worker process (spawned: it never touches the card) computing
    ``jobs``, a list of (function, kwargs), in order. The worker and this
    process run on disjoint halves of the cores this process may use, so
    that the worker takes no core from the timed phases' host side; this
    process gets its cores and torch threads back once the last job is
    taken."""

    def __init__(self, jobs: list):
        import concurrent.futures
        import multiprocessing

        import torch

        self.cpus = sorted(os.sched_getaffinity(0))
        self.threads = torch.get_num_threads()
        half = max(1, len(self.cpus) // 2)
        mine = self.cpus[:half]
        theirs = self.cpus[half:] or mine
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(theirs,))
        self.futures = {_job_key(fn, kw): self.pool.submit(_cpu_job, fn, kw)
                        for fn, kw in jobs}
        self.pinned = theirs is not mine
        if self.pinned:
            _pin_threads(mine)
            torch.set_num_threads(len(mine))
        log(f"CPU references: the worker on cores {theirs}, this process "
            f"on {mine}")

    def _unpin(self) -> None:
        import torch

        if self.pinned:
            _pin_threads(self.cpus)
            torch.set_num_threads(self.threads)
            self.pinned = False

    def take(self, fn, **kwargs):
        import torch

        fut = self.futures.pop(_job_key(fn, kwargs), None)
        if fut is None:
            log(f"{fn.__name__}: not handed to the worker, computed here")
            return fn(**kwargs)
        t0 = time.perf_counter()
        out = fut.result()
        log(f"{fn.__name__}: the worker's result (waited "
            f"{time.perf_counter() - t0:.1f} s for it)")
        if not self.futures:
            self._unpin()
        return _tree(out, lambda v: torch.from_numpy(v.values)
                     if isinstance(v, _Array) else v)

    def close(self) -> None:
        for fut in self.futures.values():
            fut.cancel()
        self.pool.shutdown(wait=True, cancel_futures=True)
        self._unpin()


def cpu_reference(fn, **kwargs):
    """``fn(**kwargs)``: the worker's result where main() handed it over."""
    if CPU_REFS is None:
        return fn(**kwargs)
    return CPU_REFS.take(fn, **kwargs)


def cpu_reference_jobs(seed: int) -> list:
    """The CPU halves of the small-depth checks (``reference_windows_cpu``,
    ``train_step_once``, ``first_stage_cycles``), with the arguments their
    phases give them, in the order main() runs those phases: the reference
    windows fused and modular at 128 and 256 channels, the train-diffusion
    steps (fused, modular, 256 channels), the three train-first-stage
    checks, then the variants phase's windows and checks."""
    from moditalker_tpu_torch.config import load_config

    win, fs, step = reference_windows_cpu, first_stage_cycles, train_step_once
    modular = dict(switches=SWITCHES, heads=4, batch=2)
    jobs = [(win, dict(seed=seed)), (win, dict(seed=seed, **modular)),
            (win, dict(seed=seed, model_channels=256)),
            (win, dict(seed=seed, model_channels=256, **modular)),
            (step, dict(device="cpu", seed=seed)),
            (step, dict(device="cpu", seed=seed, modular=True)),
            (step, dict(device="cpu", seed=seed, model_channels=256))]
    # base_gan.yaml's check (the default loss), base.yaml's, base_ldmk.yaml's
    for loss, landmark in (
            (first_stage_loss(), False),
            (load_config("configs/autoencoder/base.yaml").mtov_loss, False),
            (load_config("configs/autoencoder/base_ldmk.yaml").mtov_loss,
             True)):
        jobs.append((fs, dict(device="cpu", seed=seed, loss_cfg=loss,
                              freeze_decoder=landmark)))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {name: load_config(variant_yaml(name, tmp))
               for name in VARIANTS}
    frames = cfg["clip32"].mtov_ae.timesteps
    unet192 = cfg["channels192"].mtov_unet
    unet_h2 = cfg["num_heads2"].mtov_unet
    jobs += [(win, dict(seed=seed, frames=frames)),
             (win, dict(seed=seed, frames=frames, **modular)),
             (fs, dict(device="cpu", seed=seed,
                       loss_cfg=cfg["clip8"].mtov_loss,
                       frames=cfg["clip8"].mtov_ae.timesteps)),
             (win, dict(seed=seed, model_channels=unet192.model_channels)),
             (win, dict(seed=seed, model_channels=unet_h2.model_channels,
                        unet_heads=unet_h2.num_heads))]
    for h, d in VARIANT_AE_HEADS:
        ae = cfg[f"ae_heads{h}x{d}"].mtov_ae
        jobs += [(win, dict(seed=seed, heads=ae.heads, dim_head=ae.dim_head)),
                 (fs, dict(device="cpu", seed=seed,
                           loss_cfg=first_stage_loss(), heads=ae.heads,
                           dim_head=ae.dim_head))]
    return jobs


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


def check_float32_launches(what: str, by_shape: dict) -> None:
    """Raises unless every launch since the last reset was on float32
    operands (the float32 entry points: no cast pass exists to take them);
    ``by_shape`` is ``launches_by_shape()``."""
    from moditalker_tpu_torch.ops.kernels import FLOAT32_LAUNCHES_BY_SHAPE

    f32_by_shape = {name: {str(list(sh)): n for sh, n in sorted(by.items())}
                    for name, by in FLOAT32_LAUNCHES_BY_SHAPE.items() if by}
    if f32_by_shape != by_shape:
        raise AssertionError(f"{what}: launches not on float32 operands: "
                             f"{by_shape} against float32 {f32_by_shape}")


# ------------------------------------------------------------------ kernels
def kernel_phase(torch, batch: int, seed: int) -> list[dict]:
    import torch.nn.functional as F

    from moditalker_tpu_torch.ops import attention, rotary
    from moditalker_tpu_torch.ops.kernels import (BF16_LIMITS, QUANTILE,
                                                  QUANTILE_LIMITS,
                                                  LAUNCHES_BY_ENTRY,
                                                  bf16_rounded_share,
                                                  check_bf16,
                                                  FLOAT32_ROUTE_LIMITS,
                                                  check_float32_route)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, dh, f, n = 8, 64, 16, 1024        # shipped AE: 256², patch 8
    hd = heads * dh
    scale = dh**-0.5

    def errors(name, kern, plain, route, dtype=None, limits=None):
        """The row's errors against its plain version; a float32 result is
        also held to ``route()``, its float32 route's function (within
        ``FLOAT32_ROUTE_LIMITS[limits or name]``), and to a bf16-rounded
        share under 1 %. ``dtype``: the inputs' type where
        ``plain`` computes in float32 on them widened (the oracle of the
        rows added with the classes: at their lengths and head dims the bf16
        plain version's own roundings, its rotary in bf16 and its bf16
        scores, are the larger error)."""
        out, want = kern(), plain()
        if out.dtype != (dtype or want.dtype):
            raise AssertionError(f"{name}: {out.dtype} out of a "
                                 f"{dtype or want.dtype} input")
        rel_max, rel_rms, rel_q = check_bf16(name, out, want)
        err = dict(max_abs_err=(out.float() - want.float()).abs().max().item(),
                   rel_max_err=rel_max, rel_rms_err=rel_rms, rel_q_err=rel_q,
                   dtype=str(out.dtype).replace("torch.", ""),
                   oracle="float32 plain" if dtype else "plain")
        del want
        if out.dtype == torch.float32:
            err["route_rel_err"] = check_float32_route(limits or name, out,
                                                       route())
            err["bf16_rounded_share"] = bf16_rounded_share(out)
            if err["bf16_rounded_share"] >= 0.01:
                raise AssertionError(
                    f"{name}: {err['bf16_rounded_share']:.4f} of the float32 "
                    f"result equals its bf16 rounding")
        return err

    def library_sdpa(q, k, v, sc):
        """The yardstick on [B, N, D]: with a head axis of one, since the
        library's fused kernels take 4-D tensors only (3-D ones fall to its
        unfused math)."""
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=sc)

    def tables(sin_cos):
        return [torch.from_numpy(t).to(dev) for t in sin_cos]

    def head_split_rotated(qkv, sin, cos, axis, heads=heads, dh=dh):
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

    def divided_row(axis, b_, f_, n_, g=gen_more, dtype=torch.bfloat16,
                    source="divided_attention", plain32=False, heads=heads,
                    dh=dh, twice=False, replaced=None):
        """``heads`` heads of ``dh`` (the shipped AE's 8 of 64 unless
        given: another head dim runs the kernel's class). ``twice``: two
        more calls must equal each other bit for bit. ``replaced``: the
        design the kernel replaced at this shape, ``(qkv, sin, cos, heads,
        dh, scale) -> (call, design)``: its output must equal the kernel's
        bit for bit, and its time, taken in this call, goes to the log line
        alone (``replaced_ms``, popped before the kernels line)."""
        hd, scale = heads * dh, dh**-0.5
        if axis == "space":
            sin, cos = tables(rotary.axial_rotary_sincos(32, n_ // 32, dh)
                              if n_ >= 1024 else
                              rotary.axial_rotary_sincos(16, n_ // 16, dh))
        else:
            sin, cos = ((t_sin, t_cos) if f_ == f and dh == 64 else
                        tables(rotary.time_rotary_sincos(f_, dh)))
        qkv = torch.randn((b_, f_, n_, 3 * hd), generator=g,
                          device=dev).to(dtype)
        size = qkv.element_size()
        kern = lambda: dv.divided_attention(qkv, sin, cos, axis, heads, dh,
                                            scale)
        plain = lambda: dv.divided_attention_reference(
            qkv, sin, cos, axis, heads, dh, scale, use_flash=False)
        name = f"divided_{axis}_attention"
        oracle = (lambda: dv.divided_attention_reference(
            qkv.float(), sin, cos, axis, heads, dh, scale, use_flash=False)
        ) if plain32 else plain
        # float32 space rows against the route in the kernels' ex2 form
        err = errors(name, kern, oracle,
                     lambda: dv.divided_attention_float32_route(
                         qkv, sin, cos, axis, heads, dh, scale,
                         exp2=axis == "space"),
                     dtype=qkv.dtype if plain32 else None)
        if twice and not torch.equal(kern(), kern()):
            raise AssertionError(f"{name} {list(qkv.shape)}: two calls differ")
        if replaced is not None:
            other, design = replaced(qkv, sin, cos, heads, dh, scale)
            if not torch.equal(kern(), other()):
                raise AssertionError(f"{name} {list(qkv.shape)}: differs "
                                     f"from the design it replaced, {design}")
            err["replaced"] = dict(design=design, ms=time_ms(torch, other))
        q, k, v = head_split_rotated(qkv, sin, cos, axis, heads, dh)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        seq = n_ if axis == "space" else f_
        nseq = b_ * f_ * n_ // seq
        nbytes = (qkv.numel() + b_ * f_ * n_ * hd) * size + 2 * sin.numel() * 4
        flops = 4.0 * nseq * heads * seq * seq * dh
        return dict(
            name=name, route="cuda",
            source=f"moditalker_tpu_torch/csrc/{source}.cu",
            replaces=("moditalker_tpu/ops/pallas/divided_attention.py:121"
                      if axis == "space" else
                      "moditalker_tpu/ops/pallas/divided_attention.py:177"),
            shape=list(qkv.shape), heads=[heads, dh], **err,
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

    def packed_row(b_, l_, g=gen_more, dtype=torch.bfloat16, plain32=False):
        qkv = torch.randn((b_, l_, 3 * c), generator=g, device=dev).to(dtype)
        sc = (c // heads) ** -0.5
        kern = lambda: pk.packed_attention(qkv, heads, sc)
        plain = lambda: pk.packed_attention_reference(qkv, heads, sc)
        oracle = (lambda: pk.packed_attention_reference(qkv.float(), heads,
                                                        sc)
                  ) if plain32 else plain
        err = errors("packed_attention", kern, oracle,
                     lambda: pk.packed_attention_float32_route(qkv, heads, sc),
                     dtype=qkv.dtype if plain32 else None)
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

    def sdpa_row(name, replaces, source, kern, plain, q, k, v, sc,
                 plain32=False, prerounded=False):
        """``prerounded``: float32 at head dim 64 past resident K (the
        pre-pass and the bf16 K ring): held to the route's ``exp2`` form
        within the limits of its entry point
        (``FLOAT32_ROUTE_LIMITS[fa.PREROUNDED_ENTRY]``)."""
        # a shape beyond the configurations' runs the kernel's class, or
        # (one-pass and fused above 32) the wgmma tile built for its width
        if name == "tiny_attention":
            if (q.shape[1], q.shape[-1]) not in fa.TINY_SHAPES:
                source = "flash_classes"
        else:
            source = fa.attention_source(q.shape[-1],
                                         q.dtype == torch.float32)
        oracle = (lambda: fa.onepass_attention_reference(
            q.float(), k.float(), v.float(), sc)) if plain32 else plain
        lib = library_sdpa(q, k, v, sc)
        b_, nq_, d_ = q.shape
        return dict(
            name=name, route="cuda",
            source=f"moditalker_tpu_torch/csrc/{source}.cu",
            replaces=f"moditalker_tpu/ops/pallas/flash_attention.py:{replaces}",
            shape=[list(q.shape), list(k.shape)],
            # the wide tile's float32 rows against the route with the
            # kernels' ex2 (``exp2``), as its card tests hold it, and the
            # float32 rows past resident K at D = 64
            **errors(name, kern, oracle,
                     lambda: fa.attention_float32_route(
                         q, k, v, sc,
                         exp2=source == "flash_wide" or prerounded),
                     dtype=q.dtype if plain32 else None,
                     limits=fa.PREROUNDED_ENTRY if prerounded else None),
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
    def forced(row, kern, b_, nq_, nk_):
        """Float32 at head dim 64: two more calls must equal each other bit
        for bit, and the other side of the wrapper's choice, forced, must
        equal this side bit for bit; that side is timed too (``forced``).
        The choice: with K resident ``onepass_f32_own_kernel`` (the float32
        resident-K kernel or the wgmma tile's float32 route), past it
        ``onepass_f32_prerounded`` (the pre-pass and the bf16 K ring, or
        that route)."""
        name = f"{row['name']} {row['shape']}"
        out = kern()
        if not torch.equal(out, kern()):
            raise AssertionError(f"{name}: two calls differ")
        which = ("onepass_f32_prerounded" if nk_ > fa.RESIDENT_KEYS_D64
                 else "onepass_f32_own_kernel")
        chooser = getattr(fa, which)
        own = chooser(b_, nq_, nk_)
        setattr(fa, which, lambda *a: not own)
        try:
            if not torch.equal(out, kern()):
                raise AssertionError(
                    f"{name}: the kernel ({which}) and the wgmma tile's "
                    f"float32 route differ")
            row["forced"] = dict(side="route" if own else "kernel",
                                 ms=time_ms(torch, kern), bit_for_bit=True)
        finally:
            setattr(fa, which, chooser)
        return row

    def onepass_row(b_, n_, d_, g=gen, dtype=torch.bfloat16, plain32=False,
                    twice=False):
        """``twice`` (float32 at head dim 64): ``forced``."""
        q, k, v = (randn(b_, n_, d_, g=g, dtype=dtype) for _ in range(3))
        kern = lambda: fa.onepass_attention(q, k, v, d_**-0.5)
        row = sdpa_row(
            "onepass_attention", 104, "flash_attention", kern,
            lambda: fa.onepass_attention_reference(q, k, v, d_**-0.5),
            q, k, v, d_**-0.5, plain32,
            prerounded=(dtype == torch.float32 and d_ == 64
                        and fa.onepass_f32_prerounded(b_, n_, n_)))
        return forced(row, kern, b_, n_, n_) if twice else row

    rows.append(dict(onepass_row(batch * heads, l, 32),
                     design=small_head + "; at D = 64 the wgmma tile without "
                                         "the rotary"))
    rows += [onepass_row(batch * heads * f, n, dh),
             onepass_row(batch * heads, l, 16),
             onepass_row(batch * heads, 1024, 16),
             onepass_row(heads, l, 32, g=gen_more)]

    # tiny-L: the modular path's TimeSformer time attention
    def tiny_row(b_, g=gen, dtype=torch.bfloat16, l_=f, plain32=False):
        q, k, v = (randn(b_, l_, dh, g=g, dtype=dtype) for _ in range(3))
        return sdpa_row(
            "tiny_attention", 146, "tiny_attention",
            lambda: fa.tiny_attention(q, k, v, scale),
            lambda: fa.tiny_attention_reference(q, k, v, scale),
            q, k, v, scale, plain32)

    rows.append(tiny_row(batch * heads * n))

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
             onepass_row(16, 2048, 64, g=gen_b2),
             # and at sample_long's B = 1
             onepass_row(heads, 1024, 32, g=gen_b2),
             onepass_row(heads, 2048, 64, g=gen_b2)]
    # float32 in and out, at the shapes train-diffusion gives the kernels at
    # B = diffusion_batch_size: the frozen AEs' extract and the UNet's
    # packed and one-pass attentions, each held to the same limits against
    # the float32 plain version, to its float32 route's function within
    # FLOAT32_ROUTE_LIMITS and to the share of its result that equals its
    # bf16 rounding (``errors``). Every kernel reads and writes float32
    # itself: no cast pass anywhere
    f32 = torch.float32
    gen_f32 = torch.Generator(device=dev).manual_seed(seed + 3)
    tb = TRAIN_BATCH

    def space_forced(plan, design):
        """The float32 space attention with ``space_f32_own_kernel`` forced
        to ``plan`` (None: the wgmma tile's float32 route): a design the
        chooser's table replaced at a shape (``divided_row``'s
        ``replaced``)."""
        def replaced(qkv, sin, cos, heads_, dh_, scale_):
            def run():
                chooser = dv.space_f32_own_kernel
                dv.space_f32_own_kernel = lambda *a: plan
                try:
                    return dv.divided_attention(qkv, sin, cos, "space",
                                                heads_, dh_, scale_)
                finally:
                    dv.space_f32_own_kernel = chooser
            return run, design
        return replaced

    # the float32 space kernel's cluster plan at 1024 tokens (its entry
    # point's row of the kernels line), beside the one-block plan it
    # replaced there
    cluster = dict(design=SPACE_F32_CLUSTER_DESIGN,
                   entry=dv.SPACE_F32_CLUSTER_ENTRY,
                   source=SPACE_F32_CLUSTER_SOURCE)
    assert dv.space_f32_own_kernel(tb * f, n, heads) == "cluster"
    rows += [dict(divided_row("space", tb, f, n, g=gen_f32, dtype=f32,
                              twice=True, replaced=space_forced(
                                  "block", SPACE_F32_DESIGN)), **cluster),
             divided_row("time", tb, f, n, g=gen_f32, dtype=f32),
             packed_row(tb, l, g=gen_f32, dtype=f32),
             packed_row(tb, 1024, g=gen_f32, dtype=f32),
             onepass_row(tb * heads, l, 32, g=gen_f32, dtype=f32)]
    # the 256-channel UNet's joint attention after the last upsample
    # (configs/latent-diffusion/base_longvid.yaml), which train-diffusion
    # runs in float32: 2048 keys at D = 64, past resident K, the pre-pass
    # and the bf16 K ring (its entry point's row of the kernels line),
    # beside the wgmma tile's float32 route forced
    assert fa.onepass_f32_prerounded(tb * heads, l, l)
    rows.append(dict(onepass_row(tb * heads, l, dh, g=gen_f32, dtype=f32,
                                 twice=True),
                     design=PREROUNDED_DESIGN, entry=fa.PREROUNDED_ENTRY,
                     source=PREROUNDED_SOURCE))
    # the 256-channel UNet's xy-plane attention at ds = 1 (C = 256, 1024
    # tokens, dh = 32), which train-diffusion runs in float32 at B = 10
    # (configs/latent-diffusion/base_longvid.yaml): the small-head tile
    gen_lv = torch.Generator(device=dev).manual_seed(seed + 7)
    rows.append(onepass_row(tb * heads, 1024, 32, g=gen_lv, dtype=f32))
    # float32 on the modular path (both gate switches set): train-diffusion's
    # frozen extracts send the time attention to tiny-L and the space
    # attention to one-pass at D = 64, its UNet the dh = 16 attentions to
    # one-pass; B = 10, then B = 1 (the golden record's and
    # train-first-stage's batch)
    gen_mod = torch.Generator(device=dev).manual_seed(seed + 6)
    assert fa.onepass_f32_own_kernel(tb * heads * f, n, n)
    assert not fa.onepass_f32_own_kernel(heads * f, n, n)
    rows += [tiny_row(tb * heads * n, g=gen_mod, dtype=f32),
             tiny_row(heads * n, g=gen_mod, dtype=f32),
             onepass_row(tb * heads, l, 16, g=gen_mod, dtype=f32),
             onepass_row(tb * heads, 1024, 16, g=gen_mod, dtype=f32),
             dict(onepass_row(tb * heads * f, n, dh, g=gen_mod, dtype=f32,
                              twice=True), design=ONEPASS_F32_DESIGN),
             dict(onepass_row(heads * f, n, dh, g=gen_mod, dtype=f32,
                              twice=True), design=ONEPASS_F32_ROUTE_DESIGN)]
    # the fused kernel in float32 at the kernels phase's cross-length shape
    q, k, v = (randn(2, 64, dh, g=gen_mod, dtype=f32),
               randn(2, 512, dh, g=gen_mod, dtype=f32),
               randn(2, 512, dh, g=gen_mod, dtype=f32))
    rows.append(sdpa_row(
        "fused_attention", 33, "flash_attention",
        lambda: attention.sdpa_fused(q, k, v, scale),
        lambda: fa.fused_attention_reference(q, k, v, scale),
        q, k, v, scale))
    # and past resident K: query rows over 2048 keys (FUSED_PREROUNDED),
    # the pre-pass and the bf16 K ring beside the route forced
    gen_pr = torch.Generator(device=dev).manual_seed(seed + 13)
    b_, nq_, nk_ = FUSED_PREROUNDED
    assert fa.onepass_f32_prerounded(b_, nq_, nk_)
    q = randn(b_, nq_, dh, g=gen_pr, dtype=f32)
    k, v = (randn(b_, nk_, dh, g=gen_pr, dtype=f32) for _ in range(2))
    kern = lambda: attention.sdpa_fused(q, k, v, scale)
    rows.append(dict(forced(sdpa_row(
        "fused_attention", 33, "flash_attention", kern,
        lambda: fa.fused_attention_reference(q, k, v, scale),
        q, k, v, scale, prerounded=True), kern, b_, nq_, nk_),
        design=PREROUNDED_DESIGN, entry=fa.PREROUNDED_ENTRY,
        source=PREROUNDED_SOURCE))
    # float32 at B = 1, the shape train-first-stage gives them: its AE
    # trains through them
    gen_fs = torch.Generator(device=dev).manual_seed(seed + 5)
    rows += [dict(divided_row("space", 1, f, n, g=gen_fs, dtype=f32,
                              twice=True, replaced=space_forced(
                                  "block", SPACE_F32_DESIGN)), **cluster),
             divided_row("time", 1, f, n, g=gen_fs, dtype=f32)]
    # 8-frame clips (first_stage_frames_phase): 64 (frame, head) pairs,
    # beside the wgmma tile's float32 route the cluster plan replaced there
    assert dv.space_f32_own_kernel(f // 2, n, heads) == "cluster"
    rows.append(dict(divided_row("space", 1, f // 2, n, g=gen_fs, dtype=f32,
                                 twice=True, replaced=space_forced(
                                     None, SPACE_F32_ROUTE_DESIGN)),
                     **cluster))

    def backward_row(axis, g, dtype, f=f, source="divided_backward",
                     heads=heads, dh=dh, replaced=None, check_f=None):
        """The backward kernel at train-first-stage's qkv [1, 16, 1024,
        1536] (``f``: its clips of another length; ``heads`` of ``dh``: the
        AE's 512 channels split another way, the classes' backward):
        dqkv against the float32
        plain backward (the written-out adjoints) and, in float32, against
        its float32 route's function; two calls equal bit for bit. Timed
        beside the plain backward, the recompute it replaced
        (``RecomputeThroughPlain``: the plain forward again, then its vjp)
        and the library's attention backward alone (``torch.autograd.grad``
        through ``scaled_dot_product_attention`` on the rotated, head-split
        float32 q, k, v). ``replaced``: the design the kernel replaced at
        this shape, ``(qkv, out, cot, sin, cos, heads, dh, scale) -> (call,
        design, exact)``, timed in this call for the log line alone
        (``replaced_ms``); where ``exact`` its dqkv must equal the kernel's
        bit for bit. ``check_f``: the errors (and the plain backward's time,
        ``plain_shape``) at clips of ``check_f`` frames, where the plain
        backward's score-sized tensors fit the card (at 16 frames in heads
        of 2 one is 17 GB); the other times at ``f``. At heads of up to
        ``SPACE_BACKWARD_NARROW_MAX`` dims both clips must take one plan
        (``space_backward_narrow_plan``), and the check must launch that
        plan's entry point, so the errors are the timed kernel's."""
        hd, scale = heads * dh, dh**-0.5
        if axis == "space" and dh < 4:
            # the axial table has no entry below head dim 4: angles drawn per
            # rotated pair and repeated over it, as the axial table repeats
            ang = (torch.rand(n, dh // 2, generator=g, device=dev) * 6 - 3
                   ).repeat_interleave(2, dim=-1)
            sin, cos = ang.sin(), ang.cos()
        elif axis == "space":
            sin, cos = tables(rotary.axial_rotary_sincos(32, n // 32, dh))
        else:
            sin, cos = tables(rotary.time_rotary_sincos(f, dh))
        name = f"divided_{axis}_attention_backward"

        def inputs(f_):
            qkv = torch.randn((1, f_, n, 3 * hd), generator=g,
                              device=dev).to(dtype)
            cot = torch.randn((1, f_, n, hd), generator=g,
                              device=dev).to(dtype)
            out = dv.divided_attention(qkv, sin, cos, axis, heads, dh, scale)
            flat = (f_, n, -1)
            if axis == "space":
                kern = lambda: dv.space_attention_backward_cuda(
                    qkv.reshape(flat), out.reshape(flat), cot.reshape(flat),
                    sin, cos, heads, dh, scale).reshape(qkv.shape)
            else:
                kern = lambda: dv.time_attention_backward_cuda(
                    qkv, cot, sin, cos, heads, dh, scale)
            return qkv, out, cot, kern

        def check(qkv, out, cot, kern):
            args = (qkv, out, cot, sin, cos, axis, heads, dh, scale)
            got, again = kern(), kern()
            want = db.divided_attention_backward_reference(*args)
            if got.dtype != dtype or got.shape != qkv.shape:
                raise AssertionError(f"{name}: {got.dtype} "
                                     f"{list(got.shape)}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls on the same inputs "
                                     f"differ")
            rel_max, rel_rms, rel_q = check_bf16(name, got, want)
            err = dict(max_abs_err=(got.float() - want).abs().max().item(),
                       rel_max_err=rel_max, rel_rms_err=rel_rms,
                       rel_q_err=rel_q,
                       dtype=str(dtype).replace("torch.", ""),
                       deterministic=True)
            del want
            if dtype == f32:
                err["route_rel_err"] = check_float32_route(
                    name, got,
                    db.divided_attention_backward_float32_route(*args))
                err["bf16_rounded_share"] = bf16_rounded_share(got)
                if err["bf16_rounded_share"] >= 0.01:
                    raise AssertionError(f"{name}: a float32 dqkv rounded to "
                                         f"bf16")
            return err, lambda: db.divided_attention_backward_reference(*args)

        if check_f is not None:
            small = inputs(check_f)
            entry = None
            if axis == "space" and dh <= dv.SPACE_BACKWARD_NARROW_MAX:
                plan = dv.space_backward_narrow_plan(f, n, heads)
                if dv.space_backward_narrow_plan(check_f, n, heads) != plan:
                    raise AssertionError(
                        f"{name}: clips of {check_f} frames take another "
                        f"plan than the {f} timed ({plan})")
                entry = (dv.SPACE_BACKWARD_RESIDENT_ENTRY if plan ==
                         "resident" else "divided_space_attention_backward"
                         "_classes") + ("_f32" if dtype == f32 else "")
                before = LAUNCHES_BY_ENTRY[entry]
            err, small_plain = check(*small)
            if entry is not None:
                if LAUNCHES_BY_ENTRY[entry] != before + 2:
                    raise AssertionError(f"{name}: the check at {check_f} "
                                         f"frames did not launch {entry}")
                err["entry_checked"] = entry
            err["plain_shape"] = list(small[0].shape)
            plain_ms = device_ms(torch, small_plain)
            del small, small_plain
            torch.cuda.empty_cache()
        qkv, out, cot, kern = inputs(f)
        flat = (f, n, -1)
        args = (qkv, out, cot, sin, cos, axis, heads, dh, scale)
        plain = lambda: db.divided_attention_backward_reference(*args)
        if check_f is None:
            err, _ = check(qkv, out, cot, kern)
            plain_ms = time_ms(torch, plain)
        else:
            got = kern()
            if not (torch.equal(got, kern()) and got.isfinite().all()):
                raise AssertionError(f"{name} {list(qkv.shape)}: two calls "
                                     f"differ or not finite")
            del got
        if replaced is not None:
            other, design, exact = replaced(qkv, out, cot, sin, cos, heads,
                                            dh, scale)
            if exact and not torch.equal(kern(), other()):
                raise AssertionError(f"{name} {list(qkv.shape)}: differs "
                                     f"from the design it replaced, {design}")
            err["replaced"] = dict(design=design, ms=time_ms(torch, other),
                                   bit_for_bit=exact)
        if axis == "space" and dh > dv.SPACE_BACKWARD_NARROW_MAX:
            # the pre-pass alone (its entry point, uncounted) against its
            # plain version, bit for bit: every element of the scratch, gs
            # and dsum (the buffers start as NaN)
            bufs = dv.space_backward_scratch(f, n, heads, dh, dev)[:3]
            for t in bufs:
                t.fill_(float("nan"))
            lib, suffix = dv._library(
                dtype == f32, dh not in dv.SPACE_BACKWARD_HEAD_DIMS,
                backward=True)
            entry = "divided_space_backward_prepass" + suffix
            pointers = (qkv.reshape(flat), dv.rotary_pair_table(sin, cos),
                        out.reshape(flat), cot.reshape(flat), *bufs)
            status = getattr(lib, entry)(
                *(t.data_ptr() for t in pointers), f, n, heads, dh, scale,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise AssertionError(f"{entry}: CUDA error {status}")
            plain_pre = db.space_backward_prepass_reference(
                qkv.reshape(flat), out.reshape(flat), cot.reshape(flat), sin,
                cos, heads, dh, scale)
            if not all(torch.equal(a, b) for a, b in zip(bufs, plain_pre)):
                raise AssertionError(f"{entry}: the scratch differs from "
                                     f"space_backward_prepass_reference")
            err["prepass_bit_for_bit"] = True
            del bufs, plain_pre
        if check_f is None:   # (where the plain backward fits the card)
            x = qkv.detach().float().requires_grad_()
            err["recompute_ms"] = device_ms(torch, lambda: torch.autograd.grad(
                dv.divided_attention_reference(x, sin, cos, axis, heads, dh,
                                               scale, use_flash=False),
                x, cot.float()))
            del x
        q, k, v = (t.requires_grad_() for t in
                   head_split_rotated(qkv.float(), sin, cos, axis, heads, dh))
        lib_out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        lib_cot = torch.randn(lib_out.shape, generator=g, device=dev)
        library = lambda: torch.autograd.grad(lib_out, (q, k, v), lib_cot,
                                              retain_graph=True)
        seq = n if axis == "space" else f
        nseq = f * n // seq
        size = qkv.element_size()
        nbytes = (2 * qkv.numel() + cot.numel()
                  + (out.numel() if axis == "space" else 0)) * size
        # one ex2 per score in each sweep: space recomputes S three times
        # (row statistics, dq, dk and dv), twice on the narrow heads'
        # resident plan (row statistics, then dq, dk and dv from one S);
        # time once
        sweeps = 1 if axis == "time" else 2 if (
            dh <= dv.SPACE_BACKWARD_NARROW_MAX
            and dv.space_backward_narrow_plan(f, n, heads) == "resident"
        ) else 3
        return dict(
            name=name, route="cuda",
            source=f"moditalker_tpu_torch/csrc/{source}.cu",
            replaces="moditalker_tpu/ops/pallas/divided_attention.py:317",
            shape=list(qkv.shape), heads=[heads, dh], **err,
            ms=time_ms(torch, kern), plain_ms=plain_ms,
            library_ms=device_ms(torch, library),
            # the space kernels read the pair table, half of sin and cos
            nbytes=nbytes + (1 if axis == "space" else 2) * sin.numel() * 4,
            # dV, dP, S, dQ, dK: five products of 2·seq²·dh
            flops=10.0 * nseq * heads * seq * seq * dh,
            scores=sweeps * nseq * heads * seq * seq)

    # the backward kernels: float32 (the trainers') first, the main path's
    # rows of the kernels line; then bf16 at the same shape
    gen_bw = torch.Generator(device=dev).manual_seed(seed + 8)
    rows.append(dict(backward_row("space", gen_bw, f32),
                     design=SPACE_BACKWARD_DESIGN))
    rows.append(dict(backward_row("time", gen_bw, f32),
                     design="one warp per (b, n, head), mma.sync"))
    rows += [backward_row(axis, gen_bw, torch.bfloat16)
             for axis in ("space", "time")]
    # float32 at B = 1, the shapes a full-width golden record gives the
    # UNet's packed and one-pass kernels
    rows += [packed_row(1, l, g=gen_fs, dtype=f32),
             packed_row(1, 1024, g=gen_fs, dtype=f32),
             onepass_row(heads, l, 32, g=gen_fs, dtype=f32)]
    # the classes beyond the configurations' shapes, at the shapes the
    # variants phase gives them (bf16 and float32 each): clips of 32 frames
    # (time on the 32-frame tile, tiny-L at 32 rows on the modular path,
    # the UNet's packed and one-pass kernels at L = 3072), clips of 8 frames
    # (time forward and backward on the 16-frame tile, padded and masked:
    # train-first-stage's), and the 192-channel UNet's one-pass attentions
    # (head dims 24 and 48 on the small-head tile's classes 32 and 64). A
    # bf16 result is held to the plain version in float32 on its inputs
    # (``errors``' dtype): at 3072 keys the bf16 plain version's bf16
    # scores alone put the packed kernel's max measure at its limit
    gen_cl = torch.Generator(device=dev).manual_seed(seed + 9)
    staged = dict(entry=dv.STAGED_TIME_ENTRY, design=STAGED_TIME_DESIGN,
                  source=STAGED_TIME_SOURCE)

    def time_class(qkv, sin, cos, heads_, dh_, scale_):
        """The classes' time kernel (which still takes 8 frames) through its
        entry point, on the wrapper's operands."""
        b_, f_, n_, _ = qkv.shape
        lib, suffix = dv._library(qkv.dtype == f32, True)
        entry = "divided_time_attention" + suffix
        out = torch.empty(b_, f_, n_, heads_ * dh_, dtype=qkv.dtype,
                          device=dev)

        def run():
            status = getattr(lib, entry)(
                qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                out.data_ptr(), b_, f_, n_, heads_, dh_, scale_,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise AssertionError(f"{entry}: CUDA error {status}")
            return out
        return run, TIME_CLASS_DESIGN
    staged_backward = dict(entry=dv.STAGED_TIME_BACKWARD_ENTRY,
                           design=STAGED_TIME_BACKWARD_DESIGN,
                           source=STAGED_TIME_BACKWARD_SOURCE)

    def time_backward_class(qkv, out, cot, sin, cos, heads_, dh_, scale_):
        """The classes' time backward (which still takes 8 frames) through
        its entry point, on the wrapper's operands: what the staged
        backward replaced there, bit for bit."""
        b_, f_, n_, _ = qkv.shape
        lib, suffix = dv._library(qkv.dtype == f32, True, backward=True)
        entry = "divided_time_attention_backward" + suffix
        dqkv = torch.empty_like(qkv)

        def run():
            status = getattr(lib, entry)(
                qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
                cot.data_ptr(), dqkv.data_ptr(), b_, f_, n_, heads_, dh_,
                scale_, torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise AssertionError(f"{entry}: CUDA error {status}")
            return dqkv
        return run, TIME_BACKWARD_CLASS_DESIGN, True
    narrow = dict(entry=fa.NARROW_ENTRY, design=NARROW_DESIGN,
                  source=NARROW_SOURCE)
    assert dv.time_backward_staged(VARIANT_TRAIN_FRAMES)
    for dtype in (torch.bfloat16, f32):
        assert dv.time_staged(VARIANT_CLIP_FRAMES)
        rows += [
            dict(divided_row("time", batch, VARIANT_CLIP_FRAMES, n, g=gen_cl,
                             dtype=dtype, plain32=True, twice=True),
                 **staged),
            dict(divided_row("time", 1, VARIANT_TRAIN_FRAMES, n, g=gen_cl,
                             dtype=dtype, plain32=True, twice=True,
                             replaced=time_class), **staged),
            tiny_row(batch * heads * n, g=gen_cl, dtype=dtype,
                     l_=VARIANT_CLIP_FRAMES, plain32=True),
            onepass_row(batch * heads, 2048, 24, g=gen_cl, dtype=dtype,
                        plain32=True),
            onepass_row(batch * heads, 1024, 24, g=gen_cl, dtype=dtype,
                        plain32=True),
            dict(onepass_row(batch * heads, 2048, 48, g=gen_cl, dtype=dtype,
                             plain32=True),
                 **(narrow if dtype == torch.bfloat16 else {})),
            dict(backward_row("time", gen_cl, dtype, f=VARIANT_TRAIN_FRAMES,
                              replaced=time_backward_class),
                 **staged_backward)]
    # the narrow tile's other widths, and its fused masked shapes at 48:
    # ragged query chunks over one whole 128-key tile and one short of it
    # (zero-filled and masked), query rows over resident K and past it;
    # the staged time kernel at 24 frames
    gen_nw = torch.Generator(device=dev).manual_seed(seed + 14)
    for d_ in (40, 56):
        rows.append(dict(onepass_row(batch * heads, 2048, d_, g=gen_nw,
                                     plain32=True), **narrow))
    for b_, nq_, nk_ in ((batch * heads, 1000, 128),
                         (batch * heads, 1000, 120),
                         (batch * heads, 300, 1024),
                         (batch * heads, 1280, 2048)):
        q = randn(b_, nq_, 48, g=gen_nw)
        k, v = (randn(b_, nk_, 48, g=gen_nw) for _ in range(2))
        rows.append(dict(sdpa_row(
            "fused_attention", 33, "flash_attention",
            lambda q=q, k=k, v=v: fa.fused_attention(q, k, v, 48**-0.5),
            lambda q=q, k=k, v=v: fa.fused_attention_reference(
                q, k, v, 48**-0.5),
            q, k, v, 48**-0.5, plain32=True), **narrow))
    for dtype in (torch.bfloat16, f32):
        rows.append(dict(divided_row("time", batch, 24, n, g=gen_nw,
                                     dtype=dtype, plain32=True, twice=True),
                         **staged))
    rows += [packed_row(batch, 3072, g=gen_cl, plain32=True),
             onepass_row(batch * heads, 3072, 32, g=gen_cl, plain32=True)]

    # the wgmma tile built per width (csrc/flash_wide{,_f32}.cu), bf16 and
    # float32, each held to the float32 plain version: the one-pass kernel
    # at head dim 128 (base.yaml with num_heads: 2 gives the joint attention
    # after the last upsample [B·2, 2048, 128]; at 16 sequences, the
    # prediction's shape), and the fused kernel past 128, where it raised
    # before: 136 (a width of its own), 256 (the 256-column tile) and 512
    # (two groups of 256 columns, each summing S over all 512 dims)
    wide = ("wgmma built per width: S from Q's 64-dim panels in shared "
            "memory over K chunks streamed through a cp.async ring, P·V at "
            "N = d from V tiles; two consumer warpgroups, each starting a "
            "tile's S with the last tile's P·V; 128-key tiles up to 128 "
            "columns, 64 above; groups of 256 columns past 256")
    gen_wd = torch.Generator(device=dev).manual_seed(seed + 11)
    for dtype in (torch.bfloat16, f32):
        rows += [dict(onepass_row(batch * 2, 2048, 128, g=gen_wd, dtype=dtype,
                                  plain32=True), design=wide),
                 onepass_row(16, 2048, 128, g=gen_wd, dtype=dtype,
                             plain32=True)]
        for d_ in (136, 256, 512):
            q, k, v = (randn(16, 1024, d_, g=gen_wd, dtype=dtype)
                       for _ in range(3))
            rows.append(sdpa_row(
                "fused_attention", 33, "flash_attention",
                lambda q=q, k=k, v=v, d_=d_: attention.sdpa_fused(
                    q, k, v, d_**-0.5),
                lambda q=q, k=k, v=v, d_=d_: fa.fused_attention_reference(
                    q, k, v, d_**-0.5),
                q, k, v, d_**-0.5, plain32=True))
    # the space kernel's pre-rotated design (csrc/divided_space.cuh) at
    # the AE's 512 channels in 4 heads of 128, 16 of 32 and 32 of 16 (the
    # variants phase's AEs), bf16 and float32, and in float32 at head dim
    # 64 past resident K (2048 tokens); the space backward's classes at
    # train-first-stage's qkv in 4 heads of 128 and 16 of 32
    pre = ("a rotation pre-pass (q rotated and scaled, k rotated, bf16, "
           "once per call), then the wgmma tile built per width (128; 64 "
           "in float32) or the small-head tile (up to 32) on it, raw")
    for dtype in (torch.bfloat16, f32):
        rows += [dict(divided_row("space", batch, f, n, g=gen_wd,
                                  dtype=dtype, source="divided_classes",
                                  plain32=True, heads=hd // dh_, dh=dh_),
                      design=pre) for dh_ in (128, 32, 16)]
    rows.append(divided_row("space", batch, 1, 2048, g=gen_wd, dtype=f32,
                            source="divided_classes", plain32=True))
    rows += [dict(backward_row("space", gen_wd, dtype,
                               source="divided_backward_classes",
                               heads=hd // dh_, dh=dh_),
                  design=SPACE_BACKWARD_DESIGN)
             for dtype in (f32, torch.bfloat16) for dh_ in (128, 32)]
    # the space backward at heads of 16, 8, 4 and 2 dims, float32 and bf16:
    # the resident plan, which space_backward_narrow_plan names at
    # train-first-stage's qkv [1, 16, 1024, 1536], timed there beside the
    # class it replaced (not bit for bit: dq sums in another order) and the
    # library; held to the plain backward and the route at the fewest
    # frames at which the plan is still the resident one (4 at heads of 16,
    # 2 at 8, 1 at 4 and 2)
    gen_nb = torch.Generator(device=dev).manual_seed(seed + 15)

    def space_backward_class(qkv, out, cot, sin, cos, heads_, dh_, scale_):
        """The narrow space backward's class through its entry point, on
        the wrapper's operands."""
        bf_, n_ = qkv.shape[1], qkv.shape[2]
        lib, suffix = dv._library(qkv.dtype == f32, True, backward=True)
        entry = "divided_space_attention_backward" + suffix
        pointers = (qkv, dv.rotary_pair_table(sin, cos), out, cot,
                    torch.empty_like(qkv),
                    torch.empty(bf_, heads_, n_, 2, device=dev))

        def run():
            status = getattr(lib, entry)(
                *(t.data_ptr() for t in pointers), bf_, n_, heads_, dh_,
                scale_, torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise AssertionError(f"{entry}: CUDA error {status}")
            return pointers[4]
        return run, SPACE_BACKWARD_CLASS_DESIGN, False
    check_f = {}
    for dh_ in (16, 8, 4, 2):
        assert dv.space_backward_narrow_plan(f, n, hd // dh_) == "resident"
        check_f[dh_] = next(c for c in range(1, f + 1) if
                            dv.space_backward_narrow_plan(c, n, hd // dh_)
                            == "resident")
    rows += [dict(backward_row("space", gen_nb, dtype,
                               source="divided_backward_classes",
                               heads=hd // dh_, dh=dh_,
                               replaced=space_backward_class,
                               check_f=check_f[dh_]),
                  design=SPACE_BACKWARD_RESIDENT_DESIGN)
             for dtype in (f32, torch.bfloat16) for dh_ in (16, 8, 4, 2)]

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

    def route_limits(row):
        # an entry point's own limits where it has them (the float32
        # pre-pass and K ring), else its wrapper's
        return FLOAT32_ROUTE_LIMITS.get(row.get("entry"),
                                        FLOAT32_ROUTE_LIMITS[row["name"]])

    for row in rows:
        row["bound_ms"], row["bound_by"] = bound_ms(row.pop("nbytes"),
                                                    row.pop("flops"))
        # a computed yardstick for the log only: the kernels line holds
        # what the run measured, and of computed values the bound alone
        floor_ms = row.pop("scores") / ex2_per_ms
        first = row["shape"][0] if isinstance(row["shape"][0], list) \
            else row["shape"]
        # (the replaced designs were timed at the configurations' heads)
        f32_key = ("float32",) if row["dtype"] == "float32" else ()
        both = tuple(tuple(x) for x in row["shape"]) \
            if isinstance(row["shape"][0], list) else None
        before = (None if row.get("heads", [heads, dh]) != [heads, dh]
                  else BEFORE_REDESIGN_MS.get((row["name"], both) + f32_key)
                  or BEFORE_REDESIGN_MS.get((row["name"], tuple(first))
                                            + f32_key))
        log(f"{row['name']} at {row['shape']} {row['dtype']}"
            + (f" ({row['heads'][0]} heads of {row['heads'][1]})"
               if "heads" in row else "")
            + (" (against the float32 plain version)"
               if row.get("oracle") == "float32 plain" else "")
            + (f" (errors and plain at {row['plain_shape']}"
               + (f", {row['entry_checked']}" if "entry_checked" in row
                  else "") + ")" if "plain_shape" in row else "")
            + f": max abs err "
            f"{row['max_abs_err']:.3e}, relative max {row['rel_max_err']:.3e}"
            f", rms {row['rel_rms_err']:.3e} and {QUANTILE} quantile "
            f"{row['rel_q_err']:.3e} (limits {BF16_LIMITS[row['name']]}, "
            f"{QUANTILE_LIMITS[row['name']]}), kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), softmax "
            f"floor {floor_ms:.4f} ms"
            + (f", {row['design']}" if "design" in row else "")
            + (f"; against its float32 route's function max / rms / "
               f"quantile {'/'.join(f'{e:.3e}' for e in row['route_rel_err'])}"
               f" (limits {route_limits(row)}"
               f"), bf16-rounded share {row['bf16_rounded_share']:.2e}"
               if "route_rel_err" in row else "")
            + ("; the other side of the wrapper's choice ({side}) forced: "
               "bit for bit, {ms:.4f} ms".format(**row["forced"])
               if "forced" in row else "")
            + (f"; two calls equal bit for bit, the plain forward "
               f"recomputed and its vjp (what ran before) "
               f"{row['recompute_ms']:.4f} ms" if "recompute_ms" in row
               else "")
            + (f", before the redesign {before:.4f} ms" if before else "")
            + ("; the design it replaced ({design}) in this call: {same}"
               "{ms:.4f} ms".format(same="bit for bit, " if row["replaced"].get(
                   "bit_for_bit", True) else "", **row.pop("replaced"))
               if "replaced" in row else ""))
    return rows


def masked_padding_check(torch, seed: int) -> dict:
    """Clips of 8 and 24 frames run on the 16- and 32-frame time tiles with
    the frames past F loaded as zeros; a zero key scores 0, not -inf, so
    the padded keys must be masked before the max. q and k are built about
    one direction of opposite signs (every real score negative, about -7
    on average): an unmasked padded key would take nearly all the weight,
    and a mask applied after the max would leave every weight at 0. The
    forward and the backward kernels at [1, F, 64, 256] (2 heads of 64),
    bf16 and float32, against their float32 route's functions on the same
    inputs (scores this large move by whole units when q is rounded to
    bf16, so the route, which rounds where the kernels do, is the oracle):
    float32 within FLOAT32_ROUTE_LIMITS, bf16 within BF16_LIMITS and
    QUANTILE_LIMITS."""
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (check_bf16,
                                                  check_float32_route)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    heads, dh, n = 2, 64, 64
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {}
    for f_ in (8, 24):
        sin, cos = (torch.from_numpy(t).to(dev)
                    for t in rotary.time_rotary_sincos(f_, dh))
        c = randn(1, 1, n, heads * dh)
        qkv = torch.cat([c + 0.5 * randn(1, f_, n, heads * dh),
                         -c + 0.5 * randn(1, f_, n, heads * dh),
                         randn(1, f_, n, heads * dh)], dim=-1)
        cot = randn(1, f_, n, heads * dh)
        for dtype in (torch.bfloat16, torch.float32):
            x, g = qkv.to(dtype), cot.to(dtype)
            route = dv.divided_attention_float32_route(
                x.float(), sin, cos, "time", heads, dh, dh**-0.5)
            droute = db.divided_attention_backward_float32_route(
                x.float(), route, g.float(), sin, cos, "time", heads, dh,
                dh**-0.5)
            got = dv.time_attention_cuda(x, sin, cos, heads, dh, dh**-0.5)
            dgot = dv.time_attention_backward_cuda(x, g, sin, cos, heads, dh,
                                                   dh**-0.5)
            check = (check_float32_route if dtype == torch.float32
                     else check_bf16)
            key = f"F = {f_}, {str(dtype).replace('torch.', '')}"
            out[key] = {
                "forward": check("divided_time_attention", got, route),
                "backward": check("divided_time_attention_backward", dgot,
                                  droute),
                "output_peak": route.abs().max().item()}
            if not out[key]["output_peak"] > 0.5:
                raise AssertionError(f"masked padding {key}: the output "
                                     f"collapsed")
    log(f"masked padding (time classes at 8 and 24 frames, scores about "
        f"-7, against the float32 route): {out}")
    return out


def fused_masked_edge_check(torch, seed: int) -> dict:
    """The fused kernel at head dim 256 (the wide tile's 64-key tiles) over
    a ragged query length (1000 rows: a last 64-row chunk of 40 read as
    zeros and not stored) and keys short of a tile: Nk = 120 (a whole tile
    and one of 56) and Nk = 40 (one short tile), zero-filled past Nk. q and
    k are built about one direction of opposite signs (every real score
    about -7, as in ``masked_padding_check``), so a padded key left
    unmasked (score 0, v 0) would take over 98 % of the weight and bring
    every output near 0. bf16 and float32 against the float32 route's
    function with the kernels' ex2 on the same inputs (``exp2=True``; it
    rounds where the kernel does): bf16 within BF16_LIMITS and
    QUANTILE_LIMITS, float32 within FLOAT32_ROUTE_LIMITS and with under 1 %
    of it equal to its bf16 rounding (scores held this close together put
    a p at a bf16 rounding boundary in more rows than random inputs do:
    against the route with exp the card test of the same check read 1.8e-4
    on the quantile at Nk = 40, 5 rows of 2000 off; against the route with
    ex2 no row differs, ``tools/mma_sum.py --wide``)."""
    from moditalker_tpu_torch.ops.kernels import (
        bf16_rounded_share, check_bf16, check_float32_route)
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    d, nq, out = 256, 1000, {}
    for nk in (120, 40):
        c = 0.66 * randn(1, 1, d)   # |c|² d^-0.5 about 7
        q = c + 0.5 * randn(2, nq, d)
        k = -c + 0.5 * randn(2, nk, d)
        v = randn(2, nk, d)
        for dtype in (torch.bfloat16, torch.float32):
            x = [t.to(dtype) for t in (q, k, v)]
            route = fa.attention_float32_route(*(t.float() for t in x),
                                               d**-0.5, exp2=True)
            with torch.no_grad():
                got = fa.fused_attention_cuda(*x, d**-0.5)
            key = f"Nk = {nk}, {str(dtype).replace('torch.', '')}"
            out[key] = {"errors": check_bf16("fused_attention", got, route),
                        "output_peak": route.abs().max().item()}
            if dtype == torch.float32:
                out[key]["route_errors"] = check_float32_route(
                    "fused_attention", got, route)
                share = out[key]["bf16_rounded_share"] = \
                    bf16_rounded_share(got)
                if share >= 0.01:
                    raise AssertionError(
                        f"fused masked edge {key}: {share:.4f} of the "
                        f"float32 result equals its bf16 rounding")
            if not out[key]["output_peak"] > 0.1:
                raise AssertionError(f"fused masked edge {key}: the output "
                                     f"collapsed")
    log(f"fused masked edge (head dim 256, 1000 query rows over 120 and 40 "
        f"keys, scores about -7, against the float32 route with ex2): {out}")
    return out


def gradient_phase(torch, seed: int) -> list[dict]:
    """Each differentiable kernel wrapper under a gradient, float32: its
    output must carry the ``autograd.Function``'s ``grad_fn`` and the kernel
    must have launched once; its input gradients must agree with autograd
    through the plain version. Packed and one-pass at the shapes
    train-diffusion's UNet gives them, space, time and tiny-L at B = 1 (the
    shape train-first-stage gives space and time). The space and time
    backwards are kernels (``DividedAttention``: each launched once per
    gradient), held to their rows' limits against autograd through the
    plain version (``BF16_LIMITS``, ``QUANTILE_LIMITS``) and against their
    float32 route's function (``FLOAT32_ROUTE_LIMITS``), and a second
    gradient of the same output must equal the first bit for bit. The
    packed backward is the plain version's vjp, so for it this checks the
    wiring only (within GRAD_LIMIT); the one-pass and tiny-L backward is
    ``sdpa_adjoints``, written out, an independent computation (within
    GRAD_LIMIT)."""
    from moditalker_tpu_torch.ops import rotary
    from moditalker_tpu_torch.ops.kernels import (LAUNCHES, check_bf16,
                                                  check_float32_route)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import divided_backward as db
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
        def route(x, out, g):
            return db.divided_attention_backward_float32_route(
                x, out, g, sin, cos, axis, heads, dh, dh**-0.5)
        return ([randn(1, f, n, 3 * heads * dh)],
                lambda x: dv.divided_attention(x, sin, cos, axis, heads, dh,
                                               dh**-0.5),
                lambda x: dv.divided_attention_reference(
                    x, sin, cos, axis, heads, dh, dh**-0.5, use_flash=False),
                route)

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
        "tiny_attention": (
            [randn(heads * n, f, dh) for _ in range(3)],
            lambda *x: fa.tiny_attention(*x, dh**-0.5),
            lambda *x: fa.tiny_attention_reference(*x, dh**-0.5)),
    }
    rows = []
    for name, (inputs, kern, plain, *route) in cases.items():
        grads, peaks, cot, fn_name = {}, {}, None, None
        backward = f"{name}_backward" if route else None
        for which, fn in (("kernel", kern), ("plain", plain)):
            xs = [x.detach().requires_grad_() for x in inputs]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = LAUNCHES[name]
            out = fn(*xs)
            if which == "kernel":
                fn_name = type(out.grad_fn).__name__
                want_fn = ("DividedAttentionBackward" if route else
                           ("RecomputeThroughPlainBackward",
                            "FlashSdpaBackward"))
                if (LAUNCHES[name] != before + 1
                        or fn_name not in want_fn):
                    raise AssertionError(
                        f"{name}: launches {LAUNCHES[name] - before}, "
                        f"grad_fn {fn_name}")
            if cot is None:
                cot = torch.randn(out.shape, generator=gen, device=dev)
            if which == "kernel" and route:
                launched = LAUNCHES[backward]
                grads["again"] = torch.autograd.grad(out, xs, cot,
                                                     retain_graph=True)
                saved = out.detach()
            grads[which] = torch.autograd.grad(out, xs, cot)
            torch.cuda.synchronize()
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
        row = {"name": name, "shape": [list(x.shape) for x in inputs],
               "grad_fn": fn_name, "peak_gib": peaks}
        if route:
            if LAUNCHES[backward] != launched + 2:
                raise AssertionError(f"{backward}: launched "
                                     f"{LAUNCHES[backward] - launched} "
                                     f"times for two gradients")
            (got,), (want,) = grads["kernel"], grads["plain"]
            if not torch.equal(got, grads["again"][0]):
                raise AssertionError(f"{backward}: two gradients of the "
                                     f"same output differ")
            row["rel_err"] = check_bf16(backward, got, want)
            row["route_rel_err"] = check_float32_route(
                backward, got, route[0](inputs[0], saved, cot))
            log(f"gradient {name} at {row['shape']} float32: grad_fn "
                f"{fn_name}, the backward kernel launched once a gradient; "
                f"input gradient vs autograd through the plain version "
                f"max / rms / quantile "
                f"{'/'.join(f'{e:.3e}' for e in row['rel_err'])}, vs its "
                f"float32 route's function "
                f"{'/'.join(f'{e:.3e}' for e in row['route_rel_err'])}; two "
                f"gradients equal bit for bit; peak memory "
                f"{peaks['kernel']:.2f} GiB through the kernels, "
                f"{peaks['plain']:.2f} through the plain version")
        else:
            err = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(grads["kernel"], grads["plain"]))
            log(f"gradient {name} at {row['shape']} float32: "
                f"grad_fn {fn_name}, input gradient vs autograd through the "
                f"plain version {err:.3e} (limit {GRAD_LIMIT}); peak memory "
                f"{peaks['kernel']:.2f} GiB through the kernel, "
                f"{peaks['plain']:.2f} through the plain version")
            if not err <= GRAD_LIMIT:
                raise AssertionError(f"{name}: the gradient through the "
                                     f"kernel disagrees with the plain "
                                     f"version's")
            row["rel_max_err"] = err
        rows.append(row)
    return rows


# ------------------------------------------------------------------ training
class LossLog:
    """The logger a trainer's ``fit`` is given: keeps each row of scalars
    it logs, or the row's ``key`` entry."""

    def __init__(self, key: str | None = None):
        self.key, self.seen = key, []

    def log_scalars(self, step, scalars):
        self.seen.append(scalars[self.key] if self.key else scalars)


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

    class Divided:
        @staticmethod
        def apply(x, forward, backward):
            return forward(x.detach())

    class Flash:
        @staticmethod
        def apply(q, k, v, scale, forward):
            return forward(q.detach(), k.detach(), v.detach(), scale)

    kept = pk.RecomputeThroughPlain, dv.DividedAttention, fa.FlashSdpa
    pk.RecomputeThroughPlain, dv.DividedAttention = Recompute, Divided
    fa.FlashSdpa = Flash
    try:
        yield
    finally:
        pk.RecomputeThroughPlain, dv.DividedAttention, fa.FlashSdpa = kept


def seeded_state(torch, build, seed: int) -> dict:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build().state_dict()


def train_step_once(device: str, seed: int, modular: bool = False,
                    model_channels: int = 128, cut: bool = False) -> dict:
    """The step ``train_step_check`` compares, on ``device``: AE and UNet
    weights, batch and draws from ``seed``, the gate switches set around it
    where ``modular``, the gradient cut at the attentions where ``cut``; the
    loss, the launches by shape and the UNet's gradient and update on the
    CPU."""
    import torch

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
    # channel_mult (1, 2): the last upsample lands 2·model_channels at
    # ds = 1, so the joint attention there takes the one-pass kernel, as in
    # the full UNet
    unet_cfg = MtovUNetConfig(model_channels=model_channels,
                              num_res_blocks=1, channel_mult=(1, 2),
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
    trainer = MtovDiffusionTrainer(unet_cfg, diff_cfg, tc, device=device,
                                   state_dict=unet)
    models = []
    for state in aes:
        m = ViTAutoencoder(ae_cfg)
        m.load_state_dict(state)
        models.append(m)
    loop = LatentDiffusionLoop(trainer, *models)
    reset_launch_counts()
    with (gradient_cut() if cut else contextlib.nullcontext(),
          modular_attention() if modular else contextlib.nullcontext()):
        m = loop.train_step(batch, draws=(t.to(device), noise.to(device)))
    out = {"loss": m["loss"].item(), "launches": launches_by_shape()}
    for name, p in trainer.model.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        out.setdefault("grad", {})[name] = grad.detach().cpu()
        out.setdefault("update", {})[name] = p.detach().cpu() - unet[name]
    return out


def train_step_check(torch, seed: int, modular: bool = False,
                     model_channels: int = 128) -> dict:
    """One train-diffusion step at a small depth but the full spatial size
    (so that every kernel gate passes; B = 2) on the card and on the CPU
    from the same AE and UNet weights, batch and draws, float32
    (``train_step_once``; the CPU's from the worker where main() handed it
    over): the loss, the UNet's gradient and its update within
    TRAIN_LIMITS, and the same step with the gradient cut at the attentions
    (``gradient_cut``) outside them. ``modular``: with both gate switches
    set around the steps (the AEs' 2 heads × B = 2 × 1024 patches pass the
    tiny-L gate). ``model_channels`` 256: base_longvid.yaml's UNet at the
    same small depth (head dims 32 and 64, no packed launch)."""
    def rel(a, b):
        num = sum(float((a[k] - b[k]).square().sum()) for k in b)
        den = sum(float(b[k].square().sum()) for k in b)
        return (num / den) ** 0.5

    kwargs = dict(seed=seed, modular=modular, model_channels=model_channels)
    cpu = cpu_reference(train_step_once, device="cpu", **kwargs)
    result = {}
    path = "modular" if modular else "fused"
    if model_channels != 128:
        path += f", {model_channels} channels"
    for label, cut in ((f"card, {path} path", False),
                       (f"card, {path} path, gradient cut", True)):
        card = train_step_once("cuda", cut=cut, **kwargs)
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
        if not cut and set(card["launches"]) != (
                MODULAR_PATH if modular else
                LONGVID_PATH if model_channels == 256 else FUSED_PATH):
            raise AssertionError(f"train-diffusion step ({path} path): "
                                 f"launches {card['launches']}")
        result[label] = errs
    return result


def train_diffusion_phase(torch, seed: int, modular: bool = False) -> dict:
    """``LatentDiffusionLoop.fit`` at the full width (config.py: AE 384 wide,
    depth 8, 256² × 16 frames; UNet 128 channels) at B =
    diffusion_batch_size, float32, on a synthetic batch with AE and UNet
    weights from ``seed``: one untimed step, then 5 timed (steps/s, video
    clips/s, the peak memory, the launches by kernel and shape: the divided
    space and time, packed and one-pass kernels and no other), every loss
    finite, one step traced; then ``train_step_check``.

    ``modular``: the same with both gate switches set for the phase and put
    back after it, 3 timed steps: the tiny-L and one-pass kernels and no
    other, every launch on float32 operands, tiny-L and one-pass at head
    dims 16, 32 and 64 among them, the AE's space attention at head dim 64
    through the float32 resident-K kernel (its entry point given the V
    scratch) at every launch. Both report the launches by entry point
    (``LAUNCHES_BY_ENTRY``)."""
    with modular_attention() if modular else contextlib.nullcontext():
        return _train_diffusion(torch, seed, modular)


def _train_diffusion(torch, seed: int, modular: bool) -> dict:
    import itertools

    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovTrainConfig, MtovUNetConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import ViTAutoencoder
    from moditalker_tpu_torch.ops.kernels import (FLOAT32_LAUNCHES_BY_SHAPE,
                                                  LAUNCHES_BY_ENTRY,
                                                  reset_launch_counts)
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    ae_cfg, unet_cfg = MtovAEConfig(), MtovUNetConfig()
    tc = MtovTrainConfig(seed=seed)
    b, steps = tc.diffusion_batch_size, 3 if modular else 5
    path, expected = (("modular", MODULAR_PATH) if modular
                      else ("fused", FUSED_PATH))
    what = f"train-diffusion ({path} path)"
    models = []
    for i in (11, 12):
        m = ViTAutoencoder(ae_cfg)
        m.load_state_dict(seeded_state(torch, lambda: ViTAutoencoder(ae_cfg),
                                       seed + i))
        models.append(m)
    trainer = MtovDiffusionTrainer(unet_cfg, MtovDiffusionConfig(), tc)
    loop = LatentDiffusionLoop(trainer, *models)
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)

    losses = LossLog("loss")
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
    counts = check_launches(what, expected)
    by_shape = launches_by_shape()
    by_entry = dict(sorted(LAUNCHES_BY_ENTRY.items()))
    check_float32_launches(what, by_shape)
    if modular:
        f32_by_shape = FLOAT32_LAUNCHES_BY_SHAPE["onepass_attention"]
        dims = {sh[-1] for sh in f32_by_shape}
        if not ({16, 32, 64} <= dims
                and FLOAT32_LAUNCHES_BY_SHAPE["tiny_attention"]):
            raise AssertionError(f"{what}: float32 launches of tiny-L and of "
                                 f"one-pass at head dims 16, 32 and 64 "
                                 f"expected, got {dict(f32_by_shape)}")
        space = sum(c for sh, c in f32_by_shape.items() if sh[-1] == 64)
        if by_entry.get("fused_attention_f32 + V scratch") != space:
            raise AssertionError(f"{what}: {space} launches of the AE's space "
                                 f"attention at head dim 64, by entry point "
                                 f"{by_entry}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (len(losses.seen) == steps + 1
            and all(np.isfinite(losses.seen))):
        raise AssertionError(f"{what}: losses {losses.seen}")
    per_step = {k: v / steps for k, v in counts.items() if v}
    log(f"{what} (full width, B = {b}, float32): {steps} steps in "
        f"{dt:.3f} s = {steps / dt:.4f} steps/s = {steps * b / dt:.3f} clips/s"
        f"; peak memory {peak:.2f} GiB; losses {losses.seen}; launches per "
        f"step {per_step}, by shape over the {steps} steps (all on float32 "
        f"operands) {by_shape}, by entry point {by_entry}")
    dev = loop.to_device(batch)
    traced = trace(torch, lambda: loop.train_step(dev))
    log_trace(f"{what} step (batch on the card)", traced)
    del loop, trainer, models, dev
    torch.cuda.empty_cache()
    check = train_step_check(torch, seed, modular)
    return {"launches": counts, "launches_by_shape": by_shape,
            "launches_by_entry": by_entry,
            "steps_per_s": steps / dt, "clips_per_s": steps * b / dt,
            "peak_gib": peak, "losses": losses.seen, "card_vs_cpu": check,
            "trace": traced}


def train_diffusion_longvid_phase(torch, seed: int) -> dict:
    """``LatentDiffusionLoop.fit`` with base_longvid.yaml's UNet (256
    channels) at full width (the shipped AEs), B = diffusion_batch_size,
    float32, on a synthetic batch with AE and UNet weights from ``seed``:
    one untimed step, then 3 timed steps with ``remat`` off and 3 with it
    on (``model.set_remat``, as the CPU tests set it; steps/s, clips/s and
    the peak memory of each; launches by shape, every one on float32
    operands, exactly as predicted: a step's four frozen extracts launch
    space and time 32 times each, its UNet the one-pass kernel at
    LONGVID_ONEPASS_PER_CALL, and with ``remat`` the recompute launches
    each of those again; by entry point, the joint attention after the last
    upsample, [B·8, 2048, 64], through the pre-pass and the bf16 K ring,
    the others through the float32 entry point), every loss finite; one
    step traced; then ``remat_check`` and a small-depth 256-channel step
    against the CPU (``train_step_check``)."""
    import dataclasses
    import itertools

    from moditalker_tpu_torch.config import load_config
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import ViTAutoencoder
    from moditalker_tpu_torch.ops.kernels import (FLOAT32_LAUNCHES_BY_SHAPE,
                                                  LAUNCHES_BY_ENTRY,
                                                  reset_launch_counts)
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    cfg = load_config(LONGVID_YAML)
    ae_cfg, unet_cfg = cfg.mtov_ae, longvid_unet_config()
    tc = dataclasses.replace(cfg.mtov_train, seed=seed)
    b, steps = tc.diffusion_batch_size, 3
    models = []
    for i in (11, 12):
        m = ViTAutoencoder(ae_cfg)
        m.load_state_dict(seeded_state(torch, lambda: ViTAutoencoder(ae_cfg),
                                       seed + i))
        models.append(m)
    trainer = MtovDiffusionTrainer(unet_cfg, cfg.mtov_diffusion, tc)
    loop = LatentDiffusionLoop(trainer, *models)
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)
    n_params = sum(p.numel() for p in trainer.model.parameters())

    losses = LossLog("loss")
    loop.fit(itertools.repeat(batch), max_steps=1, logger=losses,
             log_every=1)
    # the divided kernels' qkv: [B·F, N, 3·H·dh] for space, [B, F, N, 3·H·dh]
    # for time
    n, hd3 = ((ae_cfg.resolution // ae_cfg.patch_size) ** 2,
              3 * ae_cfg.heads * ae_cfg.dim_head)
    space_qkv = str([b * ae_cfg.timesteps, n, hd3])
    time_qkv = str([b, ae_cfg.timesteps, n, hd3])
    runs = {}
    for remat in (False, True):
        what = f"longvid train-diffusion, remat {'on' if remat else 'off'}"
        trainer.model.set_remat(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loop.fit(itertools.repeat(batch), max_steps=steps, logger=losses,
                 log_every=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = check_launches(what, LONGVID_PATH)
        by_shape = launches_by_shape()
        f32_by_shape = {n: {str(list(sh)): k for sh, k in sorted(by.items())}
                        for n, by in FLOAT32_LAUNCHES_BY_SHAPE.items() if by}
        extracts = 4 * ae_cfg.depth * steps
        predicted = {"divided_space_attention": {space_qkv: extracts},
                     "divided_time_attention": {time_qkv: extracts},
                     "onepass_attention": longvid_onepass(
                         b, steps * (2 if remat else 1))}
        if not by_shape == f32_by_shape == predicted:
            raise AssertionError(f"{what}: launches {by_shape}, on float32 "
                                 f"operands {f32_by_shape}, predicted "
                                 f"{predicted}")
        calls = steps * (2 if remat else 1)
        assert fa.onepass_f32_prerounded(b * 8, 2048, 2048)
        by_entry = {e: c for e, c in sorted(LAUNCHES_BY_ENTRY.items())
                    if e.startswith("fused_attention")}
        per_call = LONGVID_ONEPASS_PER_CALL
        predicted = {"fused_attention_f32": calls * sum(
                         k for (_, d), k in per_call.items() if d != 64),
                     fa.PREROUNDED_ENTRY: calls * per_call[(2048, 64)]}
        if by_entry != predicted:
            raise AssertionError(f"{what}: one-pass launches by entry point "
                                 f"{by_entry}, predicted {predicted}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[what] = {"steps_per_s": steps / dt, "clips_per_s": steps * b / dt,
                      "peak_gib": peak, "launches": counts,
                      "launches_by_shape": by_shape,
                      "launches_by_entry": by_entry}
        log(f"{what} (full width, {n_params / 1e6:.2f} M parameters, B = "
            f"{b}, float32): {steps} steps in {dt:.3f} s = {steps / dt:.4f} "
            f"steps/s = {steps * b / dt:.3f} clips/s; peak memory "
            f"{peak:.2f} GiB; launches by shape over the {steps} steps, all "
            f"on float32 operands, as predicted {by_shape}; the one-pass "
            f"kernel's by entry point, as predicted {by_entry}"
            + ("; with remat each UNet launch is counted twice, once in the "
               "forward and once in the recompute" if remat else ""))
    if not (len(losses.seen) == 2 * steps + 1
            and all(np.isfinite(losses.seen))):
        raise AssertionError(f"longvid train-diffusion: losses {losses.seen}")
    trainer.model.set_remat(False)
    dev = loop.to_device(batch)
    traced = trace(torch, lambda: loop.train_step(dev))
    log_trace("longvid train-diffusion step, remat off (batch on the card)",
              traced)
    remat = remat_check(torch, loop, dev, seed)
    del loop, trainer, models, dev
    torch.cuda.empty_cache()
    check = train_step_check(torch, seed, model_channels=256)
    return {"parameters": n_params, "runs": runs, "losses": losses.seen,
            "trace": traced, "remat_vs_no_remat": remat,
            "card_vs_cpu": check}


def remat_check(torch, loop, dev_batch: dict, seed: int) -> dict:
    """One train-diffusion step's loss and UNet gradient with ``remat`` on
    against the same step with it off: the same weights, latents and draws
    (t, noise), cuDNN deterministic; the loss and each parameter's gradient
    within REMAT_LIMIT (relative; a zero gradient must stay zero), and
    whether they are equal bit for bit. The optimizer's update is a
    function of these, so neither step is applied."""
    from moditalker_tpu_torch.train.mtov import extract_latents

    trainer = loop.trainer
    lat = extract_latents(loop.ae_rgb, loop.ae_ldmk, dev_batch)
    draws = [d.to(trainer.device) for d in trainer.ddpm.draw_loss_inputs(
        torch.Generator().manual_seed(seed), lat["z"])]
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for remat in (False, True):
            trainer.model.set_remat(remat)
            trainer.model.zero_grad(set_to_none=True)
            loss, _ = trainer.ddpm.p_losses(lat["z"], lat["cond"],
                                            lat["image_cond"], *draws)
            loss.backward()
            out[remat] = (loss.detach(), {
                n: p.grad for n, p in trainer.model.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = old
        trainer.model.set_remat(False)
        trainer.model.zero_grad(set_to_none=True)
    (l0, g0), (l1, g1) = out[False], out[True]
    errs = {"loss": abs(l1 - l0).item() / abs(l0).item()}
    grad_err, equal = 0.0, int(torch.equal(l0, l1))
    for name, a in g0.items():
        diff, den = (g1[name] - a).norm().item(), a.norm().item()
        if den == 0 and diff != 0:
            raise AssertionError(f"remat: {name}'s gradient is zero without "
                                 f"remat and not with it")
        grad_err = max(grad_err, diff / den if den else 0.0)
        equal += torch.equal(a, g1[name])
    errs["grad"] = grad_err
    bitwise = equal == len(g0) + 1
    log(f"longvid train-diffusion step with remat vs without (same weights, "
        f"latents and draws; cuDNN deterministic): loss {l1.item():.8f} vs "
        f"{l0.item():.8f}, relative errors {errs} (limit {REMAT_LIMIT}); "
        f"{equal} of {len(g0) + 1} tensors (the loss and {len(g0)} "
        f"gradients) equal bit for bit")
    if max(errs.values()) > REMAT_LIMIT:
        raise AssertionError("remat: the step with remat disagrees with the "
                             "step without it")
    return {**errs, "bitwise_equal": bitwise, "equal_tensors": equal,
            "tensors": len(g0) + 1}


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
def backward_events(torch, fn):
    """Every backward of the ``autograd.Function`` ``fn`` in the block
    between two CUDA events: yields the list of (start, end) pairs."""
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


def first_stage_cycles(device: str, seed: int, loss_cfg=None,
                       freeze_decoder: bool = False,
                       frames: int | None = None, heads: int = 2,
                       dim_head: int = 64, cut: bool = False) -> dict:
    """The cycles ``first_stage_check`` compares, on ``device``: a fresh
    ``FirstStageTrainer`` at the small depth from ``seed``, two cycles (one
    with the gradient cut at the attentions, ``cut``) on the same clips and
    frame draws; every loss, the launches by shape, and the compared
    parameters' gradients and updates on the CPU."""
    import torch

    from moditalker_tpu_torch.config import MtovAEConfig, MtovTrainConfig
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=heads,
                          dim_head=dim_head, quant_depth=1, quant_heads=2,
                          quant_mlp_dim=64,
                          **({"timesteps": frames} if frames else {}))
    loss_cfg = first_stage_loss(loss_cfg)
    tc = MtovTrainConfig(seed=seed)
    k = tc.accum_iter
    key = "x_l" if freeze_decoder else "x"
    videos = [synthetic_mtov_batch(1, ae_cfg.timesteps, ae_cfg.resolution,
                                   seed + i)[key] for i in range(k)]
    g = torch.Generator().manual_seed(seed)
    draws = [torch.randint(0, ae_cfg.timesteps, (1,), generator=g)
             for _ in range(2 * k)]

    def params(tr, what):
        nets = {"ae": [tr.ae], "disc": [tr.disc2d, tr.disc3d]}[what]
        return {f"{i}.{n}": p for i, m in enumerate(nets)
                for n, p in m.named_parameters() if p.requires_grad}

    tr = FirstStageTrainer(ae_cfg, loss_cfg, tc, device=device,
                           freeze_decoder=freeze_decoder)
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
    for w in ("ae",) if cut else first_stage_compared(loss_cfg):
        now = params(tr, w)
        out[f"{w}_grad"] = {n: p.grad.cpu() for n, p in now.items()}
        out[f"{w}_update"] = {n: p.detach().cpu() - before[w][n]
                              for n, p in now.items()}
    return out


def first_stage_loss(loss_cfg=None):
    """``first_stage_check``'s loss configuration: disc_start −1 (base_gan
    .yaml: a G and a D cycle) unless given."""
    from moditalker_tpu_torch.config import MtovLossConfig

    return loss_cfg or MtovLossConfig(disc_start=-1)


def first_stage_compared(loss_cfg) -> tuple:
    """The nets whose gradients and updates are compared: the
    discriminators too where the phase flips after the first cycle."""
    return ("ae", "disc") if loss_cfg.disc_start <= 0 else ("ae",)


def first_stage_check(torch, seed: int, loss_cfg=None,
                      freeze_decoder: bool = False,
                      frames: int | None = None, heads: int = 2,
                      dim_head: int = 64) -> dict:
    """Two cycles of ``FirstStageTrainer`` at a small depth but the full
    spatial size (AE 64 wide, depth 1, 2 heads of 64, so that the space and
    time gates pass; the published discriminators and full LPIPS-VGG16;
    B = 1, accumulation 3) on the card and on the CPU from the same
    weights, clips and frame draws, float32 (``first_stage_cycles``; the
    CPU's from the worker where main() handed them over): every loss term,
    the mean gradients and the updates within FIRST_STAGE_LIMITS; the first
    G cycle with the gradient cut at the attentions (``gradient_cut``)
    outside them. The card launches the space and time kernels and no
    other. ``loss_cfg`` defaults to disc_start −1 (base_gan.yaml: a G and a
    D cycle); at a later disc_start both cycles are G cycles and the
    discriminators are not compared. ``freeze_decoder``: the landmark AE
    (its trainable parameters compared, on landmark clips). ``frames``:
    clips of another length than the configuration's 16. ``heads`` of
    ``dim_head``: the AE's attention split another way."""
    loss_cfg = first_stage_loss(loss_cfg)
    compared = first_stage_compared(loss_cfg)
    kwargs = dict(seed=seed, loss_cfg=loss_cfg,
                  freeze_decoder=freeze_decoder, frames=frames, heads=heads,
                  dim_head=dim_head)

    def rel(a, b):
        num = sum(float((a[n] - b[n]).square().sum()) for n in b)
        den = sum(float(b[n].square().sum()) for n in b)
        return (num / den) ** 0.5

    cpu = cpu_reference(first_stage_cycles, device="cpu", **kwargs)
    result = {}
    for label, cut in (("card", False), ("card, gradient cut", True)):
        card = first_stage_cycles("cuda", cut=cut, **kwargs)
        # a term the discriminators' factor holds at 0 reads 0 on both
        errs = {"loss": max(abs(a[n] - b[n]) / abs(b[n]) if b[n] else
                            abs(a[n])
                            for a, b in zip(card["losses"], cpu["losses"])
                            for n in b)}
        for w in ("ae",) if cut else compared:
            for q in ("grad", "update"):
                errs[f"{w}_{q}"] = rel(card[f"{w}_{q}"], cpu[f"{w}_{q}"])
        within = all(errs[n] <= FIRST_STAGE_LIMITS[n] for n in errs)
        cycle = ("G cycle" if cut else "G and D cycle"
                 if "disc" in compared else "two G cycles")
        log(f"train-first-stage {cycle} at small depth ({label}; disc_start "
            f"{loss_cfg.disc_start}, freeze_decoder {freeze_decoder}) vs cpu,"
            f" float32: relative errors {errs} (limits {FIRST_STAGE_LIMITS})"
            f"; launches {card['launches']}")
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
    shape: the divided space and time kernels and their backward kernels,
    one of each per attention of a micro-step, the backwards in G
    micro-steps only, and no other), every loss finite, no
    ``RecomputeThroughPlain`` backward run; each micro-step of one more G
    and D cycle timed apart; one G step traced, with the device time of the
    space and time backwards in it (``backward_events`` around
    ``DividedAttention``); then ``first_stage_check``."""
    import itertools

    from moditalker_tpu_torch.config import (MtovAEConfig, MtovLossConfig,
                                             MtovTrainConfig)
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.ops.kernels.autograd import (
        DividedAttention, RecomputeThroughPlain)
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    ae_cfg, tc = MtovAEConfig(), MtovTrainConfig(seed=seed)
    trainer = FirstStageTrainer(ae_cfg, MtovLossConfig(disc_start=-1), tc)
    b, k, cycles = tc.batch_size, tc.accum_iter, 2
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)

    losses = LossLog()
    trainer.fit(itertools.repeat(batch), max_steps=2 * k, logger=losses,
                log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    iters = 2 * k * cycles
    t0 = time.perf_counter()
    with backward_events(torch, RecomputeThroughPlain) as recomputed:
        trainer.fit(itertools.repeat(batch), max_steps=2 * k + iters,
                    logger=losses, log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = check_launches("train-first-stage", FIRST_STAGE_PATH)
    check_float32_launches("train-first-stage", launches_by_shape())
    per_step = 2 * ae_cfg.depth    # the encoder's blocks and the decoder's
    want = {n: per_step * (iters // 2 if n in FIRST_STAGE_BACKWARDS
                           else iters) for n in FIRST_STAGE_PATH}
    if {n: c for n, c in counts.items() if c} != want or recomputed:
        raise AssertionError(f"train-first-stage: launches {counts} "
                             f"(want {want}), {len(recomputed)} "
                             f"RecomputeThroughPlain backwards")
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
    with backward_events(torch, DividedAttention) as events, \
            backward_events(torch, RecomputeThroughPlain) as recomputed:
        traced = trace(torch, lambda: trainer.step(video))
    if len(events) != 2 * per_step or recomputed:   # space and time
        raise AssertionError(f"train-first-stage G step: {len(events)} "
                             f"divided backwards, {len(recomputed)} "
                             f"RecomputeThroughPlain backwards")
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
        f"(the backward kernels; no RecomputeThroughPlain backward) take "
        f"{backward_ms:.2f} ms of its {traced['device_busy_ms']:.2f} ms "
        f"device time ({share:.3f})")
    del trainer, video
    torch.cuda.empty_cache()
    check = first_stage_check(torch, seed)
    return {"launches": counts, "launches_by_shape": by_shape,
            "iterations_per_s": iters / dt, "clips_per_s": iters * b / dt,
            "g_step_ms": g_ms, "d_step_ms": d_ms, "peak_gib": peak,
            "backward_ms": backward_ms,
            "backward_share": share, "card_vs_cpu": check,
            "trace": traced}


def first_stage_variant_phase(torch, seed: int, config: str,
                              landmark: bool = False) -> dict:
    """``FirstStageTrainer.fit`` at the operating point of ``config``
    (configs/autoencoder/base.yaml, or base_ldmk.yaml with ``landmark``:
    the landmark AE on landmark clips, decoder and ``to_pixel`` frozen, as
    ``train-first-stage --landmark`` builds it), both with the
    discriminators off (disc_start 1e8: every micro-step is a G step), at
    full width, B = 1, accumulation 3, float32, weights from ``seed``: one
    cycle untimed, two timed (iterations/s, clips/s, peak memory, launches
    by shape: the divided space and time kernels and their backward
    kernels, 2·depth of each a micro-step, and no other; no
    ``RecomputeThroughPlain`` backward), every loss finite, the
    discriminators and
    (``landmark``) the frozen parameters unmoved and every other AE
    parameter moved; one micro-step traced; then ``first_stage_check`` at
    the same loss configuration and ``freeze_decoder``."""
    import dataclasses
    import itertools

    from moditalker_tpu_torch.config import load_config
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.ops.kernels.autograd import \
        RecomputeThroughPlain
    from moditalker_tpu_torch.train.mtov_first_stage import (
        FROZEN_WITH_DECODER, FirstStageTrainer)

    cfg = load_config(config)
    ae_cfg, loss_cfg = cfg.mtov_ae, cfg.mtov_loss
    tc = dataclasses.replace(cfg.mtov_train, seed=seed)
    what = (f"train-first-stage {'--landmark ' if landmark else ''}"
            f"{os.path.basename(config)}")
    trainer = FirstStageTrainer(ae_cfg, loss_cfg, tc, freeze_decoder=landmark)
    b, k, cycles = tc.batch_size, tc.accum_iter, 2
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)

    losses = LossLog()
    trainer.fit(itertools.repeat(batch), max_steps=k, logger=losses,
                log_every=1, eval_every=10**9)
    nets = {"ae": trainer.ae, "disc2d": trainer.disc2d,
            "disc3d": trainer.disc3d}
    before = {f"{m}.{n}": p.detach().clone() for m, net in nets.items()
              for n, p in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    iters = k * cycles
    t0 = time.perf_counter()
    with backward_events(torch, RecomputeThroughPlain) as recomputed:
        trainer.fit(itertools.repeat(batch), max_steps=k + iters,
                    logger=losses, log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if recomputed:
        raise AssertionError(f"{what}: {len(recomputed)} "
                             f"RecomputeThroughPlain backwards")
    counts = check_launches(what, FIRST_STAGE_PATH)
    by_shape = launches_by_shape()
    check_float32_launches(what, by_shape)
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = [v for row in losses.seen for v in row.values()]
    if (len(losses.seen) != k + iters or not np.isfinite(values).all()
            or any("d_loss" in row for row in losses.seen)):
        raise AssertionError(f"{what}: losses {losses.seen}")
    per_step = 2 * ae_cfg.depth        # the encoder's blocks and the decoder's
    if {n: c for n, c in counts.items() if c} != {
            n: per_step * iters for n in FIRST_STAGE_PATH}:
        raise AssertionError(f"{what}: launches {counts}")
    moved = {f"{m}.{n}": not torch.equal(p, before[f"{m}.{n}"])
             for m, net in nets.items() for n, p in net.named_parameters()}
    frozen = {key for key in moved if key.startswith("ae.") and landmark
              and set(key.split(".")) & set(FROZEN_WITH_DECODER)}
    trained = {key for key in moved
               if key.startswith("ae.") and key not in frozen}
    still = frozen | {key for key in moved if key.startswith("disc")}
    wrong = sorted([key for key in still if moved[key]]
                   + [key for key in trained if not moved[key]])
    if wrong:
        raise AssertionError(f"{what}: parameters moved that must stay or "
                             f"stayed that must move: {wrong[:5]} of "
                             f"{len(wrong)}")
    video = trainer.to_device(batch["x_l" if landmark else "x"])
    traced = trace(torch, lambda: trainer.step(video))
    step_ms = dt / iters * 1e3
    log(f"{what} (full width, B = {b}, accumulation {k}, float32, "
        f"disc_start {loss_cfg.disc_start}): {iters} iterations ({cycles} G "
        f"cycles) in {dt:.3f} s = {iters / dt:.4f} iterations/s = "
        f"{iters * b / dt:.4f} clips/s, {step_ms:.2f} ms a micro-step; peak "
        f"memory {peak:.2f} GiB; launches by shape over the {iters} "
        f"iterations {by_shape}; the discriminators unmoved"
        + (f", {len(frozen)} frozen decoder and to_pixel tensors unmoved"
           if landmark else "")
        + f", {len(trained)} trained AE tensors moved; last losses "
        f"{losses.seen[-1]}")
    log_trace(f"{what} G micro-step (clip on the card)", traced)
    del trainer, video
    torch.cuda.empty_cache()
    check = first_stage_check(torch, seed, loss_cfg, freeze_decoder=landmark)
    return {"iterations_per_s": iters / dt, "clips_per_s": iters * b / dt,
            "micro_step_ms": step_ms, "peak_gib": peak, "launches": counts,
            "launches_by_shape": by_shape, "frozen_unmoved": len(frozen),
            "trained_moved": len(trained), "card_vs_cpu": check,
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


def reference_configs(heads: int = 2, model_channels: int = 128,
                      frames: int = 16, unet_heads: int = 8,
                      dim_head: int = 64):
    """The small-depth AE, UNet and DDIM-2 configurations of a reference
    window (``reference_phase``)."""
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovUNetConfig)

    ae_cfg = MtovAEConfig(channels=64, depth=1, heads=heads,
                          dim_head=dim_head, quant_depth=1, quant_heads=2,
                          quant_mlp_dim=64, timesteps=frames)
    # channel_mult (1, 2): the last upsample lands 2·model_channels at
    # ds = 1, so the joint attention there takes the one-pass kernel, as in
    # the full UNet (at 256 channels every gated attention does)
    unet_cfg = MtovUNetConfig(model_channels=model_channels,
                              num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,), latent_t=frames,
                              num_heads=unet_heads)
    return ae_cfg, unet_cfg, MtovDiffusionConfig(sampling_timesteps=2)


def reference_window(device: str, dtype: str, seed: int, heads: int = 2,
                     batch: int = 1, model_channels: int = 128,
                     frames: int = 16, unet_heads: int = 8,
                     dim_head: int = 64):
    """One small-depth window (``reference_configs``) on ``device`` in
    ``dtype`` ("bfloat16" or "float32"), weights, window and draws from
    ``seed``: the decoded video, float32 on the CPU."""
    import torch

    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg, unet_cfg, diff_cfg = reference_configs(
        heads, model_channels, frames, unet_heads, dim_head)
    states = random_states(torch, ae_cfg, unet_cfg, seed)
    w = make_windows(ae_cfg, 1, batch, seed)[0]
    pipe = MtovSamplePipeline(*states, ae_cfg, unet_cfg, diff_cfg,
                              dtype=getattr(torch, dtype), device=device)
    g = torch.Generator().manual_seed(seed)
    draws = lambda shape, dt, g=g: torch.randn(shape, generator=g)
    out = pipe.window_step(w["x_l"], w["masked_x"], w["x_ref"], draws)
    return out.float().cpu()


def reference_windows_cpu(seed: int, switches: tuple = (), heads: int = 2,
                          batch: int = 1, model_channels: int = 128,
                          frames: int = 16, unet_heads: int = 8,
                          dim_head: int = 64) -> dict:
    """The CPU half of ``reference_phase``: the window on the plain path in
    float32 and in bf16, with the gate switches ``switches`` set (the
    modular path's), each with its seconds."""
    window = dict(heads=heads, batch=batch, model_channels=model_channels,
                  frames=frames, unet_heads=unet_heads, dim_head=dim_head)
    outs, seconds = {}, {}
    old = {name: os.environ.get(name) for name in SWITCHES}
    for name in SWITCHES:
        os.environ.pop(name, None)
    os.environ.update({name: "1" for name in switches})
    try:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            outs[dtype] = reference_window("cpu", dtype, seed, **window)
            seconds[dtype] = time.perf_counter() - t0
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    return {"outs": outs, "seconds": seconds}


def reference_phase(torch, seed: int, what: str, expected: set,
                    heads: int = 2, batch: int = 1,
                    model_channels: int = 128, frames: int = 16,
                    unet_heads: int = 8, dim_head: int = 64) -> dict:
    """A small-depth window on the card (bf16, kernels) against the CPU in
    float32 (plain path), with the same weights and the same draws. The
    same window on the CPU in bf16 (plain path) measures what bf16 alone
    costs; the card may differ from float32 by at most REF_FACTOR times
    that, in mean and in max. On the card exactly the ``expected`` kernels
    must launch. ``model_channels`` 256: the UNet of base_longvid.yaml at
    the same small depth (192: the variants phase's). ``frames``: clips of
    another length (the UNet's latent_t follows). ``unet_heads``: the
    UNet's num_heads. ``heads`` of ``dim_head``: the AE's attention. The
    CPU half (``reference_windows_cpu``) comes from the worker where main()
    handed it over (``cpu_reference``). Returns the errors and the card's
    launches by shape and by entry point."""
    from moditalker_tpu_torch.ops.kernels import (LAUNCHES, LAUNCHES_BY_ENTRY,
                                                  reset_launch_counts)

    window = dict(heads=heads, batch=batch, model_channels=model_channels,
                  frames=frames, unet_heads=unet_heads, dim_head=dim_head)
    cpu = cpu_reference(reference_windows_cpu, seed=seed,
                        switches=active_switches(), **window)
    reset_launch_counts()
    t0 = time.perf_counter()
    card = reference_window("cuda", "bfloat16", seed, **window)
    log(f"{what} reference window on cuda (torch.bfloat16): "
        f"{time.perf_counter() - t0:.2f} s, launches {dict(LAUNCHES)}")
    check_launches(f"{what} reference window", expected)
    by_shape = launches_by_shape()
    by_entry = dict(sorted(LAUNCHES_BY_ENTRY.items()))
    log(f"{what} reference window on the card: launches by shape "
        f"{by_shape}, by entry point {by_entry}")
    for dtype, sec in cpu["seconds"].items():
        log(f"{what} reference window on cpu (torch.{dtype}): {sec:.2f} s")
    fp32 = cpu["outs"]["float32"]
    err_card = (card - fp32).abs()
    bf16 = (cpu["outs"]["bfloat16"] - fp32).abs()
    log(f"{what} reference vs cpu fp32, decoded video: card bf16 mean abs "
        f"{err_card.mean().item():.3e} max {err_card.max().item():.3e}; cpu "
        f"bf16 mean abs {bf16.mean().item():.3e} max "
        f"{bf16.max().item():.3e} (card within {REF_FACTOR}x)")
    if not (torch.isfinite(card).all()
            and err_card.mean() <= REF_FACTOR * bf16.mean()
            and err_card.max() <= REF_FACTOR * bf16.max()):
        raise AssertionError(f"{what}: the card's window disagrees with the "
                             "CPU reference")
    return {"card_mean_abs": err_card.mean().item(), "card_max_abs":
            err_card.max().item(), "cpu_bf16_mean_abs": bf16.mean().item(),
            "cpu_bf16_max_abs": bf16.max().item(),
            "launches_by_shape": by_shape, "launches_by_entry": by_entry}


def longvid_unet_config():
    """The UNet of configs/latent-diffusion/base_longvid.yaml at the shipped
    AE's latent size (as ``sample`` builds it)."""
    import dataclasses

    from moditalker_tpu_torch.config import load_config

    cfg = load_config(LONGVID_YAML)
    ae = cfg.mtov_ae
    return dataclasses.replace(cfg.mtov_unet, latent_res=ae.latent_res,
                               latent_t=ae.timesteps // ae.splits)


def longvid_onepass(batch: int, calls: int) -> dict:
    """The one-pass launches, by shape, of ``calls`` 256-channel UNet calls
    at ``batch`` (LONGVID_ONEPASS_PER_CALL)."""
    return {str([batch * 8, n, d]): k * calls
            for (n, d), k in sorted(LONGVID_ONEPASS_PER_CALL.items())}


def longvid_unet_check(torch, seed: int) -> dict:
    """base_longvid.yaml's UNet at full width alone (528 M parameters): a
    DDIM-2 run at B = 1 on seeded conditioning latents, on the card in bf16
    (the one-pass kernel at every gated attention) and on the CPU in float32
    and in bf16 (plain path), from the same weights and draws; the card may
    differ from float32 by at most REF_FACTOR times what bf16 costs the
    CPU, in mean and in max."""
    from moditalker_tpu_torch.config import MtovDiffusionConfig
    from moditalker_tpu_torch.models.mtov import MtovDDPM, TriplaneUNet
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts

    unet_cfg = longvid_unet_config()
    state = seeded_state(torch, lambda: TriplaneUNet(unet_cfg), seed)
    n_params = sum(v.numel() for v in state.values())
    L = unet_cfg.latent_res**2 + 2 * unet_cfg.latent_t * unet_cfg.latent_res
    rng = np.random.default_rng(seed)
    cond = torch.from_numpy(rng.normal(size=(1, 8, L)).astype(np.float32))
    ic = torch.from_numpy(rng.normal(size=(1, 4, L)).astype(np.float32))
    outs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32),
                          ("cpu", torch.bfloat16)):
        unet = TriplaneUNet(unet_cfg, dtype)
        unet.load_state_dict(state)
        unet = unet.to(device).eval().requires_grad_(False)
        ddpm = MtovDDPM.create(unet, MtovDiffusionConfig(
            sampling_timesteps=2, w=0.0), device)
        g = torch.Generator().manual_seed(seed)
        draws = lambda shape, dt, g=g: torch.randn(shape, generator=g)
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            z = ddpm.ddim_sample((1, 4, L), cond.to(device, dtype),
                                 ic.to(device, dtype), generator=draws)
        outs[device, dtype] = z.float().cpu()
        log(f"longvid UNet DDIM-2 at B = 1 on {device} ({dtype}): "
            f"{time.perf_counter() - t0:.2f} s")
        if device == "cuda":
            check_launches("longvid UNet DDIM-2", {"onepass_attention"})
            by_shape = launches_by_shape()
            if by_shape != {"onepass_attention": longvid_onepass(1, 2)}:
                raise AssertionError(f"longvid UNet DDIM-2: launches "
                                     f"{by_shape}")
        del unet, ddpm
    fp32 = outs["cpu", torch.float32]
    card = (outs["cuda", torch.bfloat16] - fp32).abs()
    bf16 = (outs["cpu", torch.bfloat16] - fp32).abs()
    log(f"longvid UNet ({n_params / 1e6:.2f} M parameters) DDIM-2 vs cpu "
        f"fp32, latent [1, 4, {L}]: card bf16 mean abs {card.mean().item():.3e}"
        f" max {card.max().item():.3e}; cpu bf16 mean abs "
        f"{bf16.mean().item():.3e} max {bf16.max().item():.3e} (card within "
        f"{REF_FACTOR}x); launches by shape {by_shape}")
    if not (torch.isfinite(outs["cuda", torch.bfloat16]).all()
            and card.mean() <= REF_FACTOR * bf16.mean()
            and card.max() <= REF_FACTOR * bf16.max()):
        raise AssertionError("longvid UNet: the card's DDIM-2 disagrees with "
                             "the CPU reference")
    return {"parameters": n_params, "card_mean_abs": card.mean().item(),
            "card_max_abs": card.max().item(),
            "cpu_bf16_mean_abs": bf16.mean().item(),
            "cpu_bf16_max_abs": bf16.max().item(),
            "launches_by_shape": by_shape}


def check_frames(video, frames: int, cfg, what: str) -> None:
    want = (1, frames, cfg.resolution, cfg.resolution, 3)
    if video.dtype != np.uint8 or video.shape != want:
        raise AssertionError(f"{what}: got {video.dtype} {video.shape}, "
                             f"want uint8 {want}")
    per_window = video.reshape(-1, cfg.timesteps, *want[2:])
    if any(int(w.max()) == int(w.min()) for w in per_window):
        raise AssertionError(f"{what}: a window is constant")


def main_path_phase(torch, seed: int, longvid: bool = False) -> dict:
    """``sample_independent`` (2 windows at batch 2, DDIM-100) and the
    fast-mode ``sample_long`` (3 windows at B = 1) at full width, each
    timed after an untimed run of the same call at DDIM-2, then
    ``sample_independent`` on the modular-attention path. ``longvid``: the
    UNet of base_longvid.yaml (256 channels) and the fused path only, each
    one-pass count by shape as LONGVID_ONEPASS_PER_CALL predicts."""
    import dataclasses

    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovUNetConfig)
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

    ae_cfg = MtovAEConfig()
    unet_cfg = longvid_unet_config() if longvid else MtovUNetConfig()
    prefix = "longvid " if longvid else ""
    diff_cfg = MtovDiffusionConfig(sampling_timesteps=100, w=0.0)
    t0 = time.perf_counter()
    pipe = MtovSamplePipeline(*random_states(torch, ae_cfg, unet_cfg, seed),
                              ae_cfg, unet_cfg, diff_cfg)
    log(f"full-width {prefix}pipeline built in {time.perf_counter() - t0:.1f}"
        f" s")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    launches, by_shape = {}, {}

    def drive(name, fn, frames, expected=LONGVID_PATH if longvid
              else FUSED_PATH):
        name = prefix + name
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

    @contextlib.contextmanager
    def warm_up():
        """The untimed pass, at DDIM-2, which meets the shapes of DDIM-100
        in a fiftieth of its time."""
        full = pipe.ddpm
        pipe.ddpm = dataclasses.replace(full, cfg=dataclasses.replace(
            full.cfg, sampling_timesteps=2))
        try:
            yield
        finally:
            pipe.ddpm = full

    t = ae_cfg.timesteps
    # each path runs twice: the first pass meets its shapes for the first
    # time (cuBLAS/cuDNN plans, the allocator) and is not timed
    for label in ("sample_independent (warm-up)", "sample_independent"):
        with warm_up() if "warm-up" in label else contextlib.nullcontext():
            fps_ind = drive(label, lambda: pipe.sample_independent(
                make_windows(ae_cfg, 2, 1, seed), gen, batch=2), 2 * t)
    for label in ("sample_long (warm-up)", "sample_long"):
        with warm_up() if "warm-up" in label else contextlib.nullcontext():
            fps_long = drive(label, lambda: pipe.sample_long(
                make_windows(ae_cfg, 3, 1, seed + 1), gen,
                noised_start_ratio=0.25, noised_start_source="ref"), 3 * t)
    if longvid:
        # one UNet call per DDIM step: 100 at B = 2 for the two windows of
        # sample_independent, 25 at B = 1 for each of sample_long's three
        for name, b, calls in (("sample_independent", 2, 100),
                               ("sample_long", 1, 75)):
            got = by_shape[prefix + name]
            if got.get("onepass_attention") != longvid_onepass(b, calls):
                raise AssertionError(f"{prefix}{name}: one-pass launches "
                                     f"{got.get('onepass_attention')}, "
                                     f"predicted {longvid_onepass(b, calls)}")
        return {"launches": launches, "launches_by_shape": by_shape,
                "sample_independent_fps": fps_ind,
                "sample_long_fps": fps_long, "pipe": pipe}
    with modular_attention():
        for label in ("modular sample_independent (warm-up)",
                      "modular sample_independent"):
            with (warm_up() if "warm-up" in label
                  else contextlib.nullcontext()):
                fps_mod = drive(label, lambda: pipe.sample_independent(
                    make_windows(ae_cfg, 2, 1, seed), gen, batch=2), 2 * t,
                    MODULAR_PATH)
    return {"launches": launches, "launches_by_shape": by_shape,
            "sample_independent_fps": fps_ind,
            "sample_long_fps": fps_long,
            "modular_sample_independent_fps": fps_mod, "pipe": pipe}


def cli_phase(torch, seed: int, config: str | None = None) -> dict:
    """The ``sample`` command at full width, from its own parser to the
    video file, on synthetic uint8 windows. ``config``: a ``--config``
    file; base_longvid.yaml's launches are held to LONGVID_PATH and the
    one-pass counts by shape to LONGVID_ONEPASS_PER_CALL."""
    from moditalker_tpu_torch import cli
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts

    windows, steps = 4, 25
    longvid = config == LONGVID_YAML
    what = "longvid cli sample" if longvid else "cli sample"
    with tempfile.TemporaryDirectory() as tmp:
        args = cli.build_parser().parse_args([
            "sample", "--frames-dir", "-", "--aligned-dir", "-", "--batch",
            "2", "--no-last-as-reference", "--sampling-steps", str(steps),
            "--seed", str(seed), "--out-dir", tmp,
            *(["--config", config] if config else [])])
        ae_cfg = cli._sample_configs(args)[0]
        reset_launch_counts()
        t0 = time.perf_counter()
        path = cli.sample_windows(args, make_windows(ae_cfg, windows, 1, seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = check_launches(what, LONGVID_PATH if longvid else FUSED_PATH)
        by_shape = launches_by_shape()
        # one UNet call at batch 2 per DDIM step of each of the 2 batches
        if longvid and by_shape["onepass_attention"] != longvid_onepass(
                2, steps * windows // 2):
            raise AssertionError(f"{what}: one-pass launches "
                                 f"{by_shape['onepass_attention']}")
        frames = windows * ae_cfg.timesteps
        if not path.startswith(tmp) or os.path.getsize(path) == 0:
            raise AssertionError(f"{what}: no video at {path}")
        if path.endswith(".npz"):   # no ffmpeg on this host: a frame dump
            with np.load(path) as dump:
                check_frames(dump["frames"][None], frames, ae_cfg, what)
        elif not path.endswith(".mp4"):
            raise AssertionError(f"{what}: unexpected file {path}")
    log(f"{what} (pipeline built from the seed, {windows} windows at "
        f"batch 2, DDIM-{steps}): {frames} frames in {dt:.2f} s incl. the "
        f"build, wrote {os.path.basename(path)}; launches {counts}, by "
        f"shape {by_shape}")
    return {"launches": counts, "launches_by_shape": by_shape,
            "seconds_with_build": dt}


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


def hubert_part_ms(torch, model, dtype) -> dict:
    """Device ms of HuBERT's parts on a 20 s clip (T = 1000 frames): the
    feature extractor on the wave, the positional conv and the 24 layers
    (one layer's time 24 times) on a residual stream in ``dtype``."""
    from moditalker_tpu_torch.preprocess import audio

    cfg = model.cfg
    x = torch.randn((1, 1000, cfg.hidden_size), device="cuda", dtype=dtype)
    wave_clip = torch.randn((1, audio.CLIP_LENGTH - audio.STRIDE
                             + audio.KERNEL), device="cuda")
    with torch.inference_mode():
        return {
            "feature_extractor": device_ms(
                torch, lambda: model.feature_extractor(wave_clip)),
            "pos_conv": device_ms(torch, lambda: model.pos_conv(x)),
            "24 layers": cfg.num_layers * device_ms(
                torch, lambda: model.layer_0(x))}


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
    flops = layer_flops(
        torch, model, lambda: audio.extract_hubert_features(speech, card_fn),
        attention=(hubert.EncoderLayerStableLN,))
    audio_bound_ms = flops / H100_FP32_FLOPS * 1e3
    part_ms = hubert_part_ms(torch, model, torch.float32)
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
            "bound_ms": audio_bound_ms, "clip_device_ms": part_ms,
            "bf16_inputs": {"model": model, "clip": clip, "cpu": cpu,
                            "speech": speech, "flops": flops}}


def audio_bf16_phase(torch, seed: int, fp32: dict) -> dict:
    """HuBERT-large with the bf16 trunk (``dtype=torch.bfloat16``) and the
    float32 phase's weights: the 2 s clip on the card against the CPU's
    float32 features within REF_FACTOR times the error bf16 alone costs on
    the CPU (the port in bf16 against the port in float32, both there),
    then the chain over the float32 phase's 23 s timed warm."""
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.preprocess import audio, hubert

    inp = fp32["bf16_inputs"]
    model = hubert.HubertEncoder(hubert.HubertConfig(), torch.bfloat16)
    model.load_state_dict(inp["model"].state_dict())
    model.eval()
    clip, speech, flops = inp["clip"], inp["speech"], inp["flops"]
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu16 = model(torch.from_numpy(clip[None]))[0].float().numpy()
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    card_fn = audio.hubert_forward(model, "cuda")
    card = card_fn(clip[None])
    own, err = rel_err(cpu16, inp["cpu"]), rel_err(card, inp["cpu"])
    log(f"audio bf16: HuBERT-large, bf16 trunk, on the 2 s clip against "
        f"the CPU's float32, max abs err over max |cpu|: card {err:.3e}, "
        f"the CPU's bf16 {own:.3e} (card within {REF_FACTOR}x; the CPU's "
        f"bf16 forward took {cpu_s:.1f} s)")
    if card.dtype != np.float32 or err > REF_FACTOR * own:
        raise AssertionError("audio bf16: the card disagrees with the CPU")
    n = speech.shape[0]
    for label in ("audio features bf16 (warm-up)", "audio features bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = audio.extract_hubert_features(speech, card_fn)
        dt = time.perf_counter() - t0
    rate = n / 16000 / dt
    bound = flops / H100_BF16_FLOPS * 1e3
    traced = trace(torch, lambda: audio.extract_hubert_features(speech,
                                                                 card_fn))
    log_trace("audio features bf16", traced)
    part_ms = hubert_part_ms(torch, model, torch.bfloat16)
    want_t = audio.expected_num_frames(n)
    if (feats.shape != (want_t, model.cfg.hidden_size)
            or feats.dtype != np.float32 or not np.isfinite(feats).all()):
        raise AssertionError(f"audio bf16: features {feats.shape} "
                             f"{feats.dtype}")
    counts = check_launches("audio bf16", set())
    log(f"{label}: {n / 16000:.2f} s of audio in {dt:.3f} s = {rate:.2f} s "
        f"of audio per s (float32: {fp32['audio_s_per_s']:.2f}); "
        f"{flops / dt / 1e12:.2f} TFLOP/s, bound {bound:.2f} ms "
        f"(operations, bf16 at {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s); "
        f"device ms per 20 s clip by part {part_ms} (float32 "
        f"{fp32['clip_device_ms']}); launches {counts}")
    return {"launches": counts, "audio_s_per_s": rate,
            "card_vs_cpu_rel_max_err": err, "cpu_bf16_rel_max_err": own,
            "tflop_per_s": flops / dt / 1e12, "bound_ms": bound,
            "clip_device_ms": part_ms, "trace": traced, "cpu_bf16_s": cpu_s}


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


def chunk_net_ms(torch, fused, frames) -> tuple:
    """One fused chunk's device ms, whole and by net (the nets on inputs
    of the chunk's shapes), and each net's FLOPs there."""
    from moditalker_tpu_torch.preprocess.s3fd import preprocess_frames

    chunk = frames[:fused.chunk]
    dev = torch.from_numpy(chunk).cuda()
    x256 = torch.rand((fused.chunk, 256, 256, 3), device="cuda")
    x224 = torch.rand((fused.chunk, 224, 224, 3), device="cuda")
    calls = {"s3fd": (fused.s3fd, lambda: fused.s3fd(preprocess_frames(dev))),
             "fan": (fused.fan, lambda: fused.fan(x256)),
             "recon": (fused.recon, lambda: fused.recon(x224))}
    with torch.inference_mode():
        net_ms = {"chunk": device_ms(torch, lambda: fused.chunk_rows(chunk)),
                  **{k: device_ms(torch, fn) for k, (_, fn) in calls.items()}}
    flops = {k: layer_flops(torch, net, fn) for k, (net, fn) in calls.items()}
    return net_ms, flops


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
        maps32 = cpu.s3fd(preprocess_frames(torch.from_numpy(two)))
        errs["s3fd maps"] = max(rel_err(g, w) for g, w in zip(maps, maps32))
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
        recon_in, coeff32 = x224, cpu.recon(x224)
        errs["recon coefficients"] = rel_err(fused.recon(x224.cuda()).cpu(),
                                             coeff32)
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
    net_ms, net_flops = chunk_net_ms(torch, fused, frames)
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
            "chunk_bound_ms": chunk_bound_ms,
            "bf16_inputs": {
                "states": states, "lm3d_std": lm3d_std, "frames": frames,
                "landmark_fn": landmark_fn, "coeff_fn": coeff_fn,
                "lm68_atom": lm68_atom, "two": two, "crops": crops,
                "scale": want["scale"], "x224": recon_in, "maps32": maps32,
                "coeff32": coeff32}}


def determined_points(hm32, *hms):
    """[B, 68] mask of the heatmap points whose decode no bf16 result in
    ``hms`` can move: with e the largest |bf16 − float32| of that heatmap
    over ``hms``, the float32 map's top value beats its runner-up, and its
    neighbours |right − left| and |below − above| differ where the ±0.25
    shift applies, each by more than 2e (two values may each move by e).
    Heatmaps [B, H, W, 68], numpy."""
    b, hh, ww, n = hm32.shape
    e = np.max([np.abs(h - hm32).max(axis=(1, 2)) for h in hms], axis=0)
    flat = hm32.transpose(0, 3, 1, 2).reshape(b, n, hh * ww)
    top2 = np.sort(flat, axis=-1)[..., -2:]
    ok = top2[..., 1] - top2[..., 0] > 2 * e
    idx = flat.argmax(axis=-1)
    yi, xi = idx // ww, idx % ww

    def at(y, x):
        return np.take_along_axis(flat, (y * ww + x)[..., None], -1)[..., 0]

    for inside, a, c in (
            ((xi > 0) & (xi < ww - 1), at(yi, np.minimum(xi + 1, ww - 1)),
             at(yi, np.maximum(xi - 1, 0))),
            ((yi > 0) & (yi < hh - 1), at(np.minimum(yi + 1, hh - 1), xi),
             at(np.maximum(yi - 1, 0), xi))):
        ok &= ~inside | (np.abs(a - c) > 2 * e)
    return ok


def fan_discriminant(feats: np.ndarray, crops01: np.ndarray, r: int = 2,
                     ridge: float = 0.01) -> tuple:
    """FAN's last heatmap head (a 1 × 1 conv, C → 68) peaked on given
    crops, so that the landmark checks have determined points to compare:
    random heads give flat heatmaps (2 % of the points determined on the
    align phase's crops). ``feats`` [B, C, 64, 64], the head's input in
    float32 on crops01 [B, 256, 256, 3] in 0..1. Per crop b, p_jb is the
    j-th brightest local maximum of its 4 × 4-pixel cell means (at least
    r + 1 cells apart, r from the border; cyclic where fewer), Σ_b the
    features' covariance over the map plus ``ridge`` of its mean variance,
    and kernel column j = Σ_b unit(Σ_b⁻¹ (f_b(p_jb) − the mean of f_b over
    the (2r + 1)² cells around it)), a linear discriminant of that cell
    against its map; the bias centres crop 0's map. Returns (kernel [C,
    68], bias [68]), float32."""
    c = feats.shape[1]
    kernel = np.zeros((c, 68))
    for f, crop in zip(feats, crops01):
        cells = crop.mean(-1).reshape(64, 4, 64, 4).mean((1, 3))
        cells[:r], cells[-r:], cells[:, :r], cells[:, -r:] = 0, 0, 0, 0
        pts = []
        for i in np.argsort(cells, axis=None)[::-1]:
            y, x = divmod(int(i), 64)
            if cells[y, x] <= 0 or len(pts) == 68:
                break
            if all(max(abs(y - a), abs(x - b)) > r for a, b in pts):
                pts.append((y, x))
        pts = np.array([pts[j % len(pts)] for j in range(68)])
        cov = np.cov(f.reshape(c, -1))
        cov += ridge * np.trace(cov) / c * np.eye(c)
        near = np.stack([f[:, y - r:y + r + 1, x - r:x + r + 1].mean((1, 2))
                         for y, x in pts], axis=1)          # [C, 68]
        u = np.linalg.solve(cov, f[:, pts[:, 0], pts[:, 1]] - near)
        kernel += u / np.linalg.norm(u, axis=0, keepdims=True)
    bias = -(feats[0].mean(axis=(1, 2)) @ kernel)
    return kernel.astype(np.float32), bias.astype(np.float32)


def align_bf16_phase(torch, seed: int, fp32: dict) -> dict:
    """The alignment stack with its three trunks in bf16
    (``FusedAligner(dtype=torch.bfloat16)``) from the float32 phase's
    state_dicts: S3FD's maps, FAN's heatmaps and ReconNet's coefficients on
    the float32 check's inputs, on the card against the CPU's float32
    within REF_FACTOR times the CPU's own bf16 error; the 2 frames'
    detection flags equal to the CPU bf16 chunk's; every determined
    landmark within 1e-2 px of the CPU bf16 decode's on the same crops
    (FAN's last head made a discriminant of the crops' bright cells,
    ``fan_discriminant``, in every copy here, so that points are
    determined); then ``align_sequence`` over the 156 frames timed warm,
    and device ms and TFLOP/s per net per chunk."""
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.preprocess import fused_align
    from moditalker_tpu_torch.preprocess.fan import FAN, decode_heatmaps
    from moditalker_tpu_torch.preprocess.motion_align import (HORIZON,
                                                              MotionAligner)
    from moditalker_tpu_torch.preprocess.s3fd import preprocess_frames

    inp = fp32["bf16_inputs"]
    bf16, unpack = torch.bfloat16, fused_align.FusedAligner.unpack
    two, crops, x224 = inp["two"], inp["crops"], inp["x224"]
    s3fd_state, fan_state, recon_state = inp["states"]
    fan32 = FAN(num_modules=4).eval()
    fan32.load_state_dict(fan_state)
    head = f"l{fan32.num_modules - 1}"
    seen = []
    hook = getattr(fan32, head).register_forward_hook(
        lambda m, a, out: seen.append(a[0]))
    with torch.inference_mode():
        fan32(crops)
    hook.remove()
    kernel, bias = fan_discriminant(seen[0].numpy(), crops.numpy())
    fan_state = dict(fan_state)
    fan_state[f"{head}.weight"] = torch.from_numpy(kernel.T.copy())[
        :, :, None, None]
    fan_state[f"{head}.bias"] = torch.from_numpy(bias)
    fan32.load_state_dict(fan_state)
    with torch.inference_mode():
        hm32 = fan32(crops)[-1].numpy()
    states = (s3fd_state, fan_state, recon_state)
    reset_launch_counts()
    fused = fused_align.FusedAligner(*states, inp["lm3d_std"],
                                     device="cuda", dtype=bf16)
    cpu = fused_align.FusedAligner(*states, inp["lm3d_std"], device="cpu",
                                   dtype=bf16)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = unpack(cpu.chunk_rows(two).numpy())
        maps16 = cpu.s3fd(preprocess_frames(torch.from_numpy(two)))
        hm16 = cpu.fan(crops)[-1].float()
        coeff16 = cpu.recon(x224)
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        got = unpack(fused.chunk_rows(two).cpu().numpy())
        maps = [m.cpu() for m in fused.s3fd(preprocess_frames(
            torch.from_numpy(two).cuda()))]
        hm = fused.fan(crops.cuda())[-1].float().cpu()
        coeff = fused.recon(x224.cuda()).cpu()
    card = {"s3fd maps": max(rel_err(g, w)
                             for g, w in zip(maps, inp["maps32"])),
            "fan heatmaps": rel_err(hm, hm32),
            "recon coefficients": rel_err(coeff, inp["coeff32"])}
    own = {"s3fd maps": max(rel_err(g, w)
                            for g, w in zip(maps16, inp["maps32"])),
           "fan heatmaps": rel_err(hm16, hm32),
           "recon coefficients": rel_err(coeff16, inp["coeff32"])}
    ok = determined_points(hm32, hm16.numpy(), hm.numpy())
    # heatmap px to image px: the crop's side 200·scale over 64 cells
    px = (200.0 * inp["scale"] / 64.0)[:, None]
    off = (np.abs(decode_heatmaps(hm).numpy() - decode_heatmaps(hm16).numpy())
           .max(axis=-1) * px)
    log(f"align bf16: card vs cpu float32, max abs err over max |cpu|: "
        f"{card}; the CPU's bf16: {own} (card within {REF_FACTOR}x; the "
        f"CPU's bf16 chunk and nets took {cpu_s:.1f} s); detected card "
        f"{got['detected']} cpu bf16 {want['detected']}; determined points "
        f"{int(ok.sum())} of {ok.size} ({ok.mean():.1%}), the largest "
        f"determined offset from the CPU's bf16 decode "
        f"{off[ok].max(initial=0):.3e} px (limit 1e-2)")
    if (any(card[k] > REF_FACTOR * own[k] for k in card)
            or not np.array_equal(got["detected"], want["detected"])
            or not got["detected"].all() or not ok.any()
            or off[ok].max() > 1e-2):
        raise AssertionError("align bf16: the card disagrees with the CPU")

    frames, lm68_atom = inp["frames"], inp["lm68_atom"]
    aligner = MotionAligner(inp["landmark_fn"], inp["coeff_fn"],
                            inp["lm3d_std"], fused=fused)
    if not fused.process(frames)["detected"].all():
        raise AssertionError("align bf16: a frame missed its detection")
    for label in ("align_sequence bf16 (warm-up)", "align_sequence bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligned = aligner.align_sequence(lm68_atom, frames)
        dt = time.perf_counter() - t0
    fps = HORIZON / dt
    traced = trace(torch, lambda: aligner.align_sequence(lm68_atom, frames))
    log_trace("align_sequence bf16", traced)
    side = frames.shape[1]
    if (aligned.shape != (HORIZON, 68, 2) or not np.isfinite(aligned).all()
            or aligned.min() < 0 or aligned.max() > side - 1):
        raise AssertionError(f"align bf16: aligned landmarks "
                             f"{aligned.shape} outside the frame")
    net_ms, flops = chunk_net_ms(torch, fused, frames)
    rates = {k: round(f / (net_ms[k] * 1e9), 2) for k, f in flops.items()}
    bound = sum(flops.values()) / H100_BF16_FLOPS * 1e3
    counts = check_launches("align bf16", set())
    log(f"{label}: {HORIZON} frames of {side}×{side} in {dt:.3f} s = "
        f"{fps:.2f} frames/s (float32: {fp32['frames_per_s']:.2f}); device "
        f"ms per chunk of {fused.chunk} frames {net_ms} (float32 "
        f"{fp32['chunk_device_ms']}), TFLOP/s {rates} (float32 "
        f"{fp32['chunk_tflop_per_s']}); the nets' bound {bound:.1f} ms "
        f"(operations, bf16); launches {counts}")
    return {"launches": counts, "frames_per_s": fps,
            "card_vs_cpu_rel_max_err": card, "cpu_bf16_rel_max_err": own,
            "determined_share": float(ok.mean()), "trace": traced,
            "chunk_device_ms": net_ms, "chunk_tflop_per_s": rates,
            "chunk_bound_ms": bound, "cpu_bf16_s": cpu_s}


def profile_phase(torch, pipe, seed: int,
                  parts=("unet_step", "extract", "decode"),
                  label: str = "") -> dict:
    """Where a window's time goes: one UNet step at B = 2 and one AE extract
    and decode at B = 2 (those of ``parts``), each timed on the host clock
    (after a warm-up, over 3 runs, synchronised) and traced once with
    torch.profiler for the device's busy time, its kernel count and its
    top kernels."""
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
    fns = {
        "unet_step": lambda: pipe.ddpm.model(x, cond, ic, t),
        "extract": lambda: pipe.ae_rgb.extract(pipe._in(video)),
        "decode": lambda: pipe.ae_rgb.decode_from_sample(x),
    }
    result = {}
    with torch.inference_mode():
        for name in parts:
            fn = fns[name]
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
            log(f"profile {label}{name} at B={b}: wall {wall_ms:.2f} ms, "
                f"device busy {busy_ms:.2f} ms, {result[name]['kernels']} "
                f"kernels; top {result[name]['top']}")
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


# ------------------------------------------------------------------ variants
def variant_yaml(name: str, directory: str) -> str:
    """The shipped YAML of ``VARIANTS[name]`` with its keys changed,
    written into ``directory``; returns the file's path."""
    import yaml

    src, section, changes = VARIANTS[name]
    with open(src) as fh:
        data = yaml.safe_load(fh) or {}
    data.setdefault(section, {}).update(changes)
    path = os.path.join(directory, f"{name}.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(data, fh)
    return path


def check_gated(what: str, by_shape: dict, frames: int) -> None:
    """Every launch at a shape its kernel's gate admits (the port's gates,
    held equal to the JAX gates on the CPU), the time and tiny-L launches on
    sequences of ``frames``."""
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    gate = {
        "divided_space_attention": lambda s: dv.divided_attention_viable(
            "space", 1, s[-2], 8, 64, 64),
        "divided_time_attention": lambda s: s[1] == frames and
        dv.divided_attention_viable("time", s[1], s[2], 8, 64, 64),
        "divided_space_attention_backward": lambda s:
        dv.divided_attention_viable("space", 1, s[-2], 8, 64, 64),
        "divided_time_attention_backward": lambda s: s[1] == frames and
        dv.divided_attention_viable("time", s[1], s[2], 8, 64, 64),
        "tiny_attention": lambda s: s[1] == frames and
        fa.tiny_attention_viable(s[0], s[1], s[1], s[2]),
        "onepass_attention": lambda s: fa.onepass_attention_viable(
            s[1], s[1], s[2]),
        "packed_attention": lambda s: pk.packed_attention_viable(
            s[1], s[2] // 3, 8)}
    off = {name: key for name, shapes in by_shape.items() for key in shapes
           if not gate[name](json.loads(key))}
    if off:
        raise AssertionError(f"{what}: launches at shapes their gates do not "
                             f"admit: {off}")


def check_unet_launches(what: str, by_shape: dict, per_call: dict,
                        calls: int, other_onepass=None) -> None:
    """The UNet's launches by shape, ``per_call`` of them a call
    (VARIANT_UNET_PER_CALL) over ``calls`` calls; the one-pass kernel's
    other shapes must be the AE's (``other_onepass(shape)``)."""
    for name, want in per_call.items():
        got = dict(by_shape.get(name, {}))
        for shape, k in want.items():
            if got.pop(str(list(shape)), None) != k * calls:
                raise AssertionError(f"{what}: {name} launches "
                                     f"{by_shape.get(name)}, predicted "
                                     f"{k * calls} at {list(shape)}")
        if got and not (name == "onepass_attention" and other_onepass and all(
                other_onepass(json.loads(key)) for key in got)):
            raise AssertionError(f"{what}: {name} launched at {got} too")


def variant_sample(torch, seed: int, config: str, path: str) -> dict:
    """The ``sample`` command with ``config`` (clips of 32 frames) through
    the CLI's own parser, two windows at batch 2, on the fused or the
    modular ``path``: a DDIM-2 warm-up, then DDIM-25 timed; the path's
    kernels and no other, every launch at a shape its gate admits, the
    time kernel at [2, 32, 1024, 1536] (fused) or tiny-L at [16384, 32, 64]
    (modular), the UNet's launches by shape as VARIANT_UNET_PER_CALL
    predicts for 25 calls, the frames written."""
    from moditalker_tpu_torch import cli
    from moditalker_tpu_torch.ops.kernels import (LAUNCHES_BY_ENTRY,
                                                  reset_launch_counts)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv

    windows, steps = 2, 25
    what = f"variants clip32 sample ({path})"
    switches = modular_attention() if path == "modular" else \
        contextlib.nullcontext()
    with switches, tempfile.TemporaryDirectory() as tmp:
        def args(n):
            return cli.build_parser().parse_args([
                "sample", "--frames-dir", "-", "--aligned-dir", "-",
                "--batch", "2", "--no-last-as-reference", "--sampling-steps",
                str(n), "--seed", str(seed), "--out-dir", tmp, "--config",
                config])

        ae_cfg = cli._sample_configs(args(2))[0]
        f_ = ae_cfg.timesteps
        cli.sample_windows(args(2), make_windows(ae_cfg, windows, 1, seed))
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.sample_windows(args(steps),
                                 make_windows(ae_cfg, windows, 1, seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = check_launches(what, MODULAR_PATH if path == "modular"
                                else FUSED_PATH)
        by_shape = launches_by_shape()
        by_entry = dict(sorted(LAUNCHES_BY_ENTRY.items()))
        frames = windows * f_
        if out.endswith(".npz"):
            with np.load(out) as dump:
                check_frames(dump["frames"][None], frames, ae_cfg, what)
        elif not out.endswith(".mp4") or os.path.getsize(out) == 0:
            raise AssertionError(f"{what}: no video at {out}")
    check_gated(what, by_shape, f_)
    new_class = (("tiny_attention", [2 * 8 * 1024, f_, 64]) if path ==
                 "modular" else ("divided_time_attention",
                                 [2, f_, 1024, 1536]))
    if str(new_class[1]) not in by_shape.get(new_class[0], {}):
        raise AssertionError(f"{what}: no {new_class[0]} launch at "
                             f"{new_class[1]}: {by_shape}")
    check_unet_launches(what, by_shape, VARIANT_UNET_PER_CALL[
        "clip32", path], steps,
        other_onepass=lambda s: s[1:] == [1024, 64])
    # every time launch at these clips through the staged kernel's entry
    if by_entry.get(dv.STAGED_TIME_ENTRY, 0) != counts.get(
            "divided_time_attention", 0):
        raise AssertionError(f"{what}: time launches {counts}, by entry "
                             f"point {by_entry}")
    log(f"{what} (DDIM-{steps}, {windows} windows at batch 2, built from "
        f"the seed): {frames} frames of {f_}-frame clips in {dt:.2f} s incl. "
        f"the build = {frames / dt:.3f} frames/s; launches {counts}, by "
        f"shape {by_shape}, by entry point {by_entry}")
    return {"frames_per_s_with_build": frames / dt, "launches": counts,
            "launches_by_shape": by_shape, "launches_by_entry": by_entry}


def first_stage_frames_phase(torch, seed: int, config: str) -> dict:
    """``FirstStageTrainer`` at ``config`` (base_gan.yaml's operating point
    with clips of 8 frames), full width, B = 1, accumulation 3, float32:
    one G and one D cycle untimed, then one of each timed (iterations/s,
    peak memory), every loss finite; launches by shape: the space and time
    kernels 2·depth a micro-step, their backward kernels 2·depth a G
    micro-step, all on float32 operands, the time kernels at [1, 8, 1024,
    1536], and no other kernel; by entry point: every space launch the
    float32 space kernel's cluster plan (``SPACE_F32_CLUSTER_ENTRY``), every
    time launch the staged kernel's float32 entry point, every time backward
    the staged backward's (``STAGED_TIME_BACKWARD_ENTRY``); then
    a G and a D cycle at small depth on 8-frame clips against the CPU
    within FIRST_STAGE_LIMITS (``first_stage_check``)."""
    import dataclasses
    import itertools

    from moditalker_tpu_torch.config import load_config
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.ops.kernels import (LAUNCHES_BY_ENTRY,
                                                  reset_launch_counts)
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    cfg = load_config(config)
    ae_cfg, loss_cfg = cfg.mtov_ae, cfg.mtov_loss
    tc = dataclasses.replace(cfg.mtov_train, seed=seed)
    what = f"variants clip8 train-first-stage ({ae_cfg.timesteps} frames)"
    trainer = FirstStageTrainer(ae_cfg, loss_cfg, tc)
    b, k = tc.batch_size, tc.accum_iter
    batch = synthetic_mtov_batch(b, ae_cfg.timesteps, ae_cfg.resolution, seed)
    losses = LossLog()
    trainer.fit(itertools.repeat(batch), max_steps=2 * k, logger=losses,
                log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(itertools.repeat(batch), max_steps=4 * k, logger=losses,
                log_every=1, eval_every=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = check_launches(what, FIRST_STAGE_PATH)
    by_shape = launches_by_shape()
    by_entry = dict(sorted(LAUNCHES_BY_ENTRY.items()))
    check_float32_launches(what, by_shape)
    check_gated(what, by_shape, ae_cfg.timesteps)
    per_step = 2 * ae_cfg.depth
    want = {n: per_step * (k if n in FIRST_STAGE_BACKWARDS else 2 * k)
            for n in FIRST_STAGE_PATH}
    qkv = str([b, ae_cfg.timesteps, 1024, 1536])
    values = [v for row in losses.seen for v in row.values()]
    if ({n: c for n, c in counts.items() if c} != want
            or by_shape["divided_time_attention"] != {qkv: want[
                "divided_time_attention"]}
            or by_shape["divided_time_attention_backward"] != {qkv: want[
                "divided_time_attention_backward"]}
            or len(losses.seen) != 4 * k or not np.isfinite(values).all()):
        raise AssertionError(f"{what}: launches {by_shape} (want {want}), "
                             f"losses {losses.seen}")
    # every space launch on the float32 space kernel's cluster plan, every
    # time launch on the staged kernel and every time backward on the
    # staged backward (their float32 entry points)
    if (by_entry.get(dv.SPACE_F32_CLUSTER_ENTRY, 0)
            != want["divided_space_attention"]
            or by_entry.get(dv.STAGED_TIME_ENTRY + "_f32", 0)
            != want["divided_time_attention"]
            or by_entry.get(dv.STAGED_TIME_BACKWARD_ENTRY + "_f32", 0)
            != want["divided_time_attention_backward"]):
        raise AssertionError(f"{what}: launches by entry point {by_entry} "
                             f"(want the cluster plan's and the staged "
                             f"kernels' {want})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{what} (full width, B = {b}, accumulation {k}, float32): one G and "
        f"one D cycle in {dt:.3f} s = {2 * k / dt:.4f} iterations/s; peak "
        f"memory {peak:.2f} GiB; launches by shape {by_shape}, by entry "
        f"point {by_entry}; last losses {losses.seen[-2:]}")
    del trainer
    torch.cuda.empty_cache()
    check = first_stage_check(torch, seed, loss_cfg,
                              frames=ae_cfg.timesteps)
    return {"iterations_per_s": 2 * k / dt, "peak_gib": peak,
            "launches": counts, "launches_by_shape": by_shape,
            "launches_by_entry": by_entry, "card_vs_cpu": check}


def ae_heads_phase(torch, seed: int, config: str) -> dict:
    """The AE of ``config`` (base.yaml's, its 512 attention channels in
    other heads: the divided space kernel's pre-rotated design, the time
    kernel's head-dim class) at full width, bf16, weights from the seed: one
    extract of a B = 2 clip and one decode of a B = 2 latent, each timed
    warm over 3 calls on the host clock after a synchronise, with its
    launches (the space and time kernels and no other, the space kernel's
    every launch the pre-rotated design's); the outputs finite and of their
    shapes. Then a small-depth window with such heads against the CPU
    (``reference_phase``) and a small-depth G and D cycle of the first
    stage against the CPU within FIRST_STAGE_LIMITS (``first_stage_check``:
    the space backward's classes)."""
    from moditalker_tpu_torch.config import load_config
    from moditalker_tpu_torch.models.mtov import ViTAutoencoder
    from moditalker_tpu_torch.ops.kernels import reset_launch_counts
    from moditalker_tpu_torch.ops.kernels import divided_attention as dv

    ae_cfg = load_config(config).mtov_ae
    heads, dh = ae_cfg.heads, ae_cfg.dim_head
    what = f"variants AE in {heads} heads of {dh}"
    n = (ae_cfg.resolution // ae_cfg.patch_size) ** 2
    if not dv.space_prerotated(dh, n, False):
        raise AssertionError(f"{what}: not the space kernel's pre-rotated "
                             f"design")
    torch.manual_seed(seed)
    ae = ViTAutoencoder(ae_cfg, torch.bfloat16).to("cuda").eval()
    ae.requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, reps = 2, 3
    video = torch.randint(0, 256, (b, ae_cfg.timesteps, ae_cfg.resolution,
                                   ae_cfg.resolution, 3), generator=g,
                          device="cuda", dtype=torch.uint8).float() / 127.5 - 1
    latent = torch.randn((b, ae_cfg.embed_dim, ae_cfg.latent_len),
                         generator=g, device="cuda")
    shapes = {"extract": (b, ae_cfg.embed_dim, ae_cfg.latent_len),
              "decode": tuple(video.shape)}
    result = {}
    with torch.inference_mode():
        for name, fn in (("extract", lambda: ae.extract(video)),
                         ("decode", lambda: ae.decode_from_sample(latent))):
            fn()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / reps * 1e3
            counts = check_launches(f"{what} {name}",
                                    {"divided_space_attention",
                                     "divided_time_attention"})
            by_shape = launches_by_shape()
            if (tuple(out.shape) != shapes[name]
                    or not torch.isfinite(out).all()
                    or counts["divided_space_attention"] !=
                    reps * ae_cfg.depth):
                raise AssertionError(f"{what} {name}: {list(out.shape)}, "
                                     f"launches {by_shape}")
            result[name] = {"ms": ms, "launches": counts,
                            "launches_by_shape": by_shape}
            log(f"{what} {name} at full width, B = {b}, bf16: {ms:.2f} ms a "
                f"call (host clock, {reps} calls); launches by shape "
                f"{by_shape}")
    del ae
    torch.cuda.empty_cache()
    result["reference"] = reference_phase(
        torch, seed, what, FUSED_PATH, heads=heads, dim_head=dh)
    result["first_stage"] = first_stage_check(torch, seed, heads=heads,
                                              dim_head=dh)
    return result


def variants_phase(torch, seed: int) -> dict:
    """Shipped configurations changed by one key each (VARIANTS), read by
    ``load_config`` from temporary YAMLs: ``sample`` at clips of 32 frames
    on the fused and the modular path (``variant_sample``) and a
    small-depth window of such clips against the CPU; train-first-stage at
    clips of 8 frames (``first_stage_frames_phase``); a small-depth window
    of the 192-channel UNet against the CPU, its one-pass launches at head
    dims 24 and 48; a small-depth window of the UNet with two heads against
    the CPU, its one-pass launches at head dims 64 and 128 (the wide
    tile's); the AE in 4 heads of 128 and in 16 of 32 (``ae_heads_phase``).
    The counts are zeroed before each path and read after it."""
    from moditalker_tpu_torch.config import load_config
    from moditalker_tpu_torch.ops.kernels import flash_attention as fa

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: variant_yaml(name, tmp) for name in VARIANTS}
        frames = load_config(paths["clip32"]).mtov_ae.timesteps
        out["clip32"] = {p: variant_sample(torch, seed, paths["clip32"], p)
                         for p in ("fused", "modular")}
        torch.cuda.empty_cache()
        out["clip32"]["reference"] = reference_phase(
            torch, seed, "variants clip32 fused", FUSED_PATH, frames=frames)
        with modular_attention():
            out["clip32"]["reference modular"] = reference_phase(
                torch, seed, "variants clip32 modular", MODULAR_PATH,
                heads=4, batch=2, frames=frames)
        torch.cuda.empty_cache()
        out["clip8"] = first_stage_frames_phase(torch, seed, paths["clip8"])
        torch.cuda.empty_cache()
        channels = load_config(paths["channels192"]).mtov_unet.model_channels
        ref = reference_phase(torch, seed, "variants channels192",
                              LONGVID_PATH, model_channels=channels)
        heads = {json.loads(key)[2] for key in
                 ref["launches_by_shape"]["onepass_attention"]}
        if heads != {channels // 8, 2 * channels // 8}:
            raise AssertionError(f"variants channels192: one-pass at head "
                                 f"dims {heads}")
        # its bf16 head dim 48 through the narrow tile's entry point
        narrow = sum(c for key, c in
                     ref["launches_by_shape"]["onepass_attention"].items()
                     if json.loads(key)[2] in fa.NARROW_HEAD_DIMS)
        if not narrow or ref["launches_by_entry"].get(fa.NARROW_ENTRY) \
                != narrow:
            raise AssertionError(f"variants channels192: by entry point "
                                 f"{ref['launches_by_entry']}")
        out["channels192"] = {"reference": ref}
        torch.cuda.empty_cache()
        unet = load_config(paths["num_heads2"]).mtov_unet
        ref = reference_phase(torch, seed, "variants num_heads2",
                              LONGVID_PATH,
                              model_channels=unet.model_channels,
                              unet_heads=unet.num_heads)
        dims = {json.loads(key)[2] for key in
                ref["launches_by_shape"]["onepass_attention"]}
        if dims != {unet.model_channels // unet.num_heads,
                    2 * unet.model_channels // unet.num_heads}:
            raise AssertionError(f"variants num_heads2: one-pass at head "
                                 f"dims {dims}")
        out["num_heads2"] = {"reference": ref}
        for h, d in VARIANT_AE_HEADS:
            torch.cuda.empty_cache()
            name = f"ae_heads{h}x{d}"
            out[name] = phase(f"variants {name}", ae_heads_phase, torch,
                              seed, paths[name])
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
        from moditalker_tpu_torch.ops.kernels import _build, all_sources
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    try:
        return run(torch, args)
    finally:
        if CPU_REFS is not None:
            CPU_REFS.close()


def run(torch, args) -> int:
    """Every phase in turn (``main``); the CPU halves of the small-depth
    checks in a worker process (``CpuReferences``) from the end of the
    kernels and gradient phases on."""
    global CPU_REFS
    from moditalker_tpu_torch.ops.kernels import _build, all_sources

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    logs = _build.build(all_sources())
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    log(f"build: {PHASE_SECONDS['build']:.1f} s")
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
    rows = phase("kernels", kernel_phase, torch, batch=2, seed=args.seed)
    masked = phase("masked padding", masked_padding_check, torch, args.seed)
    masked["fused"] = phase("fused masked edge", fused_masked_edge_check,
                            torch, args.seed)
    grads = phase("gradients", gradient_phase, torch, args.seed)
    if args.kernels_only:
        return 0
    # from here on the CPU halves of the small-depth checks run in a worker
    # on half the host's cores, this process on the other half (not under
    # the kernels phase: a busy host can stretch a device time taken between
    # two events), and the reference windows, its first jobs, come after the
    # sampling paths
    CPU_REFS = CpuReferences(cpu_reference_jobs(args.seed))
    longvid = {"unet_ddim2": phase("longvid UNet DDIM-2", longvid_unet_check,
                                   torch, args.seed)}
    result = phase("main path", main_path_phase, torch, args.seed)
    longvid_result = phase("longvid main path", main_path_phase, torch,
                           args.seed, longvid=True)
    # the AEs' launches are those of the 128-channel path
    for path in ("sample_independent", "sample_long"):
        for name in ("divided_space_attention", "divided_time_attention"):
            if (longvid_result["launches_by_shape"][f"longvid {path}"][name]
                    != result["launches_by_shape"][path][name]):
                raise AssertionError(f"longvid {path}: {name}'s launches "
                                     f"differ from the 128-channel path's")
    longvid["profile"] = phase("longvid profile", profile_phase, torch,
                               longvid_result.pop("pipe"), args.seed,
                               ("unet_step",), "longvid ")
    torch.cuda.empty_cache()
    # the command keeps its last pipeline: the 128-channel one stays, as
    # it stayed before the 256-channel paths, under the later phases' peaks
    longvid_cli = phase("longvid cli", cli_phase, torch, args.seed,
                        LONGVID_YAML)
    cli_result = phase("cli", cli_phase, torch, args.seed)
    phase("reference fused", reference_phase, torch, args.seed, "fused",
          FUSED_PATH)
    with modular_attention():
        # 2·4·1024 = 8192 folded sequences: the time attention passes the
        # tiny-L gate (at B = 1 and 2 heads it would not)
        phase("reference modular", reference_phase, torch, args.seed,
              "modular", MODULAR_PATH, heads=4, batch=2)
    longvid["reference"] = {
        "fused": phase("reference longvid fused", reference_phase, torch,
                       args.seed, "longvid fused", LONGVID_PATH,
                       model_channels=256)}
    with modular_attention():
        longvid["reference"]["modular"] = phase(
            "reference longvid modular", reference_phase, torch, args.seed,
            "longvid modular", MODULAR_PATH, heads=4, batch=2,
            model_channels=256)
    atom = phase("atom", atom_phase, torch, args.seed)
    audio = phase("audio", audio_phase, torch, args.seed)
    audio16 = phase("audio bf16", audio_bf16_phase, torch, args.seed, audio)
    align = phase("align", align_phase, torch, args.seed,
                  audio.pop("lm68_atom"))
    align16 = phase("align bf16", align_bf16_phase, torch, args.seed, align)
    audio.pop("bf16_inputs")
    align.pop("bf16_inputs")
    train_diff = phase("train-diffusion", train_diffusion_phase, torch,
                       args.seed)
    train_diff_modular = phase("train-diffusion modular",
                               train_diffusion_phase, torch, args.seed,
                               modular=True)
    train_longvid = phase("train-diffusion longvid",
                          train_diffusion_longvid_phase, torch, args.seed)
    train_atom = phase("train-atom", train_atom_phase, torch, args.seed)
    first_stage = phase("train-first-stage", train_first_stage_phase, torch,
                        args.seed)
    variants = {
        "base.yaml": phase(
            "train-first-stage base.yaml", first_stage_variant_phase, torch,
            args.seed, "configs/autoencoder/base.yaml"),
        "base_ldmk.yaml --landmark": phase(
            "train-first-stage base_ldmk.yaml", first_stage_variant_phase,
            torch, args.seed, "configs/autoencoder/base_ldmk.yaml",
            landmark=True)}
    variant_runs = phase("variants", variants_phase, torch, args.seed)
    i3d = phase("i3d", i3d_phase, torch, args.seed)
    gold = phase("golden", golden_phase, torch, args.seed)
    distributed = phase("distributed", distributed_phase, torch, args.seed)
    pipe = result.pop("pipe")
    prof = phase("profile", profile_phase, torch, pipe, args.seed)
    profiling = phase("profiling", profiling_phase, torch, pipe, args.seed)

    timed = {path: counts for path, counts in {
        **result["launches"], **longvid_result["launches"]}.items()
        if "warm-up" not in path}
    timed["cli sample"] = cli_result["launches"]
    timed["longvid cli sample"] = longvid_cli["launches"]
    timed["atom run_directory"] = atom["launches"]
    timed["audio"] = audio["launches"]
    timed["audio bf16"] = audio16["launches"]
    timed["align"] = align["launches"]
    timed["align bf16"] = align16["launches"]
    timed["train-diffusion"] = train_diff["launches"]
    timed["train-diffusion modular"] = train_diff_modular["launches"]
    for what, run in train_longvid["runs"].items():
        timed[what] = run["launches"]
    timed["train-atom"] = train_atom["launches"]
    timed["train-first-stage"] = first_stage["launches"]
    for what, run in variants.items():
        timed[f"train-first-stage {what}"] = run["launches"]
    timed["golden record"] = gold["launches"]
    for p in ("fused", "modular"):
        timed[f"variants clip32 sample {p}"] = \
            variant_runs["clip32"][p]["launches"]
    timed["variants clip8 train-first-stage"] = \
        variant_runs["clip8"]["launches"]
    ae_heads = {f"variants AE {h}x{d} {part}": variant_runs[
        f"ae_heads{h}x{d}"][part] for h, d in VARIANT_AE_HEADS
        for part in ("extract", "decode")}
    for what, run in ae_heads.items():
        timed[what] = run["launches"]
    timed["head_parallel_attention"] = distributed["tp_launches"]
    timed["sample --data-parallel 1"] = distributed["sample_launches"]
    # one line entry per kernel: its first row, the shape its main path
    # gives it; the rows at its other shapes go under "other_shapes". A row
    # with an "entry" (the float32 pre-pass and bf16 K ring at head dim 64
    # past resident K, fused_attention_f32_prerounded; the bf16 narrow tile
    # at head dims 40 to 56, fused_attention_narrow; the time kernel staged
    # at 24 and 32 frames, divided_time_attention_staged; the time backward
    # staged at 8 frames, divided_time_attention_backward_staged) is an
    # entry of its
    # own, named by that entry point, its launches those of its entry point
    # (and of its float32 twin, ``<entry>_f32``, where the float32 library
    # has one) on the paths that count by entry point (the train-diffusion
    # phases, the variants' 32-frame sampling and reference windows, their
    # 8-frame train-first-stage: the float32 space kernel's cluster plan,
    # SPACE_F32_CLUSTER_ENTRY, and the staged time kernel and backward at 8
    # frames, STAGED_TIME_BACKWARD_ENTRY)
    by_entry_paths = {
        "train-diffusion": train_diff["launches_by_entry"],
        "train-diffusion modular": train_diff_modular["launches_by_entry"],
        **{what: run["launches_by_entry"]
           for what, run in train_longvid["runs"].items()},
        **{f"variants clip32 sample {p}":
           variant_runs["clip32"][p]["launches_by_entry"]
           for p in ("fused", "modular")},
        "variants clip32 reference":
            variant_runs["clip32"]["reference"]["launches_by_entry"],
        "variants channels192 reference":
            variant_runs["channels192"]["reference"]["launches_by_entry"],
        "variants clip8 train-first-stage":
            variant_runs["clip8"]["launches_by_entry"]}
    kernels = {}
    for row in rows:
        if "entry" in row:
            row = dict(row, name=row["entry"], wrapper=row["name"])
        if row["name"] in kernels:
            kernels[row["name"]].setdefault("other_shapes", []).append(
                {k: row[k] for k in ("shape", "heads", "dtype", "source",
                                     "design", "oracle",
                                     "max_abs_err",
                                     "rel_max_err", "rel_rms_err",
                                     "rel_q_err", "route_rel_err",
                                     "bf16_rounded_share", "ms",
                                     "plain_ms", "recompute_ms",
                                     "library_ms", "bound_ms",
                                     "bound_by", "forced")
                 if k in row})
            continue
        kernels[row["name"]] = row
        if "entry" in row:
            row["launches_by_path"] = {
                p: c.get(row["entry"], 0) + c.get(row["entry"] + "_f32", 0)
                for p, c in by_entry_paths.items()}
            row["launches"] = sum(row["launches_by_path"].values())
            if not row["launches"]:
                raise AssertionError(f"{row['entry']}: launched no time on "
                                     f"the paths {by_entry_paths}")
            continue
        row["launches_by_path"] = {p: c[row["name"]] for p, c in timed.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        by_path = {**result["launches_by_shape"],
                   **longvid_result["launches_by_shape"],
                   "longvid cli sample": longvid_cli["launches_by_shape"],
                   "train-diffusion": train_diff["launches_by_shape"],
                   "train-diffusion modular":
                       train_diff_modular["launches_by_shape"],
                   **{what: run["launches_by_shape"]
                      for what, run in train_longvid["runs"].items()},
                   "train-first-stage": first_stage["launches_by_shape"],
                   **{f"train-first-stage {what}": run["launches_by_shape"]
                      for what, run in variants.items()},
                   "golden record": gold["launches_by_shape"],
                   **{f"variants clip32 sample {p}":
                      variant_runs["clip32"][p]["launches_by_shape"]
                      for p in ("fused", "modular")},
                   "variants clip8 train-first-stage":
                       variant_runs["clip8"]["launches_by_shape"],
                   **{what: run["launches_by_shape"]
                      for what, run in ae_heads.items()}}
        row["launches_by_shape"] = {
            p: by[row["name"]] for p, by in by_path.items()
            if "warm-up" not in p and row["name"] in by}
    kernels["fused_attention"]["note"] = (
        "op-level only: reached through ops.attention.sdpa_fused, which no "
        "model path calls; launched by the kernels phase")
    kernels["divided_space_attention"]["note"] = (
        "at head dims other than 64, and at 64 in float32 past 1152 tokens, "
        "one counted launch is two kernels: the rotation pre-pass "
        "(space_rotate_kernel) and the tile")
    seconds = time.perf_counter() - t_start
    log(f"every phase passed in {seconds:.1f} s, the build included")
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
        "audio_bf16": audio16, "align_bf16": align16,
        "train_diffusion": {k: train_diff[k] for k in (
            "steps_per_s", "clips_per_s", "peak_gib", "losses",
            "launches_by_entry", "card_vs_cpu", "trace")},
        "train_diffusion_modular": {k: train_diff_modular[k] for k in (
            "steps_per_s", "clips_per_s", "peak_gib", "losses",
            "launches_by_entry", "card_vs_cpu", "trace")},
        "train_atom": {k: train_atom[k] for k in (
            "sequences_per_s", "card_vs_cpu_loss_rel_err", "adan_aligned",
            "parameters", "trace")},
        "train_first_stage": {k: first_stage[k] for k in (
            "iterations_per_s", "clips_per_s", "g_step_ms", "d_step_ms",
            "peak_gib", "backward_ms", "backward_share",
            "card_vs_cpu", "trace")},
        "longvid": {
            **longvid,
            "frames_per_s": {
                "sample_independent": longvid_result["sample_independent_fps"],
                "sample_long": longvid_result["sample_long_fps"]},
            "launches_by_shape": longvid_result["launches_by_shape"],
            "cli_sample": longvid_cli,
            "train_diffusion": train_longvid},
        "first_stage_variants": variants,
        "variants": variant_runs,
        "i3d": i3d,
        "golden": {k: gold[k] for k in (
            "convert_s", "lpips_card_vs_cpu_rel_err", "record_s", "check_s",
            "small_s", "small_card_vs_cpu")},
        "distributed": {k: distributed[k] for k in ("init_s", "step_exact",
                                                    "tp")},
        "profiling": profiling,
        "gradients": grads, "masked_padding": masked, "card": card,
        "profile": prof,
        "phase_seconds": PHASE_SECONDS,
        "seconds": seconds}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
