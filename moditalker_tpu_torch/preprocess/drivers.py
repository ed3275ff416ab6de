"""Runnable corpus drivers for the preprocessing subsystem (port of
``moditalker_tpu/preprocess/drivers.py``).

The reference ships two executable scripts this module re-implements as
library functions behind CLI commands:

  * ``align_motion_corpus`` — the AToM→MToV inference glue
    (``data/data_utils/motion_align/align_face_recon.py:240-348``):
    per identity, detect landmarks + 3DMM coefficients on the pose-driving
    frames, rigid-transform the frontalized AToM landmarks into that pose,
    de-align to image space, write ``aligned_npy/{id}/*.npy``.
  * ``extract_keypoints_corpus`` — training-data keypoint extraction
    (``preprocess/process_video_3dmm_rollback_hdtf_batchify.py:253-321``):
    per identity, per frame batch, detect landmarks → 257-dim coeffs →
    the three keypoint-set trees.

Both keep the reference's operational semantics: multi-process striping by
``--process-id/--total`` (batchify.py:282-288), per-batch try/except resume
(:293-321), and skip-if-already-written restartability.

Detectors are injected as callables (``landmark_fn(frames)->[T,68,2]``,
``coeff_fn(frames, lm5)->[T,257]``) so the drivers run with the production
S3FD+FAN+ReconNet stack or with cheap deterministic synthetic stand-ins
(plumbing tests, smoke runs without checkpoints). The production stack's
checkpoints are the port's ``state_dict``s saved with ``torch.save``
(``utils/convert.py`` makes them from the JAX package's parameters, or from
the reference networks' own checkpoints), in place of the JAX package's
converted orbax params.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import align
from .bfm import Face3DHelper
from .keypoints import keypoint_sets, shard_indices, write_keypoint_sets
from .motion_align import NUM_OF_FRAME, MotionAligner

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _natsort_key(s: str):
    import re

    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def list_frame_files(folder: str) -> list[str]:
    return sorted((f for f in os.listdir(folder)
                   if f.lower().endswith(IMAGE_EXTS)), key=_natsort_key)


def load_frames(folder: str, names: list[str]) -> np.ndarray:
    from PIL import Image

    return np.stack([
        np.asarray(Image.open(os.path.join(folder, n)).convert("RGB"),
                   np.uint8) for n in names])


# ---------------------------------------------------------------- detectors
def synthetic_landmark_fn(frames_u8: np.ndarray) -> np.ndarray:
    """Deterministic stand-in landmarks: a canonical 68-point face layout
    scaled into the central region of each frame (valid input for the POS
    similarity solve — 5-point extraction, crop_params)."""
    t, h, w = frames_u8.shape[:3]
    rng = np.random.default_rng(0)
    base = rng.uniform(0.3, 0.7, (68, 2))  # fixed canonical layout
    # anchor the 5-point rows (eyes/nose/mouth) to a face-like geometry
    base[36:42] = [0.38, 0.42] + rng.uniform(-0.02, 0.02, (6, 2))
    base[42:48] = [0.62, 0.42] + rng.uniform(-0.02, 0.02, (6, 2))
    base[30] = [0.5, 0.55]
    base[48] = [0.40, 0.70]
    base[54] = [0.60, 0.70]
    out = np.empty((t, 68, 2))
    for i in range(t):
        jitter = (frames_u8[i].mean() % 7) / 100.0  # frame-dependent shift
        out[i, :, 0] = (base[:, 0] + jitter) * w
        out[i, :, 1] = (base[:, 1] + jitter) * h
    return out


def synthetic_coeff_fn(frames_u8: np.ndarray, lm5: np.ndarray) -> np.ndarray:
    """Deterministic stand-in 257-dim coefficients: small id/exp, mild pose
    angles derived from the frame index."""
    t = frames_u8.shape[0]
    coeff = np.zeros((t, 257), np.float32)
    rng = np.random.default_rng(1)
    coeff[:, :80] = rng.normal(scale=0.05, size=(t, 80))      # identity
    coeff[:, 80:144] = rng.normal(scale=0.05, size=(t, 64))   # expression
    coeff[:, 224:227] = np.linspace(-0.1, 0.1, t)[:, None]    # angles
    coeff[:, 254:257] = 0.01                                  # translation
    return coeff


def build_detectors(s3fd_ckpt: str | None = None, fan_ckpt: str | None = None,
                    recon_ckpt: str | None = None, bfm_dir: str | None = None,
                    synthetic: bool = False, fused: bool = True, device=None):
    """→ (landmark_fn, coeff_fn, lm3d_std, face3d_helper, fused_aligner).

    Production: ``FanLandmarker.with_s3fd`` + ``Reconstructor`` from the
    port's state_dicts, plus a ``FusedAligner`` over the same weights (one
    device pass per chunk: the motion-alignment hot path; ``fused=False``
    leaves it out), all on ``device`` (default: the card).
    Synthetic: the deterministic stand-ins above (fused_aligner is None).
    """
    if synthetic:
        from .load_mats import synthetic_lm3d_std

        return (synthetic_landmark_fn, synthetic_coeff_fn,
                synthetic_lm3d_std(), Face3DHelper.synthetic(), None)
    if not (s3fd_ckpt and fan_ckpt and recon_ckpt):
        raise ValueError(
            "production detectors need --s3fd-ckpt, --fan-ckpt and "
            "--recon-ckpt (the port's state_dicts); or pass "
            "--synthetic-detectors")
    import torch

    from .fan import FanLandmarker
    from .reconstructor import Reconstructor

    fan_state, s3fd_state, recon_state = (
        torch.load(p, map_location="cpu", weights_only=True)
        for p in (fan_ckpt, s3fd_ckpt, recon_ckpt))
    landmarker = FanLandmarker.with_s3fd(fan_state, s3fd_state,
                                         device=device)
    recon = Reconstructor(recon_state, bfm_dir=bfm_dir, device=device)
    helper = (Face3DHelper.from_bfm(bfm_dir) if bfm_dir
              else Face3DHelper.synthetic())
    fused_aligner = None
    if fused:
        from .fused_align import FusedAligner

        fused_aligner = FusedAligner(s3fd_state, fan_state, recon_state,
                                     recon.lm3d_std, device=device)
    return landmarker, recon.coeff_fn(), recon.lm3d_std, helper, \
        fused_aligner


# ------------------------------------------------------------- align-motion
def _find_frontalized(frontalized_root: str, identity: str) -> str | None:
    """frontalized_npy/{id}/atom_*.npy (reference layout,
    AToM/inference.py:164) or any single .npy for the identity."""
    d = os.path.join(frontalized_root, identity)
    if not os.path.isdir(d):
        d = frontalized_root
    cands = sorted((f for f in os.listdir(d) if f.endswith(".npy")),
                   key=_natsort_key)
    preferred = [f for f in cands if f.startswith("atom")]
    pick = (preferred or cands)
    return os.path.join(d, pick[0]) if pick else None


def align_motion_corpus(
    frontalized_root: str,
    frames_root: str,
    out_root: str,
    landmark_fn,
    coeff_fn,
    lm3d_std: np.ndarray,
    chunk: int = NUM_OF_FRAME,
    process_id: int = 0,
    total_processes: int = 1,
    resume: bool = True,
    on_error: str = "skip",
    fused=None,
) -> dict[str, int]:
    """Align every identity's frontalized landmarks to its driving frames.

    Layout in: ``{frontalized_root}/{id}/atom_*.npy`` ([T,68,3]) +
    ``{frames_root}/{id}/*.jpg``; out: ``{out_root}/aligned_npy/{id}/*.npy``
    ([68,2] int). Returns {identity: frames written}. Identities stripe
    across processes; completed identities are skipped on resume.
    ``fused``: an optional ``fused_align.FusedAligner`` — the one-dispatch
    hot path; the modular callables stay as the detection-gap fallback.
    """
    ids = sorted(d for d in os.listdir(frames_root)
                 if os.path.isdir(os.path.join(frames_root, d)))
    aligner = MotionAligner(landmark_fn, coeff_fn, lm3d_std, fused=fused)
    written: dict[str, int] = {}
    for i in shard_indices(len(ids), process_id, total_processes):
        identity = ids[i]
        try:
            npy = _find_frontalized(frontalized_root, identity)
            if npy is None:
                print(f"{identity}: no frontalized npy, skipped",
                      file=sys.stderr)
                continue
            lm68_atom = np.load(npy).astype(np.float64)  # [T, 68, 3]
            frame_dir = os.path.join(frames_root, identity)
            frames = list_frame_files(frame_dir)
            t = min(lm68_atom.shape[0], len(frames))
            out_dir = os.path.join(out_root, "aligned_npy", identity)
            if resume and os.path.isdir(out_dir) and len(
                    [f for f in os.listdir(out_dir)
                     if f.endswith(".npy")]) >= t:
                written[identity] = 0
                continue
            os.makedirs(out_dir, exist_ok=True)
            n = 0
            # chunked processing (ref align_face_recon.py:315,:337 —
            # NUM_OF_FRAME chunks of the HORIZON sequence)
            for lo in range(0, t, chunk):
                hi = min(lo + chunk, t)
                fchunk = load_frames(frame_dir, frames[lo:hi])
                aligned = aligner.align_sequence(lm68_atom[lo:hi], fchunk)
                for j in range(aligned.shape[0]):
                    np.save(os.path.join(out_dir, f"{lo + j:05d}.npy"),
                            aligned[j].astype(np.int64))
                    n += 1
            written[identity] = n
            print(f"{identity}: aligned {n} frames", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — ref :319-321 blanket resume
            if on_error != "skip":
                raise
            print(f"{identity}: FAILED ({e}), continuing", file=sys.stderr)
    return written


# -------------------------------------------------------- extract-keypoints
KEYPOINT_TREES = ("face-centric/unposed", "face-centric/posed", "fa",
                  "non-face-centric/posed")


def _frame_done(out_root: str, identity: str, frame_name: str) -> bool:
    stem = os.path.splitext(frame_name)[0] + ".npy"
    return all(
        os.path.exists(os.path.join(out_root, tree, identity, stem))
        for tree in KEYPOINT_TREES)


def extract_keypoints_corpus(
    frames_root: str,
    out_root: str,
    landmark_fn,
    coeff_fn,
    helper: Face3DHelper,
    lm3d_std: np.ndarray,
    batch_size: int = 16,
    process_id: int = 0,
    total_processes: int = 1,
    resume: bool = True,
    on_error: str = "skip",
) -> dict[str, int]:
    """Extract the three keypoint-set trees (+ raw 'fa' detections) for every
    frame of every identity (ref batchify.py:253-321). Identities stripe
    across processes; frames with all four outputs present are skipped on
    resume; a failing batch is logged and skipped (ref :319-321)."""
    ids = sorted(d for d in os.listdir(frames_root)
                 if os.path.isdir(os.path.join(frames_root, d)))
    written: dict[str, int] = {}
    for i in shard_indices(len(ids), process_id, total_processes):
        identity = ids[i]
        frame_dir = os.path.join(frames_root, identity)
        frames = list_frame_files(frame_dir)
        if resume:
            frames = [f for f in frames
                      if not _frame_done(out_root, identity, f)]
        n = 0
        for lo in range(0, len(frames), batch_size):
            names = frames[lo : lo + batch_size]
            try:
                batch = load_frames(frame_dir, names)
                h, w = batch.shape[1:3]
                lm68 = np.asarray(landmark_fn(batch))
                lm5 = align.lm68_to_lm5(lm68)
                coeff = np.asarray(coeff_fn(batch, lm5))
                sizes = np.tile([[w, h]], (batch.shape[0], 1))
                sets = keypoint_sets(coeff, lm68, sizes, helper, lm3d_std)
                write_keypoint_sets(sets, out_root, identity, names)
                n += len(names)
            except Exception as e:  # noqa: BLE001 — ref :319-321
                if on_error != "skip":
                    raise
                print(f"{identity} batch @{lo}: FAILED ({e}), continuing",
                      file=sys.stderr)
        written[identity] = n
        print(f"{identity}: {n} frames extracted", file=sys.stderr)
    return written
