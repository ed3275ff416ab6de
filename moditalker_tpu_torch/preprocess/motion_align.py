"""Motion alignment: frontalized AToM landmarks → pose-matched image-space
landmarks for MToV (port of ``moditalker_tpu/preprocess/motion_align.py``).

The transform chain of ``data/data_utils/motion_align/align_face_recon.py``
(Aligner_3dmm.__call__, :240-348):

  1. per driving frame: 68 2D landmarks and 3DMM coefficients (pluggable
     callables, or one ``FusedAligner`` pass);
  2. rigid-transform AToM's frontalized [T, 68, 3] landmarks into the
     driving pose (rotation from the euler angles, plus the translation);
  3. scale to the 224 BFM template and de-align to image coordinates with
     the POS crop params;
  4. flip y; 5-point mean alignment to the detected landmarks;
  5. write ``aligned_npy/{id}/*.npy`` [68, 2] int arrays, the format MToV's
     samplers read (dataloader_sample.py:32,198).
"""

from __future__ import annotations

import os

import numpy as np

from . import align
from .bfm import compute_rotation, rigid_transform

HORIZON = 156
NUM_OF_FRAME = 75  # chunking constant (ref align_face_recon.py:315)


def pose_align_landmarks(
    lm68_atom: np.ndarray,      # [T, 68, 3] frontalized (AToM output, abs)
    coeff: np.ndarray,          # [T, 257] driving-video 3DMM coefficients
    lm68_driving: np.ndarray,   # [T, 68, 2] detected driving landmarks
    img_sizes: np.ndarray,      # [T, 2] (w, h) driving frame sizes
    lm3d_std: np.ndarray,       # [5, 3] BFM standard landmarks
    crop_t: np.ndarray | None = None,   # [T, 2] precomputed POS translation
    crop_s: np.ndarray | None = None,   # [T] precomputed POS scale
) -> np.ndarray:
    """Returns [T, 68, 2] image-space aligned landmarks, float
    (ref align_face_recon.py:253-293). ``crop_t``/``crop_s``: the POS
    similarity a caller already solved (the fused aligner returns it)."""
    t = lm68_atom.shape[0]
    angles = np.asarray(coeff[:, 224:227], np.float32)
    translation = np.asarray(coeff[:, 254:257], np.float32)
    # the pose in float32, as the JAX package computes it
    lm_r = rigid_transform(np.asarray(lm68_atom, np.float32),
                           compute_rotation(angles), translation).numpy()

    if crop_t is not None and crop_s is not None:
        t_arr = np.asarray(crop_t, np.float64).reshape(t, 2, 1)
        s_arr = np.asarray(crop_s, np.float64)
    else:
        # per-frame similarity params from the driving detections
        lm5 = align.lm68_to_lm5(lm68_driving)
        ts, ss = [], []
        for i in range(t):
            p = align.crop_params(tuple(img_sizes[i]), lm5[i], lm3d_std)
            ts.append(np.asarray(p["t"]).reshape(2, 1))
            ss.append(p["s"])
        t_arr = np.stack(ts)
        s_arr = np.asarray(ss)

    # template scale then de-align (ref :276-277: ×224/2 + 224/2, int cast)
    lm_224 = (lm_r * 224 / 2 + 224 / 2).astype(int)
    lm_img = align.de_align_landmarks(
        lm_224[:, :, :2].astype(np.float64), t_arr, s_arr, img_sizes)

    # vertical flip (ref :283-284: y -> H - 1 - y)
    lm_img[:, :, 1] = np.asarray(img_sizes)[:, 1:2] - 1 - lm_img[:, :, 1]

    # mean-point translation match against the detections (ref :286-292)
    lm5_fa = align.lm68_to_lm5(lm68_driving[:, :, :2])
    lm5_po = align.lm68_to_lm5(lm_img)
    delta = lm5_fa.mean(axis=1) - lm5_po.mean(axis=1)
    return lm_img + delta[:, None, :]


class MotionAligner:
    """Batch aligner with pluggable detectors.

    ``landmark_fn(frames_u8 [T,H,W,3]) -> [T,68,2]``;
    ``coeff_fn(frames_u8, lm5 [T,5,2]) -> [T,257]``.

    With ``fused`` (a ``fused_align.FusedAligner``) the chain runs in one
    device pass per chunk; frames whose detection score misses the
    threshold send the sequence to the modular path (which fills detection
    gaps from the neighbours) unless ``require_detection=False``.
    """

    def __init__(self, landmark_fn, coeff_fn, lm3d_std: np.ndarray,
                 fused=None, require_detection: bool = True):
        self.landmark_fn = landmark_fn
        self.coeff_fn = coeff_fn
        self.lm3d_std = np.asarray(lm3d_std, np.float64)
        self.fused = fused
        self.require_detection = require_detection

    def align_sequence(self, lm68_atom: np.ndarray,
                       driving_frames: np.ndarray) -> np.ndarray:
        t = min(lm68_atom.shape[0], driving_frames.shape[0])
        frames = driving_frames[:t]
        h, w = frames.shape[1:3]
        sizes = np.tile(np.array([[w, h]]), (t, 1))
        if self.fused is not None:
            res = self.fused.process(frames)
            if (res["detected"].all() or not self.require_detection
                    or self.landmark_fn is None):
                return pose_align_landmarks(
                    lm68_atom[:t], res["coeff"], res["lm68"], sizes,
                    self.lm3d_std, crop_t=res["t"], crop_s=res["s"])
        lm68_fa = np.asarray(self.landmark_fn(frames))
        lm5_fa = align.lm68_to_lm5(lm68_fa)
        coeff = np.asarray(self.coeff_fn(frames, lm5_fa))
        return pose_align_landmarks(lm68_atom[:t], coeff, lm68_fa, sizes,
                                    self.lm3d_std)

    def run(self, lm68_atom: np.ndarray, driving_frames: np.ndarray,
            out_dir: str, identity: str) -> list[str]:
        """Write aligned_npy/{identity}/{i:05d}.npy int [68,2] files
        (ref :337-348)."""
        aligned = self.align_sequence(lm68_atom, driving_frames)
        d = os.path.join(out_dir, "aligned_npy", identity)
        os.makedirs(d, exist_ok=True)
        paths = []
        for i in range(aligned.shape[0]):
            p = os.path.join(d, f"{i:05d}.npy")
            np.save(p, aligned[i].astype(np.int64))
            paths.append(p)
        return paths
