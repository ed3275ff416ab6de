"""Training-data keypoint extraction: the three keypoint sets (port of
``moditalker_tpu/preprocess/keypoints.py``).

Re-implements the core of ``data/data_utils/preprocess/
process_video_3dmm_rollback_hdtf_batchify.py:150-243`` as a pure function
over already-computed 3DMM coefficients and detected landmarks (the
detectors are pluggable, as in ``motion_align``):

  1. **face-centric / unposed** — idexp_lm3d/10 + key_mean_shape  ([68,3]);
  2. **face-centric / posed**   — rigid_transform(rot(angles), translation);
  3. **non-face-centric / posed** (plus the raw flipped FAN detections,
     'fa') — posed landmarks scaled to the 224 template, de-aligned to
     image coords, y-flipped, 5-point-mean matched to the detections.

Output directory layout matches the reference
({out}/face-centric/unposed|posed, {out}/fa, {out}/non-face-centric/posed,
per-frame .npy). The BFM blends and the pose run on float32 CPU tensors, as
the JAX package runs them in float32.
"""

from __future__ import annotations

import os

import numpy as np

from . import align
from .bfm import Face3DHelper, compute_rotation, rigid_transform


def keypoint_sets(
    coeff: np.ndarray,          # [B, 257]
    lm68_fa: np.ndarray,        # [B, 68, 2] detected landmarks (image coords)
    img_sizes: np.ndarray,      # [B, 2] (w, h)
    helper: Face3DHelper,
    lm3d_std: np.ndarray,       # [5, 3]
) -> dict[str, np.ndarray]:
    identity = coeff[:, 0:80]
    exp = coeff[:, 80:144]
    angle = coeff[:, 224:227]
    translation = coeff[:, 254:257]
    b = coeff.shape[0]

    idexp = helper.reconstruct_idexp_lm3d(identity, exp).numpy()  # [B,68,3]
    lm3d = idexp / 10.0 + helper.key_mean_shape[None]      # unposed

    rot = compute_rotation(angle)
    lm3d_rot = rigid_transform(lm3d, rot, translation).numpy()

    # per-frame crop params from the detections
    lm5 = align.lm68_to_lm5(lm68_fa)
    ts, ss = [], []
    for i in range(b):
        p = align.crop_params(tuple(img_sizes[i]), lm5[i], lm3d_std)
        ts.append(np.asarray(p["t"]).reshape(2, 1))
        ss.append(p["s"])
    wh = 224
    lm_224 = (lm3d_rot * wh / 2 + wh / 2).astype(int)
    lm_img = align.de_align_landmarks(
        lm_224[:, :, :2].astype(np.float64), np.stack(ts), np.asarray(ss),
        img_sizes)

    # y-flip both detections and de-aligned landmarks (ref :208-212)
    fa_flipped = np.array(lm68_fa[:, :, :2], copy=True)
    for i in range(b):
        fa_flipped[i, :, 1] = img_sizes[i, 1] - 1 - fa_flipped[i, :, 1]
        lm_img[i, :, 1] = img_sizes[i, 1] - 1 - lm_img[i, :, 1]

    # 5-point mean translation match (ref :227-233)
    delta = (align.lm68_to_lm5(fa_flipped).mean(axis=1)
             - align.lm68_to_lm5(lm_img).mean(axis=1))
    lm_matched = lm_img + delta[:, None, :]

    return {
        "face-centric/unposed": lm3d,
        "face-centric/posed": lm3d_rot,
        "fa": fa_flipped,
        "non-face-centric/posed": lm_matched,
    }


def write_keypoint_sets(sets: dict[str, np.ndarray], out_root: str,
                        identity: str, frame_names: list[str]) -> list[str]:
    paths = []
    for kind, arr in sets.items():
        d = os.path.join(out_root, kind, identity)
        os.makedirs(d, exist_ok=True)
        for i, name in enumerate(frame_names):
            p = os.path.join(d, os.path.splitext(name)[0] + ".npy")
            np.save(p, arr[i])
            paths.append(p)
    return paths


def shard_indices(n_items: int, process_id: int, total_processes: int):
    """Multi-process striping (ref batchify.py:282-288)."""
    return list(range(process_id, n_items, total_processes))
