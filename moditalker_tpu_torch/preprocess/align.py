"""Face alignment math: POS similarity solve, 5-point extraction, 224-crop
transform and its inverse (the port's copy of
``moditalker_tpu/preprocess/align.py``, numpy only).

Re-implements the pure math of ``deep_3drecon/util/preprocess.py`` and the
de-alignment of ``preprocess/process_video_3dmm_rollback_hdtf_batchify.py``:
  * ``pos_solve`` — least-squares similarity between image 5-landmarks and
    the BFM standard 3D 5-landmarks (preprocess.py:20-44);
  * ``extract_5p`` / ``lm68_to_lm5`` — 68→5 landmark reduction
    (preprocess.py:199-206, batchify.py:40-54);
  * ``crop_params`` / ``transform_landmarks_to_crop`` — the resize-n-crop
    transform applied to landmarks (resize_n_crop_img, preprocess.py:151-176);
  * ``de_align_landmarks`` — inverse transform back to image coordinates
    (batchify.py:100-124).

Everything is batched numpy (host-side; these run once per frame during
preprocessing and parity matters more than device speed). The image
resampling itself stays on host via PIL (bicubic, like the reference).
"""

from __future__ import annotations

import numpy as np

LM5_FROM_68 = np.array([31, 37, 40, 43, 46, 49, 55]) - 1


def extract_5p(lm68: np.ndarray) -> np.ndarray:
    """[68, 2+] → [5, 2+] (ref preprocess.py:199-206): order
    (left-eye, right-eye, nose, left-mouth, right-mouth)."""
    i = LM5_FROM_68
    lm5 = np.stack([
        lm68[i[0]],
        lm68[i[[1, 2]]].mean(axis=0),
        lm68[i[[3, 4]]].mean(axis=0),
        lm68[i[5]],
        lm68[i[6]],
    ], axis=0)
    return lm5[[1, 2, 0, 3, 4]]


def lm68_to_lm5(lm68: np.ndarray) -> np.ndarray:
    """Batched [B, 68, :] → [B, 5, 2] (ref batchify.py:40-54)."""
    return np.stack([extract_5p(l)[:, :2] for l in lm68])


def pos_solve(lm5_img: np.ndarray, lm5_3d: np.ndarray):
    """Least-squares perspective-free similarity (ref POS, preprocess.py:20-44).

    lm5_img: [5, 2] image landmarks; lm5_3d: [5, 3] BFM standard landmarks.
    Returns (t [2,1], s scalar).
    """
    xp = lm5_img.T  # [2, 5]
    x = lm5_3d.T    # [3, 5]
    npts = xp.shape[1]
    A = np.zeros([2 * npts, 8])
    A[0 : 2 * npts - 1 : 2, 0:3] = x.T
    A[0 : 2 * npts - 1 : 2, 3] = 1
    A[1 : 2 * npts : 2, 4:7] = x.T
    A[1 : 2 * npts : 2, 7] = 1
    b = xp.T.reshape(2 * npts, 1)
    k, *_ = np.linalg.lstsq(A, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    t = np.stack([k[3], k[7]], axis=0)
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    return t, float(s)


def crop_params(img_size, lm5_img, lm5_3d, rescale_factor: float = 102.0,
                target_size: float = 224.0) -> dict:
    """Transform parameters for the 224² BFM crop
    (ref trans_params_extract, preprocess.py:258-290)."""
    t, scale = pos_solve(lm5_img[:, :2], lm5_3d)
    s = rescale_factor / scale
    # Degenerate landmarks (collapsed/garbage detections) make the POS scale
    # arbitrarily small or negative, and the downstream resize (w0·s, h0·s)
    # then overflows int32 / allocates absurd canvases. Clamp so the resized
    # image stays within [target, 16k] on its longest side — a no-op for any
    # real face (reference op point: s ≈ 0.4–2).
    w0, h0 = img_size
    longest = max(float(w0), float(h0), 1.0)
    s = float(np.clip(s, target_size / longest, 16384.0 / longest))
    return {"t": t, "s": s, "img_size": tuple(img_size),
            "target_size": target_size}


def transform_landmarks_to_crop(lm: np.ndarray, params: dict) -> np.ndarray:
    """Apply the resize-n-crop transform to [N, 2] landmarks
    (ref resize_n_crop_img lm path, preprocess.py:167-168)."""
    w0, h0 = params["img_size"]
    s = params["s"]
    t = np.asarray(params["t"]).reshape(2)
    target = params["target_size"]
    w = np.int32(w0 * s)
    h = np.int32(h0 * s)
    lm_new = np.stack(
        [lm[:, 0] - t[0] + w0 / 2, lm[:, 1] - t[1] + h0 / 2], axis=1) * s
    return lm_new - np.array([w / 2 - target / 2, h / 2 - target / 2])


def crop_box(params: dict) -> tuple[int, int, int, int]:
    """(left, up, right, below) crop box in the resized image
    (ref resize_n_crop_img, preprocess.py:151-160)."""
    w0, h0 = params["img_size"]
    s = params["s"]
    t = np.asarray(params["t"]).reshape(2)
    target = params["target_size"]
    w = np.int32(w0 * s)
    h = np.int32(h0 * s)
    left = np.int32(w / 2 - target / 2 + float((t[0] - w0 / 2) * s))
    up = np.int32(h / 2 - target / 2 + float((h0 / 2 - t[1]) * s))
    return int(left), int(up), int(left + target), int(up + target)


def align_img(pil_img, lm5_img, lm5_3d, rescale_factor: float = 102.0,
              target_size: float = 224.0):
    """PIL image + landmarks → (params, 224² PIL crop, transformed lm)
    (ref align_img, preprocess.py:292-325). Bicubic resize like the ref."""
    from PIL import Image

    params = crop_params(pil_img.size, lm5_img, lm5_3d, rescale_factor,
                         target_size)
    w0, h0 = pil_img.size
    s = params["s"]
    w = int(np.int32(w0 * s))
    h = int(np.int32(h0 * s))
    img = pil_img.resize((w, h), resample=Image.BICUBIC)
    img = img.crop(crop_box(params))
    lm_new = transform_landmarks_to_crop(lm5_img, params)
    return params, img, lm_new


def de_align_landmarks(lm68_crop: np.ndarray, params_t: np.ndarray,
                       params_s: np.ndarray, img_sizes: np.ndarray,
                       temp_size: float = 224.0) -> np.ndarray:
    """Batched inverse of the crop transform (ref de_aligning_ldmk,
    batchify.py:100-124).

    lm68_crop: [B, 68, 2] in 224² coords; params_t: [B, 2, 1]; params_s: [B];
    img_sizes: [B, 2] (w, h). Returns [B, 68, 2] in original image coords.
    """
    b = lm68_crop.shape[0]
    w0 = img_sizes[:, 0].astype(np.float64)
    h0 = img_sizes[:, 1].astype(np.float64)
    s = np.asarray(params_s, np.float64)
    w = (w0 * s).astype(np.int32)
    h = (h0 * s).astype(np.int32)
    shift = np.stack([w / 2 - temp_size / 2, h / 2 - temp_size / 2],
                     axis=1)[:, None, :]  # [B,1,2]
    lm = lm68_crop + shift
    t = np.asarray(params_t).reshape(b, 2)
    lm = np.stack(
        [lm[:, :, 0] + t[:, 0:1] - w0[:, None] / 2,
         lm[:, :, 1] + t[:, 1:2] - h0[:, None] / 2], axis=2)
    return lm / s[:, None, None]


def flip_y(lm: np.ndarray, height: float) -> np.ndarray:
    """Vertical flip of landmark y coords (the reference's cv2.flip-then-
    index convention, align_face_recon.py:275-291)."""
    out = np.array(lm, copy=True)
    out[..., 1] = height - out[..., 1]
    return out


def mean_point_align(lm_src: np.ndarray, lm_ref: np.ndarray) -> np.ndarray:
    """Translate src so its 5-point mean matches ref's
    (ref batchify.py:199-242 mean-point translation match)."""
    src5 = lm68_to_lm5(lm_src[None] if lm_src.ndim == 2 else lm_src)
    ref5 = lm68_to_lm5(lm_ref[None] if lm_ref.ndim == 2 else lm_ref)
    delta = ref5.mean(axis=1) - src5.mean(axis=1)  # [B, 2]
    if lm_src.ndim == 2:
        return lm_src + delta[0]
    return lm_src + delta[:, None, :]
