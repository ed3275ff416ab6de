"""Sampling-time MToV data (port of the sampling part of
``moditalker_tpu/data/mtov_dataset.py``, ref MToV/tools/dataloader_sample.py
and data_utils.py): numpy/PIL host-side preprocessing that yields
channels-last [T, H, W, 3] windows.

Reference semantics kept:
  * reference frame = first frame of the identity repeated ×T;
  * landmark maps = white radius-3 dots on black 256² (dataloader.py:166-189);
  * the pose-masked video zeroes everything below landmark 33's y
    (dataloader.py:135-144).

The training dataset (random windows, the infinite sampler) is not ported
yet.
"""

from __future__ import annotations

import os
import re

import numpy as np


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _disk_offsets(radius: int = 3) -> np.ndarray:
    """Filled-circle pixel offsets matching cv2.circle(thickness=-1)."""
    r = radius
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = xs**2 + ys**2 <= r**2 + 1  # cv2's disk is slightly generous
    return np.stack([ys[mask], xs[mask]], axis=-1)


_DOT = _disk_offsets(3)


def rasterize_landmarks(landmarks: np.ndarray, size: int = 256,
                        src_wh: int | None = None) -> np.ndarray:
    """[T, 68, 2] int landmarks → [T, size, size, 3] uint8 white-dot maps
    (ref dataloader.py:166-189, flip=False path)."""
    t = landmarks.shape[0]
    src_wh = size if src_wh is None else src_wh
    pts = landmarks[..., :2].astype(np.int64)
    pts = (pts.astype(np.float64) / src_wh * size).astype(np.int64)
    img = np.zeros((t, size, size), np.uint8)
    for b in range(t):
        pix = pts[b][:, None, :] + _DOT[None, :, ::-1]  # offsets are (y, x)
        pix = pix.reshape(-1, 2)
        ys = np.clip(pix[:, 1], 0, size - 1)
        xs = np.clip(pix[:, 0], 0, size - 1)
        img[b, ys, xs] = 255
    return np.repeat(img[..., None], 3, axis=-1)


def crop_lower_half(img: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """Zero rows below landmark 33's y (ref dataloader.py:135-144).
    img [H, W, C] uint8."""
    out = img.copy()
    y = int(landmarks[33][1])
    out[max(y, 0):, :, :] = 0
    return out


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with torch ``F.interpolate(align_corners=False)``
    semantics (half-pixel centers, NO antialiasing — PIL's resize
    antialiases and does not match). img [..., H, W, C]."""
    h, w = img.shape[-3], img.shape[-2]

    def axis_coords(out_n, in_n):
        src = (np.arange(out_n, dtype=np.float64) + 0.5) * (in_n / out_n) - 0.5
        src = np.clip(src, 0, in_n - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_n - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, yf = axis_coords(out_h, h)
    xlo, xhi, xf = axis_coords(out_w, w)
    top = img[..., ylo, :, :]
    bot = img[..., yhi, :, :]
    yf = yf[:, None, None]
    rows = top * (1 - yf) + bot * yf
    left = rows[..., :, xlo, :]
    right = rows[..., :, xhi, :]
    xf = xf[None, :, None]
    return (left * (1 - xf) + right * xf).astype(np.float32)


def resize_crop(video: np.ndarray, resolution: int) -> np.ndarray:
    """Center-crop to square then bilinear-resize (ref data_utils.py:73-97).
    video [T, H, W, C] float → [T, res, res, C]."""
    t, h, w, c = video.shape
    if h > w:
        half = (h - w) // 2
        video = video[:, half : half + w]
    else:
        half = (w - h) // 2
        video = video[:, :, half : half + h]
    if video.shape[1] == resolution:
        return video.astype(np.float32)
    return bilinear_resize(video, resolution, resolution)


def to_model_range(video_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float [-1,1] (ref trainer.py:73: x/127.5 - 1)."""
    return video_u8.astype(np.float32) / 127.5 - 1.0


class SequentialWindowDataset:
    """Sequential 16-frame windows over one identity's frames + ALIGNED
    landmarks (AToM output) — the sampling-time dataset
    (ref tools/dataloader_sample.py:181-250; __len__ = total // nframes).

    ``frames_dir``: directory of jpg/png frames; ``aligned_dir``: directory
    of per-frame [68, 2] .npy landmark files (motion-align output);
    ``kpt_dir`` (optional): the identity's TRAINING keypoints
    (non-face-centric/posed) used for the pose mask — the reference masks
    with these, not with the aligned landmarks, at sample time too
    (dataloader_sample.py:216, dataloader_sample_crossID.py:216). Without
    ``kpt_dir`` the aligned landmarks mask (self-recon equivalent).
    """

    def __init__(self, frames_dir: str, aligned_dir: str, nframes: int = 16,
                 resolution: int = 256, kpt_dir: str | None = None):
        self.frames_dir = frames_dir
        self.aligned_dir = aligned_dir
        self.kpt_dir = kpt_dir
        self.nframes = nframes
        self.resolution = resolution
        self.frames = sorted(
            (f for f in os.listdir(frames_dir)
             if f.lower().endswith((".jpg", ".png"))), key=natsort_key)
        self.lms = sorted(
            (f for f in os.listdir(aligned_dir) if f.endswith(".npy")),
            key=natsort_key)
        self.n = min(len(self.frames), len(self.lms))

    @classmethod
    def cross_id(cls, aligned_root: str, audio_id: str, ref_id: str,
                 frames_root: str, kpt_root: str | None = None,
                 nframes: int = 16, resolution: int = 256
                 ) -> "SequentialWindowDataset":
        """Reference cross-ID directory convention
        (dataloader_sample_crossID.py:31,187-189): aligned landmarks at
        ``{aligned_root}/audio_{audio_id}/id_{ref_id}`` follow the DRIVING
        AUDIO identity while frames come from ``{frames_root}/{ref_id}``
        (the reference identity) and the pose mask from that identity's own
        training keypoints ``{kpt_root}/{ref_id}``."""
        aligned_dir = os.path.join(aligned_root, f"audio_{audio_id}",
                                   f"id_{ref_id}")
        return cls(os.path.join(frames_root, ref_id), aligned_dir,
                   nframes=nframes, resolution=resolution,
                   kpt_dir=(os.path.join(kpt_root, ref_id)
                            if kpt_root else None))

    def __len__(self):
        return self.n // self.nframes

    def _frame(self, fname):
        from PIL import Image

        img = Image.open(os.path.join(self.frames_dir, fname))
        return np.asarray(img.convert("RGB"), np.float32)

    def __getitem__(self, index: int) -> dict:
        lo = index * self.nframes
        clip = self.frames[lo : lo + self.nframes]
        lm_files = self.lms[lo : lo + self.nframes]
        vid = np.stack([self._frame(f) for f in clip])
        ref = np.stack([self._frame(self.frames[0])] * len(clip))
        kpts = np.stack([
            np.load(os.path.join(self.aligned_dir, f)) for f in lm_files])
        if self.kpt_dir is not None:
            mask_kpts = np.stack([
                np.load(os.path.join(
                    self.kpt_dir, c.rsplit(".", 1)[0] + ".npy"))
                for c in clip])
        else:
            mask_kpts = kpts
        masked = np.stack([
            crop_lower_half(v.astype(np.uint8), k).astype(np.float32)
            for v, k in zip(vid, mask_kpts)])
        ldmk = rasterize_landmarks(kpts, size=256,
                                   src_wh=vid.shape[2]).astype(np.float32)
        res = self.resolution
        return {
            "x_ref": resize_crop(ref, res),
            "x": resize_crop(vid, res),
            "x_l": ldmk if ldmk.shape[1] == res else resize_crop(ldmk, res),
            "masked_x": resize_crop(masked, res),
        }

    def windows(self, batch: int = 1, uint8: bool = False):
        """Yield batched windows for the sampling pipeline.

        ``uint8=True`` yields [0,255] uint8 frames (the pipeline converts
        to model range on the device: 4x less upload per window).
        Quantizing the bilinear-resize fractions to uint8 matches the
        reference, whose PIL resize operates on uint8 images
        (data_utils.py:73-97); at the stored 256->256 operating point the
        cast is exact. Default yields model-range float."""
        def conv(v):
            if uint8:
                return np.clip(np.rint(v), 0, 255).astype(np.uint8)
            return to_model_range(v)

        for i in range(len(self)):
            item = self[i]
            yield {k: conv(v[None].repeat(batch, axis=0))
                   if batch > 1 else conv(v[None])
                   for k, v in item.items()}
