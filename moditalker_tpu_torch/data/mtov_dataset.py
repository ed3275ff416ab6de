"""MToV data (port of ``moditalker_tpu/data/mtov_dataset.py``, ref
MToV/tools/dataloader.py, dataloader_sample.py and data_utils.py): numpy/PIL
host-side preprocessing that yields channels-last [T, H, W, 3] videos.

Reference semantics kept:
  * a random 16-frame window per training item; clips shorter than 16 use
    an 8-frame window left-padded with zeros (dataloader.py:196-203,
    247-252);
  * reference frame = first frame of the clip (training) or of the identity
    (sampling) repeated ×T;
  * landmark maps = white radius-3 dots on black 256² (dataloader.py:166-189);
  * the pose-masked video zeroes everything below landmark 33's y
    (dataloader.py:135-144);
  * identity split by a held-out id list (dataloader.py:81-83); the
    InfiniteSampler's rank-strided shuffled stream (data_utils.py:390-421).

Reading frames needs PIL; without it the datasets raise.
"""

from __future__ import annotations

import os
import re
import sys

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


def _pil_image():
    """PIL's ``Image``; raises ImportError on a host without PIL (the frame
    datasets read jpg/png through it, and nothing stands in for it)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading frame directories needs PIL (Pillow), "
                          "which this host lacks; use --synthetic or a host "
                          "with Pillow") from e
    return Image


class InfiniteSampler:
    """Rank-strided infinite shuffled stream (ref data_utils.py:390-421)."""

    def __init__(self, n: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 window_size: float = 0.5):
        self.n = n
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(self.n)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class HDTFFramesDataset:
    """Per-identity frame directories + per-frame landmark .npy files: the
    second-stage training data.

    Layout: ``{data_root}/{identity}/{frame:05d}.jpg`` and
    ``{kpt_root}/{identity}/{frame:05d}.npy`` ([68, 2] image-space ints) —
    the reference's on-disk format (dataloader.py:38-39, 214-223). Needs
    PIL: on a host without it the constructor raises.
    """

    def __init__(self, data_root: str, kpt_root: str, nframes: int = 16,
                 resolution: int = 256, train: bool = True,
                 holdout_ids: set[str] | None = None, seed: int = 0):
        self._image = _pil_image()
        self.data_root = data_root
        self.kpt_root = kpt_root
        self.nframes = nframes
        self.resolution = resolution
        self.rng = np.random.default_rng(seed)
        holdout_ids = holdout_ids or set()
        ids = sorted(
            d for d in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, d)))
        # reference: train = identities NOT in the holdout list (:81-83)
        self.identities = [
            i for i in ids if (i not in holdout_ids) == train]
        self.dirs = [os.path.join(data_root, i) for i in self.identities]

    def __len__(self):
        return len(self.dirs)

    def _load_frame(self, folder: str, fname: str) -> np.ndarray:
        img = self._image.open(os.path.join(folder, fname))
        return np.asarray(img.convert("RGB"), np.float32)  # H W 3, 0..255

    def _load_kpt(self, identity: str, fname: str) -> np.ndarray:
        p = os.path.join(self.kpt_root, identity,
                         fname.rsplit(".", 1)[0] + ".npy")
        return np.load(p)

    def __getitem__(self, index: int) -> dict:
        folder = self.dirs[index]
        identity = self.identities[index]
        frames = sorted(
            (f for f in os.listdir(folder)
             if f.lower().endswith((".jpg", ".png"))), key=natsort_key)
        n = self.nframes
        if len(frames) < n:
            prefix = int(self.rng.integers(0, len(frames) - n // 2 + 1))
            clip = frames[prefix : prefix + n // 2]
        else:
            prefix = int(self.rng.integers(0, len(frames) - n + 1))
            clip = frames[prefix : prefix + n]

        vid = np.stack([self._load_frame(folder, f) for f in clip])
        ref = np.stack([self._load_frame(folder, clip[0])] * len(clip))
        kpts = np.stack([self._load_kpt(identity, f) for f in clip])
        masked = np.stack([
            crop_lower_half(v.astype(np.uint8), k).astype(np.float32)
            for v, k in zip(vid, kpts)])
        ldmk = rasterize_landmarks(kpts, size=256,
                                   src_wh=vid.shape[2]).astype(np.float32)

        res = self.resolution
        out = {
            "x_ref": resize_crop(ref, res),
            "x": resize_crop(vid, res),
            "x_l": ldmk if ldmk.shape[1] == res else resize_crop(ldmk, res),
            "masked_x": resize_crop(masked, res),
            "index": index,
        }
        # short clips: zero-pad the FIRST half (ref dataloader.py:247-252)
        if len(clip) == n // 2:
            for k in ("x", "x_l", "masked_x"):
                out[k] = np.concatenate(
                    [np.zeros_like(out[k]), out[k]], axis=0)
            out["x_ref"] = np.concatenate([out["x_ref"], out["x_ref"]], axis=0)
        return out

    def batches(self, batch_size: int, rank: int = 0, num_replicas: int = 1,
                seed: int = 0, skip_bad_items: bool = True):
        """Infinite stream of collated training batches, float [-1, 1].

        ``skip_bad_items`` keeps the reference's fault tolerance (corrupt
        frames and missing landmark files are skipped, as the blanket
        except-continue of its preprocessing loops does,
        process_video_3dmm...py:319-321)."""
        sampler = iter(InfiniteSampler(len(self), rank, num_replicas,
                                       seed=seed))
        while True:
            items = []
            while len(items) < batch_size:
                idx = next(sampler)
                try:
                    items.append(self[idx])
                except (OSError, ValueError, IndexError, KeyError) as e:
                    if not skip_bad_items:
                        raise
                    print(f"skipping bad item {idx}: {e}", file=sys.stderr)
            yield {
                k: to_model_range(np.stack([it[k] for it in items]))
                for k in ("x_ref", "x", "x_l", "masked_x")
            }


def load_holdout_ids(path: str) -> set[str]:
    """Held-out identity list (ref text_folders/train_id.txt semantics,
    dataloader.py:81-83: train = identities NOT in this list)."""
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def synthetic_mtov_batch(batch_size: int = 2, timesteps: int = 16,
                         resolution: int = 256, seed: int = 0) -> dict:
    """Random batch with the training layout, float [-1, 1]."""
    rng = np.random.default_rng(seed)

    def v():
        return rng.uniform(-1, 1, size=(batch_size, timesteps, resolution,
                                        resolution, 3)).astype(np.float32)

    return {"x_ref": v(), "x": v(), "x_l": v(), "masked_x": v()}


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
        img = _pil_image().open(os.path.join(self.frames_dir, fname))
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
