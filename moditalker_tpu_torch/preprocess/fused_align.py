"""Fused motion-alignment chunk: S3FD → crop → FAN → POS → crop → ReconNet
in one device pass per fixed-size frame chunk (port of
``moditalker_tpu/preprocess/fused_align.py``).

The modular path (``S3FDDetector`` + ``FanLandmarker`` + ``Reconstructor``)
goes back to the host between the nets (box decode, ``crop_face``, the PIL
resize). Here a chunk of uint8 frames goes up once and one packed float32
row per frame comes back; every step is batched over the chunk's frames.
Each step re-derives host math of the modular path:

  * best box  — the top-1 SSD anchor over all 6 scales: the modular
    ``decode → NMS → dets[0]`` (NMS keeps the best box first).
  * crop 256  — ``fan.crop_face``: zero-padded canvas, bilinear resize with
    half-pixel centers, uint8 rounding (``torch.round`` rounds half to
    even, as ``jnp.rint`` does), as a bilinear gather.
  * POS solve — ``align.pos_solve``'s lstsq: its design matrix depends only
    on the BFM template, so pinv(A) is a host constant and the per-frame
    solve one [10]·[10, 8] product.
  * crop 224  — the reference resizes the whole frame with PIL bicubic and
    crops (``reconstructor._crop``); here the same affine map is sampled
    bilinearly in one gather (a sub-pixel difference; the modular path
    keeps PIL).

Outputs per frame, packed into one float32 row: 68 image-space landmarks,
the 257 coefficients, the POS crop params (t, s), the FAN center/scale and
the detection box / score / flag.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .fan import FAN, decode_heatmaps
from .recon_net import ReconNet
from .s3fd import S3FD, preprocess_frames

# packed row layout: [lm68(136) | coeff(257) | t(2) | s(1) | center(2) |
#                     scale(1) | box(4) | score(1) | detected(1)] = 405
_LM68 = slice(0, 136)
_COEFF = slice(136, 393)
_T = slice(393, 395)
_S = 395
_CENTER = slice(396, 398)
_SCALE = 398
_BOX = slice(399, 403)
_SCORE = 403
_DETECTED = 404
ROW = 405


def _pos_pinv(lm3d_std: np.ndarray) -> np.ndarray:
    """pinv of the POS design matrix (``align.pos_solve``'s A): constant,
    since A is built from the static BFM 5-landmark template only."""
    x = np.asarray(lm3d_std, np.float64).T        # [3, 5]
    npts = x.shape[1]
    A = np.zeros([2 * npts, 8])
    A[0 : 2 * npts - 1 : 2, 0:3] = x.T
    A[0 : 2 * npts - 1 : 2, 3] = 1
    A[1 : 2 * npts : 2, 4:7] = x.T
    A[1 : 2 * npts : 2, 7] = 1
    return np.linalg.pinv(A)                      # [8, 10]


def _best_box_scale(conf, loc, stride, variances=(0.1, 0.2)):
    """Per-frame argmax anchor of one scale, SSD-decoded: [B, 5]."""
    b, h, w = conf.shape[:3]
    flat = conf[..., 1].reshape(b, h * w).float()
    idx = flat.argmax(dim=-1)                                  # [B]
    score = flat.gather(1, idx[:, None])[:, 0]
    d = loc.reshape(b, h * w, 4).float().gather(
        1, idx[:, None, None].expand(b, 1, 4))[:, 0]           # [B, 4]
    xs = (idx % w).float()
    ys = (idx // w).float()
    axc = stride / 2 + xs * stride
    ayc = stride / 2 + ys * stride
    cx = axc + d[:, 0] * variances[0] * stride * 4
    cy = ayc + d[:, 1] * variances[0] * stride * 4
    bw = stride * 4 * torch.exp(d[:, 2] * variances[1])
    bh = stride * 4 * torch.exp(d[:, 3] * variances[1])
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
                        score], dim=1)


def best_box_per_frame(olist):
    """Global top-1 SSD detection per frame: [B, 4] box + [B] score, equal
    to ``decode_detections_batch(...)[i][0]`` (greedy NMS keeps the
    highest-scoring box first; the global argmax is that box)."""
    cands = torch.stack([
        _best_box_scale(olist[2 * i], olist[2 * i + 1], 2 << (i + 1))
        for i in range(len(olist) // 2)], dim=1)                # [B, S, 5]
    best = cands[..., 4].argmax(dim=1)                          # [B]
    row = cands.gather(1, best[:, None, None].expand(-1, 1, 5))[:, 0]
    return row[:, :4], row[:, 4]


def _sample_bilinear(img, ys, xs):
    """Zero-padded bilinear sample, batched over frames. img [C, H, W, 3]
    float; ys [C, Ho], xs [C, Wo] fractional source coords (outside the
    image a sample reads 0, the crop canvas convention) → [C, Ho, Wo, 3]."""
    c, h, w = img.shape[:3]
    frame = torch.arange(c, device=img.device)[:, None, None]

    def axis(src):
        lo = torch.floor(src)
        return lo.long(), lo.long() + 1, src - lo

    ylo, yhi, yf = axis(ys)
    xlo, xhi, xf = axis(xs)

    def take(yi, xi):
        ok = (((yi >= 0) & (yi < h))[:, :, None]
              & ((xi >= 0) & (xi < w))[:, None, :])
        v = img[frame, yi.clamp(0, h - 1)[:, :, None],
                xi.clamp(0, w - 1)[:, None, :]]
        return v * ok[..., None].to(img.dtype)

    xf = xf[:, None, :, None]
    yf = yf[:, :, None, None]
    top = take(ylo, xlo) * (1 - xf) + take(ylo, xhi) * xf
    bot = take(yhi, xlo) * (1 - xf) + take(yhi, xhi) * xf
    return top * (1 - yf) + bot * yf


def _crop256_coords(center, scale, h, w, resolution=256):
    """Source coords of ``fan.crop_face``'s canvas resample, per frame
    ([C, 2] center, [C] scale → [C, res] ys, xs): integer side
    round(200·scale) (clamped), integer canvas origin from the rounded,
    clamped center, half-pixel centers clipped to the canvas (edge
    replication inside the canvas, zeros outside the image)."""
    side = torch.round(200.0 * scale).clamp(8, 4 * max(h, w))
    cx = torch.round(center[:, 0]).clamp(-2 * w, 3 * w)
    cy = torch.round(center[:, 1]).clamp(-2 * h, 3 * h)
    x0 = cx - torch.floor(side / 2)      # side // 2 for side >= 0
    y0 = cy - torch.floor(side / 2)
    o = torch.arange(resolution, dtype=torch.float32, device=scale.device)
    c = (o[None] + 0.5) * (side / resolution)[:, None] - 0.5
    c = torch.minimum(c.clamp(min=0), (side - 1)[:, None])
    return y0[:, None] + c, x0[:, None] + c


def _crop224_coords(t, s, h: float, w: float, target=224.0):
    """Source coords of the reference's resize-then-crop 224² BFM crop
    (``reconstructor._crop``, ``align.crop_box``), per frame ([C, 2] t,
    [C] s → [C, 224] ys, xs): the whole frame resized to
    (int32(w·s), int32(h·s)), then an integer crop. Resized pixel r maps to
    source (r + 0.5)·(w / wr) − 0.5: half-pixel centers, and the ratio of
    the integer sizes, as PIL maps it."""
    wr = torch.trunc(w * s)              # the int32 cast truncates
    hr = torch.trunc(h * s)
    left = torch.trunc(wr / 2 - target / 2 + (t[:, 0] - w / 2) * s)
    up = torch.trunc(hr / 2 - target / 2 + (h / 2 - t[:, 1]) * s)
    o = torch.arange(int(target), dtype=torch.float32, device=s.device)
    xs = (left[:, None] + o + 0.5) * (w / wr)[:, None] - 0.5
    ys = (up[:, None] + o + 0.5) * (h / hr)[:, None] - 0.5
    return ys, xs


class FusedAligner:
    """Detector, landmarker and reconstructor in one device pass per chunk.

    ``process(frames_u8)`` gives ``MotionAligner`` what its ``landmark_fn``
    and ``coeff_fn`` would: a dict of lm68 / coeff / t / s / center / scale
    / boxes / scores / detected (host numpy). A frame whose best score
    misses ``threshold`` is still computed from its argmax box; ``detected``
    says so, and ``MotionAligner`` falls back to the modular path (which
    fills detection gaps from the neighbours) for such a chunk. The states
    are the port's ``S3FD``, ``FAN`` and ``ReconNet`` state_dicts, run on
    ``device`` with the three trunks in ``dtype`` (None: float32; bf16: the
    JAX package's TPU eval mode). The frames, the crops, the POS solve and
    the packed row stay float32 in either dtype."""

    def __init__(self, s3fd_state, fan_state, recon_state,
                 lm3d_std: np.ndarray, threshold: float = 0.5,
                 chunk: int = 64, num_modules: int = 4,
                 rescale_factor: float = 102.0, device=None, dtype=None):
        self.device = resolve_device(device)
        dtype = dtype or torch.float32
        self.s3fd, self.fan, self.recon = (
            net.to(self.device).eval() for net in
            (S3FD(dtype), FAN(num_modules, dtype), ReconNet(dtype)))
        for net, state in ((self.s3fd, s3fd_state), (self.fan, fan_state),
                           (self.recon, recon_state)):
            net.load_state_dict(state)
        self.threshold = float(threshold)
        self.chunk = chunk
        self.rescale_factor = float(rescale_factor)
        self.lm3d_std = np.asarray(lm3d_std, np.float64)
        self._pinv = torch.tensor(_pos_pinv(self.lm3d_std),
                                  dtype=torch.float32, device=self.device)

    def chunk_rows(self, frames_u8: np.ndarray) -> torch.Tensor:
        """[C, H, W, 3] uint8 → packed [C, ROW] float32, on the device."""
        with torch.inference_mode():
            return self._chunk_program(
                torch.from_numpy(np.ascontiguousarray(frames_u8))
                .to(self.device))

    def _chunk_program(self, frames_u8: torch.Tensor) -> torch.Tensor:
        c, h, w = frames_u8.shape[:3]
        fx = frames_u8.float()

        # ---- S3FD: BGR flip + mean subtraction (S3FDDetector) ----
        box, score = best_box_per_frame(self.s3fd(preprocess_frames(
            frames_u8)))
        detected = (score > self.threshold).float()

        # ---- center/scale (fan.bbox_to_center_scale) ----
        x0b, y0b, x1b, y1b = box.unbind(dim=1)
        center = torch.stack([(x0b + x1b) / 2,
                              (y0b + y1b) / 2 - (y1b - y0b) * 0.12], dim=1)
        scale = (x1b - x0b + y1b - y0b) / 195.0

        # ---- FAN crop + forward + decode ----
        crops = _sample_bilinear(fx, *_crop256_coords(center, scale, h, w))
        crops = torch.round(crops).clamp(0, 255)  # the host's uint8 trip
        pts = decode_heatmaps(self.fan(crops / 255.0)[-1])    # [C, 68, 2]
        # project_heatmap_coords (heatmap res 64 → image space)
        sc200 = (200.0 * scale)[:, None, None]
        lm68 = pts / 64.0 * sc200 + (center[:, None, :] - 0.5 * sc200)

        # ---- 68 → 5 (align.extract_5p) ----
        eye_l = (lm68[:, 36] + lm68[:, 39]) / 2
        eye_r = (lm68[:, 42] + lm68[:, 45]) / 2
        lm5 = torch.stack([eye_l, eye_r, lm68[:, 30], lm68[:, 48],
                           lm68[:, 54]], dim=1)               # [C, 5, 2]

        # ---- POS similarity (align.pos_solve via the constant pinv) ----
        k = lm5.reshape(c, 10) @ self._pinv.T                 # [C, 8]
        s0 = (torch.linalg.norm(k[:, 0:3], dim=1)
              + torch.linalg.norm(k[:, 4:7], dim=1)) / 2
        t_pos = k[:, [3, 7]]
        longest = float(max(w, h, 1))
        s_crop = (self.rescale_factor / s0).clamp(224.0 / longest,
                                                  16384.0 / longest)

        # ---- recon crop + forward ----
        crops224 = _sample_bilinear(
            fx, *_crop224_coords(t_pos, s_crop, float(h), float(w)))
        crops224 = torch.round(crops224).clamp(0, 255)
        coeff = self.recon(crops224 / 255.0)

        return torch.cat([lm68.reshape(c, 136), coeff, t_pos,
                          s_crop[:, None], center, scale[:, None], box,
                          score[:, None], detected[:, None]], dim=1).float()

    def process(self, frames_u8: np.ndarray) -> dict:
        """[T, H, W, 3] uint8 → per-frame alignment products (host numpy):
        one upload and one packed row per frame, ``chunk`` frames a pass."""
        from .batching import padded_chunk_apply

        return self.unpack(padded_chunk_apply(
            self.chunk_rows, np.ascontiguousarray(frames_u8), self.chunk))

    @staticmethod
    def unpack(rows: np.ndarray) -> dict:
        """Packed [T, ROW] rows → the dict ``process`` returns (float64)."""
        rows = np.asarray(rows, np.float64)
        t = rows.shape[0]
        return {
            "lm68": rows[:, _LM68].reshape(t, 68, 2),
            "coeff": rows[:, _COEFF],
            "t": rows[:, _T],
            "s": rows[:, _S],
            "center": rows[:, _CENTER],
            "scale": rows[:, _SCALE],
            "boxes": rows[:, _BOX],
            "scores": rows[:, _SCORE],
            "detected": rows[:, _DETECTED] > 0.5,
        }
