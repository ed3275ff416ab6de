"""FAN (Face Alignment Network, 2D-FAN-4) and its heatmap decoding (port of
``moditalker_tpu/preprocess/fan.py``).

The reference detects 68 2D landmarks with the ``face_alignment`` package
(``motion_align/align_face_recon.py:155``): 4 stacked depth-4 hourglass
modules over 256-channel ConvBlocks, 68 heatmaps at 64², then the sub-pixel
decode (argmax, a ±0.25 shift along the local gradient, the center/scale
back-projection). Module names follow the flax tree, BatchNorm statistics
included (``utils/convert.py::convert_fan_params``); ``convert_fan`` takes
face_alignment's ``2DFAN4-*.pth`` to that tree. Every BatchNorm runs in eval
mode (eps 1e-5).

Layout: crops and heatmaps are channels-last, [B, H, W, C], as in the JAX
package; the convolutions run on a [B, C, H, W] view.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5)


class ConvBlock(nn.Module):
    """Pre-activation 3-way split block (FAN models.py ConvBlock)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        o = out_planes
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, o // 2, 3, padding=1, bias=False)
        self.bn2 = _bn(o // 2)
        self.conv2 = nn.Conv2d(o // 2, o // 4, 3, padding=1, bias=False)
        self.bn3 = _bn(o // 4)
        self.conv3 = nn.Conv2d(o // 4, o // 4, 3, padding=1, bias=False)
        self.has_ds = in_planes != out_planes
        if self.has_ds:
            self.ds_bn = _bn(in_planes)
            self.ds_conv = nn.Conv2d(in_planes, o, 1, bias=False)

    def forward(self, x):
        h1 = self.conv1(F.relu(self.bn1(x)))
        h2 = self.conv2(F.relu(self.bn2(h1)))
        h3 = self.conv3(F.relu(self.bn3(h2)))
        out = torch.cat([h1, h2, h3], dim=1)
        res = self.ds_conv(F.relu(self.ds_bn(x))) if self.has_ds else x
        return out + res


class HourGlass(nn.Module):
    """Recursive hourglass (FAN models.py HourGlass): 2×2 average pooling
    down, a nearest ×2 repeat up."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        f = features
        for lv in range(depth, 0, -1):
            for blk in ["b1", "b2", "b3"] + (["b2_plus"] if lv == 1 else []):
                self.add_module(f"{blk}_{lv}", ConvBlock(f, f))

    def _level(self, x, lv: int):
        up1 = getattr(self, f"b1_{lv}")(x)
        low = getattr(self, f"b2_{lv}")(F.avg_pool2d(x, 2, 2))
        if lv > 1:
            low2 = self._level(low, lv - 1)
        else:
            low2 = getattr(self, f"b2_plus_{lv}")(low)
        low3 = getattr(self, f"b3_{lv}")(low2)
        up2 = low3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return up1 + up2

    def forward(self, x):
        return self._level(x, self.depth)


class FAN(nn.Module):
    """input [B, 256, 256, 3] (0..1 RGB) → list of [B, 64, 64, 68]
    heatmaps, one per stacked module (use the last)."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = _bn(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", _bn(256))
            self.add_module(f"l{i}", nn.Conv2d(256, 68, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(68, 256, 1))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        h = F.avg_pool2d(self.conv2(h), 2, 2)
        previous = self.conv4(self.conv3(h))
        outputs = []
        for i in range(self.num_modules):
            m = lambda name: getattr(self, f"{name}{i}")
            ll = m("top_m_")(m("m")(previous))
            ll = F.relu(m("bn_end")(m("conv_last")(ll)))
            tmp_out = m("l")(ll)
            outputs.append(tmp_out.permute(0, 2, 3, 1))
            if i < self.num_modules - 1:
                previous = previous + m("bl")(ll) + m("al")(tmp_out)
        return outputs


# ---------------------------------------------------------------- decoding

def heatmaps_to_landmarks(heatmaps: np.ndarray, center=None,
                          scale: float | None = None) -> np.ndarray:
    """[B, H, W, 68] heatmaps → [B, 68, 2] landmark coords.

    face_alignment's get_preds_fromhm: argmax, ±0.25 shift along the local
    heatmap gradient, then the optional center/scale back-projection to the
    original image (transform() semantics with resolution H)."""
    b, hh, ww, n = heatmaps.shape
    hm = heatmaps.transpose(0, 3, 1, 2).reshape(b, n, -1)
    idx = hm.argmax(axis=-1)
    xs = (idx % ww).astype(np.float64)
    ys = (idx // ww).astype(np.float64)
    xi = (idx % ww).astype(np.intp)
    yi = (idx // ww).astype(np.intp)
    bidx = np.arange(b, dtype=np.intp)[:, None]
    nidx = np.arange(n, dtype=np.intp)[None, :]
    right = heatmaps[bidx, yi, np.minimum(xi + 1, ww - 1), nidx]
    left = heatmaps[bidx, yi, np.maximum(xi - 1, 0), nidx]
    below = heatmaps[bidx, np.minimum(yi + 1, hh - 1), xi, nidx]
    above = heatmaps[bidx, np.maximum(yi - 1, 0), xi, nidx]
    in_x = (xi > 0) & (xi < ww - 1)
    in_y = (yi > 0) & (yi < hh - 1)
    xs += 0.25 * np.sign(right - left) * in_x
    ys += 0.25 * np.sign(below - above) * in_y
    pts = np.stack([xs, ys], axis=-1) + 0.5  # pixel centers
    if center is not None and scale is not None:
        pts = project_heatmap_coords(pts, center, scale, hh)
    return pts


def decode_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """On-device ``heatmaps_to_landmarks`` without the back-projection:
    [B, H, W, 68] → float32 [B, 68, 2] heatmap coords (pixel centers,
    +0.5), so a chunk returns landmarks, not heatmaps. Equal to the host
    decode on the same float32 maps: argmax takes the first maximum in
    numpy, jnp and torch alike."""
    b, hh, ww, n = heatmaps.shape
    flat = heatmaps.float().permute(0, 3, 1, 2).reshape(b, n, hh * ww)
    idx = flat.argmax(dim=-1)                             # [B, 68]
    xi = idx % ww
    yi = idx // ww

    def at(y, x):
        return torch.gather(flat, 2, (y * ww + x)[..., None])[..., 0]

    right = at(yi, (xi + 1).clamp(max=ww - 1))
    left = at(yi, (xi - 1).clamp(min=0))
    below = at((yi + 1).clamp(max=hh - 1), xi)
    above = at((yi - 1).clamp(min=0), xi)
    in_x = ((xi > 0) & (xi < ww - 1)).float()
    in_y = ((yi > 0) & (yi < hh - 1)).float()
    xs = xi.float() + 0.25 * torch.sign(right - left) * in_x
    ys = yi.float() + 0.25 * torch.sign(below - above) * in_y
    return torch.stack([xs, ys], dim=-1) + 0.5


def project_heatmap_coords(pts: np.ndarray, center, scale: float,
                           resolution: int = 64) -> np.ndarray:
    """Heatmap-space coords → image coords: the crop of side 200·scale
    centered at ``center`` (face_alignment transform()), in float64."""
    pts = np.asarray(pts, np.float64)
    pts = pts / resolution * (200.0 * scale)
    return pts + (np.asarray(center, np.float64) - 100.0 * scale)


def crop_face(img: np.ndarray, center, scale: float,
              resolution: int = 256) -> np.ndarray:
    """Square crop of side 200·scale around center, resized to 256²
    (bilinear, torch semantics). img [H, W, 3] float 0..255."""
    from ..data.mtov_dataset import bilinear_resize

    h, w = img.shape[:2]
    # clamp the crop to a sane multiple of the frame: degenerate detections
    # (wild landmarks from an untrained net, a collapsed track) would
    # otherwise ask for a canvas of any size
    side = int(round(200.0 * scale))
    side = max(8, min(side, 4 * max(h, w)))
    cx, cy = int(round(center[0])), int(round(center[1]))
    cx = max(-2 * w, min(cx, 3 * w))
    cy = max(-2 * h, min(cy, 3 * h))
    x0, y0 = cx - side // 2, cy - side // 2
    canvas = np.zeros((side, side, 3), np.float32)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + side, w), min(y0 + side, h)
    canvas[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return bilinear_resize(canvas[None], resolution, resolution)[0]


def bbox_to_center_scale(lm_or_box: np.ndarray) -> tuple[np.ndarray, float]:
    """Center/scale from prior-frame landmarks ([68,2]) or a box [x0,y0,x1,y1]
    (face_alignment's convention: scale = box_diag-ish / 195)."""
    a = np.asarray(lm_or_box, np.float64)
    if a.ndim == 2:  # landmarks
        x0, y0 = a.min(axis=0)
        x1, y1 = a.max(axis=0)
    else:
        x0, y0, x1, y1 = a
    center = np.array([(x0 + x1) / 2.0, (y0 + y1) / 2.0])
    center[1] -= (y1 - y0) * 0.12
    scale = (x1 - x0 + y1 - y0) / 195.0
    return center, scale


def convert_fan(sd: dict, num_modules: int = 4) -> dict:
    """face_alignment 2DFAN4 state_dict → the JAX package's flax variables
    (``params`` and ``batch_stats``; ``utils/convert.py::convert_fan_params``
    then gives the port's state_dict)."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}

    def conv(dst_p, name, src):
        d = {"kernel": np.ascontiguousarray(
            sd[f"{src}.weight"].transpose(2, 3, 1, 0))}
        if f"{src}.bias" in sd:
            d["bias"] = sd[f"{src}.bias"]
        dst_p[name] = d

    def bn(dst_p, dst_s, name, src):
        dst_p[name] = {"scale": sd[f"{src}.weight"],
                       "bias": sd[f"{src}.bias"]}
        dst_s[name] = {"mean": sd[f"{src}.running_mean"],
                       "var": sd[f"{src}.running_var"]}

    def convblock(dst_p, dst_s, src, has_ds):
        for i in (1, 2, 3):
            conv(dst_p, f"conv{i}", f"{src}.conv{i}")
            bn(dst_p, dst_s, f"bn{i}", f"{src}.bn{i}")
        if has_ds:
            bn(dst_p, dst_s, "ds_bn", f"{src}.downsample.0")
            conv(dst_p, "ds_conv", f"{src}.downsample.2")

    conv(params, "conv1", "conv1")
    bn(params, stats, "bn1", "bn1")
    for name, ds in [("conv2", True), ("conv3", False), ("conv4", True)]:
        params[name], stats[name] = {}, {}
        convblock(params[name], stats[name], name, ds)
    for i in range(num_modules):
        params[f"m{i}"], stats[f"m{i}"] = {}, {}
        for lv in (4, 3, 2, 1):
            for blk in ["b1", "b2", "b3"] + (["b2_plus"] if lv == 1 else []):
                key = f"{blk}_{lv}"
                params[f"m{i}"][key], stats[f"m{i}"][key] = {}, {}
                convblock(params[f"m{i}"][key], stats[f"m{i}"][key],
                          f"m{i}.{key}", False)
        params[f"top_m_{i}"], stats[f"top_m_{i}"] = {}, {}
        convblock(params[f"top_m_{i}"], stats[f"top_m_{i}"], f"top_m_{i}",
                  False)
        conv(params, f"conv_last{i}", f"conv_last{i}")
        bn(params, stats, f"bn_end{i}", f"bn_end{i}")
        conv(params, f"l{i}", f"l{i}")
        if i < num_modules - 1:
            conv(params, f"bl{i}", f"bl{i}")
            conv(params, f"al{i}", f"al{i}")
    return {"params": params, "batch_stats": stats}


class FanLandmarker:
    """Video landmark tracker: FAN heatmaps + crop tracking.

    ``landmark_fn`` of ``MotionAligner`` and the keypoint driver. With a
    batch-capable detector (``S3FDDetector``) every frame is cropped from
    its own box and all frames run in fixed-size chunks; otherwise each
    frame's crop comes from the previous frame's landmarks, the first from
    ``initial_box`` ([x0, y0, x1, y1]), ``detector_fn(frame)`` or a
    whole-frame prior. ``state`` is the port's ``FAN`` state_dict; float32
    on ``device``.
    """

    def __init__(self, state: dict, num_modules: int = 4, initial_box=None,
                 detector_fn=None, chunk: int = 64, device=None):
        self.device = resolve_device(device)
        self.model = FAN(num_modules=num_modules).to(self.device).eval()
        self.model.load_state_dict(state)
        self.initial_box = initial_box
        self.detector_fn = detector_fn
        self.chunk = chunk

    @classmethod
    def with_s3fd(cls, fan_state, s3fd_state, num_modules: int = 4,
                  threshold: float = 0.5, chunk: int = 64,
                  device=None) -> "FanLandmarker":
        """Cold-start tracker: S3FD detects the faces, FAN landmarks them
        (the reference's face_alignment default, align_face_recon.py:155)."""
        from .s3fd import S3FDDetector

        return cls(fan_state, num_modules=num_modules, chunk=chunk,
                   detector_fn=S3FDDetector(s3fd_state, threshold,
                                            chunk=chunk, device=device),
                   device=device)

    def _points(self, crops_u8: np.ndarray) -> torch.Tensor:
        """uint8 crops [B, 256, 256, 3] up, decoded [B, 68, 2] heatmap
        coords back (uint8 crops as the reference's cv2 crops are)."""
        with torch.inference_mode():
            x = torch.from_numpy(crops_u8).to(self.device).float() / 255.0
            return decode_heatmaps(self.model(x)[-1])

    def landmarks_for_frame(self, frame_u8: np.ndarray,
                            prior) -> np.ndarray:
        center, scale = bbox_to_center_scale(prior)
        crop = crop_face(frame_u8.astype(np.float32), center, scale)
        crop_u8 = np.clip(np.rint(crop), 0, 255).astype(np.uint8)
        pts = self._points(crop_u8[None]).cpu().numpy()
        return project_heatmap_coords(pts, center, scale)[0]

    def landmarks_batched(self, frames_u8: np.ndarray,
                          boxes: np.ndarray) -> np.ndarray:
        """All frames in fixed-size chunks, given per-frame boxes [T, 4]
        (the reference landmarks every frame independently,
        align_face_recon.py:155-163)."""
        from .batching import padded_chunk_apply

        t = frames_u8.shape[0]
        centers, scales = zip(*(bbox_to_center_scale(b) for b in boxes))
        crops = np.stack([
            crop_face(frames_u8[i].astype(np.float32), centers[i], scales[i])
            for i in range(t)])
        crops_u8 = np.clip(np.rint(crops), 0, 255).astype(np.uint8)
        pts = padded_chunk_apply(self._points, crops_u8, self.chunk)
        out = np.empty((t, 68, 2), np.float64)
        for i in range(t):
            out[i] = project_heatmap_coords(pts[i], centers[i], scales[i])
        return out

    def __call__(self, frames_u8: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 → [T, 68, 2] image-space landmarks."""
        t, h, w = frames_u8.shape[:3]
        if self.detector_fn is not None and hasattr(self.detector_fn,
                                                    "boxes_for_frames"):
            boxes = self.detector_fn.boxes_for_frames(frames_u8)
            if boxes is not None:
                return self.landmarks_batched(frames_u8, boxes)
        prior = None
        if self.initial_box is not None:
            prior = np.asarray(self.initial_box, np.float64)
        elif self.detector_fn is not None:
            box = self.detector_fn(frames_u8[0])
            if box is not None:
                prior = np.asarray(box, np.float64)
        if prior is None:
            # whole-frame prior (center crop): no detector, or no detection
            prior = np.array([w * 0.2, h * 0.2, w * 0.8, h * 0.8])
        out = np.empty((t, 68, 2), np.float64)
        for i in range(t):
            out[i] = self.landmarks_for_frame(frames_u8[i], prior)
            prior = out[i]  # track
        return out
