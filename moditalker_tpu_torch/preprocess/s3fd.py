"""S3FD face detector (port of ``moditalker_tpu/preprocess/s3fd.py``).

The first-frame bootstrap of the FAN landmark tracker, as the reference's
``face_alignment.FaceAlignment`` builds it (ref
data/data_utils/motion_align/align_face_recon.py:155): a VGG-16 trunk,
dilation-free fc6/fc7, two extra stages, L2Norm feature scaling and six
detection heads with a max-out background at stride 4. The trunk runs on the
device; the SSD box decode and NMS run on the host (numpy, data-dependent).

Layout: frames and maps are channels-last, [B, H, W, C], as in the JAX
package; the convolutions run on a [B, C, H, W] view. Module names follow the
flax tree (``utils/convert.py::convert_s3fd_params``); ``convert_s3fd`` takes
face_alignment's ``s3fd-619a316812.pth`` to that tree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

_TRUNK = [  # (name, in, out, kernel, stride, padding)
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1), "pool",
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1), "pool",
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1), "f3", "pool",
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1), "f4", "pool",
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1), "f5", "pool",
    ("fc6", 512, 1024, 3, 1, 3),               # pad 3, like the reference
    ("fc7", 1024, 1024, 1, 1, 0), "ffc7",
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1), "f6",
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1), "f7",
]
# (feature, head name, channels, face/background logits)
_HEADS = [("f3", "conv3_3_norm", 256, 4), ("f4", "conv4_3_norm", 512, 2),
          ("f5", "conv5_3_norm", 512, 2), ("ffc7", "fc7", 1024, 2),
          ("f6", "conv6_2", 512, 2), ("f7", "conv7_2", 256, 2)]
_L2NORM = {"conv3_3_norm": 10.0, "conv4_3_norm": 8.0, "conv5_3_norm": 5.0}

_BGR_MEANS = np.array([104.0, 117.0, 123.0], np.float32)


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned scale (S3FD's way of
    mixing shallow feature maps into detection heads). x: [B, C, H, W]."""

    def __init__(self, channels: int, init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init_scale))

    def forward(self, x):
        norm = torch.sqrt((x.float() ** 2).sum(1, keepdim=True) + 1e-10)
        return x / norm.to(x.dtype) * self.weight.to(x.dtype)[:, None, None]


class S3FD(nn.Module):
    """Trunk + 6 (conf, loc) heads. Input [B, H, W, 3] float (BGR means
    already subtracted, as in the original); returns a list of 12 maps
    [conf_s4, loc_s4, conf_s8, loc_s8, ...] at strides 4, 8, 16, 32, 64,
    128, channels-last, float32, the conf maps softmaxed."""

    def __init__(self):
        super().__init__()
        for spec in _TRUNK:
            if isinstance(spec, tuple):
                name, cin, cout, k, s, p = spec
                self.add_module(name, nn.Conv2d(cin, cout, k, s, p))
        for _, name, ch, n_conf in _HEADS:
            if name in _L2NORM:
                self.add_module(name, L2Norm(ch, _L2NORM[name]))
            self.add_module(f"{name}_mbox_conf", nn.Conv2d(ch, n_conf, 3, 1, 1))
            self.add_module(f"{name}_mbox_loc", nn.Conv2d(ch, 4, 3, 1, 1))

    def features(self, x) -> dict:
        """The six maps the heads read, [B, C, h, w] by name (f3: stride 4,
        f4, f5, ffc7, f6, f7: stride 128), the first three L2-normalised."""
        h = x.permute(0, 3, 1, 2)
        feats = {}
        for spec in _TRUNK:
            if spec == "pool":
                h = F.max_pool2d(h, 2, 2)
            elif isinstance(spec, str):
                feats[spec] = h
            else:
                h = F.relu(getattr(self, spec[0])(h))
        for feat, name, _, _ in _HEADS:
            if name in _L2NORM:
                feats[feat] = getattr(self, name)(feats[feat])
        return feats

    def forward(self, x):
        feats = self.features(x)
        out = []
        for feat, name, _, n_conf in _HEADS:
            f = feats[feat]
            conf = getattr(self, f"{name}_mbox_conf")(f)
            loc = getattr(self, f"{name}_mbox_loc")(f)
            if n_conf == 4:
                # max-out background at the finest scale: 3 background
                # logits maxed into one, channel 3 is the face logit
                bg = conf[:, :3].amax(dim=1, keepdim=True)
                conf = torch.cat([bg, conf[:, 3:]], dim=1)
            out.append(torch.softmax(conf.float(), dim=1).permute(0, 2, 3, 1))
            out.append(loc.float().permute(0, 2, 3, 1))
        return out


def preprocess_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] → float BGR minus the means (on the frames'
    device: a float upload would be 4× the bytes)."""
    means = torch.from_numpy(_BGR_MEANS).to(frames_u8.device)
    return frames_u8.flip(-1).float() - means


def _ssd_boxes(score, d, xs, ys, stride, variances=(0.1, 0.2)):
    """Anchors (stride s, size 4s) and center-variance box regression:
    [M, 5] rows (x0, y0, x1, y1, score)."""
    axc = stride / 2 + xs * stride
    ayc = stride / 2 + ys * stride
    cx = axc + d[:, 0] * variances[0] * stride * 4
    cy = ayc + d[:, 1] * variances[0] * stride * 4
    w = stride * 4 * np.exp(d[:, 2] * variances[1])
    hh = stride * 4 * np.exp(d[:, 3] * variances[1])
    return np.stack([cx - w / 2, cy - hh / 2, cx + w / 2, cy + hh / 2,
                     score], axis=1)


def _nms_per_frame(per_frame: list[list[np.ndarray]]) -> list[np.ndarray]:
    out = []
    for rows in per_frame:
        if not rows:
            out.append(np.zeros((0, 5)))
            continue
        b = np.concatenate(rows, axis=0).astype(np.float64)
        out.append(b[nms(b, 0.3)])
    return out


def decode_detections_batch(olist: list[np.ndarray],
                            threshold: float = 0.5,
                            variances=(0.1, 0.2)) -> list[np.ndarray]:
    """SSD decode, vectorised over frames and anchors, then per-frame NMS.
    ``olist`` = [conf_s4 [T,H,W,2], loc_s4 [T,H,W,4], ...]. Returns a list
    of T arrays [Ni, 5] (x0, y0, x1, y1, score), best first."""
    t_total = np.asarray(olist[0]).shape[0]
    per_frame: list[list[np.ndarray]] = [[] for _ in range(t_total)]
    for i in range(len(olist) // 2):
        conf = np.asarray(olist[2 * i])
        loc = np.asarray(olist[2 * i + 1])
        ts, ys, xs = np.nonzero(conf[..., 1] > threshold)
        if ts.size == 0:
            continue
        det = _ssd_boxes(conf[ts, ys, xs, 1], loc[ts, ys, xs], xs, ys,
                         2 << (i + 1), variances)
        for f in np.unique(ts):
            per_frame[int(f)].append(det[ts == f])
    return _nms_per_frame(per_frame)


def decode_detections(olist: list[np.ndarray], threshold: float = 0.5,
                      variances=(0.1, 0.2)) -> np.ndarray:
    """Single-frame SSD decode (maps carry a leading batch axis of 1).
    Returns [N, 5] (x0, y0, x1, y1, score), best first."""
    return decode_detections_batch(
        [np.asarray(o)[:1] for o in olist], threshold, variances)[0]


def nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy IoU NMS (indices sorted by score)."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


def topk_candidates_packed(olist, k: int = 128, threshold: float = 0.5):
    """The top ``k`` anchors of each scale, packed into one float32 tensor
    [T, S, k+1, 6]: per scale, row 0 is (count above threshold, h, w, 0, 0,
    0) and rows 1..k are candidates (score, flat index, loc0..loc3); scales
    with fewer than k anchors pad with score −1e30. One small copy to the
    host instead of the full maps (the index is exact in float32 up to 2^24
    anchors)."""
    scales = []
    for i in range(len(olist) // 2):
        conf, loc = olist[2 * i], olist[2 * i + 1]
        t, h, w = conf.shape[:3]
        flat = conf[..., 1].reshape(t, h * w)
        kk = min(k, h * w)
        score, idx = torch.topk(flat, kk, dim=-1)
        cand_loc = torch.gather(loc.reshape(t, h * w, 4), 1,
                                idx[..., None].expand(t, kk, 4))
        count = (flat > threshold).sum(dim=-1).float()
        rows = torch.cat([score[..., None], idx[..., None].float(),
                          cand_loc.float()], dim=-1)            # [t, kk, 6]
        if kk < k:
            # score −1e30 clears no threshold; index and loc pad with 0 so
            # the host's int cast of the index stays valid
            pad = rows.new_zeros((t, k - kk, 6))
            pad[..., 0] = -1e30
            rows = torch.cat([rows, pad], dim=1)
        meta = rows.new_zeros((t, 1, 6))
        meta[:, 0, 0] = count
        meta[:, 0, 1] = h
        meta[:, 0, 2] = w
        scales.append(torch.cat([meta, rows], dim=1))
    return torch.stack(scales, dim=1)                       # [t, S, k+1, 6]


def decode_candidates_packed(arr: np.ndarray, threshold: float = 0.5,
                             variances=(0.1, 0.2)) -> list[np.ndarray]:
    """SSD decode + per-frame NMS of ``topk_candidates_packed``'s output:
    the result of ``decode_detections_batch`` on the full maps whenever
    every frame's above-threshold count fits in the candidate budget."""
    arr = np.asarray(arr)
    per_frame: list[list[np.ndarray]] = [[] for _ in range(arr.shape[0])]
    for i in range(arr.shape[1]):
        w_map = int(arr[0, i, 0, 2])
        score = arr[:, i, 1:, 0]
        idx = arr[:, i, 1:, 1].astype(np.int64)
        loc = arr[:, i, 1:, 2:6]
        ts, js = np.nonzero(score > threshold)
        if ts.size == 0:
            continue
        sel_idx = idx[ts, js]
        det = _ssd_boxes(score[ts, js], loc[ts, js], sel_idx % w_map,
                         sel_idx // w_map, 2 << (i + 1), variances)
        for f in np.unique(ts):
            per_frame[int(f)].append(det[ts == f])
    return _nms_per_frame(per_frame)


def fill_box_gaps(all_dets: list[np.ndarray]):
    """[T] per-frame detections → [T, 4] best box per frame, or None when no
    frame has one. A frame without a face takes the previous frame's box,
    and frames before the first detection take the first one."""
    t = len(all_dets)
    boxes = np.zeros((t, 4))
    have = np.zeros(t, bool)
    for i, dets in enumerate(all_dets):
        if dets.shape[0]:
            boxes[i] = dets[0, :4]
            have[i] = True
    if not have.any():
        return None
    last = None
    for i in range(t):
        if have[i]:
            last = boxes[i]
        elif last is not None:
            boxes[i] = last
    last = None
    for i in range(t - 1, -1, -1):
        if have[i]:
            last = boxes[i]
        elif not boxes[i].any() and last is not None:
            boxes[i] = last
    return boxes


class S3FDDetector:
    """``detector_fn`` for ``FanLandmarker``: frame [H, W, 3] uint8 RGB →
    [x0, y0, x1, y1] of the highest-scoring face (None without one).
    ``state`` is the port's ``S3FD`` state_dict; float32 on ``device``."""

    def __init__(self, state: dict, threshold: float = 0.5, chunk: int = 64,
                 topk: int = 128, device=None):
        self.device = resolve_device(device)
        self.model = S3FD().to(self.device).eval()
        self.model.load_state_dict(state)
        self.threshold = threshold
        self.chunk = chunk
        self.topk = topk

    def _maps(self, part: np.ndarray):
        with torch.inference_mode():
            x = torch.from_numpy(part).to(self.device)
            return self.model(preprocess_frames(x))

    def _topk(self, part: np.ndarray):
        return topk_candidates_packed(self._maps(part), self.topk,
                                      self.threshold)

    def __call__(self, frame_u8: np.ndarray):
        boxes = self.boxes_for_frames(frame_u8[None])
        return None if boxes is None else boxes[0]

    def boxes_for_frames(self, frames_u8: np.ndarray):
        """[T, H, W, 3] uint8 → [T, 4] best box per frame (``fill_box_gaps``),
        or None when no frame has a detection (callers then track)."""
        from .batching import padded_chunk_apply

        frames_c = np.ascontiguousarray(frames_u8)
        all_dets = None
        cands = padded_chunk_apply(self._topk, frames_c, self.chunk)
        if float(cands[:, :, 0, 0].max(initial=0)) <= self.topk:
            all_dets = decode_candidates_packed(cands, self.threshold)
        # else a frame overflows the candidate budget (a crowded scene):
        # fetch the full maps for an exact decode
        if all_dets is None:
            olist = padded_chunk_apply(self._maps, frames_c, self.chunk)
            all_dets = decode_detections_batch(olist, self.threshold)
        return fill_box_gaps(all_dets)


def convert_s3fd(sd: dict) -> dict:
    """face_alignment's S3FD state_dict → the JAX package's flax tree
    (``utils/convert.py::convert_s3fd_params`` then gives the port's
    state_dict): conv weights [O, I, kh, kw] → [kh, kw, I, O], the L2Norm
    scales pass through."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    p: dict = {}
    convs = [s[0] for s in _TRUNK if isinstance(s, tuple)] + [
        f"{name}_mbox_{kind}" for _, name, _, _ in _HEADS
        for kind in ("conf", "loc")]
    for n in convs:
        p[n] = {"kernel": sd[f"{n}.weight"].transpose(2, 3, 1, 0),
                "bias": sd[f"{n}.bias"]}
    for n in _L2NORM:
        p[n] = {"weight": sd[f"{n}.weight"]}
    return {"params": p}
