"""Face reconstructor: images + landmarks → 3DMM coefficients (port of
``moditalker_tpu/preprocess/reconstructor.py``).

The inference surface of ``deep_3drecon/reconstructor.py``
(``recon_coeff`` :96, ``pose_extract`` :72): per frame, solve the POS
similarity against the BFM standard landmarks, crop and resize to the 224²
template with PIL bicubic (the reference's ``align_img``), then run the
ResNet-50 regressor over the batch. The modular ``coeff_fn`` of
``MotionAligner`` and the keypoint driver; the crop needs PIL.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import align
from .recon_net import ReconNet


class Reconstructor:
    """``state`` is the port's ``ReconNet`` state_dict; float32 on
    ``device``."""

    def __init__(self, state: dict, lm3d_std: np.ndarray | None = None,
                 rescale_factor: float = 102.0, bfm_dir: str | None = None,
                 chunk: int = 64, device=None):
        if lm3d_std is None:
            # the BFM standard template (similarity_Lm3D_all.mat via
            # load_mats.load_lm3d, ref reconstructor.py:36)
            from .load_mats import load_lm3d, synthetic_lm3d_std

            lm3d_std = (load_lm3d(bfm_dir) if bfm_dir
                        else synthetic_lm3d_std())
        self.device = resolve_device(device)
        self.model = ReconNet().to(self.device).eval()
        self.model.load_state_dict(state)
        self.lm3d_std = np.asarray(lm3d_std, np.float64)
        self.rescale_factor = rescale_factor
        self.chunk = chunk

    def _apply(self, crops_u8: np.ndarray) -> np.ndarray:
        """uint8 crops up (PIL keeps uint8, so the upload is lossless), /255
        on the device, [B, 257] coefficients back."""
        from .batching import padded_chunk_apply

        def fn(part):
            with torch.inference_mode():
                x = torch.from_numpy(part).to(self.device).float() / 255.0
                return self.model(x)

        return padded_chunk_apply(fn, np.asarray(crops_u8), self.chunk)

    def pose_extract(self, img_sizes, lm5_batch) -> list[dict]:
        """Per-frame similarity params (ref reconstructor.py:72-94)."""
        return [
            align.crop_params(tuple(img_sizes[i]), lm5_batch[i],
                              self.lm3d_std, self.rescale_factor)
            for i in range(len(lm5_batch))
        ]

    def _crop(self, frame_u8: np.ndarray, params: dict) -> np.ndarray:
        from PIL import Image

        img = Image.fromarray(frame_u8)
        w0, h0 = img.size
        s = params["s"]
        w, h = int(np.int32(w0 * s)), int(np.int32(h0 * s))
        img = img.resize((w, h), resample=Image.BICUBIC)
        img = img.crop(align.crop_box(params))
        return np.asarray(img, np.uint8)

    def _coeff(self, frames_u8: np.ndarray, lm5: np.ndarray):
        b, h, w = frames_u8.shape[:3]
        params = self.pose_extract(np.tile([[w, h]], (b, 1)), lm5)
        crops = np.stack([self._crop(frames_u8[i], params[i])
                          for i in range(b)])
        return self._apply(crops), crops, params

    def recon_coeff(self, frames_u8: np.ndarray, lm68: np.ndarray,
                    return_image: bool = False):
        """frames [B, H, W, 3] uint8 + landmarks [B, 68, 2] →
        (coeff [B, 257], crops if ``return_image``, trans_params list)
        (ref reconstructor.py:96-148)."""
        coeff, crops, params = self._coeff(frames_u8,
                                           align.lm68_to_lm5(lm68))
        if return_image:
            return coeff, crops, params
        return coeff, params

    def coeff_fn(self):
        """Adapter for MotionAligner's ``coeff_fn(frames, lm5)`` slot."""
        return lambda frames_u8, lm5: self._coeff(frames_u8, lm5)[0]
