"""AToM inference: audio (HuBERT features) → frontalized landmark sequences
(port of ``moditalker_tpu/pipelines/atom_infer.py``, ref
AToM/inference.py:34-199).

Per identity: condition on the frame-0 face-centric unposed keypoint and a
2×horizon slice of HuBERT features, DDIM-sample the landmark residual with
CFG, add back the keypoint, un-scale (÷10 + key_mean_shape) and write
``frontalized_npy/{id}/{tag}.npy`` as [T, 68, 3] float arrays, the layout
the motion-alignment stage reads. ``run_directory`` stacks identities along
the batch axis and samples each chunk in one doubled-batch CFG DDIM run.
Float32 on one card, TF32 off (``device.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import AtomDiffusionConfig, AtomModelConfig
from ..device import resolve_device
from ..models.atom import AtomDiffusion, MotionDecoder
from ..preprocess.bfm import Face3DHelper

HORIZON = 156  # 6.24 s at 25 fps (ref AToM/inference.py:26)


def prepare_condition(keypoint_npy: np.ndarray, hubert_npy: np.ndarray,
                      horizon: int = HORIZON) -> tuple[np.ndarray, np.ndarray]:
    """Identity keypoint [68,3] (or [1,68,3]) + hubert [T,1024] →
    (face [1,horizon,204], cond [1,2*horizon,1024]) (ref inference.py:114-130).
    Hubert shorter than 2*horizon is zero-padded."""
    kp = np.asarray(keypoint_npy, np.float32).reshape(-1)[: 68 * 3]
    face = np.tile(kp[None, None, :], (1, horizon, 1))
    hub = np.asarray(hubert_npy, np.float32)
    need = horizon * 2
    if hub.shape[0] < need:
        hub = np.pad(hub, ((0, need - hub.shape[0]), (0, 0)))
    cond = hub[None, :need]
    return face, cond


class AtomInferencePipeline:
    """``state``: the ``state_dict`` of the port's ``MotionDecoder``
    (``utils/convert.py`` makes one from the JAX package's parameters).
    ``device`` defaults to the card; without one the constructor raises."""

    def __init__(self, state,
                 model_cfg: AtomModelConfig = AtomModelConfig(),
                 diff_cfg: AtomDiffusionConfig = AtomDiffusionConfig(),
                 face3d: Face3DHelper | None = None,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        model = MotionDecoder(model_cfg, dtype)
        model.load_state_dict(state)
        model = model.to(self.device).eval().requires_grad_(False)
        self.diff = AtomDiffusion.create(model, diff_cfg, self.device)
        self.model_cfg = model_cfg
        self.face3d = face3d

    def generate_residual(self, generator, face: np.ndarray, cond: np.ndarray):
        """[B, horizon, 204] landmark residuals, on the device."""
        face = torch.as_tensor(face).to(self.device)
        cond = torch.as_tensor(cond).to(self.device)
        shape = (face.shape[0], self.model_cfg.horizon, self.model_cfg.repr_dim)
        return self.diff.ddim_sample(shape, face, cond, generator)

    def _absolute(self, residual, face: np.ndarray) -> np.ndarray:
        """residual + keypoint (ref inference.py:155) → [B, T, 68, 3]
        absolute landmarks on the host."""
        out = residual + torch.as_tensor(face).to(residual.device)
        out = out.reshape(out.shape[0], out.shape[1], 68, 3)
        if self.face3d is not None:
            out = self.face3d.idexp_to_absolute(out)  # /10 + key_mean_shape
        else:
            out = out / 10.0
        return out.cpu().numpy()

    def generate_landmarks(self, generator, keypoint_npy, hubert_npy):
        """Full single-identity path → [horizon, 68, 3] absolute landmarks."""
        face, cond = prepare_condition(keypoint_npy, hubert_npy,
                                       self.model_cfg.horizon)
        return self._absolute(self.generate_residual(generator, face, cond),
                              face)[0]

    def run_directory(self, identities: dict[str, tuple], out_dir: str,
                      seed: int = 0, tag: str = "atom",
                      save_pngs: bool = False, batch: int | None = None,
                      generator=None) -> dict[str, str]:
        """identities: {id: (keypoint ndarray, hubert ndarray)} → writes
        ``frontalized_npy/{id}/{tag}.npy`` (+ optional dot-rendered pngs,
        ref inference.py:164-177), returns the paths.

        Identities are stacked along the batch axis in sorted order and
        sampled in chunks of ``batch`` (default: all at once); the last
        chunk is padded by repetition to the same shape and trimmed. Draws
        come from ``generator``, or from a ``torch.Generator`` on the
        device seeded with ``seed``."""
        names = sorted(identities)
        if not names:
            return {}
        batch = len(names) if batch is None else max(1, batch)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        paths: dict[str, str] = {}
        for lo in range(0, len(names), batch):
            chunk = names[lo : lo + batch]
            prepped = [prepare_condition(*identities[n],
                                         self.model_cfg.horizon)
                       for n in chunk]
            prepped += [prepped[-1]] * (batch - len(chunk))
            face = np.concatenate([f for f, _ in prepped])
            cond = np.concatenate([c for _, c in prepped])
            out = self._absolute(
                self.generate_residual(generator, face, cond), face)
            for i, name in enumerate(chunk):
                d = os.path.join(out_dir, "frontalized_npy", name)
                os.makedirs(d, exist_ok=True)
                p = os.path.join(d, f"{tag}.npy")
                np.save(p, out[i])
                paths[name] = p
                if save_pngs:
                    save_landmark_pngs(
                        out[i], os.path.join(out_dir, "png", name))
        return paths


def save_landmark_pngs(lm3d: np.ndarray, out_dir: str, wh: int = 256):
    """Dot-render [T,68,3] landmarks to per-frame pngs, reference scaling
    (× WH/2 + WH/2, y-flip — inference.py:166-177). Without PIL it writes
    nothing and returns []."""
    from ..data.mtov_dataset import rasterize_landmarks

    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return []
    lm2d = (lm3d[..., :2] * wh / 2 + wh / 2).astype(int)
    imgs = rasterize_landmarks(lm2d, size=wh, src_wh=wh)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(imgs.shape[0]):
        frame = 255 - imgs[i, ::-1]  # black dots on white, y-flipped
        p = os.path.join(out_dir, f"{i:05d}.png")
        Image.fromarray(frame).save(p)
        paths.append(p)
    return paths
