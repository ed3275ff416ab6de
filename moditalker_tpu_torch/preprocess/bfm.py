"""BFM 2009 landmark basis (port of ``Face3DHelper`` in
``moditalker_tpu/preprocess/bfm.py``, ref data/data_utils/face3d_helper.py).

The landmark-only subset of the reference's Face3DHelper: the basis
container, its deterministic stand-in for asset-free runs, the basis blends,
the un-scaling of AToM's output, and the pose and camera math of
``deep_3drecon_models/bfm.py``. The math runs on float32 tensors, as the JAX
package runs it with x64 off: a float64 result would drift from the
reference at the 1e-6 level that ``motion_align`` then rounds to integers.
Numpy inputs become float32 CPU tensors.

Assets: ``from_bfm`` needs ``BFM_model_front.mat`` (scipy.io).
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Face3DHelper:
    """Landmark basis container.

    key_mean_shape: [68,3]; key_id_base: [204,80]; key_exp_base: [204,64]
    (ref face3d_helper.py:28-34).
    """

    def __init__(self, key_mean_shape: np.ndarray, key_id_base: np.ndarray,
                 key_exp_base: np.ndarray):
        self.key_mean_shape = np.asarray(key_mean_shape, np.float32).reshape(68, 3)
        self.key_id_base = np.asarray(key_id_base, np.float32).reshape(204, 80)
        self.key_exp_base = np.asarray(key_exp_base, np.float32).reshape(204, 64)

    @classmethod
    def from_bfm(cls, bfm_dir: str) -> "Face3DHelper":
        from scipy.io import loadmat

        model = loadmat(os.path.join(bfm_dir, "BFM_model_front.mat"))
        mean_shape = model["meanshape"].transpose()  # [3N,1]
        id_base = model["idBase"]                    # [3N,80]
        exp_base = model["exBase"]                   # [3N,64]
        keypoints = model["keypoints"].squeeze().astype(np.int64)  # [68]
        key_mean = mean_shape.reshape(-1, 3)[keypoints]
        key_id = id_base.reshape(-1, 3, 80)[keypoints].reshape(-1, 80)
        key_exp = exp_base.reshape(-1, 3, 64)[keypoints].reshape(-1, 64)
        return cls(key_mean, key_id, key_exp)

    @classmethod
    def synthetic(cls, seed: int = 0) -> "Face3DHelper":
        """Deterministic stand-in basis for asset-free runs."""
        rng = np.random.default_rng(seed)
        return cls(
            rng.normal(scale=0.5, size=(68, 3)),
            rng.normal(scale=0.01, size=(204, 80)),
            rng.normal(scale=0.01, size=(204, 64)),
        )

    # ------------------------------------------------------------ math
    def split_coeff(self, coeff):
        """257-dim Deep3DFaceRecon coefficient split (ref :36-48)."""
        return {
            "identity": coeff[..., :80],
            "expression": coeff[..., 80:144],
            "texture": coeff[..., 144:224],
            "angles": coeff[..., 224:227],
            "gamma": coeff[..., 227:254],
            "translation": coeff[..., 254:257],
        }

    def _basis(self, name: str, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(getattr(self, name)).to(like.device)

    def reconstruct_idexp_lm3d(self, id_coeff, exp_coeff):
        """(id_base·id + exp_base·exp) × 10 → [T,68,3] (ref :90-105)."""
        id_coeff, exp_coeff = _f32(id_coeff), _f32(exp_coeff)
        face = (torch.einsum("...c,dc->...d", id_coeff,
                             self._basis("key_id_base", id_coeff))
                + torch.einsum("...c,dc->...d", exp_coeff,
                               self._basis("key_exp_base", exp_coeff)))
        return face.reshape(*face.shape[:-1], 68, 3) * 10.0

    def reconstruct_lm3d(self, id_coeff, exp_coeff):
        """Full landmark positions, re-centered (ref :70-88)."""
        id_coeff, exp_coeff = _f32(id_coeff), _f32(exp_coeff)
        mean = self._basis("key_mean_shape", id_coeff)
        face = (mean.reshape(1, -1)
                + torch.einsum("...c,dc->...d", id_coeff,
                               self._basis("key_id_base", id_coeff))
                + torch.einsum("...c,dc->...d", exp_coeff,
                               self._basis("key_exp_base", exp_coeff)))
        face = face.reshape(*face.shape[:-1], 68, 3)
        return face - mean.mean(dim=0)[None, :]

    def idexp_to_absolute(self, idexp_lm3d):
        """AToM output un-scaling: lm3d = idexp/10 + key_mean_shape
        (ref AToM/inference.py:155-161). Tensor or array [..., 68, 3]."""
        mean = self.key_mean_shape
        if isinstance(idexp_lm3d, torch.Tensor):
            mean = torch.from_numpy(mean).to(idexp_lm3d.device)
        return idexp_lm3d / 10.0 + mean

    @staticmethod
    def eye_mouth_landmarks(lm3d):
        """(eye [.,31,3], mouth [.,20,3]) slices (ref :107-115)."""
        return lm3d[..., 17:48, :], lm3d[..., 48:68, :]


def _f32(x) -> torch.Tensor:
    """A float32 tensor (numpy arrays land on the CPU)."""
    return torch.as_tensor(x).float()


def compute_rotation(angles) -> torch.Tensor:
    """XYZ-euler → rotation matrices, batched (ref deep_3drecon_models/
    bfm.py:171-197: R = (Rz @ Ry @ Rx) transposed)."""
    angles = _f32(angles)
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    rot_x = torch.stack(
        [ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], -1
    ).reshape(*x.shape, 3, 3)
    rot_y = torch.stack(
        [cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], -1
    ).reshape(*x.shape, 3, 3)
    rot_z = torch.stack(
        [cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], -1
    ).reshape(*x.shape, 3, 3)
    rot = rot_z @ rot_y @ rot_x
    return rot.transpose(-1, -2)


def rigid_transform(points, rot, trans) -> torch.Tensor:
    """points [.,N,3] @ rot [.,3,3] + trans [.,1,3] (pose application, ref
    process_video_3dmm_rollback_hdtf_batchify.py:129-132)."""
    return _f32(points) @ _f32(rot) + _f32(trans)[..., None, :]


def to_camera(shape, camera_distance: float = 10.0) -> torch.Tensor:
    """z → distance − z (ref bfm.py:198-201)."""
    out = _f32(shape).clone()
    out[..., 2] = camera_distance - out[..., 2]
    return out


def to_image(shape, focal: float = 1015.0, center: float = 112.0):
    """Perspective projection to 224² image coords (ref bfm.py:202-227)."""
    shape = _f32(shape)
    return shape[..., :2] * focal / shape[..., 2:3] + center
