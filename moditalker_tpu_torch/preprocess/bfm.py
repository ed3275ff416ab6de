"""BFM 2009 landmark basis (port of ``Face3DHelper`` in
``moditalker_tpu/preprocess/bfm.py``, ref data/data_utils/face3d_helper.py).

The landmark-only subset AToM inference needs: the basis container, its
deterministic stand-in for asset-free runs, and the un-scaling of AToM's
output. The pose and camera math waits for the alignment stage.

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

    def idexp_to_absolute(self, idexp_lm3d):
        """AToM output un-scaling: lm3d = idexp/10 + key_mean_shape
        (ref AToM/inference.py:155-161). Tensor or array [..., 68, 3]."""
        mean = self.key_mean_shape
        if isinstance(idexp_lm3d, torch.Tensor):
            mean = torch.from_numpy(mean).to(idexp_lm3d.device)
        return idexp_lm3d / 10.0 + mean
