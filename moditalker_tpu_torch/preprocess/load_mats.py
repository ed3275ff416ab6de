"""BFM asset loaders: standard-landmark template and BFM09 conversion (the
port's copy of ``moditalker_tpu/preprocess/load_mats.py``, numpy and scipy
only).

Re-implements ``deep_3drecon/util/load_mats.py``:

* ``load_lm3d`` (:125-133) — loads ``similarity_Lm3D_all.mat`` and reduces
  the 68-point standard face to the 5-landmark template every POS
  similarity solve uses (eyes from means of 4 eye corners, nose, mouth
  corners, reordered eyes-nose-mouth);
* ``transfer_bfm09`` (:35-122) — builds ``BFM_model_front.mat`` from the raw
  Basel 2009 release (``01_MorphableModel.mat``) + Guo et al.'s expression
  basis (``Exp_Pca.bin``): rescale bases by eigenvalues to decimeters,
  truncate to 80 id / 64 exp / 80 tex components, and re-index to the
  35709-vertex front crop.

``synthetic_lm3d_std`` supplies the canonical Deep3DFaceRecon template
values so the alignment pipeline runs without the .mat assets (tests,
benches); it matches ``load_lm3d``'s output on the published asset to ~1e-6.
"""

from __future__ import annotations

import os
from array import array

import numpy as np

# load_lm3d(similarity_Lm3D_all.mat) output for the published Deep3DFaceRecon
# asset — the standard 5-point template (left eye, right eye, nose, left
# mouth corner, right mouth corner) in BFM decimeter units.
_STD_LM3D = np.array([
    [-0.31148657, 0.29036078, 0.13377953],
    [0.30979887, 0.28972036, 0.13179526],
    [0.0032535, -0.04617932, 0.55244243],
    [-0.25216928, -0.38133916, 0.22405732],
    [0.2484662, -0.38128236, 0.2221806],
], np.float64)


def synthetic_lm3d_std() -> np.ndarray:
    """The standard 5-landmark template without needing the .mat asset."""
    return _STD_LM3D.copy()


def lm68_template_to_lm5(lm68: np.ndarray) -> np.ndarray:
    """68-point standard face → 5-point template (ref load_mats.py:129-132):
    nose 31, eye corners 37/40 and 43/46 averaged, mouth 49/55 (1-based),
    reordered to (eyeL, eyeR, nose, mouthL, mouthR)."""
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5 = np.stack([
        lm68[idx[0]],
        lm68[idx[[1, 2]]].mean(axis=0),
        lm68[idx[[3, 4]]].mean(axis=0),
        lm68[idx[5]],
        lm68[idx[6]],
    ], axis=0)
    return lm5[[1, 2, 0, 3, 4]]


def load_lm3d(bfm_dir: str) -> np.ndarray:
    """similarity_Lm3D_all.mat → [5,3] standard landmarks
    (ref load_mats.py:125-133). Falls back to the canonical template when
    the asset is absent."""
    path = os.path.join(bfm_dir, "similarity_Lm3D_all.mat")
    if not os.path.exists(path):
        return synthetic_lm3d_std()
    from scipy.io import loadmat

    lm = loadmat(path)["lm"]
    return lm68_template_to_lm5(np.asarray(lm, np.float64))


def load_exp_basis(bfm_dir: str,
                   n_vertex: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Exp_Pca.bin + std_exp.txt → (expPC [3N, dim], expEV [dim])
    (ref load_mats.py:12-31, which hardcodes n_vertex=53215; here the
    vertex count is derived from the file size so synthetic fixtures load
    too: bytes = 4 + 4·3V + 4·dim·3V)."""
    path = os.path.join(bfm_dir, "Exp_Pca.bin")
    with open(path, "rb") as f:
        dim = array("i")
        dim.fromfile(f, 1)
        if n_vertex is None:
            n_vertex = (os.path.getsize(path) - 4) // (4 * 3 * (1 + dim[0]))
        mu = array("f")
        mu.fromfile(f, 3 * n_vertex)
        pc = array("f")
        pc.fromfile(f, 3 * dim[0] * n_vertex)
    exp_pc = np.array(pc).reshape(dim[0], -1).transpose()
    exp_ev = np.loadtxt(os.path.join(bfm_dir, "std_exp.txt"))
    return exp_pc, exp_ev


def transfer_bfm09(bfm_dir: str, out_name: str = "BFM_model_front.mat",
                   n_id: int = 80, n_exp: int = 64, n_tex: int = 80) -> str:
    """Build the front-cropped face model from the raw BFM09 release
    (ref load_mats.py:35-122). Returns the written path."""
    from scipy.io import loadmat, savemat

    raw = loadmat(os.path.join(bfm_dir, "01_MorphableModel.mat"))
    shape_pc, shape_ev = raw["shapePC"], raw["shapeEV"]
    shape_mu = raw["shapeMU"]
    tex_pc, tex_ev, tex_mu = raw["texPC"], raw["texEV"], raw["texMU"]
    exp_pc, exp_ev = load_exp_basis(bfm_dir)

    # rescale bases by eigenvalues; unify scale to decimeters; truncate
    id_base = (shape_pc * shape_ev.reshape(-1, shape_pc.shape[1])
               / 1e5)[:, :n_id]
    ex_base = (exp_pc * exp_ev.reshape(-1, exp_pc.shape[1]) / 1e5)[:, :n_exp]
    tex_base = (tex_pc * tex_ev.reshape(-1, tex_pc.shape[1]))[:, :n_tex]

    # re-index: 53490-vertex BFM → 53215 exp-basis verts → 35709 front crop
    index_exp = loadmat(os.path.join(bfm_dir, "BFM_front_idx.mat"))
    index_exp = index_exp["idx"].astype(np.int32) - 1
    index_shape = loadmat(os.path.join(bfm_dir, "BFM_exp_idx.mat"))
    index_shape = index_shape["trimIndex"].astype(np.int32) - 1
    index_shape = index_shape[index_exp]

    def take(base, idx, n):
        return base.reshape(-1, 3, n)[idx.ravel()].reshape(-1, n)

    id_base = take(id_base, index_shape, n_id)
    tex_base = take(tex_base, index_shape, n_tex)
    ex_base = take(ex_base, index_exp, n_exp)
    meanshape = (shape_mu.reshape(-1, 3) / 1e5)[index_shape.ravel()]
    meanshape = meanshape.reshape(1, -1)
    meantex = tex_mu.reshape(-1, 3)[index_shape.ravel()].reshape(1, -1)

    info = loadmat(os.path.join(bfm_dir, "facemodel_info.mat"))
    out = {
        "meanshape": meanshape,
        "meantex": meantex,
        "idBase": id_base,
        "exBase": ex_base,
        "texBase": tex_base,
        "tri": info["tri"],
        "point_buf": info["point_buf"],
        "tri_mask2": info["tri_mask2"],
        "keypoints": info["keypoints"],
        "frontmask2_idx": info["frontmask2_idx"],
        "skinmask": info["skinmask"],
    }
    path = os.path.join(bfm_dir, out_name)
    savemat(path, out)
    return path
