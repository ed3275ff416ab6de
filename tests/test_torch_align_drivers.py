"""The port's alignment drivers and commands against the JAX package's, on
the CPU: ``keypoint_sets``, ``align_motion_corpus`` and
``extract_keypoints_corpus`` (``preprocess/keypoints.py``, ``drivers.py``),
the ``align-motion`` and ``extract-keypoints`` commands, and the modular
detectors (``FanLandmarker``, ``Reconstructor``).

The corpus drivers run with the synthetic stand-in detectors of both
packages on the same small corpus and must write the same trees: the same
files, dtypes and shapes, the integer landmark files byte for byte, the
float keypoint sets within 1e-6 (float32 blends whose summation order is
XLA's in one package and torch's in the other).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moditalker_tpu import cli as jcli
from moditalker_tpu.preprocess import drivers as jdrivers
from moditalker_tpu.preprocess import fan as jfan
from moditalker_tpu.preprocess import fused_align as jfused
from moditalker_tpu.preprocess import keypoints as jkeypoints
from moditalker_tpu.preprocess import recon_net as jrecon
from moditalker_tpu.preprocess import reconstructor as jreconstructor
from moditalker_tpu.preprocess.bfm import Face3DHelper as JHelper
from moditalker_tpu_torch import cli as tcli
from moditalker_tpu_torch.preprocess import align as talign
from moditalker_tpu_torch.preprocess import drivers as tdrivers
from moditalker_tpu_torch.preprocess import fan as tfan
from moditalker_tpu_torch.preprocess import fused_align as tfused
from moditalker_tpu_torch.preprocess import keypoints as tkeypoints
from moditalker_tpu_torch.preprocess import load_mats as tload_mats
from moditalker_tpu_torch.preprocess import reconstructor as treconstructor
from moditalker_tpu_torch.preprocess import s3fd as ts3fd
from moditalker_tpu_torch.preprocess.bfm import Face3DHelper as THelper
from moditalker_tpu_torch.utils.convert import (convert_fan_params,
                                                convert_recon_params)


@pytest.fixture()
def corpus(tmp_path):
    """Three identities of 6 jpeg frames (64 × 48) and their frontalized
    AToM landmarks."""
    rng = np.random.default_rng(0)
    frames_root = tmp_path / "frames"
    front_root = tmp_path / "frontalized_npy"
    for ident in ("WDA_A", "WDA_B", "WRA_C"):
        d = frames_root / ident
        d.mkdir(parents=True)
        for i in range(6):
            img = rng.integers(0, 255, (64, 48, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / f"{i:05d}.jpg")
        fd = front_root / ident
        fd.mkdir(parents=True)
        np.save(fd / "atom_0.npy",
                rng.normal(scale=0.3, size=(6, 68, 3)).astype(np.float32))
    return tmp_path, frames_root, front_root


def _tree(root) -> dict[str, np.ndarray]:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = np.load(p)
    return out


def _assert_same_tree(got_root, want_root, atol=0.0):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if want[k].dtype.kind == "i" or atol == 0:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)


def test_synthetic_detectors_match_jax():
    frames = np.random.default_rng(1).integers(0, 255, (4, 30, 40, 3),
                                               dtype=np.uint8)
    np.testing.assert_array_equal(tdrivers.synthetic_landmark_fn(frames),
                                  jdrivers.synthetic_landmark_fn(frames))
    lm5 = np.zeros((4, 5, 2))
    np.testing.assert_array_equal(tdrivers.synthetic_coeff_fn(frames, lm5),
                                  jdrivers.synthetic_coeff_fn(frames, lm5))
    np.testing.assert_array_equal(tload_mats.synthetic_lm3d_std(),
                                  jdrivers.build_detectors(synthetic=True)[2])


def test_keypoint_sets_match_jax():
    rng = np.random.default_rng(2)
    b = 5
    coeff = rng.normal(scale=0.2, size=(b, 257)).astype(np.float32)
    frames = rng.integers(0, 255, (b, 60, 80, 3), dtype=np.uint8)
    lm68 = jdrivers.synthetic_landmark_fn(frames)
    sizes = np.tile([[80, 60]], (b, 1))
    std = tload_mats.synthetic_lm3d_std()
    want = jkeypoints.keypoint_sets(coeff, lm68, sizes, JHelper.synthetic(3),
                                    std)
    got = tkeypoints.keypoint_sets(coeff, lm68, sizes, THelper.synthetic(3),
                                   std)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_bfm_math_matches_jax():
    from moditalker_tpu.preprocess import bfm as jbfm
    from moditalker_tpu_torch.preprocess import bfm as tbfm

    rng = np.random.default_rng(4)
    angles = rng.normal(scale=0.3, size=(6, 3)).astype(np.float32)
    pts = rng.normal(size=(6, 68, 3)).astype(np.float32)
    trans = rng.normal(scale=0.1, size=(6, 3)).astype(np.float32)
    rot_t, rot_j = tbfm.compute_rotation(angles), jbfm.compute_rotation(
        jnp.asarray(angles))
    assert rot_t.dtype == torch.float32
    np.testing.assert_allclose(rot_t.numpy(), rot_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbfm.rigid_transform(pts, rot_t, trans),
                               jbfm.rigid_transform(pts, rot_j, trans),
                               rtol=0, atol=1e-6)
    cam_t, cam_j = tbfm.to_camera(pts), jbfm.to_camera(jnp.asarray(pts))
    np.testing.assert_array_equal(cam_t.numpy(), cam_j)
    np.testing.assert_allclose(tbfm.to_image(cam_t), jbfm.to_image(cam_j),
                               rtol=1e-6)
    th, jh = THelper.synthetic(1), JHelper.synthetic(1)
    idc, exc = rng.normal(size=(6, 80)), rng.normal(size=(6, 64))
    np.testing.assert_allclose(th.reconstruct_lm3d(idc, exc).numpy(),
                               jh.reconstruct_lm3d(jnp.asarray(idc),
                                                   jnp.asarray(exc)),
                               rtol=0, atol=1e-6)
    coeff = rng.normal(size=(2, 257))
    for k, v in th.split_coeff(coeff).items():
        np.testing.assert_array_equal(v, jh.split_coeff(coeff)[k])
    for a, b in zip(th.eye_mouth_landmarks(pts), jh.eye_mouth_landmarks(pts)):
        np.testing.assert_array_equal(a, b)


def test_align_motion_corpus_matches_jax(corpus):
    tmp, frames_root, front_root = corpus
    outs = {}
    for name, mod in (("jax", jdrivers), ("port", tdrivers)):
        lf, cf, std, _, fused = mod.build_detectors(synthetic=True)
        assert fused is None
        outs[name] = tmp / name
        written = mod.align_motion_corpus(
            str(front_root), str(frames_root), str(outs[name]), lf, cf, std,
            chunk=4)
        assert written == {"WDA_A": 6, "WDA_B": 6, "WRA_C": 6}
        # resume: completed identities are skipped
        again = mod.align_motion_corpus(
            str(front_root), str(frames_root), str(outs[name]), lf, cf, std,
            chunk=4)
        assert again == {"WDA_A": 0, "WDA_B": 0, "WRA_C": 0}
    _assert_same_tree(outs["port"], outs["jax"])


@pytest.mark.parametrize("fn", ["align_motion_corpus",
                                "extract_keypoints_corpus"])
def test_corpus_striping_matches_jax(corpus, fn):
    """Identities stripe over ``--total`` processes as in the JAX package:
    each process takes every total-th identity, and together they write the
    whole tree."""
    tmp, frames_root, front_root = corpus
    for name, mod in (("jax", jdrivers), ("port", tdrivers)):
        lf, cf, std, helper, _ = mod.build_detectors(synthetic=True)
        out = tmp / f"striped_{name}"
        seen = []
        for pid in range(2):
            if fn == "align_motion_corpus":
                w = mod.align_motion_corpus(
                    str(front_root), str(frames_root), str(out), lf, cf, std,
                    process_id=pid, total_processes=2)
            else:
                w = mod.extract_keypoints_corpus(
                    str(frames_root), str(out), lf, cf, helper, std,
                    batch_size=4, process_id=pid, total_processes=2)
            seen.append(sorted(w))
        assert seen == [["WDA_A", "WRA_C"], ["WDA_B"]]
    _assert_same_tree(tmp / "striped_port", tmp / "striped_jax", atol=1e-6)


def test_extract_keypoints_corpus_matches_jax(corpus):
    tmp, frames_root, _ = corpus
    outs = {}
    for name, mod in (("jax", jdrivers), ("port", tdrivers)):
        lf, cf, std, helper, _ = mod.build_detectors(synthetic=True)
        outs[name] = tmp / name
        written = mod.extract_keypoints_corpus(
            str(frames_root), str(outs[name]), lf, cf, helper, std,
            batch_size=4)
        assert written == {"WDA_A": 6, "WDA_B": 6, "WRA_C": 6}
    _assert_same_tree(outs["port"], outs["jax"], atol=1e-6)

    # resume: a deleted frame's outputs are the only ones written again
    victim = outs["port"] / "fa" / "WDA_B" / "00004.npy"
    before = np.load(victim)
    victim.unlink()
    lf, cf, std, helper, _ = tdrivers.build_detectors(synthetic=True)
    again = tdrivers.extract_keypoints_corpus(
        str(frames_root), str(outs["port"]), lf, cf, helper, std,
        batch_size=4)
    assert again == {"WDA_A": 0, "WDA_B": 1, "WRA_C": 0}
    np.testing.assert_array_equal(np.load(victim), before)


@pytest.mark.parametrize("command", ["align-motion", "extract-keypoints"])
def test_commands_match_jax(corpus, command):
    """The commands through each package's own parser, with the synthetic
    detectors (``--device cpu`` for the port): the same trees."""
    tmp, frames_root, front_root = corpus
    args = {"align-motion": ["--frontalized-dir", str(front_root)],
            "extract-keypoints": ["--batch-size", "4"]}[command]
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        main([command, "--frames-dir", str(frames_root), "--out-dir",
              str(tmp / name), "--synthetic-detectors", *args, *extra])
    _assert_same_tree(tmp / "port", tmp / "jax", atol=1e-6)


def test_production_detectors_need_checkpoints(tmp_path):
    with pytest.raises(ValueError, match="--synthetic-detectors"):
        tdrivers.build_detectors(s3fd_ckpt="a.pt", device="cpu")
    args = tcli.build_parser().parse_args([
        "align-motion", "--frontalized-dir", "f", "--frames-dir", "d",
        "--out-dir", str(tmp_path)])
    assert args.device == "cuda" and not args.synthetic_detectors
    with pytest.raises(ValueError, match="--s3fd-ckpt"):
        args.fn(args)


# --------------------------------------------------------- modular detectors
@pytest.fixture(scope="module")
def small_nets():
    key = jax.random.PRNGKey(1)
    fan_p = jax.jit(jfan.FAN(num_modules=1).init)(
        key, jnp.zeros((1, 256, 256, 3)))
    recon_p = jax.jit(jrecon.ReconNet().init)(key, jnp.zeros((1, 224, 224, 3)))
    rng = np.random.default_rng(0)
    recon_p = jax.tree_util.tree_map(np.array, recon_p)
    for i in range(7):   # the heads are zero at init
        head = recon_p["params"][f"head_{i}"]
        head["kernel"] = rng.normal(0, 0.02, head["kernel"].shape).astype(
            np.float32)
    return jax.tree_util.tree_map(np.asarray, fan_p), recon_p


def test_reconstructor_matches_jax(small_nets):
    """The PIL bicubic crop and the POS params are the same numpy; the
    coefficients within 1e-4 of their max."""
    recon_p = small_nets[1]
    frames = np.random.default_rng(3).integers(0, 255, (3, 96, 80, 3),
                                               dtype=np.uint8)
    lm68 = jdrivers.synthetic_landmark_fn(frames)
    want, want_crops, want_p = jreconstructor.Reconstructor(
        recon_p, chunk=2).recon_coeff(frames, lm68, return_image=True)
    rec = treconstructor.Reconstructor(convert_recon_params(recon_p),
                                       chunk=2, device="cpu")
    got, crops, params = rec.recon_coeff(frames, lm68, return_image=True)
    np.testing.assert_array_equal(crops, want_crops)
    for g, w in zip(params, want_p):
        np.testing.assert_array_equal(g["t"], w["t"])
        assert g["s"] == w["s"]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    lm5 = talign.lm68_to_lm5(lm68)
    np.testing.assert_array_equal(rec.coeff_fn()(frames, lm5),
                                  rec._coeff(frames, lm5)[0])


def test_fan_landmarker_decodes_its_heatmaps(small_nets):
    """Batched and tracking paths: the landmarks are the JAX package's host
    decode of the port's own heatmaps (the same floats: an argmax of
    near-flat random-weight maps is not compared across two network runs)."""
    fan_p = small_nets[0]
    frames = np.random.default_rng(5).integers(0, 255, (3, 90, 70, 3),
                                               dtype=np.uint8)
    lmk = tfan.FanLandmarker(convert_fan_params(fan_p), num_modules=1,
                             chunk=2, device="cpu")
    boxes = np.array([[10, 12, 50, 60], [8, 10, 60, 70], [0, 0, 69, 89.0]])
    got = lmk.landmarks_batched(frames, boxes)
    for i in range(3):
        center, scale = jfan.bbox_to_center_scale(boxes[i])
        crop = np.clip(np.rint(jfan.crop_face(
            frames[i].astype(np.float32), center, scale)), 0, 255)
        with torch.no_grad():
            hm = lmk.model(torch.from_numpy(crop[None] / 255.0).float())[-1]
        want = jfan.heatmaps_to_landmarks(hm.numpy(), center, scale)[0]
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-9)
    tracked = tfan.FanLandmarker(convert_fan_params(fan_p), num_modules=1,
                                 initial_box=boxes[0], device="cpu")(frames)
    assert tracked.shape == (3, 68, 2) and np.isfinite(tracked).all()
    np.testing.assert_allclose(tracked[0], got[0], rtol=0, atol=1e-9)


def test_fused_aligner_rows_layout():
    assert tfused.ROW == 405
    assert (tfused._LM68, tfused._COEFF, tfused._DETECTED) == (
        slice(0, 136), slice(136, 393), 404)
    std = tload_mats.synthetic_lm3d_std()
    np.testing.assert_array_equal(tfused._pos_pinv(std),
                                  jfused._pos_pinv(std))
    assert ts3fd._BGR_MEANS.tolist() == [104.0, 117.0, 123.0]
