"""The port's alignment networks and decoders against the JAX package's, on
the CPU in float32: S3FD, FAN and ReconNet (``preprocess/s3fd.py``,
``fan.py``, ``recon_net.py``), their discrete decoders, the fused alignment
chunk and the motion aligner (``fused_align.py``, ``motion_align.py``).

Weights come from flax ``init``, with the BatchNorm statistics and scales
moved off their init values (else the conversion of the statistics would go
untested), and reach the port through ``utils/convert.py``. Networks are
held to atol 1e-4 relative to each output's max; the discrete decoders take
the same float arrays in both packages and must agree exactly (two network
runs differ at 1e-6, which can move an argmax of near-flat random-weight
maps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.preprocess import fan as jfan
from moditalker_tpu.preprocess import fused_align as jfused
from moditalker_tpu.preprocess import motion_align as jmotion
from moditalker_tpu.preprocess import recon_net as jrecon
from moditalker_tpu.preprocess import s3fd as js3fd
from moditalker_tpu.preprocess.load_mats import synthetic_lm3d_std
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.preprocess import drivers as tdrivers
from moditalker_tpu_torch.preprocess import fan as tfan
from moditalker_tpu_torch.preprocess import fused_align as tfused
from moditalker_tpu_torch.preprocess import motion_align as tmotion
from moditalker_tpu_torch.preprocess import recon_net as trecon
from moditalker_tpu_torch.preprocess import s3fd as ts3fd
from moditalker_tpu_torch.utils.convert import (convert_fan_params,
                                                convert_recon_params,
                                                convert_s3fd_params)

H = W = 96
T = 5


def _perturb(variables, seed):
    """BatchNorm scales, biases and statistics off their init values, and
    the zero-initialised ReconNet heads off zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [getattr(k, "key", "") for k in path]
        x = np.asarray(x)
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if names[-1] == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if names[-2].startswith("head_"):
            return rng.normal(0, 0.02, x.shape).astype(np.float32)
        if names[-1] == "bias" and "bn" in names[-2]:
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _with_face_bias(s3_p, bias: float):
    """S3FD's conf heads scaled down (no saturated softmax, so no ties at
    1.0) with ``bias`` added to the face logit: +2 makes every frame
    detect, -10 none."""
    p = jax.tree_util.tree_map(np.array, s3_p)
    for name, head in p["params"].items():
        if name.endswith("_mbox_conf"):
            head["kernel"] *= 0.01
            head["bias"][-1] += bias
    return p


@pytest.fixture(scope="module")
def nets():
    key = jax.random.PRNGKey(0)
    s3_p = jax.jit(js3fd.S3FD().init)(key, jnp.zeros((1, H, W, 3)))
    fan_p = jax.jit(jfan.FAN(num_modules=1).init)(
        key, jnp.zeros((1, 256, 256, 3)))
    recon_p = jax.jit(jrecon.ReconNet().init)(key, jnp.zeros((1, 224, 224, 3)))
    return (jax.tree_util.tree_map(np.asarray, s3_p), _perturb(fan_p, 1),
            _perturb(recon_p, 2))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(
        0, 255, (T, H, W, 3)).astype(np.uint8)


def _port(net, state):
    net.load_state_dict(state, strict=True)
    return net.eval()


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ------------------------------------------------------------------ networks
def test_s3fd_maps_match_jax(nets, frames):
    s3_p = nets[0]
    x = frames[..., ::-1].astype(np.float32) - js3fd._BGR_MEANS
    want = js3fd.S3FD().apply(s3_p, jnp.asarray(x))
    model = _port(ts3fd.S3FD(), convert_s3fd_params(s3_p))
    with torch.no_grad():
        got = model(ts3fd.preprocess_frames(torch.from_numpy(frames)))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_fan_heatmaps_match_jax(nets):
    fan_p = nets[1]
    x = np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 3))
    x = x.astype(np.float32)
    want = jfan.FAN(num_modules=1).apply(fan_p, jnp.asarray(x))[-1]
    model = _port(tfan.FAN(num_modules=1), convert_fan_params(fan_p))
    with torch.no_grad():
        got = model(torch.from_numpy(x))[-1]
    _close(got.numpy(), want)


def test_recon_net_matches_jax(nets):
    recon_p = nets[2]
    x = np.random.default_rng(2).uniform(0, 1, (2, 224, 224, 3))
    x = x.astype(np.float32)
    want = jrecon.ReconNet().apply(recon_p, jnp.asarray(x))
    model = _port(trecon.ReconNet(), convert_recon_params(recon_p))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 257)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["s3fd", "fan", "recon"])
def test_converted_state_dict_loads_strict(nets, name):
    """Every parameter and buffer named, running statistics carried over
    (not left at 0 / 1), ``num_batches_tracked`` where torch has one."""
    variables, net, convert = {
        "s3fd": (nets[0], ts3fd.S3FD(), convert_s3fd_params),
        "fan": (nets[1], tfan.FAN(num_modules=1), convert_fan_params),
        "recon": (nets[2], trecon.ReconNet(), convert_recon_params)}[name]
    state = convert(variables)
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state, strict=True)
    means = [k for k in state if k.endswith("running_mean")]
    assert (name == "s3fd") == (not means)
    for k in means:
        assert state[k].abs().max() > 0
        assert state[k.replace("mean", "var")].min() >= 0.5


@pytest.mark.parametrize("name", ["s3fd", "fan", "recon"])
def test_reference_checkpoint_conversion_matches_jax(nets, name):
    """A reference torch state_dict (the layout of face_alignment's and
    Deep3DFaceRecon's .pth, rebuilt here from the JAX tree) goes through the
    port's ``convert_<net>`` to the same tree as the JAX package's."""
    variables = nets[{"s3fd": 0, "fan": 1, "recon": 2}[name]]
    sd = _reference_state_dict(name, variables)
    port = {"s3fd": ts3fd.convert_s3fd, "fan": tfan.convert_fan,
            "recon": trecon.convert_recon_net}[name]
    jax_ = {"s3fd": js3fd.convert_s3fd, "fan": jfan.convert_fan,
            "recon": jrecon.convert_recon_net}[name]
    args = (1,) if name == "fan" else ()
    got, want = port(sd, *args), jax_(sd, *args)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    for (p, a), (_, b) in zip(
            flat_got, jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def _reference_state_dict(name, variables):
    """The reference checkpoint's names for ``variables`` (inverse of the
    JAX package's converters)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = {}

    def conv(src, d):
        sd[f"{src}.weight"] = np.asarray(d["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in d:
            sd[f"{src}.bias"] = np.asarray(d["bias"])

    def bn(src, d, st):
        sd[f"{src}.weight"], sd[f"{src}.bias"] = d["scale"], d["bias"]
        sd[f"{src}.running_mean"], sd[f"{src}.running_var"] = (st["mean"],
                                                                st["var"])

    if name == "s3fd":
        for n, d in p.items():
            if "kernel" in d:
                conv(n, d)
            else:
                sd[f"{n}.weight"] = d["weight"]
        return sd

    if name == "recon":
        bb, bs = p["backbone"], s["backbone"]
        conv("backbone.conv1", bb["conv1"])
        bn("backbone.bn1", bb["bn1"], bs["bn1"])
        for key, blk in bb.items():
            if not key.startswith("layer"):
                continue
            li, bi = key[5:].split("_")
            pre = f"backbone.layer{li}.{bi}"
            for ci in (1, 2, 3):
                conv(f"{pre}.conv{ci}", blk[f"conv{ci}"])
                bn(f"{pre}.bn{ci}", blk[f"bn{ci}"], bs[key][f"bn{ci}"])
            if "ds_conv" in blk:
                conv(f"{pre}.downsample.0", blk["ds_conv"])
                bn(f"{pre}.downsample.1", blk["ds_bn"], bs[key]["ds_bn"])
        for i in range(7):
            d = p[f"head_{i}"]
            sd[f"final_layers.{i}.weight"] = np.asarray(
                d["kernel"]).T[:, :, None, None]
            sd[f"final_layers.{i}.bias"] = d["bias"]
        return sd

    def block(src, d, st):
        for i in (1, 2, 3):
            conv(f"{src}.conv{i}", d[f"conv{i}"])
            bn(f"{src}.bn{i}", d[f"bn{i}"], st[f"bn{i}"])
        if "ds_conv" in d:
            bn(f"{src}.downsample.0", d["ds_bn"], st["ds_bn"])
            conv(f"{src}.downsample.2", d["ds_conv"])

    for key, d in p.items():
        if key.startswith("m") and key[1:].isdigit():
            for sub, dd in d.items():
                block(f"{key}.{sub}", dd, s[key][sub])
        elif "conv1" in d and "bn1" in d:          # a ConvBlock
            block(key, d, s[key])
        elif "kernel" in d:
            conv(key, d)
        else:
            bn(key, d, s[key])
    return sd


# ------------------------------------------------------------------ decoders
def _random_maps(seed, t=T, hw=96, peaky=False):
    """conf/loc maps of the 6 scales as S3FD's heads give them."""
    rng = np.random.default_rng(seed)
    olist = []
    for i in range(6):
        s = max(hw // (2 << (i + 1)), 1)
        logits = rng.normal(scale=3.0 if peaky else 1.0, size=(t, s, s, 2))
        conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        olist += [conf.astype(np.float32),
                  rng.normal(scale=0.3, size=(t, s, s, 4)).astype(np.float32)]
    return olist


@pytest.mark.parametrize("seed,threshold", [(3, 0.5), (4, 0.9), (5, 0.999)])
def test_detection_decoders_match_jax_exactly(seed, threshold):
    olist = _random_maps(seed, peaky=True)
    want = js3fd.decode_detections_batch(olist, threshold)
    got = ts3fd.decode_detections_batch(olist, threshold)
    assert len(got) == len(want) == T
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ts3fd.decode_detections(olist, threshold),
                                  js3fd.decode_detections(olist, threshold))
    dets = np.concatenate(want)
    if len(dets):
        assert ts3fd.nms(dets, 0.3) == js3fd.nms(dets, 0.3)
    # top-k on the device: torch.topk and lax.top_k may order candidates
    # of equal score differently, so the boxes are compared after the decode
    # and NMS, where every count fits the budget (the detectors fetch the
    # full maps where one does not), on maps without two equal scores (NMS
    # keeps the first of two equal overlapping boxes it is given)
    olist = _random_maps(seed + 100)
    for k in (8, 128, 1024):
        t_c = ts3fd.topk_candidates_packed(
            [torch.from_numpy(o) for o in olist], k, threshold).numpy()
        j_c = np.asarray(js3fd.topk_candidates_packed(
            [jnp.asarray(o) for o in olist], k, threshold))
        assert t_c.shape == j_c.shape
        np.testing.assert_array_equal(t_c[:, :, 0], j_c[:, :, 0])
        if j_c[:, :, 0, 0].max() > k:
            continue
        for g, w in zip(ts3fd.decode_candidates_packed(t_c, threshold),
                        js3fd.decode_candidates_packed(j_c, threshold)):
            np.testing.assert_array_equal(g, w)


class _FixedCandidates:
    """``_apply_topk`` / ``_topk`` stand-in: the same packed candidates for
    both packages' detectors (no network run)."""

    def __init__(self, cands):
        self.cands = cands

    def __call__(self, *args):
        part = args[-1]
        n = part.shape[0]
        out, self.cands = self.cands[:n], self.cands[n:]
        return out


@pytest.mark.parametrize("missing", [(), (0,), (1, 2), (4,), (0, 1, 2, 3, 4)])
def test_box_gap_fill_matches_jax(missing):
    olist = _random_maps(11, peaky=True)
    cands = np.asarray(js3fd.topk_candidates_packed(
        [jnp.asarray(o) for o in olist], 1024, 0.5)).copy()
    for i in missing:
        cands[i, :, 1:, 0] = 0.0   # no anchor above the threshold
    frames = np.zeros((T, 8, 8, 3), np.uint8)
    jdet = js3fd.S3FDDetector.__new__(js3fd.S3FDDetector)
    jdet.threshold, jdet.chunk, jdet.topk, jdet.params = 0.5, 2, 1024, None
    jdet._apply_topk = _FixedCandidates(cands)
    tdet = ts3fd.S3FDDetector.__new__(ts3fd.S3FDDetector)
    tdet.threshold, tdet.chunk, tdet.topk = 0.5, 2, 1024
    tdet._topk = lambda part, c=_FixedCandidates(cands): torch.from_numpy(
        c(part))
    want, got = jdet.boxes_for_frames(frames), tdet.boxes_for_frames(frames)
    if want is None:
        assert got is None and len(missing) == T
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heatmap_decode_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    hm = rng.normal(size=(3, 64, 64, 68)).astype(np.float32)
    hm[0, 0, :, 5] = 9.0           # maxima on the border, and ties
    hm[1, 63, 63, 7] = 9.0
    hm[2, 10, 20:22, 3] = 9.0
    want = np.asarray(jfan.decode_heatmaps_jnp(jnp.asarray(hm)))
    got = tfan.decode_heatmaps(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(got, want)
    center, scale = np.array([40.5, 51.25]), 1.37
    np.testing.assert_array_equal(
        tfan.heatmaps_to_landmarks(hm, center, scale),
        jfan.heatmaps_to_landmarks(hm, center, scale))
    np.testing.assert_array_equal(tfan.heatmaps_to_landmarks(hm),
                                  jfan.heatmaps_to_landmarks(hm))


@pytest.mark.parametrize("seed", [3, 4])
def test_best_box_matches_jax(seed):
    """The same anchor (its score exactly); the box through float32 ``exp``,
    whose last bit differs between XLA's and torch's (rtol 1e-6)."""
    olist = _random_maps(seed)
    box_j, score_j = jfused.best_box_per_frame([jnp.asarray(o)
                                                for o in olist])
    box_t, score_t = tfused.best_box_per_frame([torch.from_numpy(o)
                                                for o in olist])
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
    np.testing.assert_allclose(box_t.numpy(), np.asarray(box_j), rtol=1e-6)


def test_crop_helpers_match_jax():
    img = np.random.default_rng(0).uniform(0, 255, (50, 70, 3))
    img = img.astype(np.float32)
    for center, scale in (([30.2, 20.7], 0.4), ([-10.0, 90.0], 2.6),
                          ([35.5, 25.5], 0.1)):
        np.testing.assert_array_equal(
            tfan.crop_face(img, center, scale),
            jfan.crop_face(img, center, scale))
    for a in (np.array([3.0, 4.0, 40.0, 52.0]),
              np.random.default_rng(1).uniform(0, 60, (68, 2))):
        tc, ts_ = tfan.bbox_to_center_scale(a)
        jc, js_ = jfan.bbox_to_center_scale(a)
        np.testing.assert_array_equal(tc, jc)
        assert ts_ == js_


# ------------------------------------------------------------- fused chunk
_CONTINUOUS = ("lm68", "coeff", "t", "s", "center", "scale", "boxes",
               "scores")


def _fused_pair(nets, bias):
    s3_p, fan_p, recon_p = nets
    s3_p = _with_face_bias(s3_p, bias)
    lm3d = synthetic_lm3d_std()
    jf = jfused.FusedAligner(s3_p, fan_p, recon_p, lm3d, threshold=0.5,
                             chunk=4, num_modules=1)
    tf = tfused.FusedAligner(
        convert_s3fd_params(s3_p), convert_fan_params(fan_p),
        convert_recon_params(recon_p), lm3d, threshold=0.5, chunk=4,
        num_modules=1, device="cpu")
    return jf, tf


def test_fused_process_matches_jax(nets, frames):
    """T = 5 at 96², chunk 4 (one padded chunk): the continuous rows within
    atol 1e-3, ``detected`` equal, and no kernel launched."""
    jf, tf = _fused_pair(nets, 2.0)
    want = jf.process(frames)
    tkernels.reset_launch_counts()
    got = tf.process(frames)
    assert not any(tkernels.LAUNCHES.values())
    assert want["detected"].all()
    np.testing.assert_array_equal(got["detected"], want["detected"])
    for k in _CONTINUOUS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)


def test_motion_aligner_matches_jax(nets, frames):
    """``align_sequence`` on the fused path (every frame detects) and, with
    no detection, through the modular fallback (synthetic stand-in
    detectors): the floats before the int cast within 1e-4 px."""
    lm3d = synthetic_lm3d_std()
    atom = np.random.default_rng(3).normal(scale=0.3, size=(T, 68, 3))
    for bias in (2.0, -10.0):
        jf, tf = _fused_pair(nets, bias)
        want = jmotion.MotionAligner(
            tdrivers.synthetic_landmark_fn, tdrivers.synthetic_coeff_fn,
            lm3d, fused=jf).align_sequence(atom, frames)
        aligner = tmotion.MotionAligner(
            tdrivers.synthetic_landmark_fn, tdrivers.synthetic_coeff_fn,
            lm3d, fused=tf)
        got = aligner.align_sequence(atom, frames)
        assert tf.process(frames)["detected"].all() == (bias > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("given_pos", [False, True])
def test_pose_align_landmarks_matches_jax(given_pos):
    rng = np.random.default_rng(4)
    t = 6
    atom = rng.normal(scale=0.3, size=(t, 68, 3))
    coeff = rng.normal(scale=0.1, size=(t, 257)).astype(np.float32)
    lm68 = tdrivers.synthetic_landmark_fn(
        rng.integers(0, 255, (t, 60, 80, 3), dtype=np.uint8))
    sizes = np.tile([[80, 60]], (t, 1))
    kw = {}
    if given_pos:
        kw = dict(crop_t=rng.uniform(30, 50, (t, 2)),
                  crop_s=rng.uniform(0.8, 1.2, t))
    want = jmotion.pose_align_landmarks(atom, coeff, lm68, sizes,
                                        synthetic_lm3d_std(), **kw)
    got = tmotion.pose_align_landmarks(atom, coeff, lm68, sizes,
                                       synthetic_lm3d_std(), **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
