"""The port's preprocessing nets with a bf16 trunk (``dtype=torch.bfloat16``)
against the JAX package's with ``dtype=jnp.bfloat16``, on the CPU: HuBERT,
S3FD and its detector, FAN and its landmarker, ReconNet and its
reconstructor, and the fused alignment chunk; and the two ways a BatchNorm
writes its output (FAN's float32, ReconNet's bf16).

Weights are drawn from a seed with numpy in the JAX package's trees (the
shapes from ``jax.eval_shape``), with the BatchNorm statistics, scales and
biases moved off their init values (``test_torch_align._perturb``), and
reach the port through ``utils/convert.py``. Inputs are numpy arrays drawn
from a seed.

Tolerances:

* A float output: max |port bf16 − JAX float32| at most ``REF_FACTOR`` (2,
  ``chip_smoke.py``'s factor for the card against the CPU) times
  max |JAX bf16 − JAX float32|, plus ``REL_FLOOR`` (1e-3) of max |JAX
  float32|. The floor covers one bf16 rounding of an O(1) output that the
  JAX package's CPU program does not make: XLA on the CPU drops a bf16
  rounding that a float32 cast follows (S3FD's conf logits before their
  float32 softmax read 20× closer to float32 in JAX than flax's dtype
  rules give on the card, where the port rounds them).
* A landmark: only a point whose decode is *determined*
  (``chip_smoke.determined_points``) is compared: its float32 heatmap's top
  value beats the runner-up, and the neighbours that set its ±0.25 shift
  differ, by more than twice the largest bf16 error on that heatmap (JAX's
  and the port's; each of two values may move by it). Every determined
  point equals JAX bf16's within 1e-2 px, and at least half the points are
  determined. Random heads give flat heatmaps (no point determined), so
  FAN's last head is a discriminant of its input features at bright cells
  of the crops (``_peaked_fan``), as ``chip_smoke.py::align_states`` makes
  S3FD's face head a detector of its frames' face.
* A detection: the flag, and the anchor of the best box, equal; the box
  by the float rule. With ``_with_face_bias``'s flat random heads the best
  face score beats the runner-up by 1e-5 to 2e-5, below bf16's resolution
  of the logit, so the detector and the fused chunk run a peaked S3FD face
  head (``_peaked_s3fd``) on frames that hold one noise patch, where the
  runner-up trails by about 0.13; the maps alone are held with
  ``_with_face_bias(+2)``'s heads.

The module runs with one torch thread (``torch_threads.py``).
"""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu.preprocess import fan as jfan
from moditalker_tpu.preprocess import fused_align as jfused
from moditalker_tpu.preprocess import hubert as jhubert
from moditalker_tpu.preprocess import recon_net as jrecon
from moditalker_tpu.preprocess import reconstructor as jreconstructor
from moditalker_tpu.preprocess import s3fd as js3fd
from moditalker_tpu.preprocess.load_mats import synthetic_lm3d_std
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.preprocess import audio as taudio
from moditalker_tpu_torch.preprocess import drivers as tdrivers
from moditalker_tpu_torch.preprocess import fan as tfan
from moditalker_tpu_torch.preprocess import fused_align as tfused
from moditalker_tpu_torch.preprocess import hubert as thubert
from moditalker_tpu_torch.preprocess import recon_net as trecon
from moditalker_tpu_torch.preprocess import reconstructor as treconstructor
from moditalker_tpu_torch.preprocess import s3fd as ts3fd
from moditalker_tpu_torch.utils.convert import (convert_fan_params,
                                                convert_hubert_params,
                                                convert_recon_params,
                                                convert_s3fd_params)

from .test_torch_align import _perturb, _with_face_bias
from .test_torch_audio import TINY
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
# the card's check and this one share the factor and the landmark rule
REF_FACTOR = _smoke.REF_FACTOR
determined_points = _smoke.determined_points

BF = jnp.bfloat16
REL_FLOOR = 1e-3
POINT_TOL = 1e-2     # px, a determined landmark
H = W = 96
T = 5


def _limit(want32, want16):
    """The float rule's limit on an output."""
    want32, want16 = (np.asarray(a, np.float64) for a in (want32, want16))
    return (REF_FACTOR * np.abs(want16 - want32).max()
            + REL_FLOOR * np.abs(want32).max())


def _hold(got, want32, want16, what=""):
    """The float rule; returns its limit."""
    got, want32, want16 = (np.asarray(a, np.float64)
                           for a in (got, want32, want16))
    assert got.shape == want32.shape == want16.shape, what
    limit = _limit(want32, want16)
    err = np.abs(got - want32).max()
    assert err <= limit, f"{what}: {err:.3e} > {limit:.3e}"
    return limit


def _params(model, shape, seed):
    """The model's variables drawn from ``seed``: kernels with a LeCun
    normal scale (flax's default), biases N(0, 0.05), S3FD's L2Norm scales
    in [4, 10], then the BatchNorms off their init (``_perturb``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            scale = float(np.prod(s.shape[:-1])) ** -0.5
            return rng.normal(0, scale, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        if name == "weight":
            return rng.uniform(4, 10, s.shape).astype(np.float32)
        return np.ones(s.shape, np.float32)

    return _perturb(jax.tree_util.tree_map_with_path(leaf, shapes), seed)


def _port(net, state):
    net.load_state_dict(state, strict=True)
    return net.eval()


# ------------------------------------------------------------------ HuBERT
@pytest.mark.parametrize("masked", [False, True])
def test_hubert_bf16_matches_jax(masked):
    """Two waves through a 2-layer HuBERT (head dim 16), unmasked and with
    a frame mask on zero-padded waves (the attention's plain route, as
    ``hubert_forward`` runs every call); ``hubert_forward`` gives the bf16
    model's features as float32."""
    cfg = jhubert.HubertConfig(**TINY)
    params = _params(jhubert.HubertEncoder(cfg), (1, 1600), 3)
    wave = np.random.default_rng(4).normal(size=(2, 1600)).astype(np.float32)
    kw = {}
    if masked:
        n = np.array([1100, 1500])
        wave[0, n[0]:] = wave[1, n[1]:] = 0
        frames = [taudio.conv_out_frames(int(v), cfg) for v in n]
        kw = {"n_frames": np.array(frames, np.int32)}
    want32, want16 = (np.asarray(jhubert.HubertEncoder(cfg, d).apply(
        params, jnp.asarray(wave), **{k: jnp.asarray(v)
                                      for k, v in kw.items()}),
        np.float32) for d in (jnp.float32, BF))
    model = _port(thubert.HubertEncoder(thubert.HubertConfig(**TINY),
                                        torch.bfloat16),
                  convert_hubert_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(wave),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.bfloat16
    _hold(got.float().numpy(), want32, want16, "features")
    if masked:
        feats = taudio.hubert_forward(model, "cpu", bucket_samples=1600)(
            wave[:1, :1100])
        with torch.no_grad():
            one = model(torch.from_numpy(wave[:1]),
                        n_frames=torch.tensor(frames[:1]))
        assert feats.dtype == np.float32
        np.testing.assert_array_equal(
            feats, one[0, :frames[0]].float().numpy())


# ------------------------------------------------------------------- S3FD
@pytest.fixture(scope="module")
def s3fd_params():
    return _params(js3fd.S3FD(), (1, H, W, 3), 5)


def _s3fd_maps(params, frames):
    """The JAX package's 12 maps in float32 and in bf16, then the port's
    in bf16."""
    x = jnp.asarray(frames[..., ::-1].astype(np.float32) - js3fd._BGR_MEANS)
    want32, want16 = ([np.asarray(m, np.float32) for m in
                       jax.jit(js3fd.S3FD(dtype=d).apply)(params, x)]
                      for d in (jnp.float32, BF))
    model = _port(ts3fd.S3FD(torch.bfloat16), convert_s3fd_params(params))
    with torch.no_grad():
        got = model(ts3fd.preprocess_frames(torch.from_numpy(frames)))
    return want32, want16, got


def test_s3fd_bf16_maps_match_jax(s3fd_params):
    """The 12 maps of five random frames with ``_with_face_bias(+2)``'s
    heads, float32 out of a bf16 trunk, each by the float rule."""
    frames = np.random.default_rng(7).integers(
        0, 255, (T, H, W, 3)).astype(np.uint8)
    want32, want16, got = _s3fd_maps(_with_face_bias(s3fd_params, 2.0),
                                     frames)
    assert len(got) == 12
    for i, (g, w32, w16) in enumerate(zip(got, want32, want16)):
        assert g.dtype == torch.float32
        _hold(g.numpy(), w32, w16, f"map {i}")


def _patch_frames(seed):
    """T frames of black holding one 16² patch of sparse bright pixels (the
    same patch in every frame) at positions on the trunk's 8-pixel pooling
    grid, away from the border: one "face" per frame, whose pixels FAN's
    crop magnifies to markers (``_peaked_fan``)."""
    rng = np.random.default_rng(seed)
    patch = np.zeros((16, 16, 3), np.uint8)
    for cy in range(4):
        for cx in range(4):
            y, x = (cy * 4, cx * 4) + rng.integers(0, 3, 2)
            patch[y, x] = rng.integers(80, 256, 3)
    frames = np.zeros((T, H, W, 3), np.uint8)
    corners = rng.integers(3, 8, (T, 2)) * 8
    for i, (y, x) in enumerate(corners):
        frames[i, y:y + 16, x:x + 16] = patch
    return frames, corners


def _peaked_s3fd(params, frames, corners):
    """S3FD with one face head: every conf weight zero but the stride-4
    face logit's centre tap, set to û · (f − (f_face + f̄) / 2), f the
    L2-normalised conv3_3 feature at an anchor, f_face the one at frame 0's
    patch centre, f̄ the mean over frame 0's anchors, û the unit vector
    along f_face − f̄. The features come from the port in float32 (held
    to the JAX package's in ``test_torch_align.py``)."""
    p = jax.tree_util.tree_map(np.array, params)
    model = _port(ts3fd.S3FD(), convert_s3fd_params(p))
    with torch.no_grad():
        f3 = model.features(ts3fd.preprocess_frames(
            torch.from_numpy(frames[:1])))["f3"][0].numpy()
    cy, cx = (corners[0] + 8) // 4
    face, mean = f3[:, cy, cx], f3.mean(axis=(1, 2))
    u = (face - mean) / np.linalg.norm(face - mean)
    for name, head in p["params"].items():
        if name.endswith("_mbox_conf"):
            head["kernel"][:] = 0
            head["bias"][:] = 0
    head = p["params"]["conv3_3_norm_mbox_conf"]
    head["kernel"][1, 1, :, 3] = u
    head["bias"][3] = -float(u @ (face + mean) / 2)
    return p


@pytest.fixture(scope="module")
def patch_scene(s3fd_params):
    frames, corners = _patch_frames(8)
    return frames, _peaked_s3fd(s3fd_params, frames, corners)


def _anchors(olist):
    """The best face anchor per frame over the six scales: (scale, cell)."""
    scores = [np.asarray(c)[..., 1].reshape(len(c), -1) for c in olist[0::2]]
    flat = np.concatenate(scores, axis=1)
    return flat.argmax(axis=1)


def test_s3fd_detector_bf16_matches_jax(patch_scene):
    """``S3FDDetector(dtype=bf16)``: every frame detects at the JAX
    package's anchor, its box by the float rule, on the peaked head."""
    frames, params = patch_scene
    want32, want16, got = _s3fd_maps(params, frames)
    np.testing.assert_array_equal(_anchors(got), _anchors(want16))
    np.testing.assert_array_equal(_anchors(want16), _anchors(want32))
    det32, det16 = (js3fd.S3FDDetector(params, dtype=d, chunk=4)
                    for d in (None, BF))
    det = ts3fd.S3FDDetector(convert_s3fd_params(params), chunk=4,
                             device="cpu", dtype=torch.bfloat16)
    assert det.model.conv1_1.weight.dtype == torch.float32
    boxes = det.boxes_for_frames(frames)
    assert boxes is not None
    _hold(boxes, det32.boxes_for_frames(frames),
          det16.boxes_for_frames(frames), "boxes")


# -------------------------------------------------------------------- FAN
def _fan_features(params, crops01):
    """The input of FAN's last heatmap head (``l0``) on crops in 0..1,
    [B, 256, 64, 64], from the port in float32."""
    model = _port(tfan.FAN(num_modules=1), convert_fan_params(params))
    seen = []
    hook = model.l0.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    with torch.no_grad():
        model(torch.from_numpy(crops01.astype(np.float32)))
    hook.remove()
    return seen[0].numpy()


def _peaked_fan(params, crops01):
    """FAN whose heatmap head is ``chip_smoke.fan_discriminant`` of its
    float32 features on ``crops01`` (the card's check peaks its FAN so):
    heatmap j of each crop peaks at one of its bright cells. Random heads
    on noise crops leave no point determined, and plain templates of the
    features at bright markers a third (neighbouring cells share most of
    their features); the discriminant puts 90 % of the argmaxes on their
    cell and leaves two thirds of the points determined."""
    p = jax.tree_util.tree_map(np.array, params)
    kernel, bias = _smoke.fan_discriminant(_fan_features(p, crops01),
                                           crops01)
    p["params"]["l0"]["kernel"][0, 0] = kernel
    p["params"]["l0"]["bias"] = bias
    return p


def _marker_frames(n, seed):
    """``n`` black frames with 3 × 3 markers of random colours on a grid of
    7-pixel cells in the middle: FAN's crop magnifies each to a blob of
    about two heatmap cells."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, H, W, 3), np.uint8)
    for frame in frames:
        for cy in range(2, 12):
            for cx in range(2, 12):
                if rng.uniform() < 0.5:
                    y, x = cy * 7 + rng.integers(0, 3, 2)
                    frame[y:y + 3, x:x + 3] = rng.integers(80, 256, 3)
    return frames


@pytest.fixture(scope="module")
def fan_scene():
    """Two marker frames, a box each, the landmarker's uint8 crops, a FAN
    (one module) peaked on those crops, and its last heatmaps: JAX float32,
    JAX bf16 and the port's bf16."""
    frames = _marker_frames(2, 9)
    boxes = np.array([[14.0, 20.0, 80.0, 78.0], [18.0, 12.0, 84.0, 76.0]])
    crops = []
    for frame, box in zip(frames, boxes):
        center, scale = tfan.bbox_to_center_scale(box)
        crops.append(tfan.crop_face(frame.astype(np.float32), center, scale))
    crops_u8 = np.clip(np.rint(np.stack(crops)), 0, 255).astype(np.uint8)
    base = _params(jfan.FAN(num_modules=1), (1, 256, 256, 3), 1)
    params = _peaked_fan(base, crops_u8 / 255.0)
    x = crops_u8.astype(np.float32) / 255.0
    want32, want16 = (np.asarray(jax.jit(
        lambda p, x, d=d: jfan.FAN(num_modules=1, dtype=d).apply(p, x)[-1])(
            params, jnp.asarray(x)), np.float32) for d in (jnp.float32, BF))
    model = _port(tfan.FAN(1, torch.bfloat16), convert_fan_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))[-1]
    return frames, boxes, params, want32, want16, got


def test_fan_bf16_heatmaps_match_jax(fan_scene):
    """The last heatmaps by the float rule, bf16 out of a bf16 trunk; the
    decoded points equal JAX bf16's within 1e-2 (heatmap) px where
    determined, at least half of them."""
    _, _, _, want32, want16, hm = fan_scene
    assert hm.dtype == torch.bfloat16
    _hold(hm.float().numpy(), want32, want16, "heatmaps")
    ok = determined_points(want32, want16, hm.float().numpy())
    assert ok.mean() >= 0.5, ok.mean()
    got = tfan.decode_heatmaps(hm).numpy()
    want = np.asarray(jfan.decode_heatmaps_jnp(jnp.asarray(want16)))
    assert np.abs(got - want).max(-1)[ok].max() <= POINT_TOL


def test_fan_landmarker_bf16_matches_jax(fan_scene):
    """``FanLandmarker(dtype=bf16).landmarks_batched``: image-space points
    equal JAX bf16's within 1e-2 px where determined."""
    frames, boxes, params, want32, want16, hm = fan_scene
    ok = determined_points(want32, want16, hm.float().numpy())
    want = jfan.FanLandmarker(params, num_modules=1, chunk=2,
                              dtype=BF).landmarks_batched(frames, boxes)
    lm = tfan.FanLandmarker(convert_fan_params(params), num_modules=1,
                            chunk=2, device="cpu", dtype=torch.bfloat16)
    assert lm.model.conv1.weight.dtype == torch.float32
    got = lm.landmarks_batched(frames, boxes)
    assert ok.mean() >= 0.5
    assert np.abs(got - want).max(-1)[ok].max() <= POINT_TOL


# --------------------------------------------------------------- ReconNet
@pytest.fixture(scope="module")
def recon_params():
    return _params(jrecon.ReconNet(), (1, 224, 224, 3), 2)


def test_recon_net_bf16_matches_jax(recon_params):
    """257 coefficients (float32 heads on a bf16 trunk) by the float
    rule."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 224, 224, 3))
    x = jnp.asarray(x.astype(np.float32))
    want32, want16 = (np.asarray(jax.jit(jrecon.ReconNet(dtype=d).apply)(
        recon_params, x)) for d in (jnp.float32, BF))
    model = _port(trecon.ReconNet(torch.bfloat16),
                  convert_recon_params(recon_params))
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == (2, 257)
    _hold(got.numpy(), want32, want16, "coefficients")


def test_reconstructor_bf16_matches_jax(recon_params):
    """``Reconstructor(dtype=bf16).recon_coeff`` on two frames with the
    synthetic landmarks (the PIL crop): coefficients by the float rule,
    the crop params equal."""
    frames = np.random.default_rng(11).integers(
        0, 255, (2, H, W, 3)).astype(np.uint8)
    lm68 = tdrivers.synthetic_landmark_fn(frames)
    lm3d = synthetic_lm3d_std()
    (want32, p32), (want16, _) = (
        jreconstructor.Reconstructor(recon_params, lm3d, chunk=2,
                                     dtype=d).recon_coeff(frames, lm68)
        for d in (None, BF))
    rec = treconstructor.Reconstructor(
        convert_recon_params(recon_params), lm3d, chunk=2, device="cpu",
        dtype=torch.bfloat16)
    got, params = rec.recon_coeff(frames, lm68)
    assert got.dtype == np.float32
    for a, b in zip(params, p32):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    _hold(got, want32, want16, "coefficients")


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("flax_dtype,port_dtype", [
    (None, torch.float32), (BF, torch.bfloat16)])
def test_batchnorm_output_dtype_both_ways(flax_dtype, port_dtype):
    """A bf16 input through flax's ``BatchNorm(use_running_average=True)``
    without a dtype (FAN's) writes float32, with ``dtype=bf16``
    (ReconNet's) bf16; the port's ``BatchNorm2d`` writes the same type and
    values (within one float32 rounding before the bf16 cast, 1e-6 of the
    output's max). FAN's and ReconNet's first BatchNorms are built so."""
    rng = np.random.default_rng(12)
    c = 16
    x = rng.normal(size=(2, 5, 5, c)).astype(np.float32)
    x16 = np.asarray(jnp.asarray(x, BF))
    stats = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-5,
                       dtype=flax_dtype)
    want = bn.apply({"params": {"scale": scale, "bias": bias},
                     "batch_stats": stats}, jnp.asarray(x16))
    fan_bn = tfan.FAN(1, torch.bfloat16).bn1
    recon_bn = trecon.ReconNet(torch.bfloat16).backbone.bn1
    port_bn = fan_bn if flax_dtype is None else recon_bn
    port_bn = type(port_bn)(c, eps=1e-5, dtype=port_bn.out_dtype).eval()
    with torch.no_grad():
        port_bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port_bn.running_var.copy_(torch.from_numpy(stats["var"]))
        port_bn.weight.copy_(torch.from_numpy(scale))
        port_bn.bias.copy_(torch.from_numpy(bias))
        got = port_bn(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == port_dtype
    assert want.dtype == (jnp.float32 if flax_dtype is None else BF)
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    if flax_dtype is None:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:   # one bf16 rounding of values a float32 ulp apart: one ulp
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


# ----------------------------------------------------------- fused chunk
def test_fused_chunk_bf16_matches_jax(patch_scene, recon_params):
    """``FusedAligner(dtype=bf16).process`` on five patch frames (chunk 4,
    one padded chunk), the peaked S3FD and a FAN peaked on the chunk's
    crops: the flags equal (every frame detects), the box, score, centre
    and scale by the float rule, the landmarks equal JAX bf16's within
    1e-2 px where determined (at least half), the POS params and the
    coefficients by the float rule on the frames whose seven points of the
    POS solve (``align.extract_5p``'s) equal JAX bf16's within 1e-2 px (at
    least one), and no kernel launched."""
    frames, s3_p = patch_scene
    lm3d = synthetic_lm3d_std()
    base = _params(jfan.FAN(num_modules=1), (1, 256, 256, 3), 1)
    # the chunk's FAN crops, as the port's float32 chunk makes them (held
    # to the JAX package's in test_torch_align.py): the frames hold one
    # patch on the pooling grid, so the crops agree and one discriminant
    # serves them all
    probe = tfused.FusedAligner(
        convert_s3fd_params(s3_p), convert_fan_params(base),
        convert_recon_params(recon_params), lm3d, chunk=4, num_modules=1,
        device="cpu")
    seen = []
    probe.fan.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    probe.process(frames)
    crops = torch.cat(seen)[:T].numpy()
    np.testing.assert_array_equal(crops, np.broadcast_to(crops[:1],
                                                         crops.shape))
    x = crops[:1]
    fan_p = _peaked_fan(base, x)
    hm32, hm16 = (np.asarray(jax.jit(
        lambda p, x, d=d: jfan.FAN(num_modules=1, dtype=d).apply(p, x)[-1])(
            fan_p, jnp.asarray(x)), np.float32) for d in (jnp.float32, BF))
    with torch.no_grad():
        hm = _port(tfan.FAN(1, torch.bfloat16), convert_fan_params(fan_p))(
            torch.from_numpy(x))[-1].float().numpy()
    want32, want16 = (jfused.FusedAligner(
        s3_p, fan_p, recon_params, lm3d, chunk=4, num_modules=1,
        dtype=d).process(frames) for d in (None, BF))
    aligner = tfused.FusedAligner(
        convert_s3fd_params(s3_p), convert_fan_params(fan_p),
        convert_recon_params(recon_params), lm3d, chunk=4, num_modules=1,
        device="cpu", dtype=torch.bfloat16)
    tkernels.reset_launch_counts()
    got = aligner.process(frames)
    assert not any(tkernels.LAUNCHES.values())
    assert want32["detected"].all()
    np.testing.assert_array_equal(got["detected"], want16["detected"])
    np.testing.assert_array_equal(got["detected"], want32["detected"])
    for k in ("boxes", "scores", "center", "scale"):
        _hold(got[k], want32[k], want16[k], k)
    ok = np.repeat(determined_points(hm32, hm16, hm), T, axis=0)
    assert ok.mean() >= 0.5
    assert np.abs(got["lm68"] - want16["lm68"]).max(-1)[ok].max() \
        <= POINT_TOL
    pos = [30, 36, 39, 42, 45, 48, 54]
    same = (np.abs(got["lm68"] - want16["lm68"])[:, pos].max((1, 2))
            <= POINT_TOL)
    assert same.any()
    for k in ("t", "s", "coeff"):
        _hold(got[k][same], want32[k][same], want16[k][same], k)
