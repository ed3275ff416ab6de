"""The port's evals and video tools vs the JAX package, on the CPU.

* I3D against the JAX I3D at [1, 9, 224, 224, 3] (1e-3 of the logits'
  scale, as ``tests/test_evals.py``), the JAX weights made from the port's
  ``state_dict`` by the JAX package's own reader of the reference's keys
  (``convert_i3d``): so the port's module names are the reference's.
* FVD (preprocessing, the matrix square roots, the distance), the eval
  loops and the metrics against the JAX functions on the same arrays.
* ``unify-fps`` and ``video2frame``: a stand-in ``ffmpeg`` on the PATH
  records each command line; both packages' corpus drivers and commands
  give the same ones.
* ``train-diffusion --i3d`` and ``train-first-stage --i3d`` on the CPU (16
  frames: I3D pools time down to 1 from at least 9).
"""

import json
import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moditalker_tpu import cli as jcli
from moditalker_tpu.evals import fvd as jfvd
from moditalker_tpu.evals import loops as jloops
from moditalker_tpu.evals import metrics as jmetrics
from moditalker_tpu.evals.i3d import InceptionI3d as JI3d
from moditalker_tpu.evals.i3d import convert_i3d
from moditalker_tpu.preprocess import video as jvideo
from moditalker_tpu_torch import cli
from moditalker_tpu_torch.core.checkpoint import load_single
from moditalker_tpu_torch.evals import fvd, loops, metrics
from moditalker_tpu_torch.evals.i3d import InceptionI3d, i3d_apply, load_i3d
from moditalker_tpu_torch.preprocess import video
from moditalker_tpu_torch.utils.convert import convert_i3d_params

from .torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _i3d_state(seed=0):
    """A random I3D whose activations keep their scale through the 60
    layers (He-scaled convs, random BatchNorm statistics), so the logits
    vary with the input."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionI3d()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv3d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=gen))
            elif isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(1 + 0.5 * torch.rand(c, generator=gen))
    return model.state_dict()


@pytest.fixture(scope="module")
def i3d_state():
    return _i3d_state()


def test_i3d_matches_jax_on_the_reference_keys(i3d_state):
    """The JAX package reads the port's state_dict as a reference
    checkpoint; both I3Ds then agree within 1e-3 of the logits' scale."""
    x = np.random.default_rng(0).uniform(-1, 1, (1, 9, 224, 224, 3)).astype(
        np.float32)
    sd = {k: v.numpy() for k, v in i3d_state.items()}
    want = np.asarray(JI3d(400).apply(convert_i3d(sd), jnp.asarray(x)))
    model = InceptionI3d().eval()
    model.load_state_dict(i3d_state)
    got = i3d_apply(model)(x)
    assert got.shape == want.shape == (1, 400) and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    # and the converter from the JAX tree gives back the same state_dict
    back = convert_i3d_params(convert_i3d(sd))
    assert set(back) == set(i3d_state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), i3d_state[k].numpy(), k)


def test_i3d_pads_like_tf_same():
    from moditalker_tpu.evals.i3d import _same_pad as jpad
    from moditalker_tpu_torch.evals.i3d import _same_pad

    for size in range(1, 20):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                assert _same_pad(size, k, s) == jpad(size, k, s)


# ------------------------------------------------------------ FVD
def test_fvd_math_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 12))
    y = rng.normal(size=(64, 12)) * 1.5 + 0.3
    np.testing.assert_array_equal(fvd.cov(x), jfvd.cov(x))
    m = fvd.cov(x)
    np.testing.assert_allclose(fvd._sym_sqrt(m), jfvd._sym_sqrt(m),
                               rtol=0, atol=1e-12)
    assert fvd.trace_sqrt_product(m, fvd.cov(y)) == pytest.approx(
        jfvd.trace_sqrt_product(m, jfvd.cov(y)), rel=1e-12)
    assert fvd.frechet_distance(x, y) == pytest.approx(
        jfvd.frechet_distance(x, y), rel=1e-12)
    assert abs(fvd.frechet_distance(x, x)) < 1e-6


@pytest.mark.parametrize("shape", [(3, 48, 64, 3), (3, 70, 40, 3),
                                   (2, 32, 32, 3)])
def test_fvd_preprocessing_matches_jax(shape):
    v = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(fvd.preprocess_video(v, 24),
                                  jfvd.preprocess_video(v, 24))
    np.testing.assert_array_equal(fvd.preprocess_batch(v[None], 24),
                                  jfvd.preprocess_batch(v[None], 24))


def _mock_i3d(videos):
    v = np.asarray(videos)
    return np.concatenate([v.mean(axis=(1, 2, 3)), v.std(axis=(1, 2, 3))],
                          axis=-1)


def test_compute_fvd_and_eval_loops_match_jax():
    rng = np.random.default_rng(3)
    batches = [rng.uniform(-1, 1, (2, 4, 16, 16, 3)).astype(np.float32)
               for _ in range(3)]
    real = ((rng.uniform(0, 1, (6, 4, 20, 24, 3))) * 255).astype(np.uint8)
    fake = ((rng.uniform(0, 1, (6, 4, 20, 24, 3))) * 255).astype(np.uint8)
    assert fvd.compute_fvd(_mock_i3d, real, fake, batch=4) == pytest.approx(
        jfvd.compute_fvd(_mock_i3d, real, fake, batch=4), rel=1e-12)
    ae = lambda v: v * 0.8
    ae_t = lambda v: torch.from_numpy(np.asarray(v)) * 0.8   # a tensor back
    assert loops.eval_ae_psnr(ae_t, iter(batches)) == pytest.approx(
        jloops.eval_ae_psnr(ae, iter(batches)), rel=1e-6)
    assert loops.eval_ae_psnr(ae, iter(batches), max_batches=2) == \
        pytest.approx(jloops.eval_ae_psnr(ae, iter(batches), max_batches=2),
                      rel=1e-12)
    assert np.isnan(loops.eval_ae_psnr(ae, iter([])))
    assert loops.eval_ae_rfvd(ae, iter(batches), _mock_i3d) == pytest.approx(
        jloops.eval_ae_rfvd(ae, iter(batches), _mock_i3d), rel=1e-9)
    samples = [{"x": b} for b in batches]
    gen = lambda b: np.clip(b["x"] + 0.3, -1, 1)
    assert loops.eval_sample_fvd(gen, samples, _mock_i3d) == pytest.approx(
        jloops.eval_sample_fvd(gen, samples, _mock_i3d), rel=1e-9)
    v = batches[0] * 1.5
    np.testing.assert_array_equal(loops._to_u8(torch.from_numpy(v)),
                                  jloops._to_u8(v))


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    p, t = rng.normal(size=(2, 5, 68, 3)), rng.normal(size=(2, 5, 68, 3))
    for name in ("landmark_l2", "mouth_landmark_l2", "face_landmark_l2"):
        assert getattr(metrics, name)(p, t) == pytest.approx(
            getattr(jmetrics, name)(p, t), rel=1e-12), name
        assert getattr(metrics, name)(torch.from_numpy(p), t) == \
            pytest.approx(getattr(jmetrics, name)(p, t), rel=1e-6), name
    assert metrics.psnr(0.01) == jmetrics.psnr(0.01)
    batches = [rng.uniform(-1, 1, (2, 3, 8, 8, 3)) for _ in range(3)]
    ae = lambda v: v * 0.9
    assert metrics.ae_reconstruction_eval(ae, iter(batches), 2) == \
        pytest.approx(jmetrics.ae_reconstruction_eval(ae, iter(batches), 2),
                      rel=1e-12)


# ------------------------------------------------------------ video tools
FAKE_FFMPEG = """#!{python}
import json, os, sys, uuid
log = os.environ["FAKE_FFMPEG_LOG"]
with open(os.path.join(log, uuid.uuid4().hex), "w") as f:
    json.dump([os.path.basename(sys.argv[0])] + sys.argv[1:], f)
if os.path.basename(sys.argv[0]) == "ffprobe":
    print("25/1")
    sys.exit(0)
out = sys.argv[-1]
if "%05d" in out:
    out = out.replace("%05d", "00000")
os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
open(out, "w").close()
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """``ffmpeg`` and ``ffprobe`` on the PATH that record their arguments
    (the spawned pool workers inherit the PATH) and write the output."""
    bin_dir, log = tmp_path / "bin", tmp_path / "log"
    bin_dir.mkdir()
    log.mkdir()
    for name in ("ffmpeg", "ffprobe"):
        path = bin_dir / name
        path.write_text(FAKE_FFMPEG.format(python=sys.executable))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(log))

    def calls(root):
        """The recorded command lines, ``root`` replaced by ROOT, sorted;
        the log emptied."""
        out = []
        for f in os.listdir(log):
            with open(log / f) as fh:
                out.append([a.replace(str(root), "ROOT")
                            for a in json.load(fh)])
            os.remove(log / f)
        return sorted(out)

    return calls


@pytest.fixture
def corpus(tmp_path):
    """Mixed layout: flat {id}.mp4 and nested {id}/video.mp4."""
    src = tmp_path / "src"
    (src / "idB").mkdir(parents=True)
    (src / "idA.mp4").write_bytes(b"x")
    (src / "idB" / "video.mp4").write_bytes(b"x")
    (src / "notes.txt").write_text("ignored")
    (src / "empty_dir").mkdir()
    return src


def test_video_tools_build_the_jax_command_lines(corpus, tmp_path,
                                                 fake_ffmpeg):
    assert video.corpus_videos(str(corpus)) == jvideo.corpus_videos(
        str(corpus))
    for pkg, tag in ((jvideo, "jax"), (video, "port")):
        root = tmp_path / tag
        got = pkg.unify_fps_corpus(str(corpus), str(root / "fps"), fps=30,
                                   processes=2)
        assert len(got) == 2
        assert pkg.unify_fps_corpus(str(corpus), str(root / "fps")) == []
        pkg.video_to_frames_corpus(str(corpus), str(root / "frames"),
                                   quality=3, processes=2)
        assert pkg.video_to_frames_corpus(str(corpus),
                                          str(root / "frames")) == []
        a = pkg.unify_fps_corpus(str(corpus), str(root / "s"), processes=1,
                                 process_id=0, total_processes=2)
        b = pkg.unify_fps_corpus(str(corpus), str(root / "s"), processes=1,
                                 process_id=1, total_processes=2)
        assert len(a) == len(b) == 1
        assert pkg.probe_fps(str(corpus / "idA.mp4")) == 25.0
        calls = fake_ffmpeg(root)
        if tag == "jax":
            want = calls
    assert calls == want and len(calls) == 7
    assert ["ffmpeg", "-y", "-i", str(corpus / "idA.mp4"), "-r", "30",
            "ROOT/fps/idA.mp4"] in calls


@pytest.mark.parametrize("command,extra", [("unify-fps", ["--fps", "24"]),
                                           ("video2frame",
                                            ["--quality", "5"])])
def test_video_commands_match_jax(corpus, tmp_path, fake_ffmpeg, capsys,
                                  command, extra):
    for main, tag in ((jcli.main, "jax"), (cli.main, "port")):
        out = tmp_path / tag
        main([command, "--src-root", str(corpus), "--out-dir", str(out),
              "--processes", "1"] + extra)
        calls = fake_ffmpeg(out)
        if tag == "jax":
            want, printed = calls, capsys.readouterr().out
    assert calls == want and len(calls) == 2
    assert capsys.readouterr().out.replace(str(tmp_path / "port"), "O") == \
        printed.replace(str(tmp_path / "jax"), "O")


# ------------------------------------------------------------ the probes
def _config_16_frames(tmp_path) -> str:
    """configs/tiny.yaml at 16 frames (I3D pools 9 or more frames down to
    one), the UNet's latent_t to match."""
    with open("configs/tiny.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["mtov_ae"]["timesteps"] = 16
    cfg["mtov_unet"]["latent_t"] = 16
    path = tmp_path / "tiny16.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_training_probes_read_fvd_through_i3d(tmp_path, i3d_state, capsys):
    """``train-diffusion --i3d`` logs the sample FVD, ``train-first-stage
    --i3d`` the reconstruction FVD, both through the port's I3D on the
    CPU."""
    i3d = str(tmp_path / "i3d.pt")
    torch.save(i3d_state, i3d)
    model = load_i3d(i3d, "cpu")
    assert not model.training
    config = _config_16_frames(tmp_path)
    cli.main(["train-diffusion", "--device", "cpu", "--config", config,
              "--synthetic", "--steps", "1", "--ckpt-every", "1",
              "--i3d", i3d, "--out-dir", str(tmp_path / "td")])
    out = capsys.readouterr().out
    assert "sample_fvd=" in out and "sample_psnr=" in out
    path = cli.main(["train-first-stage", "--device", "cpu", "--config",
                     config, "--synthetic", "--steps", "1", "--eval-every",
                     "1", "--i3d", i3d, "--out-dir", str(tmp_path / "fs")])
    out = capsys.readouterr().out
    assert "eval_psnr=" in out and "eval_rfvd=" in out
    assert load_single(path)["step"] == 1
