"""The port's ``sample`` and ``atom-infer`` entry points, its sampling-time
dataset and its video writers, on the CPU at configs/tiny.yaml.

The dataset and the writers are held against the JAX package's on the same
files. The commands draw their noise from torch generators, which no JAX key
reproduces, so they are run end to end and checked for what they write; the
modules they drive are held against the JAX package in
tests/test_torch_sample.py and tests/test_torch_atom.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from moditalker_tpu.data import mtov_dataset as jdata
from moditalker_tpu.pipelines import mtov_sample as jsample
from moditalker_tpu_torch import cli
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.data import mtov_dataset as tdata
from moditalker_tpu_torch.data.prefetch import background_iter
from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.pipelines import mtov_sample as tsample

TINY = "configs/tiny.yaml"   # 32² frames, 4 per window


def _write_identity(root, ident, n_frames, hw=(40, 36), seed=0):
    """PNG frames (non-square, so the crop and the resize both run) and
    per-frame [68, 2] landmark files."""
    rng = np.random.default_rng(seed)
    frames, kpts = root / "frames" / ident, root / "kpt" / ident
    frames.mkdir(parents=True)
    kpts.mkdir(parents=True)
    for i in range(n_frames):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            frames / f"{i:05d}.png")
        np.save(kpts / f"{i:05d}.npy", rng.integers(0, min(hw), (68, 2)))
    return frames, kpts


def _write_aligned(path, n, seed=1):
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    for i in range(n):
        np.save(path / f"{i:05d}.npy", rng.integers(0, 36, (68, 2)))
    return path


def _assert_same_windows(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) > 0
    for uint8 in (True, False):
        for got, want in zip(got_ds.windows(uint8=uint8),
                             want_ds.windows(uint8=uint8)):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("with_kpt", [False, True])
def test_sequential_window_dataset_matches_jax(tmp_path, with_kpt):
    frames, kpts = _write_identity(tmp_path, "idA", 9)
    aligned = _write_aligned(tmp_path / "aligned", 10)
    kw = dict(nframes=4, resolution=32, kpt_dir=str(kpts) if with_kpt else None)
    _assert_same_windows(
        tdata.SequentialWindowDataset(str(frames), str(aligned), **kw),
        jdata.SequentialWindowDataset(str(frames), str(aligned), **kw))
    got = next(tdata.SequentialWindowDataset(
        str(frames), str(aligned), **kw).windows(batch=2, uint8=True))
    assert got["x"].shape == (2, 4, 32, 32, 3) and got["x"].dtype == np.uint8


def test_cross_id_dataset_matches_jax(tmp_path):
    _write_identity(tmp_path, "ref7", 8)
    _write_aligned(tmp_path / "aligned" / "audio_a3" / "id_ref7", 8)
    args = (str(tmp_path / "aligned"), "a3", "ref7", str(tmp_path / "frames"))
    kw = dict(kpt_root=str(tmp_path / "kpt"), nframes=4, resolution=32)
    _assert_same_windows(tdata.SequentialWindowDataset.cross_id(*args, **kw),
                         jdata.SequentialWindowDataset.cross_id(*args, **kw))


def test_dataset_helpers_match_jax():
    rng = np.random.default_rng(3)
    lm = rng.integers(-5, 300, (3, 68, 2))
    np.testing.assert_array_equal(tdata.rasterize_landmarks(lm, 64, 256),
                                  jdata.rasterize_landmarks(lm, 64, 256))
    video = rng.uniform(0, 255, (2, 20, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata.resize_crop(video, 16),
                                  jdata.resize_crop(video, 16))
    names = ["10.png", "9.png", "a2b.png", "a10b.png"]
    assert sorted(names, key=tdata.natsort_key) \
        == sorted(names, key=jdata.natsort_key)


def test_writers_match_jax(tmp_path, monkeypatch):
    video = np.random.default_rng(4).integers(0, 256, (5, 8, 8, 3),
                                              dtype=np.uint8)
    for mod in (tsample, jsample):
        monkeypatch.setattr(mod, "has_ffmpeg", lambda: False)
    got = tsample.write_video(video, str(tmp_path / "t" / "v.mp4"), fps=25)
    want = jsample.write_video(video, str(tmp_path / "j" / "v.mp4"), fps=25)
    assert got.endswith("v.npz") and want.endswith("v.npz")
    a, b = np.load(got), np.load(want)
    np.testing.assert_array_equal(a["frames"], b["frames"])
    assert int(a["fps"]) == int(b["fps"]) == 25
    for name in ("save_gif", "save_image_grid"):
        ext = "gif" if name == "save_gif" else "png"
        pa = getattr(tsample, name)(video, str(tmp_path / "t" / f"x.{ext}"))
        pb = getattr(jsample, name)(video, str(tmp_path / "j" / f"x.{ext}"))
        assert open(pa, "rb").read() == open(pb, "rb").read()
    pa = tsample.save_frames(video, str(tmp_path / "t" / "frames"))
    pb = jsample.save_frames(video, str(tmp_path / "j" / "frames"))
    assert [open(p, "rb").read() for p in pa] \
        == [open(p, "rb").read() for p in pb] and len(pa) == 5


def test_background_iter_keeps_order_and_raises_in_the_consumer():
    assert list(background_iter(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise OSError("bad frame")

    it = background_iter(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="bad frame"):
        next(it)


# ------------------------------------------------------------------ sample
@pytest.fixture(autouse=True)
def fresh_memo():
    """The pipeline memo outlives a call on purpose; a test starts without
    one."""
    cli._SAMPLE_PIPE_CACHE.clear()
    yield
    cli._SAMPLE_PIPE_CACHE.clear()


@pytest.fixture
def identity(tmp_path):
    frames, kpts = _write_identity(tmp_path, "idA", 8, hw=(32, 32))
    aligned = _write_aligned(tmp_path / "aligned", 8)
    return ["--frames-dir", str(frames), "--aligned-dir", str(aligned),
            "--device", "cpu", "--config", TINY]


def _frames(path):
    assert path.endswith(".npz") or path.endswith(".mp4")
    if path.endswith(".mp4"):    # a host with ffmpeg
        return None
    return np.load(path)["frames"]


@pytest.mark.parametrize("extra", [
    [], ["--noised-start-ratio", "0.5"],
    ["--batch", "2", "--no-last-as-reference"]],
    ids=["ar", "ar-fast", "batched"])
def test_sample_command_writes_a_video(identity, tmp_path, capsys, extra):
    out_dir = tmp_path / "out"
    path = cli.main(["sample", *identity, "--out-dir", str(out_dir),
                     "--seed", "3", *extra])
    printed = capsys.readouterr()
    assert f"video: {path}" in printed.out
    assert printed.err.count("WARNING: random weights") == 3
    assert "sampled 8 frames" in printed.err
    frames = _frames(path)
    if frames is not None:
        assert frames.shape == (8, 32, 32, 3) and frames.dtype == np.uint8
        assert frames.min() != frames.max()
        # the same seed gives the same video; another seed, another one
        again = _frames(cli.main(["sample", *identity, "--out-dir",
                                  str(tmp_path / "again"), "--seed", "3",
                                  *extra]))
        np.testing.assert_array_equal(frames, again)


def test_sample_command_loads_checkpoints(identity, tmp_path, capsys):
    """``state_dict``s saved with ``torch.save`` and drawn from the seeds the
    command would use give the video the command gives without them."""
    cfg = tcfg.load_config(TINY)
    ae = lambda: ViTAutoencoder(cfg.mtov_ae)
    unet = lambda: TriplaneUNet(cfg.mtov_unet)
    paths = {}
    for flag, init, seed in (("--ae-rgb", ae, 5), ("--ae-ldmk", ae, 6),
                             ("--diffusion-model", unet, 5)):
        paths[flag] = str(tmp_path / f"{flag[2:]}.pt")
        torch.save(cli._load_state(None, init, flag, seed), paths[flag])
    capsys.readouterr()
    flags = [x for kv in paths.items() for x in kv]
    with_ckpt = cli.main(["sample", *identity, "--seed", "5", "--out-dir",
                          str(tmp_path / "a"), *flags])
    assert "WARNING" not in capsys.readouterr().err
    without = cli.main(["sample", *identity, "--seed", "5", "--out-dir",
                        str(tmp_path / "b")])
    a, b = _frames(with_ckpt), _frames(without)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_sample_command_cross_id(tmp_path):
    _write_identity(tmp_path, "ref7", 4, hw=(32, 32))
    _write_aligned(tmp_path / "aligned" / "audio_a3" / "id_ref7", 4)
    base = ["sample", "--frames-dir", str(tmp_path / "frames"),
            "--aligned-dir", str(tmp_path / "aligned"), "--device", "cpu",
            "--config", TINY, "--out-dir", str(tmp_path / "out"), "--cross-id"]
    with pytest.raises(SystemExit, match="--audio-id and --ref-id"):
        cli.main(base)
    path = cli.main([*base, "--audio-id", "a3", "--ref-id", "ref7",
                     "--kpt-root", str(tmp_path / "kpt")])
    frames = _frames(path)
    assert frames is None or frames.shape == (4, 32, 32, 3)


def test_batched_sample_needs_independent_windows(identity):
    with pytest.raises(SystemExit, match="--no-last-as-reference"):
        cli.main(["sample", *identity, "--batch", "2"])


def test_sample_pipeline_memo(identity, tmp_path):
    parse = lambda *extra: cli.build_parser().parse_args(
        ["sample", *identity, *extra])
    args = parse()
    cfgs = cli._sample_configs(args)
    first = cli._build_sample_pipeline(args, *cfgs)
    assert cli._build_sample_pipeline(parse(), *cfgs) is first
    other = cli._build_sample_pipeline(parse("--seed", "7"), *cfgs)
    assert other is not first and len(cli._SAMPLE_PIPE_CACHE) == 1
    steps = parse("--sampling-steps", "3")
    assert cli._sample_configs(steps)[2].sampling_timesteps == 3
    assert cli._build_sample_pipeline(
        steps, *cli._sample_configs(steps)) is not other


def test_parsers_have_the_jax_flags_minus_the_mesh(monkeypatch):
    """Both commands take the JAX CLI's flags, ``--data-parallel`` among
    them (the port's mesh is a replica per card), plus ``--device``; the
    trainers take the JAX CLI's multi-process flags. The JAX CLI builds its
    parser inside ``main``: it is caught where ``main`` hands it the
    arguments."""
    import argparse

    from moditalker_tpu import cli as jcli

    class Caught(Exception):
        pass

    def catch(self, argv=None):
        raise Caught(self)

    def flags(parser, command):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {s for a in sub.choices[command]._actions
                for s in a.option_strings}

    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as caught:
            jcli.main([])
    jparser = caught.value.args[0]
    for command in ("sample", "atom-infer"):
        want = flags(jparser, command)
        assert {"--seed", "--data-parallel"} <= want
        assert flags(cli.build_parser(), command) == want | {"--device"}
    for command in ("train-atom", "train-first-stage", "train-diffusion"):
        multi = {"--coordinator", "--num-processes", "--process-id"}
        assert multi <= flags(jparser, command)
        assert multi <= flags(cli.build_parser(), command)


# ------------------------------------------------------------------ atom-infer
def test_atom_infer_command_writes_landmarks(tmp_path, capsys):
    rng = np.random.default_rng(5)
    for name in ("idB", "idA"):
        d = tmp_path / "kp" / name
        d.mkdir(parents=True)
        np.save(d / "00000.npy", rng.normal(size=(1, 68, 3)))
    np.save(tmp_path / "hubert.npy", rng.normal(size=(20, 1024)))
    cli.main(["atom-infer", "--device", "cpu", "--config", TINY,
              "--keypoint-dir", str(tmp_path / "kp"), "--hubert",
              str(tmp_path / "hubert.npy"), "--out-dir", str(tmp_path / "out"),
              "--batch", "1", "--seed", "2"])
    printed = capsys.readouterr()
    assert "WARNING: no checkpoint given" in printed.err
    for name in ("idA", "idB"):
        path = tmp_path / "out" / "frontalized_npy" / name / "atom.npy"
        assert f"{name}: {path}" in printed.out
        lm = np.load(path)
        assert lm.shape == (12, 68, 3) and np.isfinite(lm).all()
        assert lm.std() > 0


def test_atom_infer_command_loads_a_checkpoint(tmp_path, capsys):
    from moditalker_tpu_torch.models.atom import MotionDecoder

    cfg = tcfg.load_config(TINY)
    torch.manual_seed(1)
    state = MotionDecoder(cfg.atom_model).state_dict()
    torch.save({"ema_params": state, "step": torch.tensor(3)},
               tmp_path / "atom.pt")
    rng = np.random.default_rng(6)
    (tmp_path / "kp" / "x").mkdir(parents=True)
    np.save(tmp_path / "kp" / "x" / "00000.npy", rng.normal(size=(68, 3)))
    np.save(tmp_path / "hubert.npy", rng.normal(size=(30, 1024)))
    cli.main(["atom-infer", "--device", "cpu", "--config", TINY,
              "--checkpoint", str(tmp_path / "atom.pt"), "--keypoint-dir",
              str(tmp_path / "kp"), "--hubert", str(tmp_path / "hubert.npy"),
              "--out-dir", str(tmp_path / "out")])
    assert "WARNING" not in capsys.readouterr().err
    assert (tmp_path / "out" / "frontalized_npy" / "x" / "atom.npy").exists()


# ------------------------------------------------------------------ modular
def test_modular_configuration_gives_the_fused_window(monkeypatch):
    """At a size where every gate passes (256² frames, patch 8: 1024 patch
    tokens; 4 heads x 64; UNet C = 128 with 8 heads), the window with both
    switches set goes through ``sdpa``'s one-pass and tiny-L routes and
    equals the window of the fused wrappers, on the CPU in float32."""
    ae_cfg = tcfg.MtovAEConfig(channels=32, timesteps=8, depth=1, heads=4,
                               dim_head=64, quant_depth=1, quant_heads=2,
                               quant_mlp_dim=32)
    unet_cfg = tcfg.MtovUNetConfig(num_res_blocks=1, channel_mult=(1,),
                                   attention_resolutions=(1,), latent_t=8)
    diff_cfg = tcfg.MtovDiffusionConfig(sampling_timesteps=1)
    torch.manual_seed(0)
    pipe = tsample.MtovSamplePipeline(
        ViTAutoencoder(ae_cfg).state_dict(), ViTAutoencoder(ae_cfg).state_dict(),
        TriplaneUNet(unet_cfg).state_dict(), ae_cfg, unet_cfg, diff_cfg,
        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    w = {k: rng.integers(0, 256, (1, 8, 256, 256, 3), dtype=np.uint8)
         for k in ("x_l", "masked_x", "x_ref")}
    calls = {"onepass": 0, "tiny": 0}
    for route in calls:
        inner = getattr(tflash, f"{route}_attention")

        def counted(*a, _inner=inner, _route=route):
            calls[_route] += 1
            return _inner(*a)

        monkeypatch.setattr(tflash, f"{route}_attention", counted)

    def window():
        gen = torch.Generator().manual_seed(1)
        return pipe.window_step(w["x_l"], w["masked_x"], w["x_ref"], gen)

    for name in ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN"):
        monkeypatch.delenv(name, raising=False)
    fused = window()
    assert calls == {"onepass": 0, "tiny": 0}
    for name in ("MODITALKER_NO_DIVIDED_FUSED", "MODITALKER_NO_PACKED_ATTN"):
        monkeypatch.setenv(name, "1")
    modular = window()
    # per AE pass (3 extracts + 1 decode, depth 1): one space and one time
    # attention; per UNet step: the dh = 16 attentions
    assert calls["tiny"] == 4 and calls["onepass"] > 4
    assert fused.shape == (1, 8, 256, 256, 3)
    np.testing.assert_allclose(modular.numpy(), fused.numpy(), rtol=0,
                               atol=1e-4)
