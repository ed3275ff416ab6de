"""The port's audio stage against the JAX package's, on the CPU in float32:
HuBERT (``preprocess/hubert.py``), the chunking and its helpers
(``preprocess/audio.py``) and the ``process-audio`` command.

Weights come from flax ``init`` and reach the port through
``utils/convert.py``; a randomly initialised transformers ``HubertModel``
reaches both packages through their ``convert_hubert``. Tiny configs.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import cli as jcli
from moditalker_tpu.preprocess import audio as jaudio
from moditalker_tpu.preprocess import hubert as jhubert
from moditalker_tpu_torch import cli as tcli
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.preprocess import audio as taudio
from moditalker_tpu_torch.preprocess import hubert as thubert
from moditalker_tpu_torch.utils.convert import convert_hubert_params

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            conv_dim=(8, 8, 8), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
            conv_bias=True, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
# hubert-large frame arithmetic (total stride 320, footprint <= 400) at a
# tiny width, so that extract_hubert_features' expected T holds
FRAMES = dict(TINY, conv_stride=(5, 8, 8))


def _jax_model(kw, n=800, seed=0):
    cfg = jhubert.HubertConfig(**kw)
    model = jhubert.HubertEncoder(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, n)))
    return cfg, model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(kw, params):
    model = thubert.HubertEncoder(thubert.HubertConfig(**kw))
    model.load_state_dict(convert_hubert_params(params), strict=True)
    return model.eval()


def test_hubert_matches_jax():
    """rtol 1e-4, atol 1e-5 in float32 (a batch of two waves)."""
    _, jmodel, params = _jax_model(TINY)
    wave_ = np.random.default_rng(0).normal(size=(2, 800)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(wave_)))
    with torch.no_grad():
        got = _port_model(TINY, params)(torch.from_numpy(wave_)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_hubert_state_dict_loads_strict():
    """The converted tree names every parameter of the port's module, the
    weight-normed positional conv and the 1-D conv kernels included."""
    _, _, params = _jax_model(TINY)
    state = convert_hubert_params(params)
    model = thubert.HubertEncoder(thubert.HubertConfig(**TINY))
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state, strict=True)
    assert state["pos_conv.conv.weight"].shape == (32, 8, 16)
    assert state["feature_extractor.conv_0.weight"].shape == (8, 1, 10)


def test_hubert_matches_transformers():
    """A random transformers HubertModel through the port's convert_hubert
    (rtol 1e-3, atol 1e-4, as tests/test_hubert.py holds the JAX one)."""
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(8, 8, 8), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 3), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True)
    torch.manual_seed(0)
    ref = transformers.HubertModel(tcfg).eval()
    wave_ = np.random.default_rng(0).normal(size=(2, 800)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(wave_)).last_hidden_state.numpy()
    cfg = thubert.HubertConfig(**TINY)
    tree = thubert.convert_hubert(ref.state_dict(), cfg)
    jtree = jhubert.convert_hubert(
        {k: v.numpy() for k, v in ref.state_dict().items()},
        jhubert.HubertConfig(**TINY))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves_with_path(jtree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    model = thubert.HubertEncoder(cfg)
    model.load_state_dict(convert_hubert_params(tree), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(wave_)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_masked_padded_forward_matches_unpadded():
    """The tail bucket: zero-padded wave + frame mask equals the unpadded
    forward on the valid frames (2e-5, as tests/test_hubert.py)."""
    cfg, _, params = _jax_model(TINY)
    model = _port_model(TINY, params)
    n = 437
    wave_ = np.random.default_rng(0).normal(size=(1, n)).astype(np.float32)
    t_true = taudio.conv_out_frames(n, cfg)
    with torch.no_grad():
        plain = model(torch.from_numpy(wave_)).numpy()
        padded = np.pad(wave_, ((0, 0), (0, 600 - n)))
        masked = model(torch.from_numpy(padded),
                       n_frames=torch.tensor([t_true])).numpy()
    assert plain.shape[1] == t_true
    np.testing.assert_allclose(masked[:, :t_true], plain, rtol=2e-5,
                               atol=2e-5)


def test_extract_features_chain_matches_jax():
    """normalize + chunking + the bucketed forward on a 10 700-sample wave:
    the port's chain against the JAX package's (rtol 1e-4, atol 1e-5), and
    no kernel launched (the masked attention takes the plain math)."""
    cfg, _, params = _jax_model(FRAMES, n=3000, seed=0)
    speech = np.random.default_rng(1).normal(size=(10700,)).astype(np.float32)
    speech = jaudio.normalize_like_wav2vec2(speech)
    np.testing.assert_array_equal(taudio.normalize_like_wav2vec2(speech),
                                  jaudio.normalize_like_wav2vec2(speech))
    want = jaudio.extract_hubert_features(
        speech, jaudio.flax_hubert_forward(params, cfg, bucket_samples=4000))
    tkernels.reset_launch_counts()
    got = taudio.extract_hubert_features(speech, taudio.hubert_forward(
        _port_model(FRAMES, params), "cpu", bucket_samples=4000))
    assert not any(tkernels.LAUNCHES.values())
    assert got.shape == want.shape == (taudio.expected_num_frames(10700), 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_extract_features_takes_channel_zero():
    """2-D input: channel 0 (ref :21-22), where ``_read_wav`` averages."""
    speech = np.random.default_rng(2).normal(size=(4000, 2)).astype(
        np.float32)

    def model_fn(wave):   # one 32-wide frame per 320 samples
        t = taudio.expected_num_frames(wave.shape[1])
        return np.repeat(wave[0, : t * 320 : 320, None], 32, axis=1)

    got = taudio.extract_hubert_features(speech, model_fn)
    np.testing.assert_array_equal(
        got, jaudio.extract_hubert_features(speech, model_fn))
    np.testing.assert_array_equal(
        got, taudio.extract_hubert_features(speech[:, 0], model_fn))


CLIP = taudio.CLIP_LENGTH


@pytest.mark.parametrize("n", [399, 400, 401, 10700, CLIP, CLIP + 399,
                               CLIP + 400, 2 * CLIP, 2 * CLIP + 80,
                               3 * CLIP + 12345])
def test_chunking_helpers_match_jax(n):
    assert taudio.chunk_bounds(n) == jaudio.chunk_bounds(n)
    assert taudio.expected_num_frames(n) == jaudio.expected_num_frames(n)
    assert taudio.conv_out_frames(n) == jaudio.conv_out_frames(n)
    kw = jhubert.HubertConfig(**FRAMES)
    assert taudio.conv_out_frames(n, thubert.HubertConfig(**FRAMES)) \
        == jaudio.conv_out_frames(n, kw)


def test_constants_match_jax():
    assert (taudio.KERNEL, taudio.STRIDE, taudio.CLIP_LENGTH) == (
        jaudio.KERNEL, jaudio.STRIDE, jaudio.CLIP_LENGTH) == (400, 320,
                                                              320000)
    assert taudio.expected_num_frames(CLIP) == 999
    assert taudio.conv_out_frames(CLIP - 320 + 400) == 1000


def _write_wav(path, data: np.ndarray, width: int, channels: int):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2),
                                            (1, 2)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dt)
    data = rng.integers(info.min, info.max, size=(500, channels), dtype=dt)
    path = tmp_path / "a.wav"
    _write_wav(path, data, width, channels)
    got, want = tcli._read_wav(str(path)), jcli._read_wav(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == (500,)
    np.testing.assert_array_equal(got, want)


def test_resample_command_line(tmp_path, monkeypatch):
    """``--resample`` runs the same ffmpeg command line as the JAX package."""
    import subprocess

    calls = []

    class Done:
        returncode = 0

    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or Done())
    src, dst = str(tmp_path / "in.mp3"), str(tmp_path / "sub" / "o.wav")
    assert taudio.ffmpeg_resample_to_16k(src, dst) == dst
    assert jaudio.ffmpeg_resample_to_16k(src, dst) == dst
    assert calls[0] == calls[1] == ["ffmpeg", "-i", src, "-f", "wav", "-ar",
                                    "16000", dst, "-y"]


def _default_config(monkeypatch, module, cfg):
    """Make ``module.HubertConfig()`` (the commands' full-size default)
    return ``cfg``."""
    monkeypatch.setattr(module, "HubertConfig", lambda: cfg)


def test_process_audio_command_matches_jax(tmp_path, monkeypatch):
    """``process-audio`` end to end on the CPU with a port state_dict,
    against the JAX command on the same weights, on a stereo 16-bit wav
    (both at the tiny config with hubert-large frame arithmetic; rtol 1e-4,
    atol 1e-5)."""
    from moditalker_tpu.core import checkpoint as jckpt

    cfg, _, params = _jax_model(FRAMES, n=3000)
    ckpt = tmp_path / "hubert.pt"
    torch.save(convert_hubert_params(params), ckpt)
    _default_config(monkeypatch, jhubert, cfg)
    _default_config(monkeypatch, thubert, thubert.HubertConfig(**FRAMES))
    monkeypatch.setattr(jckpt, "load_single", lambda path: params)
    data = np.random.default_rng(5).integers(-30000, 30000, size=(6000, 2),
                                             dtype=np.int16)
    wav = tmp_path / "a.wav"
    _write_wav(wav, data, 2, 2)

    jcli.main(["process-audio", "--audio", str(wav), "--out",
               str(tmp_path / "jax.npy"), "--hubert-ckpt", "params"])
    tkernels.reset_launch_counts()
    tcli.main(["process-audio", "--audio", str(wav), "--out",
               str(tmp_path / "port.npy"), "--hubert-ckpt", str(ckpt),
               "--device", "cpu"])
    assert not any(tkernels.LAUNCHES.values())
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (taudio.expected_num_frames(6000), 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_process_audio_without_checkpoint_warns(tmp_path, monkeypatch,
                                                capsys):
    """No ``--hubert-ckpt``: weights from ``--seed`` (the same on every
    run) and a WARNING, where the JAX package would download HuBERT."""
    _default_config(monkeypatch, thubert, thubert.HubertConfig(**FRAMES))
    wav = tmp_path / "a.wav"
    _write_wav(wav, np.random.default_rng(0).integers(
        -3000, 3000, size=(4000, 1), dtype=np.int16), 2, 1)
    outs = []
    for i in range(2):
        out = tmp_path / f"{i}.npy"
        tcli.main(["process-audio", "--audio", str(wav), "--out", str(out),
                   "--seed", "3", "--device", "cpu"])
        outs.append(np.load(out))
    assert "WARNING: random weights (hubert)" in capsys.readouterr().err
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (taudio.expected_num_frames(4000), 32)
