"""HuBERT audio features with the reference's chunking (port of
``moditalker_tpu/preprocess/audio.py``; ref
``data/data_utils/preprocess/process_audio.py:10-55``).

16 kHz speech → [T, 1024] features, T = (samples − (400 − 320)) // 320,
computed in clips of ``CLIP_LENGTH`` = 320 000 samples (20 s, T = 1000),
each extended by kernel − stride so the conv windows line up, then padded or
trimmed to the expected T. ``extract_hubert_features`` takes any
``model_fn``: ``wave [1, n] → features [T', D]``; ``hubert_forward`` is the
port's, the ``HubertEncoder`` on a device. The JAX package's
``torch_hubert_forward`` (transformers' ``from_pretrained``, which needs the
hub) has no counterpart: the port loads a ``state_dict`` instead.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ..device import resolve_device

KERNEL = 400
STRIDE = 320
CLIP_LENGTH = STRIDE * 1000


def expected_num_frames(n_samples: int) -> int:
    return (n_samples - (KERNEL - STRIDE)) // STRIDE


def chunk_bounds(n_samples: int) -> list[tuple[int, int]]:
    """Clip boundaries exactly as the reference iterates (ref :28-47)."""
    bounds = []
    num_iter = n_samples // CLIP_LENGTH
    for i in range(num_iter):
        start = CLIP_LENGTH * i
        bounds.append((start, start + (CLIP_LENGTH - STRIDE + KERNEL)))
    tail_start = CLIP_LENGTH * num_iter
    if n_samples - tail_start >= KERNEL:  # skip sub-kernel tails (ref :45)
        bounds.append((tail_start, n_samples))
    return bounds


def extract_hubert_features(speech: np.ndarray, model_fn) -> np.ndarray:
    """speech: [N] float 16 kHz mono (2-D input takes channel 0, ref
    :21-22); model_fn: [1, n] → [T', D]. Returns [expected_T, D]."""
    speech = np.asarray(speech, np.float32)
    if speech.ndim == 2:
        speech = speech[:, 0]
    n = speech.shape[0]
    exp_t = expected_num_frames(n)
    feats = []
    for start, end in chunk_bounds(n):
        out = np.asarray(model_fn(speech[None, start:end]))
        feats.append(out.reshape(-1, out.shape[-1]))
    ret = np.concatenate(feats, axis=0) if feats else np.zeros((0, 1024))
    assert abs(ret.shape[0] - exp_t) <= 1, (ret.shape, exp_t)
    if ret.shape[0] < exp_t:
        ret = np.pad(ret, ((0, exp_t - ret.shape[0]), (0, 0)))
    return ret[:exp_t]


def normalize_like_wav2vec2(speech: np.ndarray) -> np.ndarray:
    """Zero-mean unit-variance per utterance — what Wav2Vec2Processor does
    for hubert-large-ls960-ft (do_normalize=True)."""
    speech = np.asarray(speech, np.float32)
    return (speech - speech.mean()) / np.sqrt(speech.var() + 1e-7)


def conv_out_frames(n: int, cfg=None) -> int:
    """Output frame count of the HuBERT conv feature extractor (VALID
    convs) for an n-sample wave."""
    from .hubert import HubertConfig

    c = cfg or HubertConfig()
    for k, s in zip(c.conv_kernel, c.conv_stride):
        n = (n - k) // s + 1
    return n


def hubert_forward(model, device=None, bucket_samples: int = 32000):
    """``model_fn`` for ``extract_hubert_features``: ``model`` (a
    ``HubertEncoder``, moved there) in eval mode on ``device`` (default:
    the card), float32.

    A wave shorter than a whole clip (the utterance's tail) is zero-padded
    up to the next ``bucket_samples`` multiple (2 s) and run with its frame
    mask, as the JAX package's ``flax_hubert_forward`` runs it: the valid
    frames equal the unpadded forward's, and a serving process meets at
    most ~10 tail shapes instead of one per utterance length."""
    device = resolve_device(device)
    model = model.to(device).eval()
    cfg = model.cfg
    full = CLIP_LENGTH - STRIDE + KERNEL

    def fn(wave):
        wave = np.asarray(wave, np.float32)
        n = wave.shape[1]
        t_true = conv_out_frames(n, cfg)
        # chunk_bounds never exceeds `full`; an oversize wave runs unpadded
        n_pad = n if n >= full else (
            (n + bucket_samples - 1) // bucket_samples * bucket_samples)
        x = torch.zeros((1, n_pad), dtype=torch.float32)
        x[:, :n] = torch.from_numpy(wave)
        with torch.inference_mode():
            out = model(x.to(device), n_frames=torch.tensor([t_true]))
        return out[0, :t_true].cpu().numpy()

    return fn


def ffmpeg_resample_to_16k(src: str, dst: str,
                           sampling_rate: int = 16000) -> str:
    """ref convert_wav_sampling_rate (process_audio.py:57-64)."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    proc = subprocess.run(
        ["ffmpeg", "-i", src, "-f", "wav", "-ar", str(sampling_rate), dst,
         "-y"], capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode()[-300:])
    return dst
