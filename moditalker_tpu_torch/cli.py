"""Command-line interface of the PyTorch port (port of the inference and
preprocessing commands of ``moditalker_tpu/cli.py``):

  reference                                   | here
  --------------------------------------------------------------------
  MToV/sample.py                              | sample
  MToV/sample_crossID.py                      | sample --cross-id
  AToM/inference.py                           | atom-infer
  data_utils/preprocess/process_audio.py      | process-audio
  data_utils/motion_align/align_face_recon.py | align-motion
  preprocess/process_video_3dmm_rollback_     | extract-keypoints
    hdtf_batchify.py                          |

    python -m moditalker_tpu_torch.cli process-audio --audio a.wav --out h.npy
    python -m moditalker_tpu_torch.cli atom-infer --keypoint-dir ... --hubert ...
    python -m moditalker_tpu_torch.cli align-motion --frontalized-dir ... \
        --frames-dir ... --out-dir ...
    python -m moditalker_tpu_torch.cli sample --frames-dir ... --aligned-dir ...

Each runs on the card unless ``--device cpu`` is given. Checkpoints are
``state_dict``s of the port's modules saved with ``torch.save``
(``utils/convert.py`` makes them from the JAX package's parameters); without
a checkpoint ``sample``, ``atom-infer`` and ``process-audio`` draw the
weights from ``--seed`` and print a WARNING (the JAX package's
``process-audio`` downloads HuBERT instead). The flags are the JAX
package's, minus ``--data-parallel`` (one card), plus ``--device`` (and
``--seed`` for ``process-audio``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def _cfg(args):
    """Resolved Config: defaults overlaid with --config if given."""
    from .config import Config, load_config

    return load_config(args.config) if args.config else Config()


def _seeded_module(init_fn, seed: int):
    """``init_fn()`` with its weights drawn from ``seed``; the caller's
    random state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return init_fn()


def _seeded_state(init_fn, seed: int):
    return _seeded_module(init_fn, seed).state_dict()


def _load_state(path: str | None, init_fn, what: str, seed: int):
    """A checkpoint's ``state_dict``, or weights drawn from ``seed``."""
    if path:
        return torch.load(path, map_location="cpu", weights_only=True)
    print(f"WARNING: random weights ({what})", file=sys.stderr)
    return _seeded_state(init_fn, seed)


# ------------------------------------------------------------------ atom-infer
def cmd_atom_infer(args):
    from .models.atom import MotionDecoder
    from .pipelines.atom_infer import AtomInferencePipeline
    from .preprocess.bfm import Face3DHelper

    cfg = _cfg(args)
    mc = cfg.atom_model
    if args.checkpoint:
        state = torch.load(args.checkpoint, map_location="cpu",
                           weights_only=True)
        # a trainer checkpoint holds the weights beside the optimizer state
        for key in ("ema_params", "params"):
            if isinstance(state.get(key), dict):
                state = state[key]
                break
    else:
        print("WARNING: no checkpoint given — random weights", file=sys.stderr)
        state = _seeded_state(lambda: MotionDecoder(mc), 0)

    face3d = (Face3DHelper.from_bfm(args.bfm_dir) if args.bfm_dir
              else Face3DHelper.synthetic())
    pipe = AtomInferencePipeline(state, mc, cfg.atom_diffusion, face3d=face3d,
                                 device=args.device)
    hub = np.load(args.hubert)
    identities = {
        name: (np.load(os.path.join(args.keypoint_dir, name, "00000.npy")), hub)
        for name in sorted(os.listdir(args.keypoint_dir))}
    paths = pipe.run_directory(identities, args.out_dir, seed=args.seed,
                               batch=args.batch)
    for n, p in paths.items():
        print(f"{n}: {p}")


# --------------------------------------------------------------- process-audio
def _read_wav(path: str) -> np.ndarray:
    """Mono float32 waveform from a wav file, channels averaged. soundfile
    when present, stdlib ``wave`` otherwise."""
    try:
        import soundfile as sf  # type: ignore

        speech, _ = sf.read(path)
    except ImportError:
        import wave

        with wave.open(path, "rb") as w:
            n, width = w.getnframes(), w.getsampwidth()
            raw = w.readframes(n)
            dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            speech = np.frombuffer(raw, dt).astype(np.float32)
            if width == 1:
                speech = (speech - 128.0) / 128.0
            else:
                speech = speech / float(np.iinfo(dt).max)
            if w.getnchannels() > 1:
                speech = speech.reshape(-1, w.getnchannels())
    if speech.ndim > 1:
        speech = speech.mean(axis=1)
    return speech.astype(np.float32)


def cmd_process_audio(args):
    from .preprocess import hubert
    from .preprocess.audio import (extract_hubert_features,
                                   ffmpeg_resample_to_16k, hubert_forward,
                                   normalize_like_wav2vec2)

    wav16 = args.audio
    if args.resample:
        wav16 = ffmpeg_resample_to_16k(args.audio, args.audio + ".16k.wav")
    speech = _read_wav(wav16)
    cfg = hubert.HubertConfig()
    if args.hubert_ckpt:
        model = hubert.HubertEncoder(cfg)
        model.load_state_dict(torch.load(args.hubert_ckpt, map_location="cpu",
                                         weights_only=True))
    else:
        print("WARNING: random weights (hubert)", file=sys.stderr)
        model = _seeded_module(lambda: hubert.HubertEncoder(cfg), args.seed)
    model_fn = hubert_forward(model, args.device)
    feats = extract_hubert_features(normalize_like_wav2vec2(speech), model_fn)
    np.save(args.out, feats)
    print(f"saved {args.out} {feats.shape}")


# ------------------------------------------------- align-motion, keypoints
def _build_detectors(args):
    from .preprocess.drivers import build_detectors

    return build_detectors(args.s3fd_ckpt, args.fan_ckpt, args.recon_ckpt,
                           args.bfm_dir, synthetic=args.synthetic_detectors,
                           device=args.device)


def cmd_align_motion(args):
    """AToM→MToV glue (ref align_face_recon.py:240-348)."""
    from .preprocess.drivers import align_motion_corpus

    landmark_fn, coeff_fn, lm3d_std, _, fused = _build_detectors(args)
    written = align_motion_corpus(
        args.frontalized_dir, args.frames_dir, args.out_dir,
        landmark_fn, coeff_fn, lm3d_std,
        process_id=args.process_id, total_processes=args.total,
        resume=not args.no_resume, fused=fused)
    total = sum(written.values())
    print(f"aligned {total} frames across {len(written)} identities "
          f"→ {os.path.join(args.out_dir, 'aligned_npy')}")


def cmd_extract_keypoints(args):
    """Training-data keypoint trees (ref batchify.py:253-321)."""
    from .preprocess.drivers import extract_keypoints_corpus

    landmark_fn, coeff_fn, lm3d_std, helper, _ = _build_detectors(args)
    written = extract_keypoints_corpus(
        args.frames_dir, args.out_dir, landmark_fn, coeff_fn, helper,
        lm3d_std, batch_size=args.batch_size or 16,
        process_id=args.process_id, total_processes=args.total,
        resume=not args.no_resume)
    total = sum(written.values())
    print(f"extracted keypoints for {total} frames across "
          f"{len(written)} identities → {args.out_dir}")


# ------------------------------------------------------------------ sample
_SAMPLE_PIPE_CACHE: dict = {}


def _sample_configs(args):
    cfg = _cfg(args)
    ae_cfg = cfg.mtov_ae
    unet_cfg = dataclasses.replace(
        cfg.mtov_unet, latent_res=ae_cfg.latent_res,
        latent_t=ae_cfg.timesteps // ae_cfg.splits)
    diff_cfg = cfg.mtov_diffusion
    if args.sampling_steps is not None:
        diff_cfg = dataclasses.replace(
            diff_cfg, sampling_timesteps=args.sampling_steps)
    return ae_cfg, unet_cfg, diff_cfg


def _build_sample_pipeline(args, ae_cfg, unet_cfg, diff_cfg):
    """Construct (or reuse) the sampling pipeline.

    In-process memo with one entry: a serving process that calls ``sample``
    repeatedly rebuilds nothing, the weights stay on the device. Keyed by
    the configs, the checkpoint paths and mtimes (or the seed), and the
    device; a new key evicts the old."""
    from .models.mtov import TriplaneUNet, ViTAutoencoder
    from .pipelines.mtov_sample import MtovSamplePipeline

    def src(path):
        return (path, os.path.getmtime(path)) if path else ("seed", args.seed)

    cache_key = (repr(ae_cfg), repr(unet_cfg), repr(diff_cfg),
                 src(args.ae_rgb), src(args.ae_ldmk),
                 src(args.diffusion_model), args.device)
    if cache_key in _SAMPLE_PIPE_CACHE:
        return _SAMPLE_PIPE_CACHE[cache_key]

    pipe = MtovSamplePipeline(
        _load_state(args.ae_rgb, lambda: ViTAutoencoder(ae_cfg), "ae_rgb",
                    args.seed),
        _load_state(args.ae_ldmk, lambda: ViTAutoencoder(ae_cfg), "ae_ldmk",
                    args.seed + 1),
        _load_state(args.diffusion_model, lambda: TriplaneUNet(unet_cfg),
                    "unet", args.seed),
        ae_cfg, unet_cfg, diff_cfg,
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        device=args.device)
    _SAMPLE_PIPE_CACHE.clear()
    _SAMPLE_PIPE_CACHE[cache_key] = pipe
    return pipe


def sample_windows(args, windows) -> str:
    """Everything ``sample`` does once its dataset exists: the pipeline from
    the memo, autoregressive or batched sampling over ``windows`` (an
    iterable of uint8 window dicts, ``SequentialWindowDataset.windows``),
    the timing line, and the video file. Returns the path written."""
    from .pipelines.mtov_sample import write_video

    if args.batch > 1 and not args.no_last_as_reference:
        sys.exit("--batch > 1 batches INDEPENDENT windows; it requires "
                 "--no-last-as-reference (the AR reference chain "
                 "serializes windows)")
    pipe = _build_sample_pipeline(args, *_sample_configs(args))
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    t0 = time.perf_counter()
    if args.batch > 1:
        frames = pipe.sample_independent(
            windows, gen, batch=args.batch,
            noised_start_ratio=args.noised_start_ratio,
            noised_start_source=args.noised_start_source)
    else:
        frames = pipe.sample_long(
            windows, gen,
            use_last_as_reference=not args.no_last_as_reference,
            noised_start_ratio=args.noised_start_ratio,
            noised_start_source=args.noised_start_source)
    dt = time.perf_counter() - t0
    nf = frames.shape[0] * frames.shape[1]
    print(f"sampled {nf} frames in {dt:.2f}s ({nf / dt:.2f} frames/s on "
          f"{pipe.device})", file=sys.stderr)
    out = write_video(frames[0], os.path.join(args.out_dir, "sample.mp4"),
                      fps=25, audio_path=args.audio)
    print(f"video: {out}")
    return out


def cmd_sample(args):
    from .data.mtov_dataset import SequentialWindowDataset
    from .data.prefetch import background_iter

    ae_cfg = _sample_configs(args)[0]
    if args.cross_id:
        if not (args.audio_id and args.ref_id):
            sys.exit("--cross-id needs --audio-id and --ref-id; then "
                     "--aligned-dir is the cross_id aligned_npy ROOT and "
                     "--frames-dir the frames ROOT "
                     "(ref dataloader_sample_crossID.py:31,187-189)")
        ds = SequentialWindowDataset.cross_id(
            args.aligned_dir, args.audio_id, args.ref_id, args.frames_dir,
            kpt_root=args.kpt_root, nframes=ae_cfg.timesteps,
            resolution=ae_cfg.resolution)
    else:
        ds = SequentialWindowDataset(args.frames_dir, args.aligned_dir,
                                     nframes=ae_cfg.timesteps,
                                     resolution=ae_cfg.resolution,
                                     kpt_dir=args.kpt_dir)
    # image decode and dot rasterization for window k+1 run in a host
    # thread while the device samples window k
    return sample_windows(args, background_iter(ds.windows(uint8=True)))


# ------------------------------------------------------------------ parser
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="moditalker_tpu_torch.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="'cuda' (default; fails without a card) or 'cpu'")

    def detector_args(p):
        p.add_argument("--s3fd-ckpt", default=None,
                       help="the port's S3FD state_dict (torch.save)")
        p.add_argument("--fan-ckpt", default=None,
                       help="the port's FAN state_dict (torch.save)")
        p.add_argument("--recon-ckpt", default=None,
                       help="the port's ReconNet state_dict (torch.save)")
        p.add_argument("--bfm-dir", default=None,
                       help="BFM asset dir (similarity_Lm3D_all.mat etc.)")
        p.add_argument("--synthetic-detectors", action="store_true",
                       help="deterministic stand-in detectors (no "
                            "checkpoints; plumbing smoke runs)")
        p.add_argument("--process-id", type=int, default=0)
        p.add_argument("--total", type=int, default=1,
                       help="total processes striping the corpus "
                            "(ref batchify.py:282-288)")
        p.add_argument("--no-resume", action="store_true")
        device_flag(p)

    p = sub.add_parser("process-audio")
    p.add_argument("--audio", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--resample", action="store_true",
                   help="resample to 16 kHz with ffmpeg first")
    p.add_argument("--hubert-ckpt", default=None,
                   help="the port's HubertEncoder state_dict (torch.save); "
                        "default: random weights from --seed")
    p.add_argument("--seed", type=int, default=0)
    device_flag(p)
    p.set_defaults(fn=cmd_process_audio)

    p = sub.add_parser("atom-infer")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--keypoint-dir", required=True,
                   help="keypoints/face-centric/unposed root")
    p.add_argument("--hubert", required=True, help="hubert .npy path")
    p.add_argument("--bfm-dir", default=None)
    p.add_argument("--out-dir", default="runs/atom_infer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="identities per device dispatch (default: all)")
    device_flag(p)
    p.set_defaults(fn=cmd_atom_infer)

    p = sub.add_parser("sample")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--frames-dir", required=True,
                   help="identity frames dir; with --cross-id: frames ROOT")
    p.add_argument("--aligned-dir", required=True,
                   help="aligned_npy/{id} dir; with --cross-id: the "
                        "cross_id aligned_npy ROOT "
                        "(…/audio_{a}/id_{r} resolved from it)")
    p.add_argument("--cross-id", action="store_true",
                   help="reference cross-ID layout (landmarks follow the "
                        "audio identity, frames the reference identity)")
    p.add_argument("--audio-id", default=None)
    p.add_argument("--ref-id", default=None)
    p.add_argument("--kpt-dir", default=None,
                   help="identity training keypoints for the pose mask "
                        "(ref dataloader_sample.py:216); default: mask with "
                        "the aligned landmarks")
    p.add_argument("--kpt-root", default=None,
                   help="cross-ID: training-keypoint ROOT for the mask")
    p.add_argument("--batch", type=int, default=1,
                   help="windows per device dispatch (requires "
                        "--no-last-as-reference)")
    p.add_argument("--ae-rgb", default=None)
    p.add_argument("--ae-ldmk", default=None)
    p.add_argument("--diffusion-model", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--sampling-steps", type=int, default=None,
                   help="DDIM steps (default: config value, ref 100)")
    p.add_argument("--noised-start-ratio", type=float, default=None)
    p.add_argument("--noised-start-source", choices=("ref", "gt"),
                   default="ref",
                   help="fast-mode renoise latent: 'ref' = the dataset "
                        "reference window (--x_noisy_start, the shipped "
                        "sample.sh mode), 'gt' = the ground-truth window "
                        "(--refvid_noisy_start)")
    p.add_argument("--no-last-as-reference", action="store_true")
    p.add_argument("--out-dir", default="runs/sample")
    p.add_argument("--seed", type=int, default=42)
    device_flag(p)
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("align-motion",
                       help="AToM frontalized landmarks → pose-matched "
                            "aligned_npy for MToV")
    p.add_argument("--frontalized-dir", required=True,
                   help="frontalized_npy root (atom-infer output)")
    p.add_argument("--frames-dir", required=True,
                   help="pose-driving frames root ({id}/*.jpg)")
    p.add_argument("--out-dir", required=True)
    detector_args(p)
    p.set_defaults(fn=cmd_align_motion)

    p = sub.add_parser("extract-keypoints",
                       help="training keypoint-set trees from a frame corpus")
    p.add_argument("--frames-dir", required=True,
                   help="frames root ({id}/*.jpg)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    detector_args(p)
    p.set_defaults(fn=cmd_extract_keypoints)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
