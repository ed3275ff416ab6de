"""Command-line interface of the PyTorch port (port of the ``sample`` and
``atom-infer`` commands of ``moditalker_tpu/cli.py``):

  reference                | here
  ---------------------------------------------------------
  MToV/sample.py           | sample
  MToV/sample_crossID.py   | sample --cross-id
  AToM/inference.py        | atom-infer

    python -m moditalker_tpu_torch.cli sample --frames-dir ... --aligned-dir ...
    python -m moditalker_tpu_torch.cli atom-infer --keypoint-dir ... --hubert ...

Both run on the card unless ``--device cpu`` is given. Checkpoints are
``state_dict``s of the port's modules saved with ``torch.save``
(``utils/convert.py`` makes them from the JAX package's parameters); without
a checkpoint the weights are drawn from ``--seed`` and a WARNING is printed.
The flags are the JAX package's, minus ``--data-parallel`` (one card).
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


def _seeded_state(init_fn, seed: int):
    """The ``state_dict`` of ``init_fn()`` with its weights drawn from
    ``seed``; the caller's random state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return init_fn().state_dict()


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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
