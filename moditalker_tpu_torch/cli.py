"""Command-line interface of the PyTorch port (port of the inference,
preprocessing and training commands of ``moditalker_tpu/cli.py``):

  reference                                   | here
  --------------------------------------------------------------------
  AToM/train.py                               | train-atom
  MToV/main.py --exp first_stage              | train-first-stage
  MToV/main.py --exp first_stage_ldmk         | train-first-stage --landmark
  MToV/main.py --exp ddpm                     | train-diffusion
  MToV/sample.py                              | sample
  MToV/sample_crossID.py                      | sample --cross-id
  AToM/inference.py                           | atom-infer
  data_utils/preprocess/process_audio.py      | process-audio
  data_utils/motion_align/align_face_recon.py | align-motion
  preprocess/process_video_3dmm_rollback_     | extract-keypoints
    hdtf_batchify.py                          |
  data_utils/preprocess/unify_fps.py          | unify-fps
  data_utils/preprocess/video2frame_hdtf.py   | video2frame
  (reference checkpoints → the port)          | golden, convert-checkpoint

    python -m moditalker_tpu_torch.cli process-audio --audio a.wav --out h.npy
    python -m moditalker_tpu_torch.cli atom-infer --keypoint-dir ... --hubert ...
    python -m moditalker_tpu_torch.cli align-motion --frontalized-dir ... \
        --frames-dir ... --out-dir ...
    python -m moditalker_tpu_torch.cli sample --frames-dir ... --aligned-dir ...

    python -m moditalker_tpu_torch.cli train-atom --synthetic --steps 100
    python -m moditalker_tpu_torch.cli train-first-stage --synthetic --steps 100
    python -m moditalker_tpu_torch.cli train-diffusion --synthetic --steps 100
    python -m moditalker_tpu_torch.cli video2frame --src-root ... --out-dir ...
    python -m moditalker_tpu_torch.cli convert-checkpoint --torch-ckpt \
        diffusion_model.pth --kind triplane-unet --out unet.pt
    python -m moditalker_tpu_torch.cli golden --mode record --golden g.npz

Each runs on the card unless ``--device cpu`` is given; ``unify-fps`` and
``video2frame`` only run ffmpeg on the host and take no ``--device``.
Checkpoints are ``state_dict``s of the port's modules saved with ``torch.save``
(``utils/convert.py`` makes them from the JAX package's parameters); without
a checkpoint ``sample``, ``atom-infer`` and ``process-audio`` draw the
weights from ``--seed`` and print a WARNING (the JAX package's
``process-audio`` downloads HuBERT instead). The flags are the JAX
package's, plus ``--device`` (and ``--seed`` for ``process-audio``).
``--data-parallel N`` on ``sample`` and ``atom-infer`` runs a replica on each
of N cards of the host (default: every visible card; one on the CPU). The
trainers train over several processes, one per card (``core/sharding.py``):
with ``--coordinator host:port --num-processes N --process-id i`` on each,
or under ``torchrun --nproc-per-node N`` (its environment); ``--batch-size``
is the global batch, of which each process trains on its rows. The trainers write the
port's checkpoints (``core/checkpoint.py``: ``torch.save`` trees, one
directory per step) and, at the end, the final state as one file; the
first stage's (``ae_rgb.pt``, ``ae_ldmk.pt``) is what ``train-diffusion
--ae-rgb / --ae-ldmk`` read. ``--i3d`` takes an I3D
``state_dict`` (the port's, or the reference's ``i3d_pretrained_400.pt``:
they share their keys).
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


def _init_distributed(args) -> None:
    """Join the trainers' process group (explicit flags, or torchrun's
    environment; a single process otherwise)."""
    from .core.sharding import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     device=args.device)


def _logger(args):
    """The metric logger of rank 0; None on the other ranks."""
    from .core.logging import MetricLogger
    from .core.sharding import is_main

    return MetricLogger(os.path.join(args.out_dir, "logs")) if is_main() \
        else None


def _save_final(path: str, state) -> str:
    """Rank 0 writes the final state, the others wait for it."""
    from .core.checkpoint import save_single
    from .core.sharding import barrier, is_main

    if is_main():
        save_single(path, state)
    barrier()
    return path


# ------------------------------------------------------------------ train-atom
def cmd_train_atom(args):
    """AToM training (ref AToM/train.py → AToM.py:32-236) on LRS3's
    GeneFace database under ``--data-root``, or on one synthetic batch
    repeated (``--synthetic``, or no ``--data-root``)."""
    from .core.checkpoint import CheckpointManager
    from .core.preempt import GracefulStop
    from .data.atom_dataset import AtomSequenceDataset, synthetic_batch
    from .train.atom import AtomTrainer

    _init_distributed(args)
    cfg = _cfg(args)
    tc = dataclasses.replace(
        cfg.atom_train, batch_size=args.batch_size or cfg.atom_train.batch_size,
        seed=args.seed)
    trainer = AtomTrainer(cfg.atom_model, cfg.atom_diffusion, tc,
                          device=args.device)
    if args.synthetic or args.data_root is None:
        batch = synthetic_batch(tc.batch_size, cfg.atom_model.horizon,
                                seed=args.seed)

        class _Synthetic:  # iter_epoch with the LRS3 batch layout
            def iter_epoch(self, batch_size, seed=0):
                for _ in range(args.steps):
                    yield batch

        ds = _Synthetic()
    else:
        ds = AtomSequenceDataset(args.data_root, "train")
    logger = _logger(args)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "atom_ckpt"))
    # {params, ema_params, optimizer, step} every --ckpt-every steps (ref
    # AToM.py:188-196 saves {ema, model, optimizer} per save_interval)
    state = trainer.fit(ds, epochs=10**9 if args.steps else None,
                        log_every=10, ckpt_manager=ckpt,
                        ckpt_every=args.ckpt_every, logger=logger,
                        stop=GracefulStop().install(), max_steps=args.steps)
    if logger is not None:
        logger.close()
    path = _save_final(os.path.join(args.out_dir, "atom.pt"), state)
    print(f"step {state['step']}: checkpoint {path}")
    return path


# ----------------------------------------------------------- train-first-stage
def _load_i3d(path: str, device):
    """The ``i3d_apply`` of an I3D ``state_dict`` file on ``device``."""
    from .evals.i3d import i3d_apply, load_i3d

    return i3d_apply(load_i3d(path, device))


def cmd_train_first_stage(args):
    """First stage: the RGB autoencoder, or with ``--landmark`` the landmark
    AE with its decoder frozen, against LPIPS and the 2D/3D PatchGANs (ref
    MToV/main.py --exp first_stage[_ldmk] → tools/trainer.py:134-...), on
    HDTF frames under ``--data-root`` or one synthetic batch repeated. The
    PSNR probe (and with ``--i3d`` the reconstruction FVD) and a full-state
    checkpoint every ``--eval-every`` iterations (ref trainer.py:232-257)."""
    import itertools

    from .core.checkpoint import CheckpointManager
    from .core.preempt import GracefulStop
    from .data.mtov_dataset import HDTFFramesDataset, synthetic_mtov_batch
    from .evals.loops import eval_ae_psnr, eval_ae_rfvd
    from .train.mtov_first_stage import FirstStageTrainer

    _init_distributed(args)
    cfg = _cfg(args)
    tc = dataclasses.replace(
        cfg.mtov_train, batch_size=args.batch_size or cfg.mtov_train.batch_size,
        seed=args.seed)
    ae_cfg = cfg.mtov_ae
    trainer = FirstStageTrainer(ae_cfg, cfg.mtov_loss, tc, device=args.device,
                                freeze_decoder=args.landmark)
    vkey = "x_l" if args.landmark else "x"
    if args.synthetic or args.data_root is None:
        batch = synthetic_mtov_batch(tc.batch_size, ae_cfg.timesteps,
                                     ae_cfg.resolution, args.seed)
        src = itertools.repeat(batch)
        eval_videos = [batch[vkey]]
    else:
        ds = HDTFFramesDataset(args.data_root, args.kpt_root,
                               resolution=ae_cfg.resolution,
                               nframes=ae_cfg.timesteps)
        src = ds.batches(tc.batch_size, seed=args.seed)
        probe = ds.batches(tc.batch_size, seed=args.seed + 1)
        eval_videos = [next(probe)[vkey] for _ in range(2)]
    i3d = _load_i3d(args.i3d, trainer.device) if args.i3d else None

    def eval_fn(tr):
        out = {"eval_psnr": eval_ae_psnr(tr.reconstruct, iter(eval_videos))}
        if i3d is not None:
            out["eval_rfvd"] = eval_ae_rfvd(tr.reconstruct, iter(eval_videos),
                                            i3d)
        print("probe: " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out

    name = "ae_ldmk" if args.landmark else "ae_rgb"
    logger = _logger(args)
    ckpt = CheckpointManager(os.path.join(args.out_dir, name + "_ckpt"))
    state = trainer.fit(({vkey: b[vkey]} for b in src), max_steps=args.steps,
                        logger=logger, ckpt_manager=ckpt,
                        eval_every=args.eval_every, eval_fn=eval_fn,
                        log_every=10, stop=GracefulStop().install())
    if logger is not None:
        logger.close()
    path = _save_final(os.path.join(args.out_dir, name + ".pt"), state)
    print(f"step {state['step']}: checkpoint {path}")
    return path


# -------------------------------------------------------------- train-diffusion
def _ae_state(path: str | None, ae_cfg, tag: str, seed: int) -> dict:
    """An AE's state_dict: the port's (``torch.save``), or one held under
    ``ae_params`` of a saved state; else drawn from ``seed`` (WARNING)."""
    from .models.mtov import ViTAutoencoder

    state = _load_state(path, lambda: ViTAutoencoder(ae_cfg), f"{tag} AE",
                        seed)
    return state.get("ae_params", state)


def cmd_train_diffusion(args):
    """Second stage: frozen AEs over HDTF frame batches through
    ``LatentDiffusionLoop`` (ref scripts/train/second_stg.sh →
    exps/diffusion.py:56-177 → trainer.py:23-131). ``--latents-only``
    trains on one synthetic latent batch (no AEs in the program)."""
    import itertools

    from .core.checkpoint import CheckpointManager
    from .core.preempt import GracefulStop
    from .models.mtov import ViTAutoencoder
    from .train.mtov import LatentDiffusionLoop, MtovDiffusionTrainer

    _init_distributed(args)
    cfg = _cfg(args)
    tc = dataclasses.replace(cfg.mtov_train, seed=args.seed)
    uc = cfg.mtov_unet
    L = uc.latent_res**2 + 2 * uc.latent_t * uc.latent_res
    trainer = MtovDiffusionTrainer(uc, cfg.mtov_diffusion, tc,
                                   device=args.device)
    b = args.batch_size or tc.diffusion_batch_size
    final = os.path.join(args.out_dir, "diffusion.pt")
    if args.latents_only:
        rng = np.random.default_rng(args.seed)
        batch = {
            "z": np.tanh(rng.normal(size=(b, 4, L))).astype(np.float32),
            "cond": rng.normal(size=(b, 8, L)).astype(np.float32),
            "image_cond": rng.normal(size=(b, 4, L)).astype(np.float32),
        }
        from .core.sharding import mean_over_ranks

        for i in range(args.steps):
            m = trainer.step(batch)
            if i % 10 == 0:
                print(f"step {i}: loss {mean_over_ranks(m)['loss']:.4f}")
        _save_final(final, trainer.state())
        print(f"checkpoint: {final}")
        return final

    from .data.mtov_dataset import HDTFFramesDataset, synthetic_mtov_batch
    from .evals.metrics import video_psnr

    ae_cfg = cfg.mtov_ae
    aes = []
    for path, tag, seed in ((args.ae_rgb, "rgb", args.seed + 11),
                            (args.ae_ldmk, "ldmk", args.seed + 12)):
        ae = ViTAutoencoder(ae_cfg)
        ae.load_state_dict(_ae_state(path, ae_cfg, tag, seed))
        aes.append(ae)
    loop = LatentDiffusionLoop(trainer, *aes)
    if args.synthetic or args.data_root is None:
        batch = synthetic_mtov_batch(b, resolution=ae_cfg.resolution,
                                     timesteps=ae_cfg.timesteps,
                                     seed=args.seed)
        batches = itertools.repeat(batch)
        probe_batch = batch
    else:
        ds = HDTFFramesDataset(args.data_root, args.kpt_root,
                               resolution=ae_cfg.resolution,
                               nframes=ae_cfg.timesteps)
        batches = ds.batches(b, seed=args.seed)
        probe_batch = next(ds.batches(b, seed=args.seed + 1))

    logger = _logger(args)
    ckpt = CheckpointManager(os.path.join(args.out_dir, "diffusion_ema"))
    i3d = _load_i3d(args.i3d, trainer.device) if args.i3d else None

    def eval_fn(lp, it):
        g = torch.Generator(device=trainer.device).manual_seed(args.seed + it)
        gen = lp.sample(probe_batch, g)
        out = {"sample_psnr": video_psnr(probe_batch["x"], gen)}
        if i3d is not None:
            from .evals.fvd import compute_fvd
            from .evals.loops import _to_u8

            out["sample_fvd"] = compute_fvd(
                i3d, _to_u8(probe_batch["x"]), _to_u8(gen),
                batch=min(8, gen.shape[0]))
        print(f"probe @{it}: " + " ".join(
            f"{k}={v:.4f}" for k, v in out.items()))
        return out

    loop.fit(batches, max_steps=args.steps, logger=logger, ckpt_manager=ckpt,
             ckpt_every=args.ckpt_every, eval_every=args.eval_every,
             eval_fn=eval_fn, stop=GracefulStop().install())
    if logger is not None:
        logger.close()
    _save_final(final, trainer.state())
    print(f"EMA checkpoints: {os.path.join(args.out_dir, 'diffusion_ema')}; "
          f"final state: {final}")
    return final


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
                                 device=args.device,
                                 data_parallel=args.data_parallel)
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


# ---------------------------------------------------------- video corpus tools
def cmd_unify_fps(args):
    """Corpus fps normalisation (ref unify_fps.py:19)."""
    from .preprocess.video import unify_fps_corpus

    written = unify_fps_corpus(
        args.src_root, args.out_dir, fps=args.fps, processes=args.processes,
        process_id=args.process_id, total_processes=args.total,
        skip_existing=not args.no_resume)
    print(f"re-encoded {len(written)} videos at {args.fps} fps "
          f"→ {args.out_dir}")
    return written


def cmd_video2frame(args):
    """Corpus frame extraction (ref video2frame_hdtf.py, Pool fan-out)."""
    from .preprocess.video import video_to_frames_corpus

    written = video_to_frames_corpus(
        args.src_root, args.out_dir, quality=args.quality,
        processes=args.processes, process_id=args.process_id,
        total_processes=args.total, skip_existing=not args.no_resume)
    print(f"extracted frames for {len(written)} videos → {args.out_dir}")
    return written


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
                 src(args.diffusion_model), args.device, args.data_parallel)
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
        device=args.device, data_parallel=args.data_parallel)
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
          f"{len(pipe.replicas)} x {pipe.device.type})", file=sys.stderr)
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


# ------------------------------------------------------- golden, conversion
def cmd_golden(args):
    """Reference checkpoints → the port (``convert``), or the fixed-seed
    probes recorded (``record``) or checked against a file (``check``:
    exit 1 on a mismatch)."""
    from . import golden

    if args.mode == "convert":
        if not args.ckpt_dir:
            sys.exit("--ckpt-dir required for convert")
        return golden.convert_all(args.ckpt_dir, args.out_dir)
    if args.mode == "record":
        return golden.record(args.golden, args.params_dir, tiny=args.tiny,
                             device=args.device)
    if not golden.check(args.golden, args.params_dir, tiny=args.tiny,
                        rtol=args.rtol, atol=args.atol, device=args.device):
        sys.exit(1)
    return True


def cmd_convert(args):
    """One reference checkpoint → the port's state_dict (``torch.save``),
    through the golden harness's converter registry."""
    from . import golden
    from .core.checkpoint import save_single

    sd = golden.load_torch_state_dict(args.torch_ckpt, ema=args.ema)
    ctx = {"ckpt_dir": os.path.dirname(args.torch_ckpt) or ".",
           "vgg16_path": args.vgg16}
    save_single(args.out, golden._converter(args.kind)(sd, ctx))
    print(f"converted {args.kind}: {args.out}")
    return args.out


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

    def train_args(p):
        p.add_argument("--steps", type=int, default=100)
        p.add_argument("--batch-size", type=int, default=None)
        p.add_argument("--synthetic", action="store_true")
        p.add_argument("--data-root", type=str, default=None)
        p.add_argument("--out-dir", type=str, default="runs")
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--config", type=str, default=None,
                       help="YAML config (native or reference MToV format)")
        # several processes, one per card (core/sharding.py): the same
        # --coordinator and --num-processes on each, a unique --process-id;
        # none of them → torchrun's environment, else one process
        p.add_argument("--coordinator", default=None,
                       help="host:port of process 0's rendezvous")
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)
        device_flag(p)

    def data_parallel_flag(p, what):
        p.add_argument("--data-parallel", type=int, default=None,
                       help=f"split the {what} batch over N cards, one "
                            "replica and host thread each (default: all "
                            "visible cards; 1 on the CPU)")

    p = sub.add_parser("train-atom")
    train_args(p)
    p.add_argument("--ckpt-every", type=int, default=2000,
                   help="{params, ema_params, optimizer, step} save cadence "
                        "(ref AToM.py save_interval)")
    p.set_defaults(fn=cmd_train_atom)

    p = sub.add_parser("train-first-stage")
    train_args(p)
    p.add_argument("--landmark", action="store_true",
                   help="landmark-AE variant (first_stage_ldmk)")
    p.add_argument("--kpt-root", type=str, default=None)
    p.add_argument("--i3d", default=None,
                   help="I3D state_dict → rFVD probe (ref test_ifvd)")
    p.add_argument("--eval-every", type=int, default=2000,
                   help="PSNR/rFVD probe + checkpoint cadence "
                        "(ref trainer.py:232-257)")
    p.set_defaults(fn=cmd_train_first_stage)

    p = sub.add_parser("train-diffusion")
    train_args(p)
    p.add_argument("--kpt-root", type=str, default=None)
    p.add_argument("--ae-rgb", default=None,
                   help="the port's RGB AE state_dict (torch.save)")
    p.add_argument("--ae-ldmk", default=None,
                   help="the port's landmark AE state_dict (torch.save)")
    p.add_argument("--latents-only", action="store_true",
                   help="synthetic-latent smoke mode (no AEs)")
    p.add_argument("--i3d", default=None,
                   help="I3D state_dict → sample-FVD probe")
    p.add_argument("--ckpt-every", type=int, default=1000,
                   help="EMA-save cadence (ref trainer.py:122-124)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="probe cadence (default: same as --ckpt-every)")
    p.set_defaults(fn=cmd_train_diffusion)

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
    data_parallel_flag(p, "identity")
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
    data_parallel_flag(p, "window")
    device_flag(p)
    p.set_defaults(fn=cmd_sample)

    def corpus_args(p):
        p.add_argument("--src-root", required=True,
                       help="corpus root: {id}.mp4 or {id}/video.mp4")
        p.add_argument("--out-dir", required=True)

    def stripe_args(p):
        p.add_argument("--processes", type=int, default=4)
        p.add_argument("--process-id", type=int, default=0)
        p.add_argument("--total", type=int, default=1)
        p.add_argument("--no-resume", action="store_true")

    p = sub.add_parser("unify-fps",
                       help="re-encode a video corpus at a fixed fps "
                            "(ref unify_fps.py)")
    corpus_args(p)
    p.add_argument("--fps", type=int, default=25)
    stripe_args(p)
    p.set_defaults(fn=cmd_unify_fps)

    p = sub.add_parser("video2frame",
                       help="dump a video corpus to {id}/{i:05d}.jpg frames "
                            "(ref video2frame_hdtf.py)")
    corpus_args(p)
    p.add_argument("--quality", type=int, default=2,
                   help="jpeg qscale (2 = high quality)")
    stripe_args(p)
    p.set_defaults(fn=cmd_video2frame)

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

    p = sub.add_parser("golden",
                       help="reference-checkpoint golden harness "
                            "(convert / record / check)")
    p.add_argument("--mode", required=True,
                   choices=["convert", "record", "check"])
    p.add_argument("--ckpt-dir", default=None,
                   help="directory of reference .pth/.pt files (convert)")
    p.add_argument("--params-dir", default=None,
                   help="directory of converted state_dicts (record/check)")
    p.add_argument("--golden", default="goldens.npz")
    p.add_argument("--out-dir", default="runs/converted")
    p.add_argument("--tiny", action="store_true",
                   help="tiny configs (harness self-test)")
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--atol", type=float, default=1e-4)
    device_flag(p)
    p.set_defaults(fn=cmd_golden)

    p = sub.add_parser("convert-checkpoint",
                       help="one reference checkpoint → the port's "
                            "state_dict")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--kind", required=True,
                   choices=["atom", "vit-autoencoder", "triplane-unet",
                            "recon-resnet50", "i3d", "hubert", "fan",
                            "s3fd", "lpips"])
    p.add_argument("--out", required=True)
    p.add_argument("--ema", action="store_true",
                   help="for atom ckpts: take ema_state_dict")
    p.add_argument("--vgg16", default=None,
                   help="lpips: torchvision vgg16 weights file (the trunk; "
                        "--torch-ckpt is the richzhang lin-head vgg.pth)")
    p.set_defaults(fn=cmd_convert)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
