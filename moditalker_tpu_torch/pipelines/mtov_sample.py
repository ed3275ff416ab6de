"""MToV sampling: one window and the autoregressive long-video chain (port of
``moditalker_tpu/pipelines/mtov_sample.py``, ref MToV/sample.py).

Per 16-frame window: AE-extract the landmark video, the pose-masked video and
the reference (and, in the noised-start fast mode, the renoise source);
DDIM-sample the triplane latent; decode; quantise to uint8. ``sample_long``
feeds the last generated frame back as the next window's reference
(``use_last_as_reference``, sample.py:342-362). One card, no mesh.
"""

from __future__ import annotations

import itertools
import os
import shutil
import subprocess

import numpy as np
import torch

from ..config import MtovAEConfig, MtovDiffusionConfig, MtovUNetConfig
from ..device import resolve_device
from ..models.mtov import MtovDDPM, TriplaneUNet, ViTAutoencoder


def to_uint8(video) -> np.ndarray:
    """[-1,1] float → uint8 (ref sample.py:385-386 clamp + scale, with the
    PNG round-trip's ``np.rint``, sample.py:397); uint8 passes through."""
    v = video.cpu().numpy() if isinstance(video, torch.Tensor) else np.asarray(video)
    if v.dtype == np.uint8:
        return v
    return np.rint((np.clip(v, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)


class MtovSamplePipeline:
    """Weights are ``state_dict``s of the port's ``ViTAutoencoder`` (rgb and
    landmark) and ``TriplaneUNet`` (``utils/convert.py`` makes them from the
    JAX package's parameters). ``device`` defaults to the card; without one
    the constructor raises."""

    def __init__(self, ae_rgb_state, ae_ldmk_state, unet_state,
                 ae_cfg: MtovAEConfig = MtovAEConfig(),
                 unet_cfg: MtovUNetConfig = MtovUNetConfig(),
                 diff_cfg: MtovDiffusionConfig = MtovDiffusionConfig(
                     sampling_timesteps=100, w=0.0),
                 dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.ae_cfg, self.unet_cfg = ae_cfg, unet_cfg

        def build(module, state):
            module.load_state_dict(state)
            return module.to(self.device).eval().requires_grad_(False)

        self.ae_rgb = build(ViTAutoencoder(ae_cfg, dtype), ae_rgb_state)
        self.ae_ldmk = build(ViTAutoencoder(ae_cfg, dtype), ae_ldmk_state)
        self.ddpm = MtovDDPM.create(
            build(TriplaneUNet(unet_cfg, dtype), unet_state), diff_cfg,
            self.device)
        self.L = ae_cfg.latent_len

    # ------------------------------------------------------------ window
    def _in(self, v):
        """Host or device video → model-range tensor on the device. uint8
        frames convert on the device (4× fewer bytes over the host link)."""
        v = self._in_raw(v)
        if v.dtype == torch.uint8:
            return v.float() / 127.5 - 1.0
        return v

    def _in_raw(self, v):
        return torch.as_tensor(v).to(self.device)

    @staticmethod
    def _out(video, out_u8: bool):
        if not out_u8:
            return video
        v = video.float().clamp(-1.0, 1.0)
        # round half to even, as np.rint: this uint8 also feeds back as the
        # AR reference, so truncation would bias the chain
        return torch.round((v + 1.0) * 127.5).to(torch.uint8)

    def _conditioning(self, ldmk_video, masked_video, ref_video):
        z_l = self.ae_ldmk.extract(self._in(ldmk_video))
        masked_z = self.ae_rgb.extract(self._in(masked_video))
        image_cond = self.ae_rgb.extract(self._in(ref_video))
        return torch.cat([z_l, masked_z], dim=1), image_cond

    @torch.inference_mode()
    def window_step(self, ldmk_video, masked_video, ref_video, generator,
                    out_u8: bool = False):
        """Three extracts, DDIM over the UNet, decode (mtov_sample.py:102-123)."""
        cond, image_cond = self._conditioning(ldmk_video, masked_video,
                                              ref_video)
        latent = self.ddpm.ddim_sample(
            (cond.shape[0], self.unet_cfg.in_channels, self.L), cond,
            image_cond, generator=generator)
        return self._out(self.ae_rgb.decode_from_sample(latent), out_u8)

    @torch.inference_mode()
    def window_step_noised(self, gt_video, ldmk_video, masked_video,
                           ref_video, generator, ratio: float,
                           out_u8: bool = False):
        """Four extracts, partial-renoise DDIM from ``gt_video``'s latent,
        decode (mtov_sample.py:125-144)."""
        cond, image_cond = self._conditioning(ldmk_video, masked_video,
                                              ref_video)
        z = self.ae_rgb.extract(self._in(gt_video))
        latent = self.ddpm.ddim_sample_noised_start(
            z, cond, image_cond, ratio, generator=generator)
        return self._out(self.ae_rgb.decode_from_sample(latent), out_u8)

    def sample_window(self, ldmk_video, masked_video, ref_video, generator,
                      gt_video=None, noised_start_ratio: float | None = None,
                      out_uint8: bool = False):
        """All videos [B, 16, H, W, 3], uint8 frames or [-1, 1] float →
        generated video on the device, float model range or uint8 frames."""
        if noised_start_ratio is not None:
            if gt_video is None:
                raise ValueError("the noised start needs gt_video")
            return self.window_step_noised(gt_video, ldmk_video, masked_video,
                                           ref_video, generator,
                                           noised_start_ratio, out_uint8)
        return self.window_step(ldmk_video, masked_video, ref_video,
                                generator, out_uint8)

    # ------------------------------------------------------------ many windows
    def sample_independent(self, windows, generator, batch: int = 8,
                           noised_start_ratio: float | None = None,
                           noised_start_source: str = "ref") -> np.ndarray:
        """Independent windows, ``batch`` per dispatch (the tail chunk padded
        by repetition and trimmed). Returns [1, n*T, H, W, 3] uint8."""
        it = iter(windows)
        outs = []
        pending = None  # (device uint8 still computing, n_real)

        def flush():
            g, n = pending
            g = g[:n].cpu().numpy()
            outs.append(g.reshape(1, -1, *g.shape[2:]))

        while chunk := list(itertools.islice(it, batch)):
            n_real = len(chunk)
            chunk += [chunk[-1]] * (batch - n_real)
            stacked = {k: np.concatenate([np.asarray(w[k]) for w in chunk])
                       for k in chunk[0]}
            # one upload of the reference stack: in "ref" mode it is also
            # the renoise source
            ref_dev = self._in_raw(stacked["x_ref"])
            noise_src = None
            if noised_start_ratio is not None:
                noise_src = ref_dev if noised_start_source == "ref" else stacked["x"]
            gen = self.sample_window(stacked["x_l"], stacked["masked_x"],
                                     ref_dev, generator, gt_video=noise_src,
                                     noised_start_ratio=noised_start_ratio,
                                     out_uint8=True)
            if pending is not None:
                flush()
            pending = (gen, n_real)
        if pending is None:
            return np.zeros((1, 0, 0, 0, 3), np.uint8)
        flush()
        return np.concatenate(outs, axis=1)

    def sample_long(self, windows, generator, use_last_as_reference: bool = True,
                    noised_start_ratio: float | None = None,
                    noised_start_source: str = "ref") -> np.ndarray:
        """Autoregressive multi-window generation (ref sample.py:305-398).

        ``windows``: iterable of dicts with 'x_l', 'masked_x', 'x_ref' (and
        'x' for the "gt" noised start), each [B, 16, H, W, 3]. Returns the
        concatenated uint8 video [B, n*16, H, W, 3].

        ``noised_start_source`` picks the latent the fast mode renoises
        (sample.py:375-380): "ref" (``--x_noisy_start``, the shipped mode)
        renoises the DATASET reference window even after
        ``use_last_as_reference`` swapped the conditioning reference for the
        last generated frame; "gt" (``--refvid_noisy_start``) renoises the
        ground-truth window.
        """
        if noised_start_source not in ("ref", "gt"):
            raise ValueError(f"noised_start_source {noised_start_source!r}")
        out_frames = []
        last_gen = None   # previous window's output, kept on the device
        pending = None    # device window not yet fetched to the host

        # Device staging for host inputs that stay constant across an
        # identity's windows (the dataset reference: conditioning in window 1
        # or without AR, renoise source in "ref" mode). A miss uploads and
        # keeps a COPY of the host bytes, so a caller that reuses its buffer
        # cannot change what the cache compares against.
        staged: dict[str, tuple[np.ndarray, torch.Tensor]] = {}

        def put_cached(slot, v):
            if isinstance(v, torch.Tensor):
                return v.to(self.device)
            src = np.asarray(v)
            ent = staged.get(slot)
            if (ent is not None and src.shape == ent[0].shape
                    and src.dtype == ent[0].dtype
                    and np.array_equal(src, ent[0])):
                return ent[1]
            dev = self._in_raw(src)
            staged[slot] = (src.copy(), dev)
            return dev

        for w in windows:
            noise_src = None
            if noised_start_ratio is not None:
                slot = "x_ref" if noised_start_source == "ref" else "x"
                noise_src = put_cached(slot, w[slot])
            if use_last_as_reference and last_gen is not None:
                # the previous window's final frame ×T, built on the device
                t = int(w["x_ref"].shape[1])
                ref = last_gen[:, -1:].expand(-1, t, -1, -1, -1)
            else:
                ref = put_cached("x_ref", w["x_ref"])
            gen = self.sample_window(w["x_l"], w["masked_x"], ref, generator,
                                     gt_video=noise_src,
                                     noised_start_ratio=noised_start_ratio,
                                     out_uint8=True)
            last_gen = gen
            # fetch the PREVIOUS window while the device runs this one
            if pending is not None:
                out_frames.append(pending.cpu().numpy())
            pending = gen
        if pending is not None:
            out_frames.append(pending.cpu().numpy())
        return np.concatenate(out_frames, axis=1)


# ------------------------------------------------------------------ writers
def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def write_video(frames: np.ndarray, path: str, fps: int = 25,
                audio_path: str | None = None,
                preset: str | None = None) -> str:
    """uint8 [T, H, W, 3] → mp4 via ffmpeg, optionally muxing audio
    (ref sample.py:109-117 make_video); without ffmpeg on the host, an
    ``.npz`` frame dump beside the asked path. Returns the path written.

    ``preset`` is the libx264 speed/size knob (default ``veryfast``,
    override via MODITALKER_X264_PRESET)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not has_ffmpeg():
        alt = path.rsplit(".", 1)[0] + ".npz"
        np.savez_compressed(alt, frames=frames, fps=fps)
        return alt
    if preset is None:
        preset = os.environ.get("MODITALKER_X264_PRESET", "veryfast")
    t, h, w, _ = frames.shape
    cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-s", f"{w}x{h}", "-r", str(fps), "-i", "pipe:0"]
    if audio_path:
        cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
    cmd += ["-pix_fmt", "yuv420p", "-c:v", "libx264", "-preset", preset,
            path]
    proc = subprocess.run(cmd, input=frames.tobytes(), capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[-500:]}")
    return path


def save_gif(frames: np.ndarray, path: str, fps: int = 25) -> str:
    """uint8 [T, H, W, 3] → animated gif (ref sample.py gif dumps)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 20), loop=0)
    return path


def save_image_grid(video: np.ndarray, path: str, cols: int = 8) -> str:
    """uint8 [T, H, W, 3] → one grid png (ref sample.py:56-107)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t, h, w, c = video.shape
    rows = (t + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(t):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = video[i]
    Image.fromarray(grid).save(path)
    return path


def save_frames(video: np.ndarray, out_dir: str) -> list[str]:
    """uint8 [T, H, W, 3] → per-frame jpgs in the reference layout."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, f in enumerate(video):
        p = os.path.join(out_dir, f"{i:05d}.jpg")
        Image.fromarray(f).save(p, quality=95)
        paths.append(p)
    return paths
