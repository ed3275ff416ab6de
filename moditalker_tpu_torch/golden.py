"""Reference-checkpoint golden harness (port of ``moditalker_tpu/golden.py``).

The published MoDiTalker release ships the pretrained files named in
``CKPT_KINDS`` (atom.pt, the two ViT autoencoders, the diffusion UNet, LPIPS's
vgg.pth over torchvision's VGG16, I3D, ReconNet, S3FD and FAN). This harness
turns them into the port's ``state_dict``s and records or checks fixed-seed
probes through every model:

    python -m moditalker_tpu_torch.cli golden --mode convert --ckpt-dir ckpts/
    python -m moditalker_tpu_torch.cli golden --mode record --params-dir runs/converted
    python -m moditalker_tpu_torch.cli golden --mode check --params-dir runs/converted \
        --golden goldens.npz

``convert``: every converter that applies to the files found (missing files
are reported and skipped); each result is the port's ``save_single`` file
``<out-dir>/<stem>.pt``.
``record``: one AToM DDIM-4 sequence, one MToV window (3 extracts → DDIM-4
→ decode), an AE extract and single forwards of the auxiliary nets, from the
converted weights where present and the port's seeded init otherwise; the
outputs go into one ``.npz``.
``check``: the same probes against a recorded file, per-probe max error
within ``atol + rtol·max|golden|``.

The probes' inputs come from ``numpy.random.default_rng(1234)`` in the JAX
harness's order, so both packages see the same inputs. The samplers' noise
is an input: by default drawn from a CPU ``torch.Generator`` seeded with 1234
and moved to the device (the goldens do not depend on the device's RNG);
``run_probes(noise=...)`` takes the draws instead, in the order the
samplers consume them (the tests feed JAX's draws this way).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# checkpoint file name → converter kind (reference names, README.md:100-106)
CKPT_KINDS = {
    "atom.pt": "atom",
    "autoencoder_rgb.pth": "vit-autoencoder",
    "autoencoder_motion.pth": "vit-autoencoder",
    "diffusion_model.pth": "triplane-unet",
    "vgg.pth": "lpips",
    "i3d_pretrained_400.pt": "i3d",
    "epoch_20.pth": "recon-resnet50",
    "s3fd-619a316812.pth": "s3fd",
    "2DFAN4-cd938726ad.zip": "fan",
}

# torchvision's pretrained VGG16 file: the LPIPS trunk (vgg.pth holds only
# the lin heads; ref losses/lpips.py:14-52 wraps torchvision's vgg16)
VGG16_TRUNK_FILE = "vgg16-397923af.pth"

SEED = 1234
PROBE_SIZES = ("full", "small", "tiny")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_vgg16_features_sd(ckpt_dir: str | None = None,
                           path: str | None = None) -> dict:
    """torchvision's VGG16 ``features`` state_dict (keys ``N.weight``), from
    ``path`` or ``{ckpt_dir}/vgg16-397923af.pth``. Takes the full-model file
    (keys ``features.N.*``, the torchvision download) or a bare ``features``
    state_dict."""
    candidates = [c for c in (path, ckpt_dir and os.path.join(
        ckpt_dir, VGG16_TRUNK_FILE)) if c]
    for c in candidates:
        if os.path.exists(c):
            raw = torch.load(c, map_location="cpu", weights_only=False)
            if hasattr(raw, "state_dict"):
                raw = raw.state_dict()
            return {k[len("features."):]: v for k, v in raw.items()
                    if k.startswith("features.")} or dict(raw)
    raise FileNotFoundError(
        f"VGG16 trunk weights not found (looked for {candidates}); LPIPS "
        f"needs torchvision's vgg16 features ({VGG16_TRUNK_FILE}) beside "
        f"the lin-head file vgg.pth")


def _convert_lpips_entry(sd: dict, ctx: dict) -> dict:
    from .utils import torch_port

    vgg = load_vgg16_features_sd(ctx.get("ckpt_dir"), ctx.get("vgg16_path"))
    return torch_port.convert_lpips(vgg, sd)


def _converter(kind: str):
    """Uniform-arity converter registry: every entry is ``fn(sd, ctx)`` and
    returns the port's ``state_dict``. One dispatch point for
    ``convert_all`` and the ``convert-checkpoint`` command."""
    from .utils import convert, torch_port

    if kind == "atom":
        return lambda sd, ctx: torch_port.convert_atom_decoder(sd)
    if kind == "vit-autoencoder":
        return lambda sd, ctx: torch_port.convert_vit_autoencoder(sd)
    if kind == "triplane-unet":
        return lambda sd, ctx: torch_port.convert_triplane_unet(sd)
    if kind == "lpips":
        return _convert_lpips_entry
    if kind == "i3d":
        # the port's InceptionI3d carries the reference's keys
        return lambda sd, ctx: {k: torch.as_tensor(np.asarray(v))
                                for k, v in sd.items()}
    if kind == "recon-resnet50":
        from .preprocess.recon_net import convert_recon_net

        return lambda sd, ctx: convert.convert_recon_params(
            convert_recon_net(sd))
    if kind == "s3fd":
        from .preprocess.s3fd import convert_s3fd

        return lambda sd, ctx: convert.convert_s3fd_params(convert_s3fd(sd))
    if kind == "fan":
        from .preprocess.fan import convert_fan

        return lambda sd, ctx: convert.convert_fan_params(convert_fan(sd))
    if kind == "hubert":
        from .preprocess.hubert import HubertConfig, convert_hubert

        return lambda sd, ctx: convert.convert_hubert_params(
            convert_hubert(sd, HubertConfig()))
    raise KeyError(f"no converter for kind {kind!r}")


def load_torch_state_dict(path: str, ema: bool = True) -> dict:
    """A reference checkpoint file → a flat ``{name: tensor}`` dict on the
    CPU: unwraps AToM's {ema_state_dict, model_state_dict, optimizer}
    container (AToM/AToM.py:188-192) and strips DDP's ``module.``."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "ema_state_dict" in raw:
        raw = raw["ema_state_dict" if ema else "model_state_dict"]
    return {k.replace("module.", ""): torch.as_tensor(
        v.detach() if hasattr(v, "detach") else np.asarray(v))
        for k, v in raw.items()}


def convert_all(ckpt_dir: str, out_dir: str) -> dict:
    """Convert every recognised checkpoint in ``ckpt_dir`` into
    ``out_dir/<stem>.pt``; returns {file name: path written}."""
    from .core.checkpoint import save_single

    os.makedirs(out_dir, exist_ok=True)
    done, missing = {}, []
    ctx = {"ckpt_dir": ckpt_dir}
    for fname, kind in CKPT_KINDS.items():
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            missing.append(fname)
            continue
        sd = load_torch_state_dict(path)
        try:
            state = _converter(kind)(sd, ctx)
        except FileNotFoundError as e:
            _log(f"skipped {fname} [{kind}]: {e}")
            continue
        out = os.path.join(out_dir, fname.split(".")[0] + ".pt")
        save_single(out, state)
        done[fname] = out
        _log(f"converted {fname} [{kind}] → {out}")
    for m in missing:
        _log(f"missing: {m} (skipped)")
    return done


def _load_or_init(params_dir: str | None, stem: str, init_fn):
    """(state_dict, True) from ``params_dir/<stem>.pt`` where present, else
    (the state_dict of ``init_fn()`` with weights drawn from SEED, False)."""
    if params_dir:
        path = os.path.join(params_dir, stem + ".pt")
        if os.path.exists(path):
            from .core.checkpoint import load_single

            return load_single(path), True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return init_fn().state_dict(), False


def probe_configs(size: str = "full"):
    """(AToM model config, AE config, UNet config) of the probes.
    ``full``: the shipped widths; ``tiny``: the JAX harness's self-test
    sizes; ``small``: full spatial sizes at small depth, so that every
    kernel gate on the MToV window passes as at full width."""
    from .config import AtomModelConfig, MtovAEConfig, MtovUNetConfig

    if size not in PROBE_SIZES:
        raise ValueError(f"probe size {size!r} not in {PROBE_SIZES}")
    if size == "tiny":
        ae = MtovAEConfig(channels=32, resolution=32, timesteps=4, depth=1,
                          heads=2, dim_head=8, quant_depth=1, quant_heads=2,
                          quant_mlp_dim=16)
        unet = MtovUNetConfig(model_channels=32, num_res_blocks=1,
                              channel_mult=(1, 2),
                              attention_resolutions=(1, 2), num_heads=2,
                              latent_res=ae.latent_res,
                              latent_t=ae.timesteps)
        return AtomModelConfig(horizon=16), ae, unet
    if size == "small":
        ae = MtovAEConfig(channels=64, depth=1, heads=2, dim_head=64,
                          quant_depth=1, quant_heads=2, quant_mlp_dim=64)
        # channel_mult (1, 2): the last upsample lands C = 256 at ds = 1, so
        # the joint attention there takes the one-pass gate, as at full width
        unet = MtovUNetConfig(num_res_blocks=1, channel_mult=(1, 2),
                              attention_resolutions=(1,))
        return AtomModelConfig(num_layers=2), ae, unet
    return AtomModelConfig(horizon=156), MtovAEConfig(), MtovUNetConfig()


def _draws(noise, device):
    """The samplers' ``generator``: a callable handing out ``noise``'s
    arrays in order, or draws from a CPU generator seeded with SEED."""
    if noise is not None:
        it = iter(noise)
        return lambda shape, dtype: torch.tensor(
            np.asarray(next(it), np.float32)).to(device, dtype)
    gen = torch.Generator().manual_seed(SEED)
    return lambda shape, dtype: torch.randn(shape, generator=gen).to(
        device, dtype)


@torch.inference_mode()
def run_probes(params_dir: str | None = None, tiny: bool = False, *,
               size: str | None = None, device=None,
               dtype=torch.float32, noise: dict | None = None) -> dict:
    """Fixed-seed probes through every model family → {name: ndarray}.

    ``size``: a ``probe_configs`` size (``tiny=True`` is ``size="tiny"``;
    the auxiliary FAN and S3FD probes run at ``full`` only). ``device``:
    the card unless the CPU is asked for. ``dtype``: the MToV models' (the
    AE and the UNet; AToM and the auxiliary nets run in float32).
    ``noise``: {"atom_sequence": [...], "mtov_window": [...]}, each sampler's
    draws in order; default: one CPU generator seeded with SEED."""
    from .config import AtomDiffusionConfig, MtovDiffusionConfig
    from .device import resolve_device
    from .models.atom import AtomDiffusion, MotionDecoder
    from .models.mtov import MtovDDPM, TriplaneUNet, ViTAutoencoder
    from .preprocess.recon_net import ReconNet

    size = size or ("tiny" if tiny else "full")
    dev = resolve_device(device)
    mc, ae_cfg, unet_cfg = probe_configs(size)
    rng = np.random.default_rng(SEED)
    shared = _draws(None, dev) if noise is None else None
    draws = lambda name: shared or _draws(noise[name], dev)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a, np.float32)).to(dev, dt)
    out: dict[str, np.ndarray] = {}

    def build(module, state):
        module.load_state_dict(state)
        return module.to(dev).eval()

    # ---- AToM: one DDIM-4 sequence (CFG at the configured weight)
    atom_state, real = _load_or_init(params_dir, "atom",
                                     lambda: MotionDecoder(mc))
    diff = AtomDiffusion.create(build(MotionDecoder(mc), atom_state),
                                AtomDiffusionConfig(sampling_steps=4), dev)
    face = rng.normal(size=(1, mc.horizon, 204))
    cond = rng.normal(size=(1, mc.horizon * 2, 1024))
    seq = diff.ddim_sample((1, mc.horizon, 204), t(face), t(cond),
                           draws("atom_sequence"))
    out["atom_sequence"] = seq.float().cpu().numpy()
    _log(f"atom probe ({'real' if real else 'random'} weights): "
         f"{tuple(seq.shape)}")

    # ---- MToV: one window (3 extracts → DDIM-4 → decode), and one extract
    L = ae_cfg.latent_len
    video = t(rng.uniform(-1, 1, (1, ae_cfg.timesteps, ae_cfg.resolution,
                                  ae_cfg.resolution, 3)), dtype)
    ae = lambda: ViTAutoencoder(ae_cfg)
    rgb_state, real_rgb = _load_or_init(params_dir, "autoencoder_rgb", ae)
    ldmk_state, _ = _load_or_init(params_dir, "autoencoder_motion", ae)
    unet_state, real_unet = _load_or_init(params_dir, "diffusion_model",
                                          lambda: TriplaneUNet(unet_cfg))
    ae_rgb = build(ViTAutoencoder(ae_cfg, dtype), rgb_state)
    ae_ldmk = build(ViTAutoencoder(ae_cfg, dtype), ldmk_state)
    ddpm = MtovDDPM.create(build(TriplaneUNet(unet_cfg, dtype), unet_state),
                           MtovDiffusionConfig(sampling_timesteps=4), dev)
    z_l = ae_ldmk.extract(video)
    masked_z = ae_rgb.extract(video)
    image_cond = ae_rgb.extract(video)
    lat = ddpm.ddim_sample((1, 4, L), torch.cat([z_l, masked_z], dim=1),
                           image_cond, generator=draws("mtov_window"))
    vid = ae_rgb.decode_from_sample(lat)
    out["mtov_window"] = vid.float().cpu().numpy()
    out["mtov_extract"] = ae_rgb.extract(video).float().cpu().numpy()
    _log(f"mtov probe ({'real' if real_rgb and real_unet else 'random'} "
         f"weights): {tuple(vid.shape)}")

    # ---- auxiliary nets: single forwards
    img224 = t(rng.uniform(0, 1, (1, 224, 224, 3)))
    recon_state, _ = _load_or_init(params_dir, "epoch_20", ReconNet)
    out["recon_coeff"] = build(ReconNet(), recon_state)(img224).cpu().numpy()
    if size == "full":
        from .preprocess.fan import FAN
        from .preprocess.s3fd import S3FD

        img256 = t(rng.uniform(0, 1, (1, 256, 256, 3)))
        fan_state, _ = _load_or_init(params_dir, "2DFAN4-cd938726ad",
                                     lambda: FAN(num_modules=4))
        out["fan_heatmaps"] = build(FAN(num_modules=4), fan_state)(
            img256)[-1].cpu().numpy()
        s3_state, _ = _load_or_init(params_dir, "s3fd-619a316812", S3FD)
        out["s3fd_conf_s4"] = build(S3FD(), s3_state)(img256)[0].cpu().numpy()
    return out


def record(out_path: str, params_dir: str | None, tiny: bool = False,
           **kw) -> dict:
    probes = run_probes(params_dir, tiny=tiny, **kw)
    np.savez_compressed(out_path, **probes)
    _log(f"goldens recorded: {out_path} ({sorted(probes)})")
    return probes


def compare_probes(probes: dict, gold, rtol: float = 1e-4,
                   atol: float = 1e-4) -> tuple[bool, dict]:
    """Probes against recorded goldens (an npz mapping or a dict): every
    golden present, of its shape, with max |err| ≤ atol + rtol·max |gold|."""
    names = gold.files if hasattr(gold, "files") else list(gold)
    ok, report = True, {}
    for name in names:
        if name not in probes:
            report[name] = "MISSING"
            ok = False
            continue
        a, b = probes[name], gold[name]
        if a.shape != b.shape:
            report[name] = f"SHAPE {a.shape} vs {b.shape}"
            ok = False
            continue
        err = float(np.abs(a - b).max())
        tol = atol + rtol * float(np.abs(b).max())
        report[name] = f"max_err={err:.3e} tol={tol:.3e}"
        if err > tol:
            ok = False
    return ok, report


def check(golden_path: str, params_dir: str | None, tiny: bool = False,
          rtol: float = 1e-4, atol: float = 1e-4, **kw) -> bool:
    """Re-run the probes, print one JSON line {ok, probes}, return ok."""
    probes = run_probes(params_dir, tiny=tiny, **kw)
    with np.load(golden_path) as gold:
        ok, report = compare_probes(probes, gold, rtol, atol)
    print(json.dumps({"ok": ok, "probes": report}), flush=True)
    return ok
