"""Configuration for the PyTorch port.

A copy of the AToM and MToV dataclasses of ``moditalker_tpu/config.py``
(sampling, the AToM, first-stage and latent-diffusion trainers) with the
same defaults (the published operating points), and of its YAML layer: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class AtomModelConfig:
    """MotionDecoder (ref AToM/AToM.py:58-68, AToM/model/model.py:242-383)."""

    repr_dim: int = 204          # 68 landmarks x 3
    horizon: int = 156           # frames @25fps (~6.24 s)
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 8
    dropout: float = 0.1
    cond_feature_dim: int = 1024  # HuBERT-large
    # landmark stream split: lower-face(17)+lip(20)=37 pts vs upper-face 31 pts
    lip_dim: int = 37 * 3
    upper_dim: int = 31 * 3


@dataclasses.dataclass(frozen=True)
class AtomDiffusionConfig:
    """ref AToM/AToM.py:70-81"""

    n_timesteps: int = 1000
    schedule: str = "cosine"
    predict_epsilon: bool = False  # x0 parameterization
    loss_type: str = "l2"
    cond_drop_prob: float = 0.25
    guidance_weight: float = 2.0
    sampling_steps: int = 50       # DDIM (ref diffusion.py:217)
    ddim_eta: float = 1.0
    clip_denoised: bool = True
    recon_loss_weight: float = 7.5
    velocity_loss_weight: float = 1.5
    use_p2: bool = False


@dataclasses.dataclass(frozen=True)
class AtomTrainConfig:
    """ref AToM/args.py, AToM/scripts/train.sh"""

    batch_size: int = 64
    epochs: int = 2000
    learning_rate: float = 4e-4
    weight_decay: float = 0.02
    ema_decay: float = 0.9999
    ema_interval: int = 1
    save_interval: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MtovAEConfig:
    """ViT triplane autoencoder (ref configs/autoencoder/base.yaml +
    autoencoder_vit.py:89-148)."""

    channels: int = 384           # transformer width
    resolution: int = 256
    timesteps: int = 16           # frames per clip
    splits: int = 1
    embed_dim: int = 4            # latent channels per plane
    depth: int = 8
    heads: int = 8
    dim_head: int = 64
    quant_depth: int = 4
    quant_heads: int = 4
    quant_mlp_dim: int = 512
    down: int = 3                 # latent spatial = resolution / 2^down

    @property
    def patch_size(self) -> int:
        return 4 if self.resolution == 128 else 8

    @property
    def latent_res(self) -> int:
        return self.resolution // (2**self.down)

    @property
    def latent_len(self) -> int:
        # xy(32*32) + yt(16*32) + xt(16*32) = 2048 at 256^2/16f
        r, s = self.latent_res, self.timesteps // self.splits
        return r * r + 2 * s * r


@dataclasses.dataclass(frozen=True)
class MtovUNetConfig:
    """Triplane UNet (ref configs/latent-diffusion/base.yaml unet_config)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 128     # 256 in base_longvid.yaml
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    dropout: float = 0.0
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    cond_channels: int = 8        # motion latent + masked-video latent
    image_cond_channels: int = 4  # reference-frame latent (xy plane only)
    latent_res: int = 32
    latent_t: int = 16


@dataclasses.dataclass(frozen=True)
class MtovDiffusionConfig:
    """ref configs/latent-diffusion/base.yaml model.params + ddpm.py:119-193"""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    cosine_s: float = 8e-3
    parameterization: str = "eps"
    loss_type: str = "l2"   # ctor default; cfg says l1 but is never plumbed
                            # (ddpm.py:126 vs exps/diffusion.py:148-156)
    sampling_timesteps: int = 100
    ddim_eta: float = 1.0
    w: float = 0.0
    clip_denoised: bool = True
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    v_posterior: float = 0.0


@dataclasses.dataclass(frozen=True)
class MtovLossConfig:
    """AE loss weights (ref losses/perceptual.py:65-98)."""

    disc_start: int = 100000000
    pixelloss_weight: float = 4.0
    perceptual_weight: float = 4.0
    disc_weight: float = 1.0
    gan_feat_weight: float = 4.0
    disc_in_channels: int = 3
    disc_layers: int = 3
    disc_ndf: int = 64


@dataclasses.dataclass(frozen=True)
class MtovTrainConfig:
    batch_size: int = 1           # first stage (scripts/train/first_stg.sh)
    diffusion_batch_size: int = 10
    accum_iter: int = 3
    lr: float = 1e-4
    ae_betas: tuple[float, float] = (0.5, 0.9)
    ema_interval: int = 25
    warmup_steps: int = 10000
    seed: int = 42
    resume: bool = False          # ref configs/autoencoder/base_gan.yaml


@dataclasses.dataclass(frozen=True)
class Config:
    """The sections the port's entry points read."""

    atom_model: AtomModelConfig = AtomModelConfig()
    atom_diffusion: AtomDiffusionConfig = AtomDiffusionConfig()
    atom_train: AtomTrainConfig = AtomTrainConfig()
    mtov_ae: MtovAEConfig = MtovAEConfig()
    mtov_unet: MtovUNetConfig = MtovUNetConfig()
    mtov_diffusion: MtovDiffusionConfig = MtovDiffusionConfig()
    mtov_loss: MtovLossConfig = MtovLossConfig()
    mtov_train: MtovTrainConfig = MtovTrainConfig()


# --------------------------------------------------------------- YAML layer
#
# Two accepted file formats, as in the JAX package:
#   native    — top-level keys are Config field names, values are field
#               override dicts (configs/*.yaml);
#   reference — the upstream OmegaConf layout (``model: {params: ...}``,
#               MToV/configs/**.yaml).


def _overlay(dc, updates: dict):
    """dataclasses.replace with list → tuple coercion and typo detection."""
    names = {f.name for f in dataclasses.fields(dc)}
    kw = {}
    for k, v in updates.items():
        if k not in names:
            raise KeyError(f"unknown config field {type(dc).__name__}.{k}")
        kw[k] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(dc, **kw)


def config_from_dict(data: dict, base: Config | None = None) -> Config:
    """Native-format dict → Config (unknown sections/fields raise)."""
    cfg = base or Config()
    sections = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for key, updates in data.items():
        if key not in sections:
            raise KeyError(f"unknown config section {key!r}; expected one of "
                           f"{sorted(sections)}")
        kw[key] = _overlay(getattr(cfg, key), dict(updates or {}))
    return dataclasses.replace(cfg, **kw)


def config_from_reference_dict(data: dict,
                               base: Config | None = None) -> Config:
    """Upstream MToV YAML layout → Config: autoencoder files
    (``model.params.ddconfig``) map onto ``mtov_ae`` / ``mtov_loss``,
    latent-diffusion files (``model.params.unet_config``) onto ``mtov_unet``
    / ``mtov_diffusion``, the learning rate, ``resume`` and the warm-up onto
    ``mtov_train``. ``loss_type`` in the LDM yaml is ignored, as the
    reference never plumbs it into the DDPM constructor."""
    cfg = base or Config()
    model = data.get("model", {})
    params = model.get("params", {})
    train_kw = {}
    if "base_learning_rate" in model:
        train_kw["lr"] = float(model["base_learning_rate"])
    if "resume" in model:
        train_kw["resume"] = bool(model["resume"])
    if "ddconfig" in params:
        dd = params["ddconfig"]
        ae_kw = {k: dd[k] for k in
                 ("channels", "resolution", "timesteps", "splits") if k in dd}
        if "embed_dim" in params:
            ae_kw["embed_dim"] = params["embed_dim"]
        loss_kw = dict(params.get("lossconfig", {}).get("params", {}))
        cfg = dataclasses.replace(cfg, mtov_ae=_overlay(cfg.mtov_ae, ae_kw),
                                  mtov_loss=_overlay(cfg.mtov_loss, loss_kw))
    if "unet_config" in params:
        uc = params["unet_config"]
        unet_kw = {k: uc[k] for k in
                   ("in_channels", "out_channels", "model_channels",
                    "num_res_blocks", "attention_resolutions",
                    "channel_mult", "num_heads", "use_scale_shift_norm",
                    "resblock_updown") if k in uc}
        diff_kw = {k: params[k] for k in
                   ("linear_start", "linear_end", "timesteps", "w")
                   if k in params}
        sched = params.get("scheduler_config", {})
        if sched.get("warm_up_steps"):
            train_kw["warmup_steps"] = int(sched["warm_up_steps"][0])
        cfg = dataclasses.replace(
            cfg, mtov_unet=_overlay(cfg.mtov_unet, unet_kw),
            mtov_diffusion=_overlay(cfg.mtov_diffusion, diff_kw))
    if train_kw:
        cfg = dataclasses.replace(
            cfg, mtov_train=_overlay(cfg.mtov_train, train_kw))
    return cfg


def load_config(path: str, base: Config | None = None) -> Config:
    """Load a YAML config file in either accepted format."""
    import yaml  # lazy: only --config needs it

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if isinstance(data.get("model"), dict):
        return config_from_reference_dict(data, base)
    return config_from_dict(data, base)
