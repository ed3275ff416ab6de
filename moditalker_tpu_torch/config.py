"""MToV configuration for the PyTorch port.

A copy of the MToV dataclasses of ``moditalker_tpu/config.py`` with the same
defaults (the shipped 256² / 16-frame operating point): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


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
