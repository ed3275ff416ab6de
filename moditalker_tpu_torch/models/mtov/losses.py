"""MToV first-stage losses: LPIPS, PatchGAN discriminators, GAN objectives
(port of ``moditalker_tpu/models/mtov/losses.py``; ref
MToV/losses/perceptual.py and losses/lpips.py).

* LPIPS = VGG16 features at relu{1_2,2_2,3_3,4_3,5_3}, channel-normalised,
  squared difference, 1×1 ``lin`` heads (their absolute value), spatial
  mean. The heads keep the JAX package's [C, 1] layout.
* 2D and 3D PatchGANs (ndf 64, 3 layers, BatchNorm, LeakyReLU 0.2) with
  their intermediate feature taps for the feature-matching L1. Their
  BatchNorms always normalise with the batch's statistics and keep no
  running averages (``track_running_stats=False``): the reference never
  leaves train mode for the discriminators, and the JAX package discards
  the running averages it computes.

Videos at the module boundary are [B, T, H, W, 3] and frames [B, H, W, 3],
channels last, in [-1, 1], as in the JAX package; the modules permute to
NCHW / NCDHW inside. Float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
# conv counts after which LPIPS taps the features
_SLICE_ENDS = (2, 4, 7, 10, 13)

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning the five LPIPS tap activations (NCHW)."""

    def __init__(self):
        super().__init__()
        c_in, i = 3, 0
        for v in _VGG16_CFG:
            if v != "M":
                self.add_module(f"conv_{i}", nn.Conv2d(c_in, v, 3, padding=1))
                c_in, i = v, i + 1

    def forward(self, x):
        taps, i = [], 0
        for v in _VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv_{i}")(x))
            i += 1
            if i in _SLICE_ENDS:
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual metric (ref losses/lpips.py:55-98): frames
    [B, H, W, 3] → [B]."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, c in enumerate((64, 128, 256, 512, 512)):
            self.register_parameter(f"lin_{k}",
                                    nn.Parameter(torch.ones(c, 1)))
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, y):
        def scale_in(t):
            return (t.permute(0, 3, 1, 2) - self.shift) / self.scale

        def normalize(t):
            return t / (t.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)

        val = 0.0
        for k, (a, b) in enumerate(zip(self.net(scale_in(x)),
                                       self.net(scale_in(y)))):
            diff = (normalize(a) - normalize(b)).square()
            w = getattr(self, f"lin_{k}").abs()[:, 0]
            contrib = torch.einsum("bchw,c->bhw", diff, w)
            val = val + contrib.mean(dim=(1, 2))
        return val


class _PatchDiscriminator(nn.Module):
    """Pix2pix PatchGAN with intermediate feature taps; ``conv`` and ``bn``
    are the 2D or 3D layer classes. Flax's ``padding=2`` on a 4-wide kernel
    is symmetric, as torch's is."""

    def __init__(self, conv, bn, in_channels: int, ndf: int, n_layers: int):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = conv(in_channels, ndf, 4, stride=2, padding=2)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"conv_{n}", conv(prev, nf, 4, stride=2, padding=2))
            self.add_module(f"bn_{n}", bn(nf, track_running_stats=False))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"conv_{n_layers}", conv(prev, nf, 4, stride=1,
                                                 padding=2))
        self.add_module(f"bn_{n_layers}", bn(nf, track_running_stats=False))
        self.conv_out = conv(nf, 1, 4, stride=1, padding=2)

    def trunk(self, h):
        """h channels first → (logits, [taps..., logits]), channels first."""
        h = F.leaky_relu(self.conv_0(h), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"bn_{n}")(getattr(self, f"conv_{n}")(h))
            h = F.leaky_relu(h, 0.2)
            feats.append(h)
        logits = self.conv_out(h)
        feats.append(logits)
        return logits, feats


class PatchDiscriminator2D(_PatchDiscriminator):
    """ref perceptual.py:158-205. Frames [B, H, W, C] → (logits, feats),
    both channels last as in the JAX package."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__(nn.Conv2d, nn.BatchNorm2d, in_channels, ndf,
                         n_layers)

    def forward(self, x):
        logits, feats = self.trunk(x.permute(0, 3, 1, 2))
        last = lambda t: t.permute(0, 2, 3, 1)
        return last(logits), [last(f) for f in feats]


class PatchDiscriminator3D(_PatchDiscriminator):
    """Conv3D PatchGAN (ref perceptual.py:208-251). Videos [B, T, H, W, C]
    → (logits, feats), both channels last as in the JAX package."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3):
        super().__init__(nn.Conv3d, nn.BatchNorm3d, in_channels, ndf,
                         n_layers)

    def forward(self, x):
        logits, feats = self.trunk(x.permute(0, 4, 1, 2, 3))
        last = lambda t: t.permute(0, 2, 3, 4, 1)
        return last(logits), [last(f) for f in feats]


def hinge_d_loss(logits_real, logits_fake):
    """ref perceptual.py:25-29"""
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def select_random_frame(video, frame_idx):
    """video [B, T, H, W, C], frame_idx int [B] → [B, H, W, C]
    (ref perceptual.py:103-106)."""
    return video[torch.arange(video.shape[0], device=video.device),
                 frame_idx.to(video.device)]


def adopt_weight(global_step: int, threshold: int, value: float = 0.0) -> float:
    return value if global_step < threshold else 1.0
