"""InceptionI3D (Kinetics-400) feature network for FVD (port of
``moditalker_tpu/evals/i3d.py``; ref MToV/evals/fvd/pytorch_i3d.py).

Unit3D = TF-SAME-padded Conv3D + BatchNorm + ReLU, nine Inception mixed
blocks, a [2, 7, 7] average pool, 400-class logits averaged over time. The
modules are named as the reference's ``state_dict`` keys
(``Mixed_3b.b1a.conv3d.weight``, ``logits.conv3d.bias``, …), so a reference
``i3d_pretrained_400.pt`` loads with ``load_state_dict``.

Inference only: the BatchNorms read their running statistics (epsilon 1e-5)
and the max pools pad with −inf, as the JAX package does. Input is
channels-last [B, T, H, W, 3] in [-1, 1] at 224².
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME padding (ref pytorch_i3d.py:71-97)."""
    pad = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kernel, stride, value: float = 0.0):
    """x [B, C, T, H, W] padded for a TF-SAME window."""
    pads = []
    for d in (2, 1, 0):   # F.pad runs from the last axis
        pads += _same_pad(x.shape[2 + d], kernel[d], stride[d])
    return F.pad(x, pads, value=value)


class Unit3D(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, relu: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.relu = kernel, stride, relu
        self.conv3d = nn.Conv3d(in_channels, features, kernel, stride,
                                bias=use_bias)
        self.bn = nn.BatchNorm3d(features, eps=1e-5) if use_bn else None

    def forward(self, x):
        x = self.conv3d(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


def _max_pool_same(x, kernel, stride):
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), kernel,
                        stride)


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, oc: tuple[int, ...]):
        super().__init__()   # oc: (b0, b1a, b1b, b2a, b2b, b3b)
        self.b0 = Unit3D(in_channels, oc[0])
        self.b1a = Unit3D(in_channels, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, oc[5])
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


class InceptionI3d(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, oc in _MIXED.items():
            block = InceptionModule(c, oc)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = Unit3D(c, num_classes, use_bn=False, relu=False,
                             use_bias=True)

    def forward(self, x):
        """x: [B, T, H, W, 3] → logits [B, num_classes]."""
        x = self.Conv3d_1a_7x7(x.permute(0, 4, 1, 2, 3))
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = _max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        x = self.logits(x)            # [B, C, T', 1, 1]
        return x.squeeze(4).squeeze(3).mean(dim=2)


def load_i3d(path: str, device) -> InceptionI3d:
    """An ``InceptionI3d`` in eval mode on ``device`` from a ``state_dict``
    file: the port's (``torch.save``) or the reference's
    ``i3d_pretrained_400.pt``, which share their keys."""
    model = InceptionI3d()
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return model.to(device).eval()


def i3d_apply(model: InceptionI3d):
    """``apply(videos)``: float32 [N, T, 224, 224, 3] in [-1, 1] (numpy or a
    tensor) → logits [N, 400] as numpy, run on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def apply(videos):
        x = torch.as_tensor(np.asarray(videos, np.float32)).to(device)
        return model(x).cpu().numpy()

    return apply
