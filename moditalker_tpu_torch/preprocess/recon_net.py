"""Deep3DFaceRecon coefficient regressor: ResNet-50 → 257 coefficients (port
of ``moditalker_tpu/preprocess/recon_net.py``).

The inference path of ``deep_3drecon/deep_3drecon_models/networks.py:70-106``
(ReconNetWrapper, ``use_last_fc=False``): a torchvision-layout ResNet-50
trunk, average-pooled to 2048 features, and seven zero-initialised heads —
id (80), exp (64), tex (80), angle (3), gamma (27), tx/ty (2), tz (1) —
concatenated to 257. Input: channels-last [B, 224, 224, 3] RGB in 0..1 (the
BFM-aligned crop). Module names follow the flax tree, BatchNorm statistics
included (``utils/convert.py::convert_recon_params``); ``convert_recon_net``
takes the reference's ``epoch_20.pth`` to that tree. Eval mode only.

``dtype`` (default float32), as the JAX package's: with bf16 the trunk
computes in bf16 and its BatchNorms (built with ``dtype`` in the JAX
package) write bf16 from float32 statistics; the max-pool pads with −inf in
bf16; the global mean reduces in float32 and writes bf16, as ``jnp.mean``
on bf16 does; the trunk's output is cast to float32 before the seven
float32 heads. The parameters stay float32, so one state_dict serves both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm2d, CastConv2d

COEFF_SPLITS = (80, 64, 80, 3, 27, 2, 1)


def _bn(ch: int, dtype: torch.dtype) -> BatchNorm2d:
    """Eval mode, eps 1e-5, written in the trunk's dtype."""
    return BatchNorm2d(ch, eps=1e-5, dtype=dtype)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride sits here) → 1×1 ×4, with a strided 1×1
    projection on the first block of a stage."""

    def __init__(self, in_planes: int, features: int, strides: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.conv1 = CastConv2d(in_planes, features, 1, bias=False, dtype=d)
        self.bn1 = _bn(features, d)
        self.conv2 = CastConv2d(features, features, 3, stride=strides,
                                padding=1, bias=False, dtype=d)
        self.bn2 = _bn(features, d)
        self.conv3 = CastConv2d(features, features * 4, 1, bias=False,
                                dtype=d)
        self.bn3 = _bn(features * 4, d)
        self.downsample = downsample
        if downsample:
            self.ds_conv = CastConv2d(in_planes, features * 4, 1,
                                      stride=strides, bias=False, dtype=d)
            self.ds_bn = _bn(features * 4, d)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(y + residual)


_STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]


class ResNet50Trunk(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                dtype=dtype)
        self.bn1 = _bn(64, dtype)
        in_planes = 64
        for li, (blocks, feats, stride) in enumerate(_STAGES):
            for bi in range(blocks):
                self.add_module(f"layer{li + 1}_{bi}", Bottleneck(
                    in_planes, feats, stride if bi == 0 else 1, bi == 0,
                    dtype))
                in_planes = feats * 4

    def forward(self, x):  # [B, 3, H, W] → [B, 2048] in the trunk's dtype
        x = F.relu(self.bn1(self.conv1(x)))
        # the JAX package pads with −inf and max-pools VALID: the same as
        # torch's implicit −inf padding of MaxPool2d(3, 2, padding=1)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li, (blocks, _, _) in enumerate(_STAGES):
            for bi in range(blocks):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
        return x.float().mean(dim=(2, 3)).to(x.dtype)


class ReconNet(nn.Module):
    """ResNet-50 + seven coefficient heads → [B, 257] float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNet50Trunk(dtype)
        for i, dim in enumerate(COEFF_SPLITS):
            head = nn.Linear(2048, dim)   # zero-initialised, as the ref's
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
            self.add_module(f"head_{i}", head)

    def forward(self, x):  # [B, 224, 224, 3] 0..1 RGB
        h = self.backbone(x.permute(0, 3, 1, 2)).float()
        return torch.cat([getattr(self, f"head_{i}")(h)
                          for i in range(len(COEFF_SPLITS))], dim=-1)


def convert_recon_net(sd: dict) -> dict:
    """The reference's ReconNetWrapper state_dict → the JAX package's flax
    variables (``params`` and ``batch_stats``;
    ``utils/convert.py::convert_recon_params`` then gives the port's
    state_dict). The 1×1 conv heads become dense kernels."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    params: dict = {"backbone": {}}
    stats: dict = {"backbone": {}}

    def conv(name):
        w = sd[f"{name}.weight"]
        return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}

    def bn(name):
        return ({"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]},
                {"mean": sd[f"{name}.running_mean"],
                 "var": sd[f"{name}.running_var"]})

    bb = "backbone"
    params[bb]["conv1"] = conv(f"{bb}.conv1")
    params[bb]["bn1"], stats[bb]["bn1"] = bn(f"{bb}.bn1")
    for li, (blocks, _, _) in enumerate(_STAGES):
        for bi in range(blocks):
            p, s = {}, {}
            pre = f"{bb}.layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                p[f"conv{ci}"] = conv(f"{pre}.conv{ci}")
                p[f"bn{ci}"], s[f"bn{ci}"] = bn(f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                p["ds_conv"] = conv(f"{pre}.downsample.0")
                p["ds_bn"], s["ds_bn"] = bn(f"{pre}.downsample.1")
            params[bb][f"layer{li + 1}_{bi}"] = p
            stats[bb][f"layer{li + 1}_{bi}"] = s
    for i in range(len(COEFF_SPLITS)):
        w = sd[f"final_layers.{i}.weight"][:, :, 0, 0]  # [O, I]
        params[f"head_{i}"] = {"kernel": np.ascontiguousarray(w.T),
                               "bias": sd[f"final_layers.{i}.bias"]}
    return {"params": params, "batch_stats": stats}
