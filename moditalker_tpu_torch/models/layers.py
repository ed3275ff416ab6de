"""Layers with flax's ``dtype`` semantics.

Parameters are stored in float32; each Dense/Conv casts its input and
parameters to the compute dtype (bf16 on the card) and computes there, as a
flax module built with ``dtype=`` does. Normalisation statistics run in
float32 and the result is cast to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """flax ``nn.Dense``: weight [out, in] (the transpose of flax's kernel)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW tensors: weight OIHW (flax's kernel is
    HWIO), 'same' zero padding for odd kernels."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics in float32, output in
    the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)
