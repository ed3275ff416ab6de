"""Layers with flax's ``dtype`` semantics.

Parameters are stored in float32; each Dense/Conv casts its input and
parameters to the compute dtype (bf16 on the card) and computes there, as a
flax module built with ``dtype=`` does. Normalisation statistics run in
float32 and the result is cast to the compute dtype. In float32 every layer
computes exactly what the torch layer it extends computes (a cast to the
type a tensor has is the tensor itself).

flax rounds a bf16 Conv or Dense twice, the product and then the sum with
the bf16 bias; these layers add the bias inside the product and round once.
The difference is one bf16 rounding of the output, below what bf16 costs
the preprocessing nets already (``tests/test_torch_bf16_preprocess.py``).
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


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` on NCHW with torch's arguments (stride, padding,
    bias), computing in the compute dtype as ``Dense`` does: flax
    ``nn.Conv(dtype=...)`` with an explicit padding."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(CastConv2d):
    """flax ``nn.Conv`` on NCHW tensors: weight OIHW (flax's kernel is
    HWIO), 'same' zero padding for odd kernels."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel,
                         padding=kernel // 2, dtype=dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6 (flax's default), statistics in
    float32, output in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` over one axis on channels-last [B, T, C] (flax's
    layout), with torch's ``Conv1d`` arguments and weight [O, I/groups, k];
    the compute dtype as ``Dense``'s.

    On the CPU a grouped bf16 convolution bypasses oneDNN: its bf16 grouped
    kernel returns wrong values at 8 channels a group and kernels of 8 or
    more (max error 2.8–4.6 on outputs of 2.5–4 in torch 2.13, an AVX-512 /
    AMX host; HuBERT-large's 64 a group reads right); torch's own kernel
    rounds the float32 sum once, as the card does."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x = x.transpose(1, 2).to(dt)
        if x.device.type == "cpu" and dt == torch.bfloat16 and self.groups > 1:
            with torch.backends.mkldnn.flags(enabled=False):
                y = self._conv_forward(x, self.weight.to(dt), bias)
        else:
            y = self._conv_forward(x, self.weight.to(dt), bias)
        return y.transpose(1, 2)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(use_running_average=True)`` on NCHW, inference
    only: the input widened to float32 and normalised with the float32
    running statistics, scale and bias. ``dtype`` is the output's, as flax
    gives it two ways: a BatchNorm built without ``dtype`` promotes a bf16
    input against its float32 parameters and writes float32 (FAN's); one
    built with ``dtype`` writes that type (ReconNet's)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=eps)
        self.out_dtype = dtype

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(self.out_dtype)
