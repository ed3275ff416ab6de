"""TimeSformer encoder/decoder with divided space-time attention (port of
``moditalker_tpu/models/mtov/timesformer.py``, ref
MToV/models/autoencoder/vit_modules.py:164-303).

Tokens live as [B, F, N, D]. Each attention projects a bias-free packed
q|k|v and hands it to ``divided_attention``, which runs the hand-written
space/time kernels on the card (rotary applied inside them).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import rotary
from ...ops.kernels.divided_attention import divided_attention
from ..layers import Dense, LayerNorm


@functools.lru_cache(maxsize=None)
def _tables(kind: str, shape: tuple, device: torch.device):
    """float32 (sin, cos) rotary tables on ``device``, built once. Built as
    normal tensors even where the first call runs under
    ``torch.inference_mode`` (sampling): a later training step in the same
    process saves them for its backward, which inference tensors refuse."""
    fn = rotary.time_rotary_sincos if kind == "time" else rotary.axial_rotary_sincos
    sin, cos = fn(*shape)
    with torch.inference_mode(False):
        return (torch.from_numpy(sin).to(device),
                torch.from_numpy(cos).to(device))


class GEGLUFeedForward(nn.Module):
    """Linear(d→8d) → GEGLU (exact-erf GELU) → Linear(4d→d)
    (ref vit_modules.py:89-105)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, dim * mult * 2, dtype=dtype)
        self.fc2 = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        h, gate = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(h * F.gelu(gate))


class DividedAttention(nn.Module):
    """One attention over a chosen axis of [B, F, N, D] tokens
    (ref vit_modules.py:120-160): 'time' attends over F per patch, 'space'
    over N per frame."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x, axis: str, sin, cos):
        qkv = self.to_qkv(x)
        out = divided_attention(qkv, sin, cos, axis, self.heads,
                                self.dim_head, self.dim_head**-0.5)
        return self.to_out(out)


class TimeSformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.time_norm = LayerNorm(dim, dtype)
        self.time_attn = DividedAttention(dim, heads, dim_head, dtype)
        self.space_norm = LayerNorm(dim, dtype)
        self.space_attn = DividedAttention(dim, heads, dim_head, dtype)
        self.ff_norm = LayerNorm(dim, dtype)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x, frame_sincos, image_sincos):
        x = x + self.time_attn(self.time_norm(x), "time", *frame_sincos)
        x = x + self.space_attn(self.space_norm(x), "space", *image_sincos)
        return x + self.ff(self.ff_norm(x))


class _Trunk(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, dtype):
        super().__init__()
        self.dim_head = dim_head
        self.blocks = nn.ModuleList(
            TimeSformerBlock(dim, heads, dim_head, dtype) for _ in range(depth))

    def trunk(self, x, f: int, hp: int, wp: int):
        frame_sincos = _tables("time", (f, self.dim_head), x.device)
        image_sincos = _tables("axial", (hp, wp, self.dim_head), x.device)
        for block in self.blocks:
            x = block(x, frame_sincos, image_sincos)
        return x


class TimeSformerEncoder(_Trunk):
    """Patchify + depth×(time-attn, space-attn, GEGLU FF)
    (ref vit_modules.py:164-236). Input [B, F, H, W, 3] → [B, F, N, D]."""

    def __init__(self, dim: int = 384, patch_size: int = 8, depth: int = 8,
                 heads: int = 8, dim_head: int = 64, dtype=torch.float32):
        super().__init__(dim, depth, heads, dim_head, dtype)
        self.patch_size = patch_size
        self.to_patch_embedding = Dense(patch_size * patch_size * 3, dim,
                                        dtype=dtype)

    def forward(self, video):
        b, f, h, w, c = video.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        # 'b f (h p1) (w p2) c -> b f (h w) (p1 p2 c)'
        x = video.reshape(b, f, hp, p, wp, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.to_patch_embedding(x.reshape(b, f, hp * wp, p * p * c))
        return self.trunk(x, f, hp, wp)


class TimeSformerDecoder(_Trunk):
    """Same trunk, no patchify (ref vit_modules.py:238-303).
    Input [B, F, HP, WP, D] → [B, F, HP*WP, D]."""

    def __init__(self, dim: int = 384, depth: int = 8, heads: int = 8,
                 dim_head: int = 64, dtype=torch.float32):
        super().__init__(dim, depth, heads, dim_head, dtype)

    def forward(self, z):
        b, f, hp, wp, d = z.shape
        return self.trunk(z.reshape(b, f, hp * wp, d), f, hp, wp)
