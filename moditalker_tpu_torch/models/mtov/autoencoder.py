"""ViT triplane video autoencoder (port of
``moditalker_tpu/models/mtov/autoencoder.py``, ref
MToV/models/autoencoder/autoencoder_vit.py:89-276).

Video tensors are [B, T, H, W, 3] in [-1, 1]; latents keep the reference's
byte-compatible ``[B, e, r·r + 2·s·r]`` packing, xy (h-major) | yt (t-major
over w) | xt (t-major over h).

Reference quirks reproduced on purpose (trained-in semantics): each plane
pool appends its learnable token at the END of the sequence but reads the
output at position 0 (autoencoder_vit.py:160-162); positional embeddings are
added to the token-augmented sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import MtovAEConfig
from ...ops.attention import merge_heads, sdpa, split_heads
from ..layers import Dense, LayerNorm
from .timesformer import TimeSformerDecoder, TimeSformerEncoder


class QuantLayer(nn.Module):
    """PreNorm attention + PreNorm GELU MLP (one depth step of the pool)."""

    def __init__(self, dim, heads, dim_head, mlp_dim, dtype):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.attn_norm = LayerNorm(dim, dtype)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)
        self.ff_norm = LayerNorm(dim, dtype)
        self.ff1 = Dense(dim, mlp_dim, dtype=dtype)
        self.ff2 = Dense(mlp_dim, dim, dtype=dtype)

    def forward(self, x):
        q, k, v = self.to_qkv(self.attn_norm(x)).chunk(3, dim=-1)
        out = sdpa(split_heads(q, self.heads), split_heads(k, self.heads),
                   split_heads(v, self.heads), scale=self.dim_head**-0.5)
        x = x + self.to_out(merge_heads(out))
        return x + self.ff2(F.gelu(self.ff1(self.ff_norm(x))))


class QuantAttention(nn.Module):
    """depth×(PreNorm attn + PreNorm FF) pooling transformer
    (ref autoencoder_vit.py:35-83): heads=4, dim_head=dim//8, mlp 512."""

    def __init__(self, dim: int, depth: int = 4, heads: int = 4,
                 dim_head: int = 48, mlp_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            QuantLayer(dim, heads, dim_head, mlp_dim, dtype)
            for _ in range(depth))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PatchToPixel(nn.Module):
    """ConvTranspose2d(C, features, p, stride p) as one matmul per token plus
    depth-to-space (stride == kernel, so the taps never overlap). The weight
    keeps the reference ConvTranspose2d layout [C, features, p, p]."""

    def __init__(self, channels: int, features: int, patch: int,
                 dtype=torch.float32):
        super().__init__()
        self.patch, self.features = patch, features
        self.weight = nn.Parameter(
            torch.randn(channels, features, patch, patch) * channels**-0.5)
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = dtype

    def forward(self, x):  # [B, HP, WP, C] → [B, HP*p, WP*p, features]
        p, o, dt = self.patch, self.features, self.compute_dtype
        c = x.shape[-1]
        k2 = self.weight.to(dt).permute(0, 2, 3, 1).reshape(c, p * p * o)
        y = x.to(dt) @ k2
        b, hp, wp, _ = y.shape
        y = y.reshape(b, hp, wp, p, p, o).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, hp * p, wp * p, o) + self.bias.to(dt)


class ViTAutoencoder(nn.Module):
    """Triplane video AE. All video tensors are [B, T, H, W, 3] in [-1, 1]."""

    def __init__(self, cfg: MtovAEConfig = MtovAEConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c, dim = cfg, cfg.channels
        self.encoder = TimeSformerEncoder(
            dim=dim, patch_size=c.patch_size, depth=c.depth, heads=c.heads,
            dim_head=c.dim_head, dtype=dtype)
        self.decoder = TimeSformerDecoder(
            dim=dim, depth=c.depth, heads=c.heads, dim_head=c.dim_head,
            dtype=dtype)
        self.to_pixel = PatchToPixel(dim, 3, c.patch_size, dtype)
        s, r = c.timesteps // c.splits, c.latent_res
        for plane, n in (("xy", s), ("yt", r), ("xt", r)):
            self.register_parameter(f"{plane}_token",
                                    nn.Parameter(torch.randn(1, 1, dim)))
            self.register_parameter(f"{plane}_pos_embedding",
                                    nn.Parameter(torch.randn(1, n + 1, dim)))
            self.add_module(f"{plane}_quant_attn", QuantAttention(
                dim, c.quant_depth, c.quant_heads, dim // 8, c.quant_mlp_dim,
                dtype))
            # 1×1 plane convs == Dense over the channel axis
            self.add_module(f"pre_{plane}", Dense(dim, c.embed_dim, dtype=dtype))
            self.add_module(f"post_{plane}", Dense(c.embed_dim, dim, dtype=dtype))

    # ------------------------------------------------------------ planes
    def _pool(self, tokens, plane: str):
        # tokens [M, L, C]; append the token at the END, read position 0
        m, l, ch = tokens.shape
        token = getattr(self, f"{plane}_token").to(tokens.dtype)
        t = torch.cat([tokens, token.expand(m, 1, ch)], dim=1)
        t = t + getattr(self, f"{plane}_pos_embedding")[:, : l + 1].to(tokens.dtype)
        return getattr(self, f"{plane}_quant_attn")(t)[:, 0]

    def _pool_planes(self, x):
        """Encoder trunk + 3 plane poolings → tanh'd plane latents:
        xy [B,r,r,e], yt [B,s,r,e], xt [B,s,r,e] (ref :150-187)."""
        c = self.cfg
        b = x.shape[0]
        s, r, ch = c.timesteps // c.splits, c.latent_res, c.channels
        h = self.encoder(x).reshape(b, s, r, r, ch)   # [B, t, h, w, C]
        # xy: pool over t at each (h, w)
        h_xy = self._pool(h.permute(0, 2, 3, 1, 4).reshape(b * r * r, s, ch),
                          "xy").reshape(b, r, r, ch)
        # yt: pool over h at each (t, w)
        h_yt = self._pool(h.permute(0, 1, 3, 2, 4).reshape(b * s * r, r, ch),
                          "yt").reshape(b, s, r, ch)
        # xt: pool over w at each (t, h)
        h_xt = self._pool(h.reshape(b * s * r, r, ch), "xt").reshape(b, s, r, ch)
        return (torch.tanh(self.pre_xy(h_xy)), torch.tanh(self.pre_yt(h_yt)),
                torch.tanh(self.pre_xt(h_xt)))

    def _broadcast_sum(self, h_xy, h_yt, h_xt):
        """post 1×1s + broadcast-sum to the volume [B,s,r,r,C] (ref :189-199)."""
        z_xy = self.post_xy(h_xy)[:, None]         # [B,1,r,r,C]
        z_yt = self.post_yt(h_yt)[:, :, None]      # [B,s,1,r,C]
        z_xt = self.post_xt(h_xt)[:, :, :, None]   # [B,s,r,1,C]
        return z_xy + z_yt + z_xt

    # ------------------------------------------------------------ API
    def encode(self, x):
        """video → decoder-ready volume [B,s,r,r,C] (ref :150-199)."""
        return self._broadcast_sum(*self._pool_planes(x))

    def forward(self, x):
        """video → its reconstruction, both [B,T,H,W,3] in [-1,1] (the JAX
        module's ``__call__`` without its constant second output)."""
        return self.decode(self.encode(x))

    def decode(self, z):
        """volume [B,s,r,r,C] → video [B,T,H,W,3] in [-1,1] (ref :201-204)."""
        c = self.cfg
        b, s = z.shape[0], z.shape[1]
        dec = self.decoder(z).reshape(b * s, c.latent_res, c.latent_res,
                                      c.channels)
        px = self.to_pixel(dec).reshape(b, s, c.resolution, c.resolution, 3)
        return 2.0 * torch.sigmoid(px) - 1.0

    def extract(self, x):
        """video → diffusion latent [B, e, r*r + 2*s*r] (ref :212-255)."""
        b = x.shape[0]
        e = self.cfg.embed_dim
        return torch.cat([p.permute(0, 3, 1, 2).reshape(b, e, -1)
                          for p in self._pool_planes(x)], dim=-1)

    def decode_from_sample(self, latent):
        """diffusion latent [B, e, L] → video (ref :257-275)."""
        c = self.cfg
        b = latent.shape[0]
        s, r, e = c.timesteps // c.splits, c.latent_res, c.embed_dim
        h_xy = latent[:, :, : r * r].reshape(b, e, r, r).permute(0, 2, 3, 1)
        h_yt = latent[:, :, r * r : r * (r + s)].reshape(b, e, s, r).permute(0, 2, 3, 1)
        h_xt = latent[:, :, r * (r + s) : r * (r + 2 * s)].reshape(
            b, e, s, r).permute(0, 2, 3, 1)
        return self.decode(self._broadcast_sum(h_xy, h_yt, h_xt))
