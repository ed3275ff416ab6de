"""Triplane latent-diffusion UNet (port of
``moditalker_tpu/models/mtov/unet.py``, ref MToV/models/ddpm/unet.py:601-1117).

Planes are NCHW. Every stage runs one shared-weight 2D block per plane, with
yt and xt (identical [s, r] shapes) stacked on the batch axis; after each
stage the three planes' tokens are concatenated and a joint self-attention
runs over all r² + 2·s·r tokens (unet.py:1039-1049). The image_cond beyond
the xy plane is zeroed (unet.py:1022-1024). Latents are [B, C, r² + 2·s·r]
with planes xy | yt | xt, byte-compatible with the reference.

Attention blocks project a packed q|k|v (heads contiguous inside each third)
and call ``packed_attention``, the hand-written kernel on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import MtovUNetConfig
from ...ops.kernels.packed_attention import packed_attention
from ..layers import Conv2d, Dense


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """cos-then-sin sinusoid (ref diffusionmodules.py:108-128)."""
    half = dim // 2
    log_period = torch.tensor(max_period, dtype=torch.float32).log()
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32)
                      / half).to(t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm_32(x, weight, bias, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel axis (axis 1 of [B, C, ...]), computed in
    float32 whatever the activation dtype (ref GroupNorm32).

    Variance is the JAX package's SHIFTED one-pass form: sums of (x−k) and
    (x−k)² with k the first spatial element per (batch, channel). Unlike
    E[x²]−E[x]² it does not cancel when |mean| ≫ std, since x−k is O(std).
    Var_G(x) = Var_G(y) + 2·Cov_c(ȳ_c, k_c) + Var_c(k_c) with y = x − k.
    """
    orig_dtype = x.dtype
    x32 = x.float()
    b, c = x32.shape[:2]
    g, cg = num_groups, c // num_groups
    bshape = (b, c) + (1,) * (x32.ndim - 2)
    flat = x32.reshape(b, c, -1)
    n_sp = flat.shape[-1]
    n = n_sp * cg
    k = flat[:, :, 0]                                   # [B, C] sample shift
    y = flat - k[..., None]
    s1 = y.sum(-1)
    s2 = (y * y).sum(-1)
    m_y = s1 / n_sp                                     # [B, C]
    ey = m_y.reshape(b, g, cg).mean(-1)                 # [B, g]
    ek = k.reshape(b, g, cg).mean(-1)
    mean = ey + ek
    var_y = s2.reshape(b, g, cg).sum(-1) / n - ey * ey
    kc = k.reshape(b, g, cg) - ek[..., None]
    var_k = (kc * kc).mean(-1)
    cov = (m_y.reshape(b, g, cg) * kc).mean(-1)
    var = torch.clamp(var_y + 2.0 * cov + var_k, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, -1).reshape(bshape)
    inv_c = inv.repeat_interleave(cg, -1).reshape(bshape)
    out = (x32 - mean_c) * inv_c
    out = out * weight.float().reshape(bshape[1:]) + bias.float().reshape(bshape[1:])
    return out.to(orig_dtype)


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_32(x, self.weight, self.bias, self.num_groups)


def _nearest_up2(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class ResBlock(nn.Module):
    """Scale-shift GroupNorm residual block, optionally resampling
    (ref unet.py:93-207). Inference only: dropout is not applied."""

    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False, dtype=torch.float32):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(channels)
        self.in_conv = Conv2d(channels, out_channels, 3, dtype)
        self.emb_proj = Dense(
            emb_channels,
            2 * out_channels if use_scale_shift_norm else out_channels,
            dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = Conv2d(out_channels, out_channels, 3, dtype)
        self.skip = (Conv2d(channels, out_channels, 1, dtype)
                     if out_channels != channels else None)

    def forward(self, x, emb):
        h = F.silu(self.in_norm(x))
        if self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        elif self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_norm(h) * (1 + scale) + shift
        else:
            h = self.out_norm(h + emb_out)
        h = self.out_conv(F.silu(h))
        return (x if self.skip is None else self.skip(x)) + h


class SelfAttentionBlock(nn.Module):
    """Token self-attention over [B, C, L] — per-plane spatial attention
    (ref AttentionBlock, unet.py:210-254) and the joint triplane attention
    (AttentionBlock1D, :257-300)."""

    def __init__(self, channels: int, num_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x):
        c = x.shape[1]
        qkv = self.qkv(self.norm(x).transpose(1, 2))       # [B, L, 3C]
        out = packed_attention(qkv, self.num_heads,
                               scale=(c // self.num_heads) ** -0.5)
        return x + self.proj_out(out).transpose(1, 2)


class TriplaneUNet(nn.Module):
    def __init__(self, cfg: MtovUNetConfig = MtovUNetConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_ch = mc * 4
        heads = cfg.num_heads
        self.time_embed_1 = Dense(mc, emb_ch, dtype=dtype)
        self.time_embed_2 = Dense(emb_ch, emb_ch, dtype=dtype)
        in_ch = cfg.in_channels + cfg.cond_channels + cfg.image_cond_channels
        self.input_conv = Conv2d(in_ch, mc, 3, dtype)

        def res(ch, out, **kw):
            return ResBlock(ch, out, emb_ch, cfg.use_scale_shift_norm,
                            dtype=dtype, **kw)

        def attn(ch):
            return SelfAttentionBlock(ch, heads, dtype)

        # lists with holes (no 2D attention at some stages, no joint
        # attention after the input conv) are ModuleDicts keyed by index
        self.in_res = nn.ModuleList()
        self.in_attn2d = nn.ModuleDict()
        self.in_joint = nn.ModuleDict()
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                i = len(self.in_res)
                self.in_res.append(res(ch, mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.in_attn2d[str(i)] = attn(ch)
                self.in_joint[str(i + 1)] = attn(ch)
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                i = len(self.in_res)
                self.in_res.append(res(ch, ch, down=True))
                self.in_joint[str(i + 1)] = attn(ch)
                chans.append(ch)
                ds *= 2

        self.mid_res1 = res(ch, ch)
        self.mid_attn2d = attn(ch)
        self.mid_res2 = res(ch, ch)
        self.mid_joint = attn(ch)

        self.out_res = nn.ModuleList()
        self.out_attn2d = nn.ModuleDict()
        self.out_up = nn.ModuleDict()
        self.out_joint = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for j in range(cfg.num_res_blocks + 1):
                i = len(self.out_res)
                self.out_res.append(res(ch + chans.pop(), mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.out_attn2d[str(i)] = attn(ch)
                if level and j == cfg.num_res_blocks:
                    self.out_up[str(i)] = res(ch, ch, up=True)
                    ds //= 2
                self.out_joint.append(attn(ch))

        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv2d(ch, cfg.out_channels, 3, dtype)

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def _joint(attn, h_xy, h_ytxt):
        """Concat plane tokens (xy | yt | xt), run joint attention, split
        back (ref unet.py:1039-1049)."""
        b = h_xy.shape[0]
        n_xy = h_xy.shape[2] * h_xy.shape[3]
        n_p = h_ytxt.shape[2] * h_ytxt.shape[3]
        tokens = torch.cat([h_xy.flatten(2), h_ytxt[:b].flatten(2),
                            h_ytxt[b:].flatten(2)], dim=-1)
        tokens = attn(tokens)
        h_yt = tokens[:, :, n_xy:n_xy + n_p]
        h_xt = tokens[:, :, n_xy + n_p:]
        return (tokens[:, :, :n_xy].reshape(h_xy.shape),
                torch.cat([h_yt, h_xt], dim=0).reshape(h_ytxt.shape))

    @staticmethod
    def _attn2d(attn, p):
        return attn(p.flatten(2)).reshape(p.shape)

    # ---------------------------------------------------------------- forward
    def forward(self, x, cond, image_cond, t):
        """x [B,Cin,L], cond [B,Cc,L], image_cond [B,Cin,L] → [B,Cout,L]
        with L = r² + 2·s·r (ref unet.py:995-1117)."""
        cfg = self.cfg
        b = x.shape[0]
        r, s = cfg.latent_res, cfg.latent_t
        n_xy = r * r

        emb = timestep_embedding(t, cfg.model_channels)
        emb = self.time_embed_2(F.silu(self.time_embed_1(emb)))
        emb2 = torch.cat([emb, emb], dim=0)  # for the stacked yt|xt

        dt = torch.result_type(x, cond)
        ic = torch.cat([image_cond[:, :, :n_xy].to(dt),
                        x.new_zeros(b, image_cond.shape[1], 2 * s * r, dtype=dt)],
                       dim=-1)
        h = torch.cat([x.to(dt), cond.to(dt), ic], dim=1)
        h_xy = h[:, :, :n_xy].reshape(b, -1, r, r)
        h_ytxt = torch.cat([h[:, :, n_xy:n_xy + s * r].reshape(b, -1, s, r),
                            h[:, :, n_xy + s * r:].reshape(b, -1, s, r)], dim=0)

        # input conv stage (joint attention skipped — reference Identity)
        h_xy = self.input_conv(h_xy)
        h_ytxt = self.input_conv(h_ytxt)
        skips = [(h_xy, h_ytxt)]

        for i, res in enumerate(self.in_res):
            h_xy, h_ytxt = res(h_xy, emb), res(h_ytxt, emb2)
            if str(i) in self.in_attn2d:
                a = self.in_attn2d[str(i)]
                h_xy, h_ytxt = self._attn2d(a, h_xy), self._attn2d(a, h_ytxt)
            h_xy, h_ytxt = self._joint(self.in_joint[str(i + 1)], h_xy, h_ytxt)
            skips.append((h_xy, h_ytxt))

        h_xy, h_ytxt = self.mid_res1(h_xy, emb), self.mid_res1(h_ytxt, emb2)
        h_xy = self._attn2d(self.mid_attn2d, h_xy)
        h_ytxt = self._attn2d(self.mid_attn2d, h_ytxt)
        h_xy, h_ytxt = self.mid_res2(h_xy, emb), self.mid_res2(h_ytxt, emb2)
        h_xy, h_ytxt = self._joint(self.mid_joint, h_xy, h_ytxt)

        for i, (res, joint) in enumerate(zip(self.out_res, self.out_joint)):
            skip_xy, skip_ytxt = skips.pop()
            h_xy = res(torch.cat([h_xy, skip_xy], dim=1), emb)
            h_ytxt = res(torch.cat([h_ytxt, skip_ytxt], dim=1), emb2)
            if str(i) in self.out_attn2d:
                a = self.out_attn2d[str(i)]
                h_xy, h_ytxt = self._attn2d(a, h_xy), self._attn2d(a, h_ytxt)
            if str(i) in self.out_up:
                up = self.out_up[str(i)]
                h_xy, h_ytxt = up(h_xy, emb), up(h_ytxt, emb2)
            h_xy, h_ytxt = self._joint(joint, h_xy, h_ytxt)

        # output head per plane, repacked to the reference latent layout
        o_xy = self.out_conv(F.silu(self.out_norm(h_xy)))
        o_ytxt = self.out_conv(F.silu(self.out_norm(h_ytxt)))
        return torch.cat([o_xy.flatten(2), o_ytxt[:b].flatten(2),
                          o_ytxt[b:].flatten(2)], dim=-1).to(x.dtype)
