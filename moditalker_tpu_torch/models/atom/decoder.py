"""AToM MotionDecoder — FiLM-conditioned transformer diffusion denoiser
(port of ``moditalker_tpu/models/atom/decoder.py``, ref
AToM/model/model.py:242-470).

The same computation graph as the JAX package: 68 landmarks split into a lip
stream (lower-face 17 + lip 20 = 37 points) and an upper-face stream (31
points), a HuBERT conditioning encoder with classifier-free null embeddings,
FiLM time/identity conditioning, dual-stream FiLM decoder layers and a fused
output head; full-model-dim rotary applied before the attention projections;
the two shared-weight self-attentions of a decoder layer run as one call
stacked on the batch axis. The module tree carries the flax names, so
``utils/convert.py`` maps the JAX parameters one to one.

Dropout modules exist as in the reference; inference runs in ``eval()`` and
is deterministic. Parameters are float32; the compute dtype is configurable.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import AtomModelConfig
from ...ops import rotary
from ...ops.attention import multi_head_sdpa
from ..layers import Dense, LayerNorm


def mish(x):
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-timestep embedding (ref AToM/model/utils.py:36-48); the
    divisor is ``half - 1``."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


@functools.lru_cache(maxsize=32)
def _freqs_on(seq_len: int, dim: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rotary.rotary_full_dim_freqs(seq_len, dim)).to(
        device)


def _freqs(seq_len: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    """The rotary table for a sequence, kept on ``like``'s device."""
    return _freqs_on(seq_len, dim, like.device)


class DenseFiLM(nn.Module):
    """FiLM generator (ref model.py:15-27): Mish → Dense(2d) → (scale,
    shift), each [B, 1, d]."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(features, features * 2, dtype=dtype)

    def forward(self, pos):
        return self.proj(mish(pos))[:, None, :].chunk(2, dim=-1)


def featurewise_affine(x, scale_shift):
    scale, shift = scale_shift
    return (scale + 1.0) * x + shift


class MHA(nn.Module):
    """Multi-head attention with torch ``nn.MultiheadAttention`` semantics:
    separate biased q/k/v projections of the given inputs and a biased out
    projection."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, q_in, k_in, v_in):
        out = multi_head_sdpa(self.q_proj(q_in), self.k_proj(k_in),
                              self.v_proj(v_in), self.num_heads)
        return self.drop(self.out_proj(out))


class EncoderLayer(nn.Module):
    """Pre-LN transformer encoder layer with full-dim rotary on q/k
    (ref model.py:35-99); exact-erf GELU."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MHA(d_model, num_heads, dropout, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, ff_size, dtype=dtype)
        self.linear2 = Dense(ff_size, d_model, dtype=dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        h = self.norm1(x)
        qk = rotary.apply_rotary_full_dim(
            h, _freqs(x.shape[-2], self.d_model, x))
        x = x + self.self_attn(qk, qk, h)
        h = self.drop(F.gelu(self.linear1(self.norm2(x))))
        return x + self.drop(self.linear2(h))


class FiLMDecoderLayer(nn.Module):
    """Dual-stream (lip / upper-face) FiLM decoder layer (ref
    model.py:102-228, the norm_first path of ``forward``, :161-194). The two
    same-weight self-attentions of block 1 (lip and face through ``norm1``
    + ``self_attn``) run as one stacked call."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        d = self.d_model = d_model
        self.norm1 = LayerNorm(d, dtype)
        self.norm2 = LayerNorm(d, dtype)
        self.norm3 = LayerNorm(d, dtype)
        self.self_attn = MHA(d, num_heads, dropout, dtype)
        self.multihead_attn = MHA(d, num_heads, dropout, dtype)
        self.film1 = DenseFiLM(d, dtype)
        self.film2 = DenseFiLM(d, dtype)
        self.film3 = DenseFiLM(d, dtype)
        self.linear3 = Dense(d, 2 * d, dtype=dtype)

    def forward(self, x, memory, lip_t, nonlip_t, face_memory):
        d = self.d_model
        b, t, _ = x.shape
        lip, face = x[..., :d], x[..., d:]
        seq_freqs = _freqs(t, d, x)

        def sa_block(h):
            qk = rotary.apply_rotary_full_dim(h, seq_freqs)
            return self.self_attn(qk, qk, h)

        def mha_block(h, mem):
            q = rotary.apply_rotary_full_dim(h, seq_freqs)
            k = rotary.apply_rotary_full_dim(mem, _freqs(mem.shape[-2], d, x))
            return self.multihead_attn(q, k, mem)

        # block 1: both streams self-attend with shared weights, stacked on
        # the batch axis, face first
        sa_out = sa_block(torch.cat([self.norm1(face), self.norm1(lip)]))
        face1, lip1 = sa_out[:b], sa_out[b:]
        lip = lip + featurewise_affine(lip1, self.film1(lip_t))
        face = face + featurewise_affine(face1, self.film1(nonlip_t))

        # block 2: face self-attends, lip cross-attends to the full memory
        face2 = sa_block(self.norm2(face))
        lip2 = mha_block(self.norm2(lip), memory)
        lip = lip + featurewise_affine(lip2, self.film2(lip_t))
        face = face + featurewise_affine(face2, self.film2(nonlip_t))

        # fusion: cross-attend to the face memory, FiLM, widen back to 2d
        x_tmp = mha_block(self.norm3(face + lip), face_memory)
        t_mix = (lip_t + nonlip_t) / 2
        x_tmp = x_tmp + featurewise_affine(x_tmp, self.film3(t_mix))
        return self.linear3(x_tmp)


class NonAttnProjection(nn.Module):
    """LayerNorm → Dense → SiLU → Dense on a pooled token (model.py:268-281);
    the flax names ``{name}_ln``, ``{name}_fc1``, ``{name}_fc2`` map onto
    ``{name}.ln`` etc."""

    def __init__(self, d: int, dtype):
        super().__init__()
        self.ln = LayerNorm(d, dtype)
        self.fc1 = Dense(d, d, dtype=dtype)
        self.fc2 = Dense(d, d, dtype=dtype)

    def forward(self, z):
        return self.fc2(F.silu(self.fc1(self.ln(z))))


class MotionDecoder(nn.Module):
    """Full AToM denoiser (ref model.py:242-470).

    ``forward(x, face, cond_embed, times, keep_mask)``: ``x`` [B, T, 204] the
    noisy landmark residual, ``face`` [B, T, 204] the identity keypoint
    broadcast over the horizon, ``cond_embed`` [B, 2T, 1024] HuBERT
    features, ``times`` int [B]; ``keep_mask`` bool [B] selects the
    conditioned (True) or the null (False) embeddings per sample.
    """

    def __init__(self, cfg: AtomModelConfig = AtomModelConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        dd = dict(dtype=dtype)
        layer = lambda cls: cls(d, cfg.num_heads, cfg.ff_size, cfg.dropout,
                                dtype)
        self.input_projection_lip = Dense(cfg.lip_dim, d, **dd)
        self.input_projection_wo_lip = Dense(cfg.upper_dim, d, **dd)
        self.cond_projection = Dense(cfg.cond_feature_dim, d, **dd)
        self.cond_encoder = nn.ModuleList(layer(EncoderLayer) for _ in range(2))
        self.null_cond_embed = nn.Parameter(torch.randn(1, cfg.horizon * 2, d))
        self.non_attn_cond_projection = NonAttnProjection(d, dtype)
        self.time_mlp = Dense(d, d * 4, **dd)
        self.to_time_cond = Dense(d * 4, d, **dd)
        self.to_time_tokens = Dense(d * 4, d * 2, **dd)
        self.face_projection = Dense(cfg.repr_dim, d, **dd)
        self.face_encoder = nn.ModuleList(layer(EncoderLayer) for _ in range(2))
        self.face_null_cond_embed = nn.Parameter(torch.randn(1, cfg.horizon, d))
        self.non_attn_face_projection = NonAttnProjection(d, dtype)
        self.null_cond_hidden = nn.Parameter(torch.randn(1, d))
        self.norm_cond = LayerNorm(d, dtype)
        self.decoder = nn.ModuleList(layer(FiLMDecoderLayer)
                                     for _ in range(cfg.num_layers))
        self.final_layer = Dense(2 * d, cfg.repr_dim, **dd)

    def forward(self, x, face, cond_embed, times, keep_mask=None):
        d = self.cfg.latent_dim
        b, t_len, _ = x.shape
        if keep_mask is None:
            keep_mask = torch.ones(b, dtype=torch.bool, device=x.device)

        # landmark stream split (model.py:400-417)
        pts = x.reshape(b, t_len, -1, 3)
        upper = pts[:, :, 17:48].reshape(b, t_len, -1)
        lower_w_lip = torch.cat([pts[:, :, :17].reshape(b, t_len, -1),
                                 pts[:, :, 48:].reshape(b, t_len, -1)], dim=-1)
        h = torch.cat([self.input_projection_lip(lower_w_lip),
                       self.input_projection_wo_lip(upper)], dim=-1)

        keep_embed = keep_mask[:, None, None]
        keep_hidden = keep_mask[:, None]

        # HuBERT conditioning tokens (model.py:425-433); the null embedding
        # is sliced to the sequence length
        cond_tokens = self.cond_projection(cond_embed)
        for enc in self.cond_encoder:
            cond_tokens = enc(cond_tokens)
        cond_tokens = torch.where(
            keep_embed, cond_tokens,
            self.null_cond_embed[:, :cond_tokens.shape[1]].to(cond_tokens.dtype))
        cond_hidden = self.non_attn_cond_projection(cond_tokens.mean(dim=-2))

        # diffusion timestep embedding (model.py:268-281, 436-442)
        t_hidden = mish(self.time_mlp(sinusoidal_pos_emb(times, d)))
        t_cond = self.to_time_cond(t_hidden)
        t_tokens = self.to_time_tokens(t_hidden).reshape(b, 2, d)

        # identity keypoint tokens (model.py:444-455)
        face_tokens = self.face_projection(face)
        for enc in self.face_encoder:
            face_tokens = enc(face_tokens)
        face_tokens = torch.where(
            keep_embed, face_tokens,
            self.face_null_cond_embed[:, :face_tokens.shape[1]].to(
                face_tokens.dtype))
        face_hidden = self.non_attn_face_projection(face_tokens.mean(dim=-2))

        # The reference aliases lip_t and nonlip_t to ONE tensor and updates
        # it in place three times (model.py:441-460), so both streams receive
        # t + 2·face_hidden + cond_hidden: trained-in semantics, kept.
        cond_hidden = torch.where(keep_hidden, cond_hidden,
                                  self.null_cond_hidden.to(cond_hidden.dtype))
        lip_t = nonlip_t = t_cond + 2.0 * face_hidden + cond_hidden

        memory = self.norm_cond(
            torch.cat([cond_tokens, t_tokens, face_tokens], dim=-2))
        face_memory = self.norm_cond(torch.cat([t_tokens, face_tokens], dim=-2))

        for layer in self.decoder:
            h = layer(h, memory, lip_t, nonlip_t, face_memory)
        return self.final_layer(h)
