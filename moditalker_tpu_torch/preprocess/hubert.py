"""HuBERT speech encoder (port of ``moditalker_tpu/preprocess/hubert.py``).

The inference path of transformers' ``HubertModel`` for the
``facebook/hubert-large-ls960-ft`` configuration family: a 7-layer conv
feature extractor (layer-norm variant), the feature projection, a grouped
convolutional positional embedding (weight norm folded at conversion) and a
stable-layer-norm transformer encoder. Module names follow the flax tree, so
``utils/convert.py::convert_hubert_params`` maps the JAX package's parameters
one to one; ``convert_hubert`` takes a transformers ``HubertModel``
``state_dict`` to that tree.

Layout: the flax modules run channels-last, [B, T, C]; the port keeps that
layout between modules (so layer norms are ``layer_norm`` over C) and turns
to [B, C, T] only around each ``Conv1d``.

Attention: with ``n_frames`` the frame mask sends every attention to the
plain math (``ops/attention.py::sdpa_route``), as the JAX package's masked
attention takes XLA's einsum; no hand-written kernel is reached.

``dtype`` (default float32) is the compute dtype of the whole trunk, as the
JAX package's ``dtype`` field: with bf16 every conv and dense layer computes
in bf16, every layer norm takes its statistics in float32 and writes bf16,
and the residual stream, the exact GELU and the attention (scores rounded to
bf16, softmax in float32, ``plain_sdpa``) are bf16 from the feature
extractor on; the output is bf16. The parameters stay float32 in either
dtype, so ``convert_hubert_params``'s state_dict serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv1d, Dense, LayerNorm
from ..ops.attention import multi_head_sdpa


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


class FeatureExtractor(nn.Module):
    """Strided Conv1D stack, layer-norm variant (HF HubertFeatureEncoder):
    each VALID conv is followed by a layer norm over channels and the exact
    GELU."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                            cfg.conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(c_in, dim, k, stride=s,
                                                bias=cfg.conv_bias,
                                                dtype=dtype))
            self.add_module(f"ln_{i}", LayerNorm(dim, dtype,
                                                 cfg.layer_norm_eps))
            c_in = dim

    def forward(self, x):  # x: [B, N] raw waveform → [B, T, conv_dim[-1]]
        h = x[:, :, None]
        for i in range(len(self.cfg.conv_dim)):
            h = getattr(self, f"conv_{i}")(h)
            h = F.gelu(getattr(self, f"ln_{i}")(h))
        return h


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding; with an even kernel the extra
    right sample is dropped (HF ``HubertSamePadLayer``)."""

    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.drop_last = k % 2 == 0
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                           padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups,
                           dtype=dtype)

    def forward(self, x):  # [B, T, D]
        h = self.conv(x)
        if self.drop_last:
            h = h[:, :-1]
        return F.gelu(h)


class EncoderLayerStableLN(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_heads
        self.attn_ln = LayerNorm(d, dtype, eps)
        self.q_proj = Dense(d, d, dtype=dtype)
        self.k_proj = Dense(d, d, dtype=dtype)
        self.v_proj = Dense(d, d, dtype=dtype)
        self.out_proj = Dense(d, d, dtype=dtype)
        self.final_ln = LayerNorm(d, dtype, eps)
        self.ff1 = Dense(d, cfg.intermediate_size, dtype=dtype)
        self.ff2 = Dense(cfg.intermediate_size, d, dtype=dtype)

    def forward(self, x, mask=None):
        h = self.attn_ln(x)
        attn = multi_head_sdpa(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                               self.num_heads, mask=mask)
        x = x + self.out_proj(attn)
        h = self.ff2(F.gelu(self.ff1(self.final_ln(x))))
        return x + h


class HubertEncoder(nn.Module):
    """Full model: waveform [B, N] → features [B, T, hidden] in ``dtype``."""

    def __init__(self, cfg: HubertConfig = HubertConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.feature_extractor = FeatureExtractor(cfg, dtype)
        self.fp_ln = LayerNorm(cfg.conv_dim[-1], dtype, eps)
        self.fp_proj = Dense(cfg.conv_dim[-1], cfg.hidden_size, dtype=dtype)
        self.pos_conv = PositionalConvEmbedding(cfg, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayerStableLN(cfg, dtype))
        self.encoder_ln = LayerNorm(cfg.hidden_size, dtype, eps)

    def forward(self, wave, n_frames=None):
        """``n_frames`` [B] (optional): the number of valid output frames
        when ``wave`` is zero-padded to a bucket length. The valid frames
        then equal the unpadded forward's: their VALID conv windows never
        cover the padding, padded frames are zeroed before the feature
        projection and again before the positional conv (whose SAME
        padding contributes zeros past the true end), and attention masks
        the padded keys."""
        feats = self.feature_extractor(wave)
        mask = None
        if n_frames is not None:
            t = feats.shape[1]
            n = torch.as_tensor(n_frames, device=feats.device)
            valid = (torch.arange(t, device=feats.device)[None, :]
                     < n[:, None])                              # [B, T]
            feats = torch.where(valid[..., None], feats, 0.0)
            mask = valid[:, None, None, :]                      # [B,1,1,T]
        h = self.fp_proj(self.fp_ln(feats))
        if n_frames is not None:
            # fp_ln/fp_proj give padded rows a constant bias value; zero
            # them so pos_conv sees exactly the zeros SAME padding implies
            h = torch.where(valid[..., None], h, 0.0)
        h = h + self.pos_conv(h)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, mask)
        # the stable-layer-norm variant applies the encoder LN at the END
        return self.encoder_ln(h)


def convert_hubert(sd: dict, cfg: HubertConfig) -> dict:
    """transformers ``HubertModel`` state_dict → the JAX package's flax tree
    (``{"params": ...}``; ``utils/convert.py::convert_hubert_params`` then
    gives the port's state_dict). The weight-normed positional conv is
    folded: w = g · v / ||v|| (norm over O and I)."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    p: dict = {"feature_extractor": {}, "pos_conv": {}}
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        conv = {"kernel": np.ascontiguousarray(
            sd[f"{pre}.conv.weight"].transpose(2, 1, 0))}  # [O,I,k]->[k,I,O]
        if f"{pre}.conv.bias" in sd:
            conv["bias"] = sd[f"{pre}.conv.bias"]
        p["feature_extractor"][f"conv_{i}"] = conv
        p["feature_extractor"][f"ln_{i}"] = {
            "scale": sd[f"{pre}.layer_norm.weight"],
            "bias": sd[f"{pre}.layer_norm.bias"]}
    p["fp_ln"] = {"scale": sd["feature_projection.layer_norm.weight"],
                  "bias": sd["feature_projection.layer_norm.bias"]}
    p["fp_proj"] = {
        "kernel": np.ascontiguousarray(
            sd["feature_projection.projection.weight"].T),
        "bias": sd["feature_projection.projection.bias"]}

    g = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
    v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    w = g * v / norm  # [O, I/g, k]
    p["pos_conv"]["conv"] = {
        "kernel": np.ascontiguousarray(w.transpose(2, 1, 0)),
        "bias": sd["encoder.pos_conv_embed.conv.bias"]}

    p["encoder_ln"] = {"scale": sd["encoder.layer_norm.weight"],
                       "bias": sd["encoder.layer_norm.bias"]}
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"

        def lin(n):
            return {"kernel": np.ascontiguousarray(sd[f"{pre}.{n}.weight"].T),
                    "bias": sd[f"{pre}.{n}.bias"]}

        p[f"layer_{i}"] = {
            "attn_ln": {"scale": sd[f"{pre}.layer_norm.weight"],
                        "bias": sd[f"{pre}.layer_norm.bias"]},
            "q_proj": lin("attention.q_proj"),
            "k_proj": lin("attention.k_proj"),
            "v_proj": lin("attention.v_proj"),
            "out_proj": lin("attention.out_proj"),
            "final_ln": {"scale": sd[f"{pre}.final_layer_norm.weight"],
                         "bias": sd[f"{pre}.final_layer_norm.bias"]},
            "ff1": lin("feed_forward.intermediate_dense"),
            "ff2": lin("feed_forward.output_dense"),
        }
    return {"params": p}
