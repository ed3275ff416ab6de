"""Reference torch checkpoints → the port's ``state_dict`` (port of
``moditalker_tpu/utils/torch_port.py``).

The published MoDiTalker files are ``state_dict``s of the reference's own
modules (AToM's ``MotionDecoder``, MToV's ``ViTAutoencoder`` and ``UNetModel``,
richzhang's LPIPS heads over torchvision's VGG16), whose key names and
layouts differ from the port's. Each converter here is two steps:

1. the JAX package's key mapping, kept as a copy (numpy only): the reference
   ``state_dict`` → the flax parameter tree (Linear [out, in] → kernel
   [in, out], Conv OIHW → HWIO, ``nn.MultiheadAttention.in_proj`` split into
   q/k/v, LayerNorm/GroupNorm ``weight`` → ``scale``, the UNet's head-major
   qkv rows permuted to q|k|v-major, LPIPS heads [1, C, 1, 1] → [C, 1]);
2. ``utils/convert.py``: the flax tree → the port's ``state_dict``. The port's
   module tree mirrors the flax tree, so one copy of the key mapping serves
   both packages.

The UNet's packed qkv stays q|k|v-major in the port (the layout the packed
kernel reads), so the head-major → q|k|v-major permutation of step 1 is the
only one applied. The inputs are ``{name: array or tensor}`` dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import convert


def _np(sd: dict) -> dict:
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in sd.items()}


def _lin(sd: dict, name: str) -> dict:
    return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T),
            "bias": np.asarray(sd[f"{name}.bias"])}


def _lin_nobias(sd: dict, name: str) -> dict:
    return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}


def _norm(sd: dict, name: str) -> dict:
    """LayerNorm / GroupNorm: weight → scale."""
    return {"scale": np.asarray(sd[f"{name}.weight"]),
            "bias": np.asarray(sd[f"{name}.bias"])}


def _conv(sd: dict, name: str) -> dict:
    w = np.asarray(sd[f"{name}.weight"])  # [O, I, *k] → [*k, I, O]
    axes = list(range(w.ndim))
    out = {"kernel": np.ascontiguousarray(w.transpose(axes[2:] + [1, 0]))}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def _mha(sd: dict, name: str, d: int) -> dict:
    """torch ``nn.MultiheadAttention`` → q/k/v/out projections."""
    w = np.asarray(sd[f"{name}.in_proj_weight"])
    b = np.asarray(sd[f"{name}.in_proj_bias"])
    return {
        "q_proj": {"kernel": np.ascontiguousarray(w[:d].T), "bias": b[:d]},
        "k_proj": {"kernel": np.ascontiguousarray(w[d:2 * d].T),
                   "bias": b[d:2 * d]},
        "v_proj": {"kernel": np.ascontiguousarray(w[2 * d:].T),
                   "bias": b[2 * d:]},
        "out_proj": _lin(sd, f"{name}.out_proj"),
    }


def _encoder_layer(sd: dict, prefix: str, d: int) -> dict:
    return {"norm1": _norm(sd, f"{prefix}.norm1"),
            "norm2": _norm(sd, f"{prefix}.norm2"),
            "self_attn": _mha(sd, f"{prefix}.self_attn", d),
            "linear1": _lin(sd, f"{prefix}.linear1"),
            "linear2": _lin(sd, f"{prefix}.linear2")}


def _decoder_layer(sd: dict, prefix: str, d: int) -> dict:
    # DenseFiLM.block = Sequential(Mish, Linear) → block.1
    film = lambda i: {"proj": _lin(sd, f"{prefix}.film{i}.block.1")}
    return {"norm1": _norm(sd, f"{prefix}.norm1"),
            "norm2": _norm(sd, f"{prefix}.norm2"),
            "norm3": _norm(sd, f"{prefix}.norm3"),
            "self_attn": _mha(sd, f"{prefix}.self_attn", d),
            "multihead_attn": _mha(sd, f"{prefix}.multihead_attn", d),
            "film1": film(1), "film2": film(2), "film3": film(3),
            "linear3": _lin(sd, f"{prefix}.linear3")}


def _conv1x1_as_dense(sd: dict, name: str) -> dict:
    """Conv1d/Conv2d with a 1-wide kernel → Dense."""
    w = np.asarray(sd[f"{name}.weight"])
    w = w.reshape(w.shape[0], w.shape[1])
    out = {"kernel": np.ascontiguousarray(w.T)}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def qkv_headmajor_to_qkvmajor(w: np.ndarray, b: np.ndarray,
                              num_heads: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's ``QKVAttentionLegacy`` reads the 3C rows of its qkv
    conv as H blocks of (q|k|v)·dh (unet.py:318-326); the port's Dense emits
    q (all heads) | k | v. w: [3C, C], b: [3C] → the rows permuted."""
    three_c, c = w.shape
    dh = three_c // (3 * num_heads)
    w = w.reshape(num_heads, 3, dh, c).transpose(1, 0, 2, 3).reshape(three_c, c)
    b = b.reshape(num_heads, 3, dh).transpose(1, 0, 2).reshape(three_c)
    return w, b


def _unet_qkv(sd: dict, name: str, num_heads: int) -> dict:
    w, b = qkv_headmajor_to_qkvmajor(np.asarray(sd[f"{name}.weight"])[:, :, 0],
                                     np.asarray(sd[f"{name}.bias"]), num_heads)
    return {"kernel": np.ascontiguousarray(w.T), "bias": b}


# ------------------------------------------------------------------ AToM
def atom_decoder_tree(sd: dict, num_layers: int = 8, d: int = 512) -> dict:
    """The reference ``MotionDecoder`` state_dict (AToM/model/model.py:
    242-383) → the flax tree. Dead reference modules (face_mlp,
    to_face_cond/tokens, the pos_* path, input_projection, the decoder's
    linear1/2) are dropped."""
    sd = _np(sd)
    p: dict = {
        "input_projection_lip": _lin(sd, "input_projection_lip"),
        "input_projection_wo_lip": _lin(sd, "input_projection_wo_lip"),
        "cond_projection": _lin(sd, "cond_projection"),
        "face_projection": _lin(sd, "face_projection"),
        "time_mlp": _lin(sd, "time_mlp.1"),
        "to_time_cond": _lin(sd, "to_time_cond.0"),
        "to_time_tokens": _lin(sd, "to_time_tokens.0"),
        "norm_cond": _norm(sd, "norm_cond"),
        "final_layer": _lin(sd, "final_layer"),
        "null_cond_embed": sd["null_cond_embed"],
        "null_cond_hidden": sd["null_cond_hidden"],
        "face_null_cond_embed": sd["face_null_cond_embed"],
    }
    for enc in ("cond_encoder", "face_encoder"):
        for i in range(2):
            p[f"{enc}_{i}"] = _encoder_layer(sd, f"{enc}.{i}", d)
    for proj in ("non_attn_cond_projection", "non_attn_face_projection"):
        p[f"{proj}_ln"] = _norm(sd, f"{proj}.0")
        p[f"{proj}_fc1"] = _lin(sd, f"{proj}.1")
        p[f"{proj}_fc2"] = _lin(sd, f"{proj}.3")
    for i in range(num_layers):
        p[f"decoder_{i}"] = _decoder_layer(sd, f"seqTransDecoder.stack.{i}", d)
    return {"params": p}


def convert_atom_decoder(sd: dict, num_layers: int = 8,
                         d: int = 512) -> dict[str, torch.Tensor]:
    """Reference ``MotionDecoder`` → the port's ``MotionDecoder``
    state_dict."""
    return convert.convert_atom_params(atom_decoder_tree(sd, num_layers, d))


# ------------------------------------------------------------------ MToV AE
def _timesformer_block(sd: dict, prefix: str, i: int) -> dict:
    """reference layers.{i} = [PreNorm(time_attn), PreNorm(space_attn),
    PreNorm(ff)] (vit_modules.py:199-207)."""
    out = {}
    for j, (norm_name, attn_name) in enumerate(
            [("time_norm", "time_attn"), ("space_norm", "space_attn")]):
        p = f"{prefix}.layers.{i}.{j}"
        out[norm_name] = _norm(sd, f"{p}.norm")
        out[attn_name] = {"to_qkv": _lin_nobias(sd, f"{p}.fn.to_qkv"),
                          "to_out": _lin(sd, f"{p}.fn.to_out.0")}
    p = f"{prefix}.layers.{i}.2"
    out["ff_norm"] = _norm(sd, f"{p}.norm")
    out["ff"] = {"fc1": _lin(sd, f"{p}.fn.net.0"),
                 "fc2": _lin(sd, f"{p}.fn.net.3")}
    return out


def _timesformer(sd: dict, prefix: str, depth: int, with_patch: bool) -> dict:
    out = {}
    if with_patch:
        out["to_patch_embedding"] = _lin(sd, f"{prefix}.to_patch_embedding")
    for i in range(depth):
        out[f"block_{i}"] = _timesformer_block(sd, prefix, i)
    return out


def _quant_attn(sd: dict, prefix: str, depth: int) -> dict:
    """autoencoder_vit.Transformer: layers.{i} = [PreNorm(Attention),
    PreNorm(FeedForward)] (autoencoder_vit.py:65-83)."""
    out = {}
    for i in range(depth):
        attn, ff = f"{prefix}.layers.{i}.0", f"{prefix}.layers.{i}.1"
        out[f"attn_norm_{i}"] = _norm(sd, f"{attn}.norm")
        out[f"to_qkv_{i}"] = _lin_nobias(sd, f"{attn}.fn.to_qkv")
        out[f"to_out_{i}"] = _lin(sd, f"{attn}.fn.to_out.0")
        out[f"ff_norm_{i}"] = _norm(sd, f"{ff}.norm")
        out[f"ff1_{i}"] = _lin(sd, f"{ff}.fn.net.0")
        out[f"ff2_{i}"] = _lin(sd, f"{ff}.fn.net.3")
    return out


def vit_autoencoder_tree(sd: dict, depth: int = 8,
                         quant_depth: int = 4) -> dict:
    """A reference ``ViTAutoencoder`` state_dict → the flax tree."""
    sd = _np(sd)
    p: dict = {
        "encoder": _timesformer(sd, "encoder", depth, with_patch=True),
        "decoder": _timesformer(sd, "decoder", depth, with_patch=False),
    }
    for name in ("xy_token", "yt_token", "xt_token", "xy_pos_embedding",
                 "yt_pos_embedding", "xt_pos_embedding"):
        p[name] = sd[name]
    for plane in ("xy", "yt", "xt"):
        p[f"{plane}_quant_attn"] = _quant_attn(sd, f"{plane}_quant_attn",
                                               quant_depth)
    for name in ("pre_xy", "pre_yt", "pre_xt", "post_xy", "post_yt",
                 "post_xt"):
        p[name] = _conv1x1_as_dense(sd, name)
    # ConvTranspose2d weight [I, O, kh, kw] → flax [kh, kw, O, I]
    w = np.asarray(sd["to_pixel.1.weight"])
    p["to_pixel"] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                     "bias": np.asarray(sd["to_pixel.1.bias"])}
    return {"params": p}


def convert_vit_autoencoder(sd: dict, depth: int = 8,
                            quant_depth: int = 4) -> dict[str, torch.Tensor]:
    """Reference ``ViTAutoencoder`` → the port's ``ViTAutoencoder``
    state_dict."""
    return convert.convert_ae_params(vit_autoencoder_tree(sd, depth,
                                                          quant_depth))


# ------------------------------------------------------------------ MToV UNet
def _unet_resblock(sd: dict, prefix: str) -> dict:
    out = {"in_norm": _norm(sd, f"{prefix}.in_layers.0"),
           "in_conv": _conv(sd, f"{prefix}.in_layers.2"),
           "emb_proj": _lin(sd, f"{prefix}.emb_layers.1"),
           "out_norm": _norm(sd, f"{prefix}.out_layers.0"),
           "out_conv": _conv(sd, f"{prefix}.out_layers.3")}
    if f"{prefix}.skip_connection.weight" in sd:
        out["skip"] = _conv(sd, f"{prefix}.skip_connection")
    return out


def _unet_attn(sd: dict, prefix: str, num_heads: int) -> dict:
    return {"norm": _norm(sd, f"{prefix}.norm"),
            "qkv": _unet_qkv(sd, f"{prefix}.qkv", num_heads),
            "proj_out": _conv1x1_as_dense(sd, f"{prefix}.proj_out")}


def triplane_unet_tree(sd: dict, num_res_blocks: int = 2,
                       channel_mult=(1, 2, 4, 4),
                       attention_resolutions=(4, 2, 1),
                       num_heads: int = 8) -> dict:
    """A reference ``UNetModel`` state_dict → the flax ``TriplaneUNet`` tree.
    Walks the reference module layout (unet.py:710-975) in construction
    order, with the constructor's index bookkeeping; the unused
    ``output_bg_*`` branches are skipped. The widths come from the arrays."""
    sd = _np(sd)
    p: dict = {"time_embed_1": _lin(sd, "time_embed.0"),
               "time_embed_2": _lin(sd, "time_embed.2"),
               "input_conv": _conv(sd, "input_blocks.0.0"),
               "out_norm": _norm(sd, "out.0"),
               "out_conv": _conv(sd, "out.2")}
    i_res, block_idx, ds = 0, 1, 1
    for level in range(len(channel_mult)):
        last = level == len(channel_mult) - 1
        for j in range(num_res_blocks + (0 if last else 1)):
            down = j == num_res_blocks       # the level's downsample block
            p[f"in_res_{i_res}"] = _unet_resblock(
                sd, f"input_blocks.{block_idx}.0")
            if not down and ds in attention_resolutions:
                p[f"in_attn2d_{i_res}"] = _unet_attn(
                    sd, f"input_blocks.{block_idx}.1", num_heads)
            p[f"in_joint_{i_res + 1}"] = _unet_attn(
                sd, f"input_attns.{block_idx}", num_heads)
            i_res += 1
            block_idx += 1
            if down:
                ds *= 2
    p["mid_res1"] = _unet_resblock(sd, "middle_block.0")
    p["mid_attn2d"] = _unet_attn(sd, "middle_block.1", num_heads)
    p["mid_res2"] = _unet_resblock(sd, "middle_block.2")
    p["mid_joint"] = _unet_attn(sd, "mid_attn", num_heads)
    o = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            p[f"out_res_{o}"] = _unet_resblock(sd, f"output_blocks.{o}.0")
            li = 1
            if ds in attention_resolutions:
                p[f"out_attn2d_{o}"] = _unet_attn(
                    sd, f"output_blocks.{o}.{li}", num_heads)
                li += 1
            if level and i == num_res_blocks:
                p[f"out_up_{o}"] = _unet_resblock(sd,
                                                  f"output_blocks.{o}.{li}")
                ds //= 2
            p[f"out_joint_{o}"] = _unet_attn(sd, f"output_attns.{o}",
                                             num_heads)
            o += 1
    return {"params": p}


def convert_triplane_unet(sd: dict, num_res_blocks: int = 2,
                          channel_mult=(1, 2, 4, 4),
                          attention_resolutions=(4, 2, 1),
                          num_heads: int = 8) -> dict[str, torch.Tensor]:
    """Reference ``UNetModel`` → the port's ``TriplaneUNet`` state_dict,
    qkv rows q|k|v-major."""
    return convert.convert_unet_params(triplane_unet_tree(
        sd, num_res_blocks, channel_mult, attention_resolutions, num_heads))


# ------------------------------------------------------------------ LPIPS
VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_tree(vgg_features_sd: dict, lpips_sd: dict) -> dict:
    """torchvision ``vgg16().features`` state_dict (convs at
    ``VGG16_CONV_INDICES``) and richzhang's ``vgg.pth`` (``lin{k}.model.1.
    weight`` [1, C, 1, 1]) → the flax LPIPS tree."""
    vgg, lin = _np(vgg_features_sd), _np(lpips_sd)
    params: dict = {"net": {}}
    for i, idx in enumerate(VGG16_CONV_INDICES):
        params["net"][f"conv_{i}"] = {
            "kernel": np.ascontiguousarray(
                vgg[f"{idx}.weight"].transpose(2, 3, 1, 0)),
            "bias": vgg[f"{idx}.bias"]}
    for k in range(5):
        params[f"lin_{k}"] = lin[f"lin{k}.model.1.weight"][0, :, 0, 0] \
            .reshape(-1, 1)
    return {"params": params}


def convert_lpips(vgg_features_sd: dict,
                  lpips_sd: dict) -> dict[str, torch.Tensor]:
    """torchvision VGG16 trunk + richzhang heads → the port's ``LPIPS``
    state_dict (heads [C, 1])."""
    return convert.convert_lpips_params(lpips_tree(vgg_features_sd, lpips_sd))
