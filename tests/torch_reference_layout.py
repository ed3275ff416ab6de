"""Reference-layout state_dicts made from the port's weights, for tests and
``chip_smoke.py`` (numpy and torch only: no JAX).

The published checkpoints are ``state_dict``s of the reference's own modules
(AToM's ``MotionDecoder``, MToV's ``ViTAutoencoder`` and ``UNetModel``,
richzhang's LPIPS heads over torchvision's VGG16). None is in the
repository, so the loaders are proven on files with the real key names and
shapes made here: ``flax_tree`` inverts ``utils/convert.py`` (the port's
``state_dict`` → the JAX package's parameter tree), and ``*_reference_sd``
invert ``utils/torch_port.py`` (that tree → the reference's layout, the
UNet's qkv rows head-major). ``tests/test_torch_golden.py`` holds each
inverse against the JAX package's own converters.
"""

import re

import numpy as np
import torch

_PROJ = re.compile(r"^non_attn_(cond|face)_projection$")


def _flax_path(parts: list[str]) -> list[str]:
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p == "blocks" and nxt is not None and nxt.isdigit():
            out.append(f"block_{nxt}")
            i += 2
        elif p == "layers" and nxt is not None and nxt.isdigit() \
                and i + 2 < len(parts):
            out.append(f"{parts[i + 2]}_{nxt}")
            i += 3
        elif nxt is not None and (nxt.isdigit() or (
                _PROJ.match(p) and nxt in ("ln", "fc1", "fc2"))):
            out.append(f"{p}_{nxt}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


# the inverse of utils/convert.py's kernel layouts, by rank
_KERNEL = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def flax_tree(state: dict) -> dict:
    """The port's ``state_dict`` (AToM, the AE, the UNet, LPIPS) → the flax
    ``{"params": ...}`` tree ``utils/convert.py`` maps onto it."""
    params: dict = {}
    for name, t in state.items():
        a = np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)
        parts = name.split(".")
        if len(parts) == 1:        # top-level parameters keep their names
            params[name] = a
            continue
        leaf = parts[-1]
        if leaf == "weight" and a.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf, a = "kernel", np.ascontiguousarray(a.transpose(_KERNEL[a.ndim]))
        node = params
        for p in _flax_path(parts[:-1]):
            node = node.setdefault(p, {})
        node[leaf] = a
    return {"params": params}


# ------------------------------------------ flax tree → reference layout
def _ilin(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _inorm(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _iconv(sd, name, p):
    k = np.asarray(p["kernel"])     # [*k, I, O] → [O, I, *k]
    n = k.ndim
    sd[f"{name}.weight"] = k.transpose(n - 1, n - 2, *range(n - 2))
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _idense_as_conv1x1(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _imha(sd, name, p):
    sd[f"{name}.in_proj_weight"] = np.concatenate(
        [np.asarray(p[f"{c}_proj"]["kernel"]).T for c in "qkv"])
    sd[f"{name}.in_proj_bias"] = np.concatenate(
        [np.asarray(p[f"{c}_proj"]["bias"]) for c in "qkv"])
    _ilin(sd, f"{name}.out_proj", p["out_proj"])


def atom_reference_sd(params, num_layers):
    p, sd = params["params"], {}
    for name, key in (("input_projection_lip", "input_projection_lip"),
                      ("input_projection_wo_lip", "input_projection_wo_lip"),
                      ("cond_projection", "cond_projection"),
                      ("face_projection", "face_projection"),
                      ("time_mlp.1", "time_mlp"),
                      ("to_time_cond.0", "to_time_cond"),
                      ("to_time_tokens.0", "to_time_tokens"),
                      ("final_layer", "final_layer")):
        _ilin(sd, name, p[key])
    _inorm(sd, "norm_cond", p["norm_cond"])
    for k in ("null_cond_embed", "null_cond_hidden", "face_null_cond_embed"):
        sd[k] = np.asarray(p[k])
    for enc in ("cond_encoder", "face_encoder"):
        for i in range(2):
            e, pre = p[f"{enc}_{i}"], f"{enc}.{i}"
            _inorm(sd, f"{pre}.norm1", e["norm1"])
            _inorm(sd, f"{pre}.norm2", e["norm2"])
            _imha(sd, f"{pre}.self_attn", e["self_attn"])
            _ilin(sd, f"{pre}.linear1", e["linear1"])
            _ilin(sd, f"{pre}.linear2", e["linear2"])
    for proj in ("non_attn_cond_projection", "non_attn_face_projection"):
        _inorm(sd, f"{proj}.0", p[f"{proj}_ln"])
        _ilin(sd, f"{proj}.1", p[f"{proj}_fc1"])
        _ilin(sd, f"{proj}.3", p[f"{proj}_fc2"])
    for i in range(num_layers):
        d, pre = p[f"decoder_{i}"], f"seqTransDecoder.stack.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _inorm(sd, f"{pre}.{n}", d[n])
        _imha(sd, f"{pre}.self_attn", d["self_attn"])
        _imha(sd, f"{pre}.multihead_attn", d["multihead_attn"])
        for f in ("film1", "film2", "film3"):
            _ilin(sd, f"{pre}.{f}.block.1", d[f]["proj"])
        _ilin(sd, f"{pre}.linear3", d["linear3"])
    return sd


def ae_reference_sd(params, depth, quant_depth):
    p, sd = params["params"], {}
    for part in ("encoder", "decoder"):
        t = p[part]
        if "to_patch_embedding" in t:
            _ilin(sd, f"{part}.to_patch_embedding", t["to_patch_embedding"])
        for i in range(depth):
            b = t[f"block_{i}"]
            for j, (norm, attn) in enumerate([("time_norm", "time_attn"),
                                              ("space_norm", "space_attn")]):
                pre = f"{part}.layers.{i}.{j}"
                _inorm(sd, f"{pre}.norm", b[norm])
                _ilin(sd, f"{pre}.fn.to_qkv", b[attn]["to_qkv"])
                _ilin(sd, f"{pre}.fn.to_out.0", b[attn]["to_out"])
            pre = f"{part}.layers.{i}.2"
            _inorm(sd, f"{pre}.norm", b["ff_norm"])
            _ilin(sd, f"{pre}.fn.net.0", b["ff"]["fc1"])
            _ilin(sd, f"{pre}.fn.net.3", b["ff"]["fc2"])
    for k in ("xy_token", "yt_token", "xt_token", "xy_pos_embedding",
              "yt_pos_embedding", "xt_pos_embedding"):
        sd[k] = np.asarray(p[k])
    for plane in ("xy", "yt", "xt"):
        q, pre = p[f"{plane}_quant_attn"], f"{plane}_quant_attn"
        for i in range(quant_depth):
            a, f = f"{pre}.layers.{i}.0", f"{pre}.layers.{i}.1"
            _inorm(sd, f"{a}.norm", q[f"attn_norm_{i}"])
            _ilin(sd, f"{a}.fn.to_qkv", q[f"to_qkv_{i}"])
            _ilin(sd, f"{a}.fn.to_out.0", q[f"to_out_{i}"])
            _inorm(sd, f"{f}.norm", q[f"ff_norm_{i}"])
            _ilin(sd, f"{f}.fn.net.0", q[f"ff1_{i}"])
            _ilin(sd, f"{f}.fn.net.3", q[f"ff2_{i}"])
    for name in ("pre_xy", "pre_yt", "pre_xt", "post_xy", "post_yt",
                 "post_xt"):
        _idense_as_conv1x1(sd, name, p[name])
    sd["to_pixel.1.weight"] = np.asarray(
        p["to_pixel"]["kernel"]).transpose(3, 2, 0, 1)
    sd["to_pixel.1.bias"] = np.asarray(p["to_pixel"]["bias"])
    return sd


def _iqkv(sd, name, p, heads):
    """q|k|v-major Dense → the reference's head-major qkv conv1d rows."""
    w = np.asarray(p["kernel"]).T          # [3C, C]
    b = np.asarray(p["bias"])
    three_c, c = w.shape
    dh = three_c // (3 * heads)
    sd[f"{name}.weight"] = w.reshape(3, heads, dh, c).transpose(
        1, 0, 2, 3).reshape(three_c, c)[:, :, None]
    sd[f"{name}.bias"] = b.reshape(3, heads, dh).transpose(1, 0, 2).reshape(
        three_c)


def unet_reference_sd(params, cfg):
    p, sd = params["params"], {}
    _ilin(sd, "time_embed.0", p["time_embed_1"])
    _ilin(sd, "time_embed.2", p["time_embed_2"])
    _iconv(sd, "input_blocks.0.0", p["input_conv"])
    _inorm(sd, "out.0", p["out_norm"])
    _iconv(sd, "out.2", p["out_conv"])

    def res(prefix, r):
        _inorm(sd, f"{prefix}.in_layers.0", r["in_norm"])
        _iconv(sd, f"{prefix}.in_layers.2", r["in_conv"])
        _ilin(sd, f"{prefix}.emb_layers.1", r["emb_proj"])
        _inorm(sd, f"{prefix}.out_layers.0", r["out_norm"])
        _iconv(sd, f"{prefix}.out_layers.3", r["out_conv"])
        if "skip" in r:
            _iconv(sd, f"{prefix}.skip_connection", r["skip"])

    def attn(prefix, a):
        _inorm(sd, f"{prefix}.norm", a["norm"])
        _iqkv(sd, f"{prefix}.qkv", a["qkv"], cfg.num_heads)
        _idense_as_conv1x1(sd, f"{prefix}.proj_out", a["proj_out"])

    i_res, block_idx, ds = 0, 1, 1
    levels = len(cfg.channel_mult)
    for level in range(levels):
        for j in range(cfg.num_res_blocks + (level != levels - 1)):
            res(f"input_blocks.{block_idx}.0", p[f"in_res_{i_res}"])
            if j < cfg.num_res_blocks and ds in cfg.attention_resolutions:
                attn(f"input_blocks.{block_idx}.1", p[f"in_attn2d_{i_res}"])
            attn(f"input_attns.{block_idx}", p[f"in_joint_{i_res + 1}"])
            if j == cfg.num_res_blocks:
                ds *= 2
            i_res += 1
            block_idx += 1
    res("middle_block.0", p["mid_res1"])
    attn("middle_block.1", p["mid_attn2d"])
    res("middle_block.2", p["mid_res2"])
    attn("mid_attn", p["mid_joint"])
    o = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            res(f"output_blocks.{o}.0", p[f"out_res_{o}"])
            li = 1
            if ds in cfg.attention_resolutions:
                attn(f"output_blocks.{o}.{li}", p[f"out_attn2d_{o}"])
                li += 1
            if level and i == cfg.num_res_blocks:
                res(f"output_blocks.{o}.{li}", p[f"out_up_{o}"])
                ds //= 2
            attn(f"output_attns.{o}", p[f"out_joint_{o}"])
            o += 1
    return sd


def unet_kw(cfg) -> dict:
    """The keyword arguments of ``convert_triplane_unet`` for ``cfg``."""
    return dict(num_res_blocks=cfg.num_res_blocks,
                channel_mult=cfg.channel_mult,
                attention_resolutions=cfg.attention_resolutions,
                num_heads=cfg.num_heads)


# ------------------------------------------------------------------ LPIPS
VGG16_TRUNK_FILE = "vgg16-397923af.pth"
VGG_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
              (10, 128, 256), (12, 256, 256), (14, 256, 256),
              (17, 256, 512), (19, 512, 512), (21, 512, 512),
              (24, 512, 512), (26, 512, 512), (28, 512, 512)]
LIN_CHANNELS = [64, 128, 256, 512, 512]


def write_vgg_files(d, full_model_prefix=True, trunk=True, seed=0):
    """{d}/vgg.pth (richzhang's lin heads) and torchvision's trunk file,
    with the real keys and shapes and random values."""
    rng = np.random.default_rng(seed)
    if trunk:
        sd = {}
        for idx, ci, co in VGG_CONVS:
            prefix = f"features.{idx}" if full_model_prefix else str(idx)
            sd[f"{prefix}.weight"] = torch.tensor(rng.normal(
                scale=(2 / (9 * ci)) ** 0.5,
                size=(co, ci, 3, 3)).astype(np.float32))
            sd[f"{prefix}.bias"] = torch.tensor(
                rng.normal(scale=0.01, size=co).astype(np.float32))
        torch.save(sd, str(d / VGG16_TRUNK_FILE))
    torch.save({f"lin{k}.model.1.weight": torch.tensor(
        rng.uniform(0, 1, size=(1, c, 1, 1)).astype(np.float32))
        for k, c in enumerate(LIN_CHANNELS)}, str(d / "vgg.pth"))
