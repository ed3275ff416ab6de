"""JAX-package parameters → the port's ``state_dict``.

Takes the parameter pytree of ``moditalker_tpu``'s ``ViTAutoencoder``,
``TriplaneUNet`` or AToM ``MotionDecoder`` as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``) and returns the
``state_dict`` of the port's module of the same name. No JAX is needed.

  * Dense kernel [in, out]       → Linear weight [out, in]
  * Conv kernel HWIO             → Conv2d weight OIHW
  * PatchToPixel kernel [p,p,o,c] → ConvTranspose2d layout [c, o, p, p]
    (the same axis permutation as HWIO → OIHW)
  * LayerNorm/GroupNorm ``scale`` → ``weight``

The packed qkv keeps the JAX layout, q|k|v-major with heads contiguous
inside each third: it is the layout the kernels read.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# flax list members `name_i` → the port's container `name.i` (or, for the
# quant-attention layer parts, `layers.i.name`)
_LISTS = re.compile(r"^(in_res|in_attn2d|in_joint|out_res|out_attn2d|out_up"
                    r"|out_joint)_(\d+)$")
_QUANT = re.compile(r"^(attn_norm|to_qkv|to_out|ff_norm|ff1|ff2)_(\d+)$")
_BLOCK = re.compile(r"^block_(\d+)$")
# AToM MotionDecoder: layer stacks, and the pooled-token projections whose
# flax members are `name_ln`, `name_fc1`, `name_fc2`
_ATOM_LISTS = re.compile(r"^(cond_encoder|face_encoder|decoder)_(\d+)$")
_ATOM_PROJ = re.compile(r"^(non_attn_(?:cond|face)_projection)_(ln|fc1|fc2)$")


def _module_path(names: list[str]) -> list[str]:
    out = []
    for n in names:
        if m := _BLOCK.match(n):
            out += ["blocks", m[1]]
        elif m := _QUANT.match(n):
            out += ["layers", m[2], m[1]]
        elif m := (_LISTS.match(n) or _ATOM_LISTS.match(n)
                   or _ATOM_PROJ.match(n)):
            out += [m[1], m[2]]
        else:
            out.append(n)
    return out


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


def _convert(params: dict) -> dict[str, torch.Tensor]:
    params = params.get("params", params)
    state: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + [key])
                continue
            val = np.asarray(val, dtype=np.float32)
            if path:
                leaf, val = _leaf(key, val)
                name = ".".join(_module_path(path) + [leaf])
            else:  # top-level parameters (plane tokens, positional tables)
                name = key
            state[name] = torch.tensor(val)

    walk(params, [])
    return state


def convert_ae_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """``ViTAutoencoder`` parameters → the port's ``ViTAutoencoder``
    state_dict."""
    return _convert(flax_params)


def convert_unet_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """``TriplaneUNet`` parameters → the port's ``TriplaneUNet``
    state_dict."""
    return _convert(flax_params)


def convert_atom_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """AToM ``MotionDecoder`` parameters → the port's ``MotionDecoder``
    state_dict. The three null embeddings are top-level parameters and keep
    their names and shapes."""
    return _convert(flax_params)
