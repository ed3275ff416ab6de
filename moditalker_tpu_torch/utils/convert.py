"""JAX-package parameters → the port's ``state_dict``.

Takes the variables of ``moditalker_tpu``'s ``ViTAutoencoder``,
``TriplaneUNet``, AToM ``MotionDecoder``, ``HubertEncoder``, ``S3FD``,
``FAN``, ``ReconNet``, ``LPIPS``, the two PatchGAN discriminators or
``InceptionI3d`` as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, variables)``) and returns the
``state_dict`` of the port's module of the same name; and the JAX
first-stage trainer's state as a tree of such ``state_dict``s. No JAX is
needed.

  * Dense kernel [in, out]       → Linear weight [out, in]
  * Conv kernel HWIO             → Conv2d weight OIHW
  * Conv3D kernel DHWIO          → Conv3d weight OIDHW
  * Conv1D kernel [k, I/g, O]    → Conv1d weight [O, I/g, k]
  * PatchToPixel kernel [p,p,o,c] → ConvTranspose2d layout [c, o, p, p]
    (the same axis permutation as HWIO → OIHW)
  * LayerNorm/GroupNorm/BatchNorm ``scale`` → ``weight``
  * BatchNorm ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` /
    ``running_var``, beside a ``num_batches_tracked`` of 0 (eval mode
    never reads it; torch's ``state_dict`` carries it)

The reference networks' own torch checkpoints (transformers' HuBERT,
face_alignment's S3FD and FAN, Deep3DFaceRecon's ResNet-50) reach the port
in two steps: ``preprocess/<net>.py::convert_<net>`` turns such a
``state_dict`` into the JAX package's tree, and the entry here turns that
tree into the port's ``state_dict``.

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
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


_STATS = {"mean": "running_mean", "var": "running_var"}


def _convert(variables: dict) -> dict[str, torch.Tensor]:
    params = variables.get("params", variables)
    state: dict[str, torch.Tensor] = {}

    def walk(tree, path, leaf_fn):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + [key], leaf_fn)
                continue
            val = np.asarray(val, dtype=np.float32)
            if path:
                leaf, val = leaf_fn(key, val)
                name = ".".join(_module_path(path) + [leaf])
            else:  # top-level parameters (plane tokens, positional tables)
                name = key
            state[name] = torch.tensor(val)

    walk(params, [], _leaf)
    walk(variables.get("batch_stats", {}), [],
         lambda key, val: (_STATS[key], val))
    for name in [n for n in state if n.endswith(".running_mean")]:
        module = name[:-len(".running_mean")]
        state[f"{module}.num_batches_tracked"] = torch.tensor(0)
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


def convert_hubert_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """``HubertEncoder`` parameters → the port's ``HubertEncoder``
    state_dict (the 1-D conv kernels of the feature extractor and the
    grouped positional conv become Conv1d weights)."""
    return _convert(flax_params)


def convert_s3fd_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """``S3FD`` parameters → the port's ``S3FD`` state_dict; the L2Norm
    scales keep the name ``weight``."""
    return _convert(flax_params)


def convert_fan_params(flax_variables: dict) -> dict[str, torch.Tensor]:
    """``FAN`` variables (``params`` and ``batch_stats``) → the port's
    ``FAN`` state_dict, running statistics included."""
    return _convert(flax_variables)


def convert_recon_params(flax_variables: dict) -> dict[str, torch.Tensor]:
    """``ReconNet`` variables (``params`` and ``batch_stats``) → the port's
    ``ReconNet`` state_dict, running statistics included."""
    return _convert(flax_variables)


def convert_lpips_params(flax_params: dict) -> dict[str, torch.Tensor]:
    """``LPIPS`` parameters → the port's ``LPIPS`` state_dict (the VGG16
    trunk under ``net.conv_i``; the ``lin_k`` heads keep their [C, 1]
    layout)."""
    return _convert(flax_params)


def convert_disc_params(flax_variables: dict) -> dict[str, torch.Tensor]:
    """``PatchDiscriminator2D`` / ``3D`` variables → the port's state_dict.
    Their ``batch_stats`` are dropped: the discriminators always normalise
    with the batch's statistics, and the port's keep none."""
    return _convert({"params": flax_variables.get("params", flax_variables)})


def convert_i3d_params(flax_variables: dict) -> dict[str, torch.Tensor]:
    """``InceptionI3d`` variables (``params`` and ``batch_stats``) → the
    port's ``InceptionI3d`` state_dict, running statistics included."""
    return _convert(flax_variables)


def convert_first_stage_state(state: dict) -> dict:
    """The JAX ``FirstStageState`` (as a dict: ``state._asdict()``) → the
    port's ``FirstStageTrainer`` state: {ae_params, disc2d, disc3d,
    lpips_params, step}. The optimizer states are not carried across (optax
    and torch keep different trees): a trainer loaded from it starts its
    AdamW moments and accumulation afresh."""
    return {"ae_params": convert_ae_params(state["ae_params"]),
            "disc2d": convert_disc_params(state["disc2d"]),
            "disc3d": convert_disc_params(state["disc3d"]),
            "lpips_params": convert_lpips_params(state["lpips_params"]),
            "step": int(np.asarray(state["step"]))}
