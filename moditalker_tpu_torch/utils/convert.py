"""JAX-package parameters → the port's ``state_dict``.

Takes the variables of ``moditalker_tpu``'s ``ViTAutoencoder``,
``TriplaneUNet``, AToM ``MotionDecoder``, ``HubertEncoder``, ``S3FD``,
``FAN``, ``ReconNet``, ``LPIPS``, the two PatchGAN discriminators or
``InceptionI3d`` as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, variables)``) and returns the
``state_dict`` of the port's module of the same name; and the JAX trainers'
states (``FirstStageState``, AToM's and the latent-diffusion
``TrainState``), optimizer states included, as trees the port's trainers
load (``load_optimizer_state``). No JAX is needed.

A JAX train state reaches the port on a host that has JAX: there
``moditalker_tpu.core.checkpoint.load_single`` reads the orbax directory
(it restores NamedTuples as dicts and tuples as lists; both forms are
taken here), ``convert_*_state`` converts it and the port's
``core.checkpoint.save_single`` writes it. The port reads no orbax files.

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

import copy
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
            if val is None or isinstance(val, (tuple, list)):
                continue    # optax's masked-out leaves (MaskedNode)
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


def _plain(tree):
    """NamedTuples → dicts and tuples → lists, recursively: the form orbax
    restores a JAX state in."""
    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _adam(opt_state) -> dict:
    """The ``ScaleByAdamState`` (count, mu, nu) inside an ``optax.adamw``
    chain's state; under ``optax.multi_transform`` (the landmark AE's frozen
    decoder) the trained branch's."""
    if isinstance(opt_state, dict) and "inner_states" in opt_state:
        opt_state = opt_state["inner_states"]["train"]
        opt_state = opt_state.get("inner_state", opt_state)
    return opt_state[0]


def _adamw_state(opt_state, convert_fn) -> dict:
    adam = _adam(opt_state)
    return {"step": int(np.asarray(adam["count"])),
            "exp_avg": convert_fn(adam["mu"]),
            "exp_avg_sq": convert_fn(adam["nu"])}


def _disc_pair(tree: dict) -> dict[str, torch.Tensor]:
    """{"d2": variables, "d3": variables} → one dict keyed ``disc2d.<name>``
    and ``disc3d.<name>`` (the first-stage D optimizer's parameters)."""
    return {f"disc{tag[1]}d.{k}": v for tag in ("d2", "d3")
            for k, v in convert_disc_params(tree[tag]).items()}


def convert_first_stage_state(state) -> dict:
    """The JAX ``FirstStageState`` (the NamedTuple, its ``_asdict()`` or
    orbax's restored dict) → the port's ``FirstStageTrainer`` state:
    {ae_params, disc2d, disc3d, lpips_params, g_opt, d_opt, step}. Each
    optimizer is AdamW's step and moments (``exp_avg``/``exp_avg_sq`` by
    parameter name) and ``optax.MultiSteps``' ``mini_step`` and running
    mean ``acc_grads``; the D optimizer's names are ``disc2d.*`` and
    ``disc3d.*``."""
    state = _plain(state)

    def multi_steps(ms, convert_fn):
        return {**_adamw_state(ms["inner_opt_state"], convert_fn),
                "mini_step": int(np.asarray(ms["mini_step"])),
                "acc_grads": convert_fn(ms["acc_grads"])}

    return {"ae_params": convert_ae_params(state["ae_params"]),
            "disc2d": convert_disc_params(state["disc2d"]),
            "disc3d": convert_disc_params(state["disc3d"]),
            "lpips_params": convert_lpips_params(state["lpips_params"]),
            "g_opt": multi_steps(state["g_opt"], convert_ae_params),
            "d_opt": multi_steps(state["d_opt"], _disc_pair),
            "step": int(np.asarray(state["step"]))}


def convert_atom_state(state) -> dict:
    """The JAX AToM ``TrainState`` (params, ema_params, Adan's
    ``AdanState``, step) → the port's ``AtomTrainer`` state: {params,
    ema_params, optimizer: {step, m, v, n, prev_grad}, step}."""
    state = _plain(state)
    adan = state["opt_state"]
    return {"params": convert_atom_params(state["params"]),
            "ema_params": convert_atom_params(state["ema_params"]),
            "optimizer": {"step": int(np.asarray(adan["count"])),
                          **{k: convert_atom_params(adan[k])
                             for k in ("m", "v", "n", "prev_grad")}},
            "step": int(np.asarray(state["step"]))}


def convert_mtov_state(state) -> dict:
    """The JAX latent-diffusion ``TrainState`` (params, ema_params,
    ``optax.adamw``'s state, step) → the port's ``MtovDiffusionTrainer``
    state: {params, ema_params, optimizer: {step, exp_avg, exp_avg_sq},
    step}."""
    state = _plain(state)
    return {"params": convert_unet_params(state["params"]),
            "ema_params": convert_unet_params(state["ema_params"]),
            "optimizer": _adamw_state(state["opt_state"],
                                      convert_unet_params),
            "step": int(np.asarray(state["step"]))}


def load_optimizer_state(opt: torch.optim.Optimizer, named_params,
                         state: dict) -> None:
    """Set ``opt``'s state from ``state``: a torch ``state_dict`` (it has
    ``param_groups``: what the port's trainers save), or a converted one
    ({step, <moment>: {parameter name: tensor}}, ``convert_*_state``), which
    is matched to ``named_params`` by name; a parameter it names no moment
    for (a frozen one) keeps none. The optimizer gets copies: a state taken
    from a live trainer stays that trainer's."""
    if "param_groups" in state:
        # torch's load_state_dict keeps the tensors it is given
        opt.load_state_dict(copy.deepcopy(state))
        return
    step = int(state["step"])
    moments = {k: v for k, v in state.items() if isinstance(v, dict)}
    for name, p in named_params:
        if not all(name in m for m in moments.values()):
            continue
        st = {k: m[name].to(p.device, p.dtype).clone()
              for k, m in moments.items()}
        # torch's Adam family keeps the step as a float32 tensor
        st["step"] = (torch.tensor(float(step), dtype=torch.float32)
                      if isinstance(opt, torch.optim.Adam | torch.optim.AdamW)
                      else step)
        opt.state[p] = st
