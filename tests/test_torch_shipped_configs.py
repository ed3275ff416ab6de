"""Every shipped configuration (``configs/``) in the port against the JAX
package, on the CPU, with one torch thread.

* Each YAML file loads to the same ``Config`` in both packages, field for
  field, and ``longvid_config()`` equals the JAX package's.
* The 256-channel UNet (``configs/latent-diffusion/base_longvid.yaml``'s
  width at a small depth: one res block, channel_mult (1, 2), attention at
  ds = 1; the full latent 32 × 16, B = 1) against the JAX UNet in float32
  within DESIGN.md §6's 1e-3, weights carried by ``utils/convert.py``; with
  ``remat`` on it gives the output and gradients it gives with it off.
* Which kernel each of its attentions reaches: with stub libraries in place
  of the CUDA ones, the forward's launches by shape equal what the JAX
  package's gates decide on the same shapes (``packed_attention_viable``,
  ``onepass_attention_viable``, ``tiny_attention_viable``), at the small
  depth and at the full width (on the meta device, which allocates
  nothing), in bf16 and in float32: at 256 channels no head is 16 wide, so
  no packed kernel launches. With ``remat`` the recompute launches the
  kernels a second time.
"""

import dataclasses
import pathlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.models.mtov import TriplaneUNet as JUNet
from moditalker_tpu.ops.pallas import flash_attention as jflash
from moditalker_tpu.ops.pallas import packed_attention as jpack
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.models.mtov import TriplaneUNet
from moditalker_tpu_torch.models.mtov.unet import SelfAttentionBlock
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.utils.convert import convert_unet_params

from .torch_stubs import stub_launches  # noqa: F401 (fixture)
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
SHIPPED = ["autoencoder/base.yaml", "autoencoder/base_gan.yaml",
           "autoencoder/base_ldmk.yaml", "latent-diffusion/base.yaml",
           "latent-diffusion/base_longvid.yaml", "tiny.yaml"]

# the 256-channel UNet at a small depth: dh = 32 at ds = 1, and dh = 64 in
# the joint attention after the last upsample (C = 512)
SMALL_256 = dict(model_channels=256, num_res_blocks=1, channel_mult=(1, 2),
                 attention_resolutions=(1,))
L = 2048        # 32·32 + 2·16·32: the full latent, so every gate is asked


def test_every_shipped_file_is_listed():
    assert sorted(str(p.relative_to(CONFIGS))
                  for p in CONFIGS.rglob("*.yaml")) == sorted(SHIPPED)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_loads_as_in_jax(name):
    path = str(CONFIGS / name)
    assert (dataclasses.asdict(tcfg.load_config(path))
            == dataclasses.asdict(jcfg.load_config(path)))


def test_longvid_config_matches_jax():
    got = tcfg.longvid_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg.longvid_config())
    assert got.mtov_unet.model_channels == 256
    assert got.mtov_unet == tcfg.load_config(
        str(CONFIGS / "latent-diffusion/base_longvid.yaml")).mtov_unet


# ------------------------------------------------------------ the UNet
def _inputs(b=1, seed=1):
    rng = np.random.default_rng(seed)
    x, cond, ic = (rng.normal(size=(b, c, L)).astype(np.float32)
                   for c in (4, 8, 4))
    return x, cond, ic, np.array([417] * b, np.int32)


def _jax_params(seed=0):
    """The JAX UNet's parameters, as numpy; its zero-initialised layers
    (each res block's last conv, each attention's projection, the output
    conv, the biases) get a small random value so the comparison sees every
    layer."""
    unet = JUNet(jcfg.MtovUNetConfig(**SMALL_256))
    zeros = jnp.zeros((1, 4, L))
    params = jax.jit(unet.init)(jax.random.PRNGKey(seed), zeros,
                                jnp.zeros((1, 8, L)), zeros,
                                jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    return unet, jax.tree_util.tree_map(
        lambda a: np.asarray(a) if np.asarray(a).any() else
        (0.02 * rng.normal(size=a.shape)).astype(np.float32), params)


def _port(params):
    unet = TriplaneUNet(tcfg.MtovUNetConfig(**SMALL_256))
    unet.load_state_dict(convert_unet_params(params))
    return unet


def test_unet_256_matches_jax():
    junet, params = _jax_params()
    x, cond, ic, t = _inputs()
    want = np.asarray(jax.jit(junet.apply)(params, x, cond, ic, t))
    with torch.no_grad():
        got = _port(params)(*map(torch.from_numpy, (x, cond, ic)),
                            torch.from_numpy(t).long())
    assert got.shape == (1, 4, L)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_unet_256_remat_gives_the_output_and_gradients_of_no_remat():
    torch.manual_seed(0)
    state = TriplaneUNet(tcfg.MtovUNetConfig(**SMALL_256)).state_dict()
    x, cond, ic, t = _inputs(seed=2)
    results = {}
    for remat in (False, True):
        unet = TriplaneUNet(tcfg.MtovUNetConfig(**SMALL_256), remat=remat)
        unet.load_state_dict(state)
        # the output layers start at zero: move them so that every
        # parameter gets a gradient
        with torch.no_grad():
            for p in unet.parameters():
                if not p.any():
                    p.copy_(0.02 * torch.randn(
                        p.shape, generator=torch.Generator().manual_seed(
                            p.numel())))
        out = unet(*map(torch.from_numpy, (x, cond, ic)),
                   torch.from_numpy(t).long())
        out.square().mean().backward()
        results[remat] = (out.detach(), {n: p.grad
                                         for n, p in unet.named_parameters()})
    (out0, g0), (out1, g1) = results[False], results[True]
    np.testing.assert_allclose(out1.numpy(), out0.numpy(), rtol=0,
                               atol=1e-6 * float(out0.abs().max()))
    assert g0.keys() == g1.keys()
    for name in g0:
        top = float(g0[name].abs().max())
        assert top > 0, name
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=0, atol=1e-6 * top, err_msg=name)


# ------------------------------------------------------------ the gates
def _jax_launches(shapes, heads: int) -> dict:
    """{kernel: Counter(shape)} as the JAX package's gates send each
    attention block's input [B, C, L]: the packed kernel on [B, L, 3C], else
    the head-split [B·H, L, C/H] to the one-pass or the tiny-L kernel (its
    ``sdpa``), else no kernel."""
    want = {name: Counter() for name in tkernels.LAUNCHES}
    for b, c, l in shapes:
        dh, b3 = c // heads, b * heads
        if jpack.packed_attention_viable(l, c, heads):
            want["packed_attention"][(b, l, 3 * c)] += 1
        elif jflash.onepass_attention_viable(l, l, dh):
            want["onepass_attention"][(b3, l, dh)] += 1
        elif jflash.tiny_attention_viable(b3, l, l, dh):
            want["tiny_attention"][(b3, l, dh)] += 1
    return {name: dict(by) for name, by in want.items() if by}


def _launches(float32_only=False) -> dict:
    table = (tkernels.FLOAT32_LAUNCHES_BY_SHAPE if float32_only
             else tkernels.LAUNCHES_BY_SHAPE)
    return {name: dict(by) for name, by in table.items() if by}


def _attention_shapes(unet):
    """Records the [B, C, L] input of every attention block call."""
    shapes = []
    for m in unet.modules():
        if isinstance(m, SelfAttentionBlock):
            m.register_forward_hook(
                lambda mod, args, out: shapes.append(tuple(args[0].shape)))
    return shapes


# (config, batch, expected one-pass launches per forward): the small depth
# at B = 1, and base_longvid.yaml at sampling's B = 2 and train-diffusion's
# B = 10 (diffusion_batch_size); 8 heads, so [B·8, L, C/8]
GATE_CASES = {
    "small_b1": (SMALL_256, 1, {(8, 2048, 32): 3, (8, 1024, 32): 3,
                                (8, 2048, 64): 1}),
    "longvid_b2": ({}, 2, {(16, 2048, 32): 5, (16, 1024, 32): 5,
                           (16, 2048, 64): 1}),
    "longvid_b10": ({}, 10, {(80, 2048, 32): 5, (80, 1024, 32): 5,
                             (80, 2048, 64): 1}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
@pytest.mark.parametrize("case", list(GATE_CASES))
def test_unet_256_launches_follow_the_jax_gates(stub_launches, case, dtype):
    overrides, b, onepass = GATE_CASES[case]
    cfg = dataclasses.replace(tcfg.longvid_config().mtov_unet, **overrides)
    with torch.device("meta"):
        unet = TriplaneUNet(cfg, dtype)
        shapes = _attention_shapes(unet)
        out = unet(torch.empty(b, 4, L), torch.empty(b, 8, L, dtype=dtype),
                   torch.empty(b, 4, L, dtype=dtype),
                   torch.zeros(b, dtype=torch.long))
    assert out.shape == (b, 4, L)
    f32 = dtype == torch.float32
    assert _launches() == _jax_launches(shapes, cfg.num_heads) \
        == {"onepass_attention": onepass}
    assert _launches(float32_only=True) == (
        {"onepass_attention": onepass} if f32 else {})
    # float32: the joint attention after the last upsample, [B·8, 2048,
    # 64], past resident K through the pre-pass and the bf16 K ring
    assert Counter(stub_launches) == (
        {"fused_attention_f32": sum(onepass.values()) - onepass[(8 * b, 2048,
                                                                 64)],
         tflash.PREROUNDED_ENTRY: onepass[(8 * b, 2048, 64)]} if f32
        else {"fused_attention": sum(onepass.values())})


@pytest.mark.parametrize("remat", [False, True])
def test_longvid_train_step_launches(stub_launches, remat):
    """A float32 forward and backward at train-diffusion's B = 10 and full
    width: the one-pass kernel at three shapes, and with ``remat`` each
    launch again in the recompute (the counters count both)."""
    cfg = tcfg.longvid_config().mtov_unet
    b, per_call = 10, GATE_CASES["longvid_b10"][2]
    with torch.device("meta"):
        unet = TriplaneUNet(cfg, remat=remat)
        out = unet(torch.empty(b, 4, L), torch.empty(b, 8, L),
                   torch.empty(b, 4, L), torch.zeros(b, dtype=torch.long))
        assert _launches() == {"onepass_attention": per_call}
        out.square().mean().backward()
    assert _launches(float32_only=True) == {"onepass_attention": {
        shape: n * (2 if remat else 1) for shape, n in per_call.items()}}
    assert all(p.grad is not None for p in unet.parameters())
