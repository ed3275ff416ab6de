"""The port's MToV models vs the JAX package at the configs/tiny.yaml sizes.

Weights are drawn by the JAX package's initialisers and carried across by
``moditalker_tpu_torch.utils.convert``; both packages run in float32 on the
CPU. Tolerance 1e-3 for the AE and UNet (DESIGN.md §6), 1e-6 for the
schedule tables.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import schedules as jsched
from moditalker_tpu.models.mtov import TriplaneUNet as JUNet
from moditalker_tpu.models.mtov import ViTAutoencoder as JAE
from moditalker_tpu.models.mtov import unet as junet
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import schedules
from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
from moditalker_tpu_torch.models.mtov.unet import (group_norm_32,
                                                   timestep_embedding)
from moditalker_tpu_torch.utils.convert import (convert_ae_params,
                                                convert_unet_params)

# configs/tiny.yaml, copied: the port does not read the JAX config loader
TINY_AE = dict(channels=32, resolution=32, timesteps=4, embed_dim=4, depth=1,
               heads=2, dim_head=8, quant_depth=1, quant_heads=2,
               quant_mlp_dim=16, down=3)
TINY_UNET = dict(model_channels=32, num_res_blocks=1,
                 attention_resolutions=(1, 2), channel_mult=(1, 2),
                 num_heads=2, latent_res=4, latent_t=4)
TINY_DIFF = dict(timesteps=20, sampling_timesteps=2)


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = 0):
    """(ae_rgb, ae_ldmk, unet) JAX parameters at the tiny config, as numpy.
    The UNet's zero-initialised output layers get a small random offset so
    the comparison sees every layer."""
    ae = JAE(jcfg.MtovAEConfig(**TINY_AE))
    ucfg = jcfg.MtovUNetConfig(**TINY_UNET)
    unet = JUNet(ucfg)
    v = jnp.zeros((1, 4, 32, 32, 3))
    L = jcfg.MtovAEConfig(**TINY_AE).latent_len
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    ae_init = jax.jit(ae.init)
    rgb = ae_init(k[0], v)
    ldmk = ae_init(k[1], v)
    up = jax.jit(unet.init)(k[2], jnp.zeros((1, 4, L)), jnp.zeros((1, 8, L)),
                            jnp.zeros((1, 4, L)), jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    up = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        to_np(up))
    return to_np(rgb), to_np(ldmk), up


def port_ae(params):
    ae = ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE))
    ae.load_state_dict(convert_ae_params(params))
    return ae.eval()


def port_unet(params):
    unet = TriplaneUNet(tcfg.MtovUNetConfig(**TINY_UNET))
    unet.load_state_dict(convert_unet_params(params))
    return unet.eval()


def test_configs_match_jax_defaults():
    for name in ("MtovAEConfig", "MtovUNetConfig", "MtovDiffusionConfig",
                 "MtovLossConfig"):
        assert (vars(getattr(tcfg, name)()) == vars(getattr(jcfg, name)())), name
    assert tcfg.MtovAEConfig().latent_len == jcfg.MtovAEConfig().latent_len
    assert tcfg.MtovAEConfig(**TINY_AE).latent_len == 48


def test_autoencoder_extract_and_decode_match_jax():
    rgb, _, _ = jax_params()
    jae = JAE(jcfg.MtovAEConfig(**TINY_AE))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 4, 32, 32, 3)).astype(
        np.float32)
    z = np.asarray(jax.jit(functools.partial(jae.apply, method=jae.extract))(
        rgb, x))
    ae = port_ae(rgb)
    with torch.no_grad():
        np.testing.assert_allclose(ae.extract(torch.from_numpy(x)).numpy(), z,
                                   rtol=0, atol=1e-3)
        want = jax.jit(functools.partial(
            jae.apply, method=jae.decode_from_sample))(rgb, z)
        got = ae.decode_from_sample(torch.tensor(z)).numpy()
    assert got.shape == (2, 4, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)


def test_triplane_unet_matches_jax():
    _, _, up = jax_params()
    L = 48
    rng = np.random.default_rng(1)
    x, cond, ic = (rng.normal(size=(2, c, L)).astype(np.float32)
                   for c in (4, 8, 4))
    t = np.array([3, 17], np.int32)
    want = jax.jit(JUNet(jcfg.MtovUNetConfig(**TINY_UNET)).apply)(
        up, x, cond, ic, t)
    with torch.no_grad():
        got = port_unet(up)(torch.from_numpy(x), torch.from_numpy(cond),
                            torch.from_numpy(ic), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_converted_state_dicts_are_complete():
    rgb, _, up = jax_params()
    for module, sd in ((ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE)),
                        convert_ae_params(rgb)),
                       (TriplaneUNet(tcfg.MtovUNetConfig(**TINY_UNET)),
                        convert_unet_params(up))):
        ref = module.state_dict()
        assert sorted(sd) == sorted(ref)
        for k, v in sd.items():
            assert v.shape == ref[k].shape, k


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 999], np.int32)
    want = junet.timestep_embedding(jnp.asarray(t), 128)
    got = timestep_embedding(torch.from_numpy(t).long(), 128)
    # arguments reach 999 rad, where one float32 ulp is 6e-5: XLA's and
    # torch's cos/sin differ by a fraction of that
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("offset,std", [(0.0, 1.0), (10.0, 1.0),
                                        (100.0, 1.0), (50.0, 0.1),
                                        (-30.0, 5.0)])
def test_group_norm_one_pass_variance_at_production_scales(offset, std):
    """The shifted one-pass variance at the production shape [4, 2048, 512]
    with |mean| ≫ std, against an fp64 two-pass reference (the case of
    tests/test_mtov_parity.py) and against the JAX function. The port's
    channel axis is 1."""
    rng = np.random.default_rng(0)
    b, l, c, g = 4, 2048, 512, 32
    x64 = rng.normal(loc=offset, scale=std, size=(b, l, c))
    xg = x64.reshape(b, l, g, c // g)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = ((xg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    ref = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(b, l, c)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    x32 = x64.astype(np.float32)
    got = group_norm_32(torch.from_numpy(x32).transpose(1, 2),
                        torch.from_numpy(ones), torch.from_numpy(zeros),
                        num_groups=g).transpose(1, 2).double().numpy()
    assert np.abs(got - ref).max() < 1e-3
    jgot = np.asarray(junet.group_norm_32(jnp.asarray(x32), ones, zeros, g))
    # the same 1e-3 bound both hold against fp64: summation order differs
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-3)


def test_schedule_tables_match_jax():
    d = tcfg.MtovDiffusionConfig()
    want = jsched.make_schedule("linear", d.timesteps, d.linear_start,
                                d.linear_end)
    got = schedules.make_schedule("linear", d.timesteps, d.linear_start,
                                  d.linear_end)
    assert got.num_timesteps == want.num_timesteps
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for a, b in zip(schedules.ddim_time_pairs(1000, 100),
                    jsched.ddim_time_pairs(1000, 100)):
        np.testing.assert_array_equal(a, b)
