"""``MtovDDPM``'s samplers against the JAX package's, eps and x0.

The tiny config (configs/tiny.yaml's UNet, T = 20), float32, CPU, the
JAX package's UNet parameters converted. jax.random streams cannot be
reproduced in torch, so the port's samplers are handed the JAX draws in
the order they consume them, made with the JAX code's key splits
(``tests/test_torch_sample.py``'s ``Feed``; for the ancestral loop
core/diffusion.py:291-296: x, then one draw per step, t = T − 1 first).
Latents within 1e-3 of the largest (DESIGN.md §6, AE/UNet).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.models.mtov.ddpm import MtovDDPM as JDDPM
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import diffusion as tdiff
from moditalker_tpu_torch.models.mtov.ddpm import MtovDDPM

from .test_torch_mtov_models import (TINY_AE, TINY_DIFF, TINY_UNET,
                                     jax_params, port_unet)
from .test_torch_sample import Feed, _normal, noised_draws, plain_draws
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

LIMIT = 1e-3
RATIO = 0.5
PARAMETERIZATIONS = ["eps", "x0"]


def _ddpms(parameterization, **diff):
    """(JAX MtovDDPM, its UNet parameters, the port's MtovDDPM) at the tiny
    config."""
    diff = dict(TINY_DIFF, parameterization=parameterization, **diff)
    up = jax_params()[2]
    jd = JDDPM.create(jcfg.MtovUNetConfig(**TINY_UNET),
                      jcfg.MtovDiffusionConfig(**diff), dtype=jnp.float32)
    td = MtovDDPM.create(port_unet(up), tcfg.MtovDiffusionConfig(**diff))
    return jd, up, td


def _conditioning(seed=0):
    """(shape, cond, image_cond) as numpy: the UNet's latent [B, 4, L],
    its [B, 8, L] and [B, 4, L] conditions."""
    latent_len = jcfg.MtovAEConfig(**TINY_AE).latent_len
    rng = np.random.default_rng(seed)
    shape = (2, 4, latent_len)
    cond = rng.normal(size=(2, 8, latent_len)).astype(np.float32)
    image_cond = rng.normal(size=shape).astype(np.float32)
    return shape, cond, image_cond


def ancestral_draws(key, shape, steps):
    """p_sample_loop's draws (diffusion.py:291-296): x, then the per-step
    keys of one split, in the order the steps run."""
    key, sub = jax.random.split(key)
    return [_normal(sub, shape)] + [_normal(k, shape)
                                    for k in jax.random.split(key, steps)]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=LIMIT * np.abs(want).max())


@pytest.mark.parametrize("parameterization", PARAMETERIZATIONS)
def test_ddim_sample_matches_jax(parameterization):
    jd, up, td = _ddpms(parameterization)
    shape, cond, ic = _conditioning()
    key = jax.random.PRNGKey(5)
    want = jd.ddim_sample(up, key, shape, jnp.asarray(cond), jnp.asarray(ic))
    feed = Feed(plain_draws(key, shape, TINY_DIFF["sampling_timesteps"]))
    with torch.no_grad():
        got = td.ddim_sample(shape, torch.tensor(cond), torch.tensor(ic),
                             generator=feed)
    assert not feed.draws
    _close(got, want)


@pytest.mark.parametrize("parameterization", PARAMETERIZATIONS)
def test_ddim_sample_noised_start_matches_jax(parameterization):
    jd, up, td = _ddpms(parameterization, sampling_timesteps=4)
    shape, cond, ic = _conditioning(1)
    x0 = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jd.ddim_sample_noised_start(
        up, key, jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(ic),
        jnp.asarray(RATIO, jnp.float32))
    start = tdiff.noised_start_indices(TINY_DIFF["timesteps"], 4, RATIO)[1]
    feed = Feed(noised_draws(key, shape, 4, start))
    with torch.no_grad():
        got = td.ddim_sample_noised_start(torch.tensor(x0), torch.tensor(cond),
                                          torch.tensor(ic), RATIO,
                                          generator=feed)
    assert not feed.draws
    _close(got, want)


@pytest.mark.parametrize("parameterization", PARAMETERIZATIONS)
def test_p_sample_loop_matches_jax(parameterization):
    """The ancestral loop over all T = 20 steps."""
    jd, up, td = _ddpms(parameterization)
    shape, cond, ic = _conditioning(3)
    key = jax.random.PRNGKey(7)
    want = jd.p_sample_loop(up, key, shape, jnp.asarray(cond),
                            jnp.asarray(ic))
    feed = Feed(ancestral_draws(key, shape, TINY_DIFF["timesteps"]))
    with torch.no_grad():
        got = td.p_sample_loop(shape, torch.tensor(cond), torch.tensor(ic),
                               generator=feed)
    assert not feed.draws
    _close(got, want)


@pytest.mark.parametrize("branch", ["ancestral", "ddim", "noised"])
def test_sample_dispatches_as_jax(branch):
    """``sample`` (x0): the ancestral loop when sampling_timesteps >=
    timesteps, DDIM below that, the partial renoise where a start latent is
    given; each against the JAX package's ``sample`` with its draws."""
    steps = {"ancestral": TINY_DIFF["timesteps"], "ddim": 2, "noised": 4}
    jd, up, td = _ddpms("x0", sampling_timesteps=steps[branch])
    shape, cond, ic = _conditioning(4)
    key = jax.random.PRNGKey(8)
    x0 = np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)
    start = x0 if branch == "noised" else None
    want = jd.sample(up, key, shape[0], jnp.asarray(cond), jnp.asarray(ic),
                     noised_start=None if start is None else jnp.asarray(x0),
                     ratio=None if start is None else jnp.asarray(
                         RATIO, jnp.float32),
                     latent_len=shape[2], channels=shape[1])
    if branch == "ancestral":
        draws = ancestral_draws(key, shape, TINY_DIFF["timesteps"])
    elif branch == "ddim":
        draws = plain_draws(key, shape, steps[branch])
    else:
        draws = noised_draws(key, shape, steps[branch], tdiff.
                             noised_start_indices(TINY_DIFF["timesteps"],
                                                  steps[branch], RATIO)[1])
    feed = Feed(draws)
    with torch.no_grad():
        got = td.sample(shape[0], torch.tensor(cond), torch.tensor(ic),
                        generator=feed,
                        noised_start=None if start is None else
                        torch.tensor(x0), ratio=RATIO, latent_len=shape[2],
                        channels=shape[1])
    assert not feed.draws
    assert dataclasses.asdict(td.cfg)["parameterization"] == "x0"
    _close(got, want)
