"""The port's AToM modules vs the JAX package at a small config.

Weights are drawn by the JAX package's initialisers and carried across by
``moditalker_tpu_torch.utils.convert``; inputs come from a numpy seed; both
packages run in float32 on the CPU. The samplers are handed the JAX draws
(``Feed``, as in tests/test_torch_sample.py). Tolerances: model and samplers
2e-4, rotary and schedule tables 1e-6 (DESIGN.md §6).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import diffusion as jdiff
from moditalker_tpu.core import schedules as jsched
from moditalker_tpu.models.atom import decoder as jdec
from moditalker_tpu.models.atom.diffusion import AtomDiffusion as JAtomDiffusion
from moditalker_tpu.ops import attention as jattn
from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.pipelines import atom_infer as jinfer
from moditalker_tpu.preprocess.bfm import Face3DHelper as JFace3D
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import diffusion as tdiff
from moditalker_tpu_torch.core import schedules as tsched
from moditalker_tpu_torch.models.atom import AtomDiffusion, MotionDecoder
from moditalker_tpu_torch.models.atom.decoder import sinusoidal_pos_emb
from moditalker_tpu_torch.ops import attention, rotary
from moditalker_tpu_torch.pipelines import atom_infer as tinfer
from moditalker_tpu_torch.preprocess.bfm import Face3DHelper
from moditalker_tpu_torch.utils.convert import convert_atom_params

from .test_torch_sample import Feed, _normal, plain_draws

# configs/tiny.yaml's AToM sections, copied
TINY_MODEL = dict(horizon=12, latent_dim=32, ff_size=64, num_layers=2,
                  num_heads=2)
TINY_DIFF = dict(n_timesteps=20, sampling_steps=2)
H, D = TINY_MODEL["horizon"], 204
TOL = dict(rtol=0, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@functools.lru_cache(maxsize=None)
def jax_params():
    mc = jcfg.AtomModelConfig(**TINY_MODEL)
    m = jdec.MotionDecoder(mc)
    params = jax.jit(m.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, D)), jnp.zeros((1, H, D)),
        jnp.zeros((1, 2 * H, mc.cond_feature_dim)), jnp.zeros((1,), "int32"))
    return jax.tree_util.tree_map(np.asarray, params)


def _models(diff=TINY_DIFF):
    jd = JAtomDiffusion.create(jcfg.AtomModelConfig(**TINY_MODEL),
                               jcfg.AtomDiffusionConfig(**diff))
    model = MotionDecoder(tcfg.AtomModelConfig(**TINY_MODEL))
    model.load_state_dict(convert_atom_params(jax_params()))
    td = AtomDiffusion.create(model.eval(), tcfg.AtomDiffusionConfig(**diff),
                              "cpu")
    return jd, td


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    face = np.tile(rng.normal(size=(b, 1, D)), (1, H, 1)).astype(np.float32)
    cond = rng.normal(size=(b, 2 * H, 1024)).astype(np.float32)
    return face, cond


def test_atom_configs_match_jax_defaults():
    for name in ("AtomModelConfig", "AtomDiffusionConfig"):
        assert vars(getattr(tcfg, name)()) == vars(getattr(jcfg, name)()), name


def test_config_loader_reads_the_native_yaml_like_jax():
    want = jcfg.load_config("configs/tiny.yaml")
    got = tcfg.load_config("configs/tiny.yaml")
    for section in ("atom_model", "atom_diffusion", "mtov_ae", "mtov_unet",
                    "mtov_diffusion", "mtov_loss", "mtov_train"):
        assert vars(getattr(got, section)) == vars(getattr(want, section))
    with pytest.raises(KeyError, match="unknown config section"):
        tcfg.config_from_dict({"mtov_aee": {}})
    with pytest.raises(KeyError, match="MtovAEConfig.depht"):
        tcfg.config_from_dict({"mtov_ae": {"depht": 2}})


@pytest.mark.parametrize("path", [
    "configs/autoencoder/base.yaml", "configs/latent-diffusion/base.yaml"])
def test_config_loader_reads_the_reference_yaml_like_jax(path):
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    want, got = jcfg.load_config(path), tcfg.load_config(path)
    for section in ("mtov_ae", "mtov_unet", "mtov_diffusion", "mtov_loss",
                    "mtov_train"):
        assert vars(getattr(got, section)) == vars(getattr(want, section))


@pytest.mark.parametrize("n,dim", [(12, 32), (156, 512), (5, 6)])
def test_rotary_full_dim_matches_jax(n, dim):
    np.testing.assert_array_equal(rotary.rotary_full_dim_freqs(n, dim),
                                  jrot.rotary_full_dim_freqs(n, dim))
    x = np.random.default_rng(0).normal(size=(2, n, dim + 4)).astype(np.float32)
    freqs = jrot.rotary_full_dim_freqs(n, dim)
    want = jrot.apply_rotary_full_dim(jnp.asarray(x), jnp.asarray(freqs))
    got = rotary.apply_rotary_full_dim(_t(x), _t(freqs))
    # sin/cos of angles up to n rad in float32 differ in the last ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * max(1.0, np.abs(x).max()))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "sqrt_linear",
                                      "sqrt"])
def test_schedule_tables_match_jax(schedule):
    want = jsched.make_schedule(schedule, 1000)
    got = tsched.make_schedule(schedule, 1000)
    for f in (f.name for f in dataclasses.fields(got)
              if f.name != "num_timesteps"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    with pytest.raises(ValueError, match="unknown"):
        tsched.make_schedule("quadratic", 10)


def test_sinusoidal_pos_emb_matches_jax():
    t = np.array([0, 1, 7, 19], np.int32)
    want = jdec.SinusoidalPosEmb(32).apply({}, jnp.asarray(t))
    got = sinusoidal_pos_emb(torch.from_numpy(t), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_masked_multi_head_sdpa_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 9, 32)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 1, 9, 9)) > 0.3
    mask[..., 0] = True
    want = jattn.multi_head_sdpa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 4, mask=jnp.asarray(mask))
    got = attention.multi_head_sdpa(_t(q), _t(k), _t(v), 4,
                                    mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_motion_decoder_matches_jax():
    jd, td = _models()
    rng = np.random.default_rng(1)
    b = 4
    x = rng.normal(size=(b, H, D)).astype(np.float32)
    face, cond = _inputs(b)
    times = np.array([0, 3, 11, 19], np.int32)
    keep = np.array([True, False, True, False])
    want = jd.model.apply(jax_params(), x, face, cond, times,
                          keep_mask=jnp.asarray(keep))
    with torch.no_grad():
        got = td.model(_t(x), _t(face), _t(cond), torch.from_numpy(times).long(),
                       keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a shorter sequence slices the null embeddings to its length
    s = H - 4
    want = jd.model.apply(jax_params(), x[:, :s], face[:, :s],
                          cond[:, :2 * s], times, keep_mask=jnp.asarray(keep))
    with torch.no_grad():
        got = td.model(_t(x[:, :s]), _t(face[:, :s]), _t(cond[:, :2 * s]),
                       torch.from_numpy(times).long(),
                       keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_sample_with_cfg_matches_jax():
    jd, td = _models()
    b, key = 2, jax.random.PRNGKey(3)
    face, cond = _inputs(b, seed=1)
    shape = (b, H, D)
    want = jd.ddim_sample(jax_params(), key, shape, jnp.asarray(face),
                          jnp.asarray(cond))
    feed = Feed(plain_draws(key, shape, TINY_DIFF["sampling_steps"]))
    got = td.ddim_sample(shape, _t(face), _t(cond), feed)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_long_ddim_sample_matches_jax():
    """Three chunks: the overlap constraint and the clipped guidance ramp."""
    diff = dict(n_timesteps=20, sampling_steps=4)
    jd, td = _models(diff)
    b, key = 3, jax.random.PRNGKey(4)
    face, cond = _inputs(b, seed=2)
    shape = (b, H, D)
    want = np.asarray(jd.long_ddim_sample(jax_params(), key, shape,
                                          jnp.asarray(face), jnp.asarray(cond)))
    feed = Feed(plain_draws(key, shape, 4))
    got = td.long_ddim_sample(shape, _t(face), _t(cond), feed).numpy()
    assert not feed.draws
    np.testing.assert_allclose(got, want, **TOL)
    # one chunk takes the plain sampler, as in the JAX package
    want1 = jd.long_ddim_sample(jax_params(), key, (1, H, D),
                                jnp.asarray(face[:1]), jnp.asarray(cond[:1]))
    got1 = td.long_ddim_sample((1, H, D), _t(face[:1]), _t(cond[:1]),
                               Feed(plain_draws(key, (1, H, D), 4)))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)


def _ancestral_draws(key, shape, steps):
    """p_sample_loop's draws (diffusion.py:291-296): x, then one per step."""
    key, sub = jax.random.split(key)
    return [_normal(sub, shape)] + [_normal(k, shape)
                                    for k in jax.random.split(key, steps)]


def test_p_sample_loop_matches_jax():
    jd, td = _models()
    b, key = 2, jax.random.PRNGKey(5)
    face, cond = _inputs(b, seed=3)
    shape = (b, H, D)
    want = jd.p_sample_loop(jax_params(), key, shape, jnp.asarray(face),
                            jnp.asarray(cond))
    feed = Feed(_ancestral_draws(key, shape, 20))
    got = td.p_sample_loop(shape, _t(face), _t(cond), feed)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_long_inpaint_and_partial_denoise_match_jax():
    jd, td = _models()
    b, key = 3, jax.random.PRNGKey(6)
    face, cond = _inputs(b, seed=4)
    shape = (b, H, D)
    want = jd.long_inpaint_loop(jax_params(), key, shape, jnp.asarray(face),
                                jnp.asarray(cond), start_point=6)
    got = td.long_inpaint_loop(shape, _t(face), _t(cond),
                               Feed(_ancestral_draws(key, shape, 6)),
                               start_point=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    x = np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)
    want = jd.partial_denoise(jax_params(), key, jnp.asarray(x),
                              jnp.asarray(face), jnp.asarray(cond), 5)
    k1, k2 = jax.random.split(key)
    # noise_to_t's draw, then the loop's step draws (x_init is given)
    feed = Feed([_normal(k1, shape)]
                + [_normal(k, shape) for k in jax.random.split(k2, 5)])
    got = td.partial_denoise(_t(x), _t(face), _t(cond), 5, feed)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_inpaint_loop_matches_jax():
    """Each ancestral step takes its own draw, then (while t > 0) the
    constraint's, which the JAX package folds from the step's t."""
    jd, td = _models()
    b, key, start = 2, jax.random.PRNGKey(7), 5
    face, cond = _inputs(b, seed=5)
    shape = (b, H, D)
    rng = np.random.default_rng(6)
    value = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = (rng.random(shape) > 0.5).astype(np.float32)
    want = jd.inpaint_loop(jax_params(), key, shape, jnp.asarray(face),
                           jnp.asarray(cond), jnp.asarray(mask),
                           jnp.asarray(value), start_point=start)
    key2, k_q = jax.random.split(key)
    key2, sub = jax.random.split(key2)
    draws = [_normal(sub, shape)]
    for t, k in zip(range(start - 1, -1, -1), jax.random.split(key2, start)):
        draws.append(_normal(k, shape))
        if t > 0:
            draws.append(_normal(jax.random.fold_in(k_q, t), shape))
    feed = Feed(draws)
    got = td.inpaint_loop(shape, _t(face), _t(cond), _t(mask), _t(value),
                          feed, start_point=start)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_core_ddim_post_step_and_guidance_weights_match_jax():
    """The sampler's hooks on a toy model: the constraint applies only while
    time > 0, and the model sees each step's weight."""
    jsch = jsched.make_schedule("cosine", 20)
    tsch = tsched.make_schedule("cosine", 20)
    shape, steps, key = (3, 4, 6), 5, jax.random.PRNGKey(8)
    weights = np.linspace(0.0, 2.0, steps)
    jmodel = lambda x, t, w: 0.3 * x * w + 0.01 * jnp.reshape(t, (-1, 1, 1))
    tmodel = lambda x, t, w: 0.3 * x * w + 0.01 * torch.reshape(t, (-1, 1, 1))
    want = jdiff.ddim_sample(
        jsch, jmodel, shape, key, steps, parameterization="x0",
        post_step_fn=lambda x, t: x.at[1:, :2].set(x[:-1, 2:]),
        guidance_weights=weights)

    def post(x, t):
        x = x.clone()
        x[1:, :2] = x[:-1, 2:]
        return x

    got = tdiff.ddim_sample(tsch, tmodel, shape, steps,
                            generator=Feed(plain_draws(key, shape, steps)),
                            parameterization="x0", post_step_fn=post,
                            guidance_weights=weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------------ pipeline
def test_face3d_helper_matches_jax():
    a, b = Face3DHelper.synthetic(3), JFace3D.synthetic(3)
    for name in ("key_mean_shape", "key_id_base", "key_exp_base"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    x = np.random.default_rng(0).normal(size=(2, 5, 68, 3)).astype(np.float32)
    want = np.asarray(b.idexp_to_absolute(jnp.asarray(x)))
    np.testing.assert_allclose(a.idexp_to_absolute(_t(x)).numpy(), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.idexp_to_absolute(x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("frames", [10, 24, 40])
def test_prepare_condition_matches_jax(frames):
    rng = np.random.default_rng(frames)
    kp, hub = rng.normal(size=(1, 68, 3)), rng.normal(size=(frames, 1024))
    for got, want in zip(tinfer.prepare_condition(kp, hub, H),
                         jinfer.prepare_condition(kp, hub, H)):
        np.testing.assert_array_equal(got, want)


def _pipelines(face3d_seed=0):
    mc, dc = TINY_MODEL, TINY_DIFF
    jpipe = jinfer.AtomInferencePipeline(
        jax_params(), jcfg.AtomModelConfig(**mc),
        jcfg.AtomDiffusionConfig(**dc), face3d=JFace3D.synthetic(face3d_seed))
    tpipe = tinfer.AtomInferencePipeline(
        convert_atom_params(jax_params()), tcfg.AtomModelConfig(**mc),
        tcfg.AtomDiffusionConfig(**dc),
        face3d=Face3DHelper.synthetic(face3d_seed), device="cpu")
    return jpipe, tpipe


def test_generate_landmarks_matches_jax():
    jpipe, tpipe = _pipelines()
    rng = np.random.default_rng(7)
    kp, hub = rng.normal(size=(68, 3)), rng.normal(size=(30, 1024))
    key = jax.random.PRNGKey(9)
    want = jpipe.generate_landmarks(key, kp, hub)
    feed = Feed(plain_draws(key, (1, H, D), TINY_DIFF["sampling_steps"]))
    got = tpipe.generate_landmarks(feed, kp, hub)
    assert got.shape == (H, 68, 3) and not feed.draws
    np.testing.assert_allclose(got, want, **TOL)


def test_run_directory_matches_jax(tmp_path):
    """Three identities in chunks of two: the last chunk is padded by
    repetition; same files, same arrays."""
    jpipe, tpipe = _pipelines()
    rng = np.random.default_rng(8)
    ids = {f"id{i}": (rng.normal(size=(68, 3)), rng.normal(size=(20 + i, 1024)))
           for i in (2, 0, 1)}
    want = jpipe.run_directory(ids, str(tmp_path / "jax"), seed=3, batch=2)
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(2):  # atom_infer.py:141: one split per chunk
        key, sub = jax.random.split(key)
        draws += plain_draws(sub, (2, H, D), TINY_DIFF["sampling_steps"])
    feed = Feed(draws)
    got = tpipe.run_directory(ids, str(tmp_path / "torch"), batch=2,
                              generator=feed, save_pngs=True)
    assert not feed.draws and sorted(got) == sorted(want) == sorted(ids)
    for name in ids:
        rel = os.path.join("frontalized_npy", name, "atom.npy")
        assert got[name] == str(tmp_path / "torch" / rel)
        a, b = np.load(got[name]), np.load(want[name])
        assert a.shape == (H, 68, 3) and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **TOL)
        assert len(os.listdir(tmp_path / "torch" / "png" / name)) == H
    assert tpipe.run_directory({}, str(tmp_path / "none")) == {}


def test_run_directory_draws_from_the_seed(tmp_path):
    _, tpipe = _pipelines()
    rng = np.random.default_rng(9)
    ids = {"a": (rng.normal(size=(68, 3)), rng.normal(size=(24, 1024)))}
    runs = [np.load(tpipe.run_directory(ids, str(tmp_path / str(i)),
                                        seed=s)["a"])
            for i, s in enumerate((1, 1, 2))]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.abs(runs[0] - runs[2]).max() > 1e-3


def test_atom_pipeline_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.AtomInferencePipeline(
            convert_atom_params(jax_params()),
            tcfg.AtomModelConfig(**TINY_MODEL))
