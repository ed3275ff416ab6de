"""The port's DDIM samplers and sampling pipeline vs the JAX package.

jax.random streams cannot be reproduced in torch, so the port's samplers are
handed the JAX draws: ``Feed`` supplies them in the order the port consumes
them, drawn with the key splits of the JAX code (core/diffusion.py:173-181
and :250-262, pipelines/mtov_sample.py:346). Floats at 1e-3 (DESIGN.md §6),
uint8 frames within 1 LSB. Tiny configs (configs/tiny.yaml), float32, CPU.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import diffusion as jdiff
from moditalker_tpu.core import schedules as jsched
from moditalker_tpu.pipelines.mtov_sample import \
    MtovSamplePipeline as JPipeline
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import diffusion as tdiff
from moditalker_tpu_torch.core import schedules as tsched
from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline
from moditalker_tpu_torch.utils.convert import (convert_ae_params,
                                                convert_unet_params)

from .test_torch_mtov_models import TINY_AE, TINY_DIFF, TINY_UNET, jax_params

REPO = pathlib.Path(__file__).resolve().parents[1]
RATIO = 0.5


class Feed:
    """A ``generator`` for the port's samplers that hands out given draws."""

    def __init__(self, draws):
        self.draws = [np.asarray(d) for d in draws]

    def __call__(self, shape, dtype):
        d = self.draws.pop(0)
        assert d.shape == shape, (d.shape, shape)
        return torch.tensor(d)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def plain_draws(key, shape, steps):
    """ddim_sample's draws (diffusion.py:173-181, 200): x, then one per step."""
    key, sub = jax.random.split(key)
    return [_normal(sub, shape)] + [_normal(k, shape)
                                    for k in jax.random.split(key, steps)]


def noised_draws(key, shape, steps, start):
    """ddim_sample_noised_start's draws with a traced ratio
    (diffusion.py:250-262): the renoise, then the tail steps' keys of the
    full split."""
    key, k_noise = jax.random.split(key)
    step_keys = jax.random.split(key, steps)
    return [_normal(k_noise, shape)] + [_normal(step_keys[i], shape)
                                        for i in range(start, steps)]


def _toy_model(xp):
    return lambda x, t: 0.3 * x + 0.01 * xp.reshape(t, (-1, 1, 1))


def _scheds():
    return (jsched.make_schedule("linear", 20, 0.0015, 0.0195),
            tsched.make_schedule("linear", 20, 0.0015, 0.0195))


def test_ddim_sample_matches_jax():
    jsch, tsch = _scheds()
    shape, steps, key = (2, 4, 8), 4, jax.random.PRNGKey(3)
    want = jdiff.ddim_sample(jsch, _toy_model(jnp), shape, key, steps)
    got = tdiff.ddim_sample(tsch, _toy_model(torch), shape, steps,
                            generator=Feed(plain_draws(key, shape, steps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.3])
def test_ddim_sample_noised_start_matches_jax(ratio):
    jsch, tsch = _scheds()
    steps, key = 10, jax.random.PRNGKey(4)
    x0 = np.random.default_rng(0).uniform(-1, 1, (2, 4, 8)).astype(np.float32)
    # the pipelines pass a traced ratio: floor semantics for t0 and start
    want = jdiff.ddim_sample_noised_start(
        jsch, _toy_model(jnp), jnp.asarray(x0), key, steps,
        jnp.asarray(ratio, jnp.float32))
    t0, start = tdiff.noised_start_indices(20, steps, ratio)
    feed = Feed(noised_draws(key, x0.shape, steps, start))
    got = tdiff.ddim_sample_noised_start(tsch, _toy_model(torch),
                                         torch.tensor(x0), steps, ratio,
                                         generator=feed)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------------ pipeline
def _configs(mod):
    return (mod.MtovAEConfig(**TINY_AE), mod.MtovUNetConfig(**TINY_UNET),
            mod.MtovDiffusionConfig(**TINY_DIFF))


@pytest.fixture(scope="module")
def pipelines():
    rgb, ldmk, up = jax_params()
    jpipe = JPipeline(rgb, ldmk, up, *_configs(jcfg), dtype=jnp.float32)
    tpipe = MtovSamplePipeline(convert_ae_params(rgb), convert_ae_params(ldmk),
                               convert_unet_params(up), *_configs(tcfg),
                               dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, 256, (1, 4, 32, 32, 3), dtype=np.uint8)
             for k in ("x_l", "masked_x", "x_ref", "x")} for _ in range(n)]


def _start():
    return tdiff.noised_start_indices(TINY_DIFF["timesteps"],
                                      TINY_DIFF["sampling_timesteps"], RATIO)[1]


def test_window_step_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    w = _windows(1)[0]
    key = jax.random.PRNGKey(5)
    want = jpipe.sample_window(w["x_l"], w["masked_x"], w["x_ref"], key)
    feed = Feed(plain_draws(key, (1, 4, 48), TINY_DIFF["sampling_timesteps"]))
    got = tpipe.window_step(w["x_l"], w["masked_x"], w["x_ref"], feed)
    assert not feed.draws and got.shape == (1, 4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_window_step_noised_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    w = _windows(1, seed=1)[0]
    key = jax.random.PRNGKey(6)
    want = jpipe.sample_window(w["x_l"], w["masked_x"], w["x_ref"], key,
                               gt_video=w["x"], noised_start_ratio=RATIO)
    feed = Feed(noised_draws(key, (1, 4, 48), TINY_DIFF["sampling_timesteps"],
                             _start()))
    got = tpipe.window_step_noised(w["x"], w["x_l"], w["masked_x"],
                                   w["x_ref"], feed, RATIO)
    assert not feed.draws
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("source", ["ref", "gt"])
def test_sample_long_matches_jax(pipelines, source):
    jpipe, tpipe = pipelines
    windows = _windows(2, seed=2)
    key = jax.random.PRNGKey(7)
    want = jpipe.sample_long(windows, key, noised_start_ratio=RATIO,
                             noised_start_source=source)
    draws = []
    for _ in windows:  # mtov_sample.py:346: one split per window
        key, sub = jax.random.split(key)
        draws += noised_draws(sub, (1, 4, 48), TINY_DIFF["sampling_timesteps"],
                              _start())
    feed = Feed(draws)
    got = tpipe.sample_long(windows, feed, noised_start_ratio=RATIO,
                            noised_start_source=source)
    assert not feed.draws
    assert got.dtype == np.uint8 and got.shape == (1, 8, 32, 32, 3)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_staging_cache_keeps_a_copy(pipelines):
    """A caller that reuses its host buffer for the next window must not
    make the cache serve the previous window's upload."""
    _, tpipe = pipelines
    seen = []

    class Recorder(MtovSamplePipeline):
        def sample_window(self, ldmk_video, masked_video, ref_video,
                          generator, gt_video=None, noised_start_ratio=None,
                          out_uint8=False):
            seen.append(int(gt_video[0, 0, 0, 0, 0]))
            return torch.zeros((1, 4, 2, 2, 3), dtype=torch.uint8)

    rec = Recorder.__new__(Recorder)
    rec.device = tpipe.device
    buf = np.full((1, 4, 2, 2, 3), 10, np.uint8)

    def windows():
        for v in (10, 20):
            buf[...] = v    # same buffer, new contents
            yield {"x_l": buf, "masked_x": buf, "x_ref": buf}

    rec.sample_long(windows(), None, noised_start_ratio=RATIO)
    assert seen == [10, 20]


# ------------------------------------------------------------------ guards
def _port_sources():
    # chip_smoke.py's golden phase makes its reference-layout files with
    # tests/torch_reference_layout.py: that helper is held to the rule too
    return sorted((REPO / "moditalker_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_reference_layout.py"]


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "moditalker_tpu")
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
    # and at run time: importing every module pulls in none of them
    mods = []
    for p in _port_sources():
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    # and the commands: each one parses, and the preprocessing commands run
    # on an empty corpus (their lazy imports included)
    code = ("import importlib, sys, tempfile\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from moditalker_tpu_torch import cli\n"
            "ap = cli.build_parser()\n"
            "for argv in (['process-audio', '--audio', 'a.wav', '--out', "
            "'h.npy'], ['atom-infer', '--keypoint-dir', 'k', '--hubert', "
            "'h.npy'], ['sample', '--frames-dir', 'f', '--aligned-dir', "
            "'a'], ['train-first-stage', '--landmark', '--i3d', 'i.pt'], "
            "['train-diffusion', '--i3d', 'i.pt']):\n"
            "    ap.parse_args(argv)\n"
            "d = tempfile.mkdtemp()\n"
            "cli.main(['align-motion', '--frontalized-dir', d, "
            "'--frames-dir', d, '--out-dir', d, '--synthetic-detectors'])\n"
            "cli.main(['extract-keypoints', '--frames-dir', d, '--out-dir', "
            "d, '--synthetic-detectors'])\n"
            "for c in ('unify-fps', 'video2frame'):\n"
            "    cli.main([c, '--src-root', d, '--out-dir', d, "
            "'--processes', '1'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{banned!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_pipeline_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    rgb, ldmk, up = jax_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MtovSamplePipeline(convert_ae_params(rgb), convert_ae_params(ldmk),
                           convert_unet_params(up), *_configs(tcfg))
