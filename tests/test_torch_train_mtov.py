"""The kernels under training and the port's latent-diffusion trainer vs the
JAX package, on the CPU at configs/tiny.yaml's sizes (values copied).

* Each kernel wrapper's ``autograd.Function``: its input gradient against
  ``jax.vjp`` of the JAX wrapper (the Pallas kernels in interpret mode,
  whose ``custom_vjp`` recomputes through the reference) or, for the
  one-pass and tiny-L kernels, against ``_flash_sdpa``'s backward, at 1e-5.
* A float32 tensor reaches each wrapper's kernel branch: the launch is
  exercised on the CPU with stub libraries in place of the CUDA ones.
* ``MtovDDPM.p_losses`` with JAX-drawn t and noise, the UNet's parameter
  gradients against ``jax.grad`` within 1e-3 of their max, and two
  ``LatentDiffusionLoop`` steps against the JAX fused step, from converted
  AE and UNet weights: the loss, and each step's parameter update
  (relative L2 within 1e-4).
* The training half of the MToV dataset, the optimizer, the PSNR probe and
  the ``train-diffusion`` command.
"""

import functools
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import sharding as jshard
from moditalker_tpu.data import mtov_dataset as jds
from moditalker_tpu.evals import metrics as jmetrics
from moditalker_tpu.models.mtov import ViTAutoencoder as JAE
from moditalker_tpu.models.mtov.ddpm import MtovDDPM as JDDPM
from moditalker_tpu.ops import attention as jattn
from moditalker_tpu.ops import rotary as jrot
from moditalker_tpu.ops.pallas import divided_attention as jdiv
from moditalker_tpu.ops.pallas import packed_attention as jpack
from moditalker_tpu.train import mtov as jtrain
from moditalker_tpu_torch import cli
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core.checkpoint import load_single
from moditalker_tpu_torch.data import mtov_dataset as tds
from moditalker_tpu_torch.evals import metrics as tmetrics
from moditalker_tpu_torch.models.mtov import (MtovDDPM, TriplaneUNet,
                                              ViTAutoencoder)
from moditalker_tpu_torch.ops import kernels as tkernels
from moditalker_tpu_torch.ops.kernels import divided_attention as tdiv
from moditalker_tpu_torch.ops.kernels import flash_attention as tflash
from moditalker_tpu_torch.ops.kernels import packed_attention as tpack
from moditalker_tpu_torch.train import mtov as ttrain
from moditalker_tpu_torch.utils.convert import (convert_ae_params,
                                                convert_unet_params)

from .test_torch_mtov_models import TINY_AE, TINY_DIFF, TINY_UNET, jax_params
from .torch_stubs import stub_launches  # noqa: F401 (fixture)

L = 48          # tiny latent length: 4·4 + 2·4·4
GRAD_TOL = dict(rtol=0, atol=1e-5)
UPDATE_TOL = 1e-4   # a loop step's update vs JAX's, relative L2


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _vjp_port(fn, *inputs, cot):
    xs = [_t(x).requires_grad_() for x in inputs]
    out = fn(*xs)
    assert out.grad_fn is not None
    return out.detach(), torch.autograd.grad(out, xs, _t(cot))


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("axis", ["space", "time"])
def test_divided_gradient_matches_jax_vjp(axis):
    heads, dh = 2, 64
    b, f, n = (1, 2, 256) if axis == "space" else (1, 8, 16)
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(b, f, n, 3 * heads * dh)).astype(np.float32)
    sin, cos = (jrot.axial_rotary_sincos(16, 16, dh) if axis == "space"
                else jrot.time_rotary_sincos(f, dh))
    assert tdiv.divided_attention_viable(axis, f, n, heads, dh, dh)
    cot = rng.normal(size=(b, f, n, heads * dh)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jdiv.divided_attention(
        t, sin, cos, axis, heads, dh, dh**-0.5, interpret=True),
        jnp.asarray(qkv))
    (want_g,) = vjp(jnp.asarray(cot))
    out, (g,) = _vjp_port(lambda t: tdiv.divided_attention(
        t, _t(sin), _t(cos), axis, heads, dh, dh**-0.5), qkv, cot=cot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **GRAD_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)


def test_packed_gradient_matches_jax_vjp():
    b, l, c, heads = 1, 1024, 128, 8
    rng = np.random.default_rng(4)
    qkv = rng.normal(size=(b, l, 3 * c)).astype(np.float32)
    cot = rng.normal(size=(b, l, c)).astype(np.float32)
    scale = (c // heads) ** -0.5
    want, vjp = jax.vjp(lambda t: jpack.packed_attention(
        t, heads, scale, interpret=True), jnp.asarray(qkv))
    (want_g,) = vjp(jnp.asarray(cot))
    out, (g,) = _vjp_port(lambda t: tpack.packed_attention(t, heads, scale),
                          qkv, cot=cot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **GRAD_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("kind,shape", [("onepass", (2, 1024, 16)),
                                        ("onepass", (1, 1024, 32)),
                                        ("tiny", (64, 16, 64))])
def test_flash_gradient_matches_jax_flash_sdpa_bwd(kind, shape):
    """The one-pass and tiny-L wrappers' backward is ``_flash_sdpa``'s:
    the standard adjoints on recomputed float32 probabilities."""
    rng = np.random.default_rng(5)
    q, k, v, cot = (rng.normal(size=shape).astype(np.float32)
                    for _ in range(4))
    scale = shape[-1] ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn._xla_sdpa_prescale(jq, jk, jv, scale)
    want_g = jattn._flash_sdpa_bwd(scale, (jq, jk, jv), jnp.asarray(cot))
    fn = {"onepass": tflash.onepass_attention,
          "tiny": tflash.tiny_attention}[kind]
    out, grads = _vjp_port(lambda *x: fn(*x, scale), q, k, v, cot=cot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **GRAD_TOL)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_sdpa_and_unet_attention_carry_the_gradient():
    """``sdpa`` at the one-pass gate's shapes and the UNet's attention block
    return outputs with the Functions' ``grad_fn``s."""
    from moditalker_tpu_torch.ops import attention

    q = torch.randn(2, 2, 1024, 16, requires_grad=True)
    out = attention.sdpa(q, q, q, scale=0.25)
    assert type(out.grad_fn).__name__ == "ViewBackward0"
    assert type(out.grad_fn.next_functions[0][0]).__name__ \
        == "FlashSdpaBackward"
    qkv = torch.randn(1, 1024, 384, requires_grad=True)
    out = tpack.packed_attention(qkv, 8, 0.25)
    assert type(out.grad_fn).__name__ == "RecomputeThroughPlainBackward"


# ------------------------------------------------------------ routing
def test_float32_reaches_each_kernel_branch(stub_launches):
    """A float32 operand at a gated shape goes to the kernel (never to the
    plain version), is counted once, comes back float32, and keeps its
    gradient function: every kernel through its float32 entry point, with
    no cast pass (tiny-L too: the modular path's time attention)."""
    calls = stub_launches
    f32 = lambda *s: torch.randn(*s, requires_grad=True)
    space_sc = [_t(a) for a in jrot.axial_rotary_sincos(16, 16, 64)]
    time_sc = [_t(a) for a in jrot.time_rotary_sincos(16, 64)]
    cases = [
        ("divided_space_attention", lambda: tdiv.divided_attention(
            f32(1, 2, 256, 384), *space_sc, "space", 2, 64, 0.125),
         ["divided_space_attention_f32"]),
        ("divided_time_attention", lambda: tdiv.divided_attention(
            f32(1, 16, 8, 384), *time_sc, "time", 2, 64, 0.125),
         ["divided_time_attention_f32"]),
        ("packed_attention", lambda: tpack.packed_attention(
            f32(2, 1024, 384), 8, 0.25),
         ["packed_attention_f32"]),
        ("onepass_attention", lambda: tflash.onepass_attention(
            f32(4, 1024, 32), f32(4, 1024, 32), f32(4, 1024, 32), 0.2),
         ["fused_attention_f32"]),
        ("tiny_attention", lambda: tflash.tiny_attention(
            f32(4096, 16, 64), f32(4096, 16, 64), f32(4096, 16, 64), 0.125),
         ["tiny_attention_f32"]),
    ]
    for name, run, want_calls in cases:
        calls.clear()
        before = tkernels.LAUNCHES[name]
        out = run()
        assert calls == want_calls, name
        assert tkernels.LAUNCHES[name] == before + 1, name
        assert out.dtype == torch.float32 and out.grad_fn is not None, name
    assert sum(tkernels.LAUNCHES.values()) == 5


def test_wrappers_raise_rather_than_fall_back(stub_launches):
    """Tiny-L takes bf16 or float32 and refuses any other type; the fused
    kernel has no gradient and raises where one is asked of it; neither
    gives way to the plain version."""
    x = torch.randn(4096, 16, 64).half()
    with pytest.raises(TypeError, match="bf16 or float32"):
        tflash.tiny_attention(x, x, x, 0.125)
    y = torch.randn(2, 256, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tflash.fused_attention(y, y, y)
    with torch.no_grad():
        tflash.fused_attention(y, y, y)
    assert stub_launches == ["fused_attention_f32"]
    assert tkernels.LAUNCHES["fused_attention"] == 1
    assert tkernels.LAUNCHES["tiny_attention"] == 0


# ------------------------------------------------------------ p_losses
def _ddpm(unet_params, **diff):
    unet = TriplaneUNet(tcfg.MtovUNetConfig(**TINY_UNET))
    unet.load_state_dict(convert_unet_params(unet_params))
    return MtovDDPM.create(unet, tcfg.MtovDiffusionConfig(**TINY_DIFF, **diff),
                           "cpu")


def _latents(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.normal(size=(b, 4, L))).astype(np.float32),
            rng.normal(size=(b, 8, L)).astype(np.float32),
            rng.normal(size=(b, 4, L)).astype(np.float32))


def _jax_draws(key, b, shape, num_timesteps):
    """The JAX ``p_losses`` draws: (k_t, k_noise) = split(key)."""
    k_t, k_noise = jax.random.split(key)
    t = jax.random.randint(k_t, (b,), 0, num_timesteps)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), _t(noise)


@pytest.mark.parametrize("diff", [dict(loss_type="l1"),
                                  dict(parameterization="x0",
                                       original_elbo_weight=0.5)])
def test_mtov_p_losses_match_jax(diff):
    """The l1 and x0 variants with the vlb term on (the shipped l2 / eps
    loss is held with the gradients below)."""
    _, _, up = jax_params()
    jd = JDDPM.create(jcfg.MtovUNetConfig(**TINY_UNET),
                      jcfg.MtovDiffusionConfig(**TINY_DIFF, **diff))
    td = _ddpm(up, **diff)
    z, cond, ic = _latents()
    key = jax.random.PRNGKey(3)
    want, waux = jax.jit(jd.p_losses)(up, key,
                                      *map(jnp.asarray, (z, cond, ic)))
    loss, aux = td.p_losses(_t(z), _t(cond), _t(ic),
                            *_jax_draws(key, 2, z.shape, 20))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4, atol=1e-5)
    for k in ("loss_simple", "loss_vlb"):
        np.testing.assert_allclose(aux[k].item(), float(waux[k]), rtol=1e-4,
                                   atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_unet_grads():
    """(loss, converted gradients) of the JAX ``p_losses`` at key 5."""
    _, _, up = jax_params()
    jd = JDDPM.create(jcfg.MtovUNetConfig(**TINY_UNET),
                      jcfg.MtovDiffusionConfig(**TINY_DIFF))
    z, cond, ic = _latents(seed=1)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jd.p_losses(
        p, jax.random.PRNGKey(5), *map(jnp.asarray, (z, cond, ic)))[0]))(up)
    return float(loss), convert_unet_params(
        jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_unet_gradients_match_jax_grad(remat):
    """The shipped loss (l2, eps) and every parameter gradient of it within
    1e-3 of the largest (``jax.grad`` of the JAX ``p_losses``), with and
    without ``remat``."""
    _, _, up = jax_params()
    z, cond, ic = _latents(seed=1)
    key = jax.random.PRNGKey(5)
    want_loss, want = _jax_unet_grads()
    td = _ddpm(up)
    td.model.set_remat(remat)
    loss, _ = td.p_losses(_t(z), _t(cond), _t(ic),
                          *_jax_draws(key, 2, z.shape, 20))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4, atol=1e-5)
    loss.backward()
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in td.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-3 * top, err_msg=name)


# ------------------------------------------------------------ the loop
def _videos(b=2, seed=0):
    return tds.synthetic_mtov_batch(b, timesteps=4, resolution=32, seed=seed)


def test_extract_latents_matches_jax():
    rgb, ldmk, _ = jax_params()
    batch = _videos()
    ae = JAE(jcfg.MtovAEConfig(**TINY_AE))
    want = jtrain.extract_latents(ae, rgb, ldmk,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    aes = []
    for params in (rgb, ldmk):
        m = ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE))
        m.load_state_dict(convert_ae_params(params))
        aes.append(m.eval())
    got = ttrain.extract_latents(*aes, {k: _t(v) for k, v in batch.items()})
    for k in ("z", "cond", "image_cond"):
        assert not got[k].requires_grad
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-3)


def test_two_latent_diffusion_steps_match_jax():
    """The JAX loop's fused step (frozen-AE extract + loss + AdamW + EMA) and
    the port's from the same converted AE and UNet weights, the port handed
    each step's JAX draws: the loss per step, and each step's update of the
    UNet (its parameters after the step less before) within UPDATE_TOL of
    JAX's, as the relative L2 of the difference over all parameters. Reads
    6.7e-6 and 3.1e-5; an optimizer that does not step reads 1.0, one that
    steps against the gradient 2.0, and one that keeps step 1's gradient
    (no ``zero_grad``) 3.0e-2 on step 2. (The parameters themselves cannot
    tell these apart: AdamW moves an element by about lr = 1e-4 a step.)"""
    rgb, ldmk, _ = jax_params()
    uc = jcfg.MtovUNetConfig(**TINY_UNET)
    tc = jcfg.MtovTrainConfig(diffusion_batch_size=2, seed=0)
    jt = jtrain.MtovDiffusionTrainer(uc, jcfg.MtovDiffusionConfig(**TINY_DIFF),
                                     tc, mesh=jshard.make_mesh(1),
                                     latent_len=L)
    jloop = jtrain.LatentDiffusionLoop(
        jt, JAE(jcfg.MtovAEConfig(**TINY_AE)), rgb, ldmk)
    unet0 = jax.tree_util.tree_map(np.asarray, jt.state.params)
    tt = ttrain.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET), tcfg.MtovDiffusionConfig(**TINY_DIFF),
        tcfg.MtovTrainConfig(diffusion_batch_size=2, seed=0), device="cpu",
        state_dict=convert_unet_params(unet0))
    aes = []
    for params in (rgb, ldmk):
        m = ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE))
        m.load_state_dict(convert_ae_params(params))
        aes.append(m)
    tloop = ttrain.LatentDiffusionLoop(tt, *aes)
    batch = _videos(seed=2)

    def params():
        return ({k: p.detach().clone() for k, p in tt.model.named_parameters()},
                convert_unet_params(jax.tree_util.tree_map(np.asarray,
                                                           jt.state.params)))

    before = params()
    for step in (1, 2):
        jt._key, sub = jax.random.split(jt._key)
        dev = {k: jnp.asarray(v) for k, v in batch.items()}
        jt.state, want = jloop._fused(jt.state, jloop.ae_rgb_params,
                                      jloop.ae_ldmk_params, dev, sub)
        got = tloop.train_step(batch, draws=_jax_draws(sub, 2, (2, 4, L), 20))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        after = params()
        dt = {k: after[0][k] - before[0][k] for k in after[0]}
        dj = {k: after[1][k] - before[1][k] for k in after[0]}
        err = (sum(float((dt[k] - dj[k]).pow(2).sum()) for k in dt)
               / sum(float(dj[k].pow(2).sum()) for k in dj)) ** 0.5
        assert err <= UPDATE_TOL, f"step {step}: update error {err:.3e}"
        before = after
    assert tt.step_count == 2 == int(jt.state.step)


def test_ema_runs_every_25_steps_and_checkpoints_hold_it(tmp_path):
    """EMA every ``ema_interval`` (25) steps at 0.9999; ``fit`` saves
    {ema_params, step} every ``ckpt_every`` steps."""
    from moditalker_tpu_torch.core.checkpoint import CheckpointManager

    _, _, up = jax_params()
    tt = ttrain.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET), tcfg.MtovDiffusionConfig(**TINY_DIFF),
        tcfg.MtovTrainConfig(), device="cpu",
        state_dict=convert_unet_params(up))
    ema0 = {k: v.clone() for k, v in tt.ema.items()}
    lat = dict(zip(("z", "cond", "image_cond"), map(_t, _latents())))
    for _ in range(24):
        tt.train_step(lat)
    assert all(torch.equal(tt.ema[k], ema0[k]) for k in ema0)
    tt.train_step(lat)
    w = dict(tt.model.named_parameters())
    for k in ema0:
        want = ema0[k] * 0.9999 + w[k].detach() * (1 - 0.9999)
        torch.testing.assert_close(tt.ema[k], want, rtol=0, atol=1e-7)

    rgb, ldmk, _ = jax_params()
    aes = []
    for params in (rgb, ldmk):
        m = ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE))
        m.load_state_dict(convert_ae_params(params))
        aes.append(m)
    loop = ttrain.LatentDiffusionLoop(tt, *aes)
    mgr = CheckpointManager(str(tmp_path / "ema"))
    probes = []
    loop.fit(itertools.repeat(_videos()), max_steps=4, ckpt_manager=mgr,
             ckpt_every=2, eval_every=3,
             eval_fn=lambda lp, it: probes.append(it) or {})
    assert mgr.latest_step() == 4 and probes == [3]
    saved = mgr.restore()
    assert set(saved) == {"ema_params", "step"} and saved["step"] == 29


def test_sample_probe_decodes_a_video_with_the_ema_weights():
    rgb, ldmk, up = jax_params()
    tt = ttrain.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET), tcfg.MtovDiffusionConfig(**TINY_DIFF),
        tcfg.MtovTrainConfig(), device="cpu",
        state_dict=convert_unet_params(up))
    aes = []
    for params in (rgb, ldmk):
        m = ViTAutoencoder(tcfg.MtovAEConfig(**TINY_AE))
        m.load_state_dict(convert_ae_params(params))
        aes.append(m)
    loop = ttrain.LatentDiffusionLoop(tt, *aes)
    before = {k: p.detach().clone() for k, p in tt.model.named_parameters()}
    with torch.no_grad():
        for p in tt.ema.values():
            p.add_(0.01)
    video = loop.sample(_videos(), torch.Generator().manual_seed(0))
    assert video.shape == (2, 4, 32, 32, 3) and torch.isfinite(video).all()
    for k, p in tt.model.named_parameters():
        assert torch.equal(p, before[k])


def test_make_optimizer_carries_optax_defaults():
    """AdamW with optax.adamw's weight decay 1e-4 (torch's default is 1e-2),
    and the warm-up's learning rates equal optax.linear_schedule's."""
    tc = tcfg.MtovTrainConfig(warmup_steps=10)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = ttrain.make_optimizer([p], tc)
    g = opt.param_groups[0]
    assert sched is None and g["weight_decay"] == 1e-4
    assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8 and g["lr"] == 1e-4
    opt, sched = ttrain.make_optimizer([p], tc, use_warmup=True)
    want = optax.linear_schedule(init_value=tc.lr * 1e-6, end_value=tc.lr,
                                 transition_steps=tc.warmup_steps)
    for step in range(14):
        # optax computes (init − end)·(1 − frac) + end in float32, which at
        # step 0 cancels to within float32's resolution of lr
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(step)),
                                                          abs=1e-7 * tc.lr)
        opt.step()
        sched.step()


def test_adamw_trajectory_matches_optax():
    """Five AdamW steps (the trainer's optimizer) on fixed gradients within
    1e-6 of optax.adamw(1e-4)."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(5)]
    tx = optax.adamw(1e-4)
    jp = jnp.asarray(w0)
    st = tx.init(jp)
    p = torch.nn.Parameter(_t(w0))
    opt, _ = ttrain.make_optimizer([p], tcfg.MtovTrainConfig())
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        p.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)


def test_trainer_runs_on_cuda_unless_asked():
    """No fallback hides the device: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.MtovDiffusionTrainer(tcfg.MtovUNetConfig(**TINY_UNET))


# ------------------------------------------------------------ data, probe
def test_infinite_sampler_and_synthetic_batch_match_jax():
    for kw in (dict(n=7), dict(n=10, rank=1, num_replicas=3, seed=4),
               dict(n=5, shuffle=False)):
        a = list(itertools.islice(iter(tds.InfiniteSampler(**kw)), 40))
        b = list(itertools.islice(iter(jds.InfiniteSampler(**kw)), 40))
        assert a == b
    x, y = tds.synthetic_mtov_batch(2, 4, 32, 3), jds.synthetic_mtov_batch(
        2, 4, 32, 3)
    assert set(x) == set(y)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k])


def _write_frames(root, kpt_root, ids=("a", "b", "c"), n=20):
    from PIL import Image

    rng = np.random.default_rng(0)
    for j, ident in enumerate(ids):
        os.makedirs(os.path.join(root, ident))
        os.makedirs(os.path.join(kpt_root, ident))
        for i in range(n if j else 10):   # one short clip: < 16 frames
            img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, ident, f"{i:05d}.png"))
            np.save(os.path.join(kpt_root, ident, f"{i:05d}.npy"),
                    rng.integers(0, 40, (68, 2)))


def test_hdtf_frames_dataset_matches_jax(tmp_path):
    root, kpt = str(tmp_path / "frames"), str(tmp_path / "kpts")
    _write_frames(root, kpt)
    holdout = tmp_path / "holdout.txt"
    holdout.write_text("b\n\n")
    assert tds.load_holdout_ids(str(holdout)) \
        == jds.load_holdout_ids(str(holdout)) == {"b"}
    kw = dict(nframes=16, resolution=32, holdout_ids={"b"}, seed=3)
    t = tds.HDTFFramesDataset(root, kpt, **kw)
    j = jds.HDTFFramesDataset(root, kpt, **kw)
    assert t.identities == j.identities == ["a", "c"]
    for i in range(len(t)):
        a, b = t[i], j[i]
        for k in ("x", "x_l", "masked_x", "x_ref"):
            np.testing.assert_array_equal(a[k], b[k])
    got = next(t.batches(3, seed=1))
    want = next(j.batches(3, seed=1))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_hdtf_frames_dataset_raises_without_pil(tmp_path, monkeypatch):
    """Nothing stands in for PIL: the dataset raises a clear ImportError."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        tds.HDTFFramesDataset(str(tmp_path), str(tmp_path))


def test_video_psnr_matches_jax():
    rng = np.random.default_rng(0)
    real = rng.uniform(-1, 1, (2, 4, 8, 8, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(scale=0.1, size=real.shape), -1, 1)
    want = jmetrics.video_psnr(real, fake)
    assert tmetrics.video_psnr(real, fake) == pytest.approx(want, abs=1e-9)
    assert tmetrics.video_psnr(_t(real), _t(fake)) == pytest.approx(want,
                                                                    abs=1e-4)


# ------------------------------------------------------------ the command
def test_train_diffusion_command(tmp_path):
    """``train-diffusion`` on the CPU at the tiny config: on synthetic
    videos (frozen random AEs, EMA checkpoints every --ckpt-every, the probe
    at --eval-every), and --latents-only."""
    out = str(tmp_path / "run")
    path = cli.main(["train-diffusion", "--device", "cpu", "--config",
                     "configs/tiny.yaml", "--synthetic", "--steps", "2",
                     "--ckpt-every", "2", "--eval-every", "1", "--out-dir",
                     out])
    assert os.listdir(os.path.join(out, "diffusion_ema")) == ["2"]
    state = load_single(path)
    assert state["step"] == 2
    unet = TriplaneUNet(tcfg.load_config("configs/tiny.yaml").mtov_unet)
    unet.load_state_dict(state["params"])
    out2 = str(tmp_path / "lat")
    path = cli.main(["train-diffusion", "--device", "cpu", "--config",
                     "configs/tiny.yaml", "--latents-only", "--steps", "2",
                     "--out-dir", out2])
    assert load_single(path)["step"] == 2
