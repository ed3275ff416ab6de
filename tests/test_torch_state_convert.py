"""A JAX train state, optimizer state included, carried into the port's
trainers (``utils/convert.py::convert_*_state``): from a state S the JAX
trainer has reached after a few steps, one JAX step against one port step
from the converted S, for each of the three trainers, held to the measures
of the trainers' own parity tests:

* the first stage (AdamW moments and count, ``optax.MultiSteps``' running
  mean and mini-step, for the AE and both discriminators): S taken in the
  middle of an accumulation cycle, so that the next step finishes the cycle
  and AdamW's second step reads the carried moments; the loss terms
  (relative 1e-5), the cycle's mean gradient (relative L2 within 1e-4) and
  the update over the determined elements (``_hold_cycle``);
* AToM (Adan's m, v, n, ``prev_grad`` and count, the EMA): the loss terms
  within 2e-4 and every parameter within 2e-4 but at ill-conditioned Adan
  elements, which are counted (``_hold_and_align``);
* latent diffusion (AdamW, the EMA): the loss, and the update's relative L2
  within 1e-4.

Each S also goes the supported route to the port: the JAX package's orbax
``save_single`` → ``load_single`` (on a host with JAX) → ``convert_*_state``
→ the port's ``save_single`` / ``load_single``; that tree must equal the one
converted from the live state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import checkpoint as jckpt
from moditalker_tpu.core import sharding as jshard
from moditalker_tpu.data import atom_dataset as jds
from moditalker_tpu.train import mtov as jmtov
from moditalker_tpu.train.atom import AtomTrainer as JAtomTrainer
from moditalker_tpu.train.mtov_first_stage import FirstStageTrainer as JFS
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import checkpoint as tckpt
from moditalker_tpu_torch.train import mtov as tmtov
from moditalker_tpu_torch.train.atom import AtomTrainer
from moditalker_tpu_torch.utils.convert import (convert_ae_params,
                                                convert_atom_params,
                                                convert_atom_state,
                                                convert_disc_params,
                                                convert_first_stage_state,
                                                convert_mtov_state,
                                                convert_unet_params)

from .test_torch_train_atom import H, _hold_and_align
from .test_torch_train_atom import TINY_DIFF as ATOM_DIFF
from .test_torch_train_atom import TINY_MODEL as ATOM_MODEL
from .test_torch_train_atom import TOL as ATOM_TOL
from .test_torch_train_atom import _jax_draws as atom_draws
from .test_torch_train_first_stage import (AE, LOSS, TOL, TRAIN, _hold_cycle,
                                           _port_trainer, _videos)
from .test_torch_train_mtov import L, UPDATE_TOL, _latents
from .test_torch_train_mtov import TINY_DIFF as MTOV_DIFF
from .test_torch_train_mtov import TINY_UNET
from .test_torch_train_mtov import _jax_draws as mtov_draws
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _via_orbax(state, convert_fn, tmp_path, name):
    """state → the JAX package's orbax file → ``load_single`` → convert →
    the port's file → the port's ``load_single``."""
    jckpt.save_single(str(tmp_path / f"{name}_orbax"),
                      jckpt.host_tree(state._asdict()))
    restored = jckpt.load_single(str(tmp_path / f"{name}_orbax"))
    path = os.path.join(tmp_path, f"{name}.pt")
    tckpt.save_single(path, convert_fn(restored))
    return tckpt.load_single(path)


# ------------------------------------------------------------ first stage
def _fs_step(jt, video):
    """One JAX step, and the frame draws its key split gave."""
    _, sub = jax.random.split(jt._key)      # as jt.step splits
    draws = torch.from_numpy(np.array(jax.random.randint(
        sub, (video.shape[0],), 0, AE["timesteps"]))).long()
    m = jt.step(jnp.asarray(video))
    return {k: float(v) for k, v in m.items()}, draws


def _mean_grad(opt_before, opt_after, convert_fn, b1):
    """The mean gradient AdamW took at its step: (mu' − b1·mu) / (1 − b1)."""
    mu0 = convert_fn(_np(opt_before).inner_opt_state[0].mu)
    mu1 = convert_fn(_np(opt_after).inner_opt_state[0].mu)
    return {k: (mu1[k] - b1 * mu0[k]) / (1 - b1) for k in mu1}


def _disc_tree(tt=None, tree=None, what="param"):
    if tree is not None:
        return {**{f"2.{k}": v for k, v in tree["disc2d"].items()},
                **{f"3.{k}": v for k, v in tree["disc3d"].items()}}
    out = {}
    for tag, m in (("2", tt.disc2d), ("3", tt.disc3d)):
        for k, p in m.named_parameters():
            out[f"{tag}.{k}"] = (p.detach().clone() if what == "param"
                                 else p.grad.detach().clone())
    return out


@pytest.mark.parametrize("phase", ["g", "d"])
def test_first_stage_takes_the_jax_step_from_a_converted_state(phase,
                                                               tmp_path):
    """S after G,G,D,D,G (the G cycle half done: ``mini_step`` 1) or after
    G,G,D,D,G,G,D (the D cycle half done); the next step finishes the
    cycle with AdamW's second step. Reads (g) gradient 1.5e-5, update
    within TOL; (d) gradient 1.5e-5, update within TOL over the determined
    elements of all but the conv biases in front of a BatchNorm (2.7e-4 of
    the elements, left out: their gradient is rounding)."""
    jt = JFS(jcfg.MtovAEConfig(**AE), jcfg.MtovLossConfig(**LOSS),
             jcfg.MtovTrainConfig(**TRAIN), mesh=jshard.make_mesh(1))
    videos = _videos(8, seed=1)
    n_before = 5 if phase == "g" else 7
    for v in videos[:n_before]:
        _fs_step(jt, v)
    s = _np(jt.state)       # the JAX step donates the live buffers
    state = convert_first_stage_state(s._asdict())
    _assert_same(_via_orbax(s, convert_first_stage_state, tmp_path, "fs"),
                 state)
    assert state["step"] == n_before
    opt = state[f"{phase}_opt"]
    assert opt["mini_step"] == 1 and opt["step"] == 1
    want, draws = _fs_step(jt, videos[n_before])

    tt = _port_trainer(state)
    assert tt._it == n_before and tt._disc_phase == (phase == "d")
    if phase == "g":
        before = {k: p.detach().clone() for k, p in tt.ae.named_parameters()}
    else:
        before = _disc_tree(tt)
    got = tt.step(videos[n_before], draws=draws)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    after = convert_first_stage_state(_np(jt.state._asdict()))
    b1 = TRAIN.get("ae_betas", jcfg.MtovTrainConfig().ae_betas)[0]
    if phase == "g":
        grads = {k: p.grad for k, p in tt.ae.named_parameters()}
        update = {k: p.detach() - before[k]
                  for k, p in tt.ae.named_parameters()}
        want_grads = _mean_grad(s.g_opt, jt.state.g_opt, convert_ae_params,
                                b1)
        want_update = {k: after["ae_params"][k] - state["ae_params"][k]
                       for k in update}
        assert tt.g_opt.mini_step == 0
    else:
        grads = _disc_tree(tt, what="grad")
        update = {k: v - before[k] for k, v in _disc_tree(tt).items()}
        conv = lambda mu: {f"{t[1]}.{k}": v for t in ("d2", "d3")
                           for k, v in convert_disc_params(mu[t]).items()}
        want_grads = _mean_grad(s.d_opt, jt.state.d_opt,
                                lambda mu: {k: v for k, v in conv(mu).items()
                                            if k in update}, b1)
        want_update = {k: _disc_tree(tree=after)[k]
                       - _disc_tree(tree=state)[k] for k in update}
    g_err, u_err, left_out = _hold_cycle(grads, want_grads, update,
                                         want_update)
    if phase == "d":
        # the conv biases in front of a BatchNorm have a zero gradient in
        # exact arithmetic (rounding in both packages, ROADMAP §C): AdamW's
        # second step divides one package's rounding by the carried moments
        # of the other's, so these tensors are left out of the update's
        # measure, and counted
        fronted = [k for k in update if ".conv_" in k and k.endswith(".bias")
                   and k.replace("conv_", "bn_").replace(".bias", ".weight")
                   in update]
        peak = max(float(v.abs().max()) for v in want_grads.values())
        assert fronted and all(float(want_grads[k].abs().max()) < 1e-3 * peak
                               for k in fronted)
        rest = [k for k in update if k not in fronted]
        _, u_err, left = _hold_cycle(*({k: d[k] for k in rest} for d in (
            grads, want_grads, update, want_update)))
        n_rest = sum(update[k].numel() for k in rest)
        n_all = sum(v.numel() for v in update.values())
        left_out = (left * n_rest + n_all - n_rest) / n_all
    assert g_err <= TOL and u_err <= TOL, (g_err, u_err)
    assert left_out < 0.01, left_out
    assert tt.step_count == n_before + 1 == int(jt.state.step)


# ------------------------------------------------------------------ AToM
def test_atom_takes_the_jax_step_from_a_converted_state(tmp_path):
    """S after two JAX steps (Adan's moments, prev_grad and count 2, the
    EMA); a port trainer built at another seed and loaded with the
    converted S takes the third step as the JAX trainer does."""
    mc = dict(ATOM_MODEL, dropout=0.0)
    jt = JAtomTrainer(jcfg.AtomModelConfig(**mc),
                      jcfg.AtomDiffusionConfig(**ATOM_DIFF),
                      jcfg.AtomTrainConfig(batch_size=2, seed=0),
                      mesh=jshard.make_mesh(1))
    batch = jds.synthetic_batch(2, horizon=H, seed=3)
    for _ in range(2):
        jt.step(batch)
    state = convert_atom_state(_np(jt.state._asdict()))
    _assert_same(_via_orbax(jt.state, convert_atom_state, tmp_path, "atom"),
                 state)
    assert state["optimizer"]["step"] == 2 == state["step"]
    tt = AtomTrainer(tcfg.AtomModelConfig(**mc),
                     tcfg.AtomDiffusionConfig(**ATOM_DIFF),
                     tcfg.AtomTrainConfig(batch_size=2, seed=7), device="cpu")
    tt.load_state(state)
    before = convert_atom_params(_np(jt.state.params))
    _, sub = jax.random.split(jt._key)
    want = jt.step(batch)
    x = jds.training_arrays(batch, H)[0]
    got = tt.step(batch, draws=atom_draws(sub, 2, x.shape, 20, 0.25))
    for k in ("loss", "recon", "velocity"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **ATOM_TOL,
                                   err_msg=k)
    n_params = sum(p.numel() for p in tt.model.parameters())
    aligned, _ = _hold_and_align(tt, jt, 3, before)
    assert aligned <= 0.05 * n_params, aligned
    assert tt.step_count == 3 == int(jt.state.step)
    ema_want = convert_atom_params(_np(jt.state.ema_params))
    for k, v in tt.ema.items():
        np.testing.assert_allclose(v.numpy(), ema_want[k].numpy(),
                                   **ATOM_TOL, err_msg=f"ema {k}")


# ---------------------------------------------------------- latent diffusion
def test_latent_diffusion_takes_the_jax_step_from_a_converted_state(tmp_path):
    """S after two JAX steps (AdamW's moments and count 2); a port trainer
    built at another seed and loaded with the converted S takes the third
    step as the JAX trainer does: the loss, and the update within
    UPDATE_TOL (relative L2 over all parameters)."""
    uc = jcfg.MtovUNetConfig(**TINY_UNET)
    jt = jmtov.MtovDiffusionTrainer(
        uc, jcfg.MtovDiffusionConfig(**MTOV_DIFF),
        jcfg.MtovTrainConfig(diffusion_batch_size=2, seed=0),
        mesh=jshard.make_mesh(1), latent_len=L)
    z, cond, ic = _latents(seed=4)
    batch = {"z": z, "cond": cond, "image_cond": ic}
    for _ in range(2):
        jt.step(batch)
    state = convert_mtov_state(_np(jt.state._asdict()))
    _assert_same(_via_orbax(jt.state, convert_mtov_state, tmp_path, "mtov"),
                 state)
    assert state["optimizer"]["step"] == 2 == state["step"]
    tt = tmtov.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET),
        tcfg.MtovDiffusionConfig(**MTOV_DIFF),
        tcfg.MtovTrainConfig(diffusion_batch_size=2, seed=5), device="cpu")
    tt.load_state(state)
    before = {k: p.detach().clone() for k, p in tt.model.named_parameters()}
    jbefore = convert_unet_params(_np(jt.state.params))
    _, sub = jax.random.split(jt._key)
    want = jt.step(batch)
    got = tt.step(batch, draws=mtov_draws(sub, 2, (2, 4, L), 20))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4, atol=1e-4)
    jafter = convert_unet_params(_np(jt.state.params))
    dt = {k: p.detach() - before[k] for k, p in tt.model.named_parameters()}
    dj = {k: jafter[k] - jbefore[k] for k in dt}
    err = (sum(float((dt[k] - dj[k]).square().sum()) for k in dt)
           / sum(float(dj[k].square().sum()) for k in dj)) ** 0.5
    assert err <= UPDATE_TOL, err
    # a fresh optimizer (the moments dropped) takes another step
    fresh = tmtov.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET),
        tcfg.MtovDiffusionConfig(**MTOV_DIFF),
        tcfg.MtovTrainConfig(diffusion_batch_size=2, seed=5), device="cpu",
        state_dict=state["params"])
    fresh.step(batch, draws=mtov_draws(sub, 2, (2, 4, L), 20))
    df = {k: p.detach() - before[k] for k, p in fresh.model.named_parameters()}
    err_fresh = (sum(float((df[k] - dj[k]).square().sum()) for k in df)
                 / sum(float(dj[k].square().sum()) for k in dj)) ** 0.5
    assert err_fresh > 10 * UPDATE_TOL, err_fresh
    assert tt.step_count == 3 == int(jt.state.step)


# ------------------------------------------------- the port's own states
def test_trainers_resume_from_their_own_state():
    """A trainer rebuilt from another's ``state()`` (the first stage in the
    middle of an accumulation cycle, with its AdamW moments and running
    mean; the latent-diffusion trainer with its AdamW moments; AToM with
    Adan's) takes the same next step, bit for bit: the loaded optimizer
    holds copies, not the other trainer's tensors."""
    videos = _videos(4, seed=1)
    a = _port_trainer(None)
    for v in videos[:3]:                 # G, G, D: the D cycle half done
        a.step(v)
    b = _port_trainer(a.state())
    assert (b._it, b._disc_phase, b.d_opt.mini_step) == (3, True, 1)
    draws = torch.tensor([1, 2])
    for tr in (a, b):
        tr.step(videos[3], draws=draws)
    for (k, p), q in zip(a.disc2d.named_parameters(), b.disc2d.parameters()):
        assert torch.equal(p, q), k

    z, cond, ic = _latents(seed=4)
    batch = {"z": z, "cond": cond, "image_cond": ic}
    make = lambda: tmtov.MtovDiffusionTrainer(
        tcfg.MtovUNetConfig(**TINY_UNET),
        tcfg.MtovDiffusionConfig(**MTOV_DIFF),
        tcfg.MtovTrainConfig(diffusion_batch_size=2, seed=5), device="cpu")
    a = make()
    a.step(batch)
    b = make()
    b.load_state(a.state())
    gen = torch.Generator().manual_seed(0)
    draws = (torch.randint(0, 20, (2,), generator=gen),
             torch.randn((2, 4, L), generator=gen))
    for tr in (a, b):
        tr.step(batch, draws=draws)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k

    mc = tcfg.AtomModelConfig(**ATOM_MODEL)
    make = lambda: AtomTrainer(mc, tcfg.AtomDiffusionConfig(**ATOM_DIFF),
                               tcfg.AtomTrainConfig(batch_size=2, seed=0),
                               device="cpu")
    batch = jds.synthetic_batch(2, horizon=H, seed=3)
    a = make()
    a.step(batch, deterministic=True)
    b = make()
    b.load_state(a.state())
    x = jds.training_arrays(batch, H)[0]
    gen = torch.Generator().manual_seed(1)
    draws = (torch.randint(0, 20, (2,), generator=gen),
             torch.randn(x.shape, generator=gen), torch.ones(2, dtype=bool))
    for tr in (a, b):
        tr.step(batch, draws=draws, deterministic=True)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
