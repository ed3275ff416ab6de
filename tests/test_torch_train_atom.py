"""The port's AToM trainer vs the JAX package: the indexed record store, the
training data pipeline, the loss weights, ``p_losses``, three trainer steps
and the ``train-atom`` command, at configs/tiny.yaml's AToM sections.

Weights are drawn by the JAX package's initialisers and carried across by
``moditalker_tpu_torch.utils.convert``; the loss's draws are made in JAX with
the key splits of ``models/atom/diffusion.py:56-60`` and handed to the port.
Tolerances: model, loss and trainer 2e-4, tables 1e-6 (DESIGN.md §6);
datasets exactly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moditalker_tpu import config as jcfg
from moditalker_tpu.core import schedules as jsched
from moditalker_tpu.core import sharding as jshard
from moditalker_tpu.data import atom_dataset as jds
from moditalker_tpu.data import indexed as jidx
from moditalker_tpu.models.atom.diffusion import AtomDiffusion as JAtomDiffusion
from moditalker_tpu.train.atom import AtomTrainer as JAtomTrainer
from moditalker_tpu_torch import cli
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import schedules as tsched
from moditalker_tpu_torch.core.checkpoint import CheckpointManager, load_single
from moditalker_tpu_torch.core.preempt import GracefulStop
from moditalker_tpu_torch.data import atom_dataset as tds
from moditalker_tpu_torch.data import indexed as tidx
from moditalker_tpu_torch.models.atom import AtomDiffusion, MotionDecoder
from moditalker_tpu_torch.train.atom import AtomTrainer
from moditalker_tpu_torch.utils.convert import convert_atom_params

# configs/tiny.yaml's AToM sections, copied
TINY_MODEL = dict(horizon=12, latent_dim=32, ff_size=64, num_layers=2,
                  num_heads=2)
TINY_DIFF = dict(n_timesteps=20, sampling_steps=2)
H, D = TINY_MODEL["horizon"], 204
TOL = dict(rtol=0, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------------ indexed
def _records(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"item_id": f"id{i}", "x": rng.normal(size=(i + 2, 3)),
             "tag": [i, "a" * i]} for i in range(n)]


def _same_record(a, b):
    assert a["item_id"] == b["item_id"] and a["tag"] == b["tag"]
    np.testing.assert_array_equal(a["x"], b["x"])


@pytest.mark.parametrize("gz", [False, True])
def test_indexed_is_byte_compatible_both_ways(tmp_path, gz):
    """The port reads what the JAX writer wrote and the JAX reader reads what
    the port wrote; without gzip (whose header stamps the time) the two
    writers' files are identical byte for byte."""
    recs = _records()
    paths = {}
    for name, mod in (("jax", jidx), ("port", tidx)):
        path = str(tmp_path / name)
        w = mod.IndexedWriter(path, gzip_items=gz, index_size=4096)
        for r in recs:
            w.add_item(r, id=r["item_id"])
        w.finalize()
        paths[name] = path
    for reader_mod, writer in ((tidx, "jax"), (jidx, "port")):
        reader = reader_mod.IndexedReader(paths[writer])
        assert len(reader) == len(recs)
        for i, r in enumerate(recs):
            _same_record(reader[i], r)
        _same_record(reader["id3"], recs[3])
    raw = {k: open(f"{p}.data", "rb").read() for k, p in paths.items()}
    if not gz:
        assert raw["jax"] == raw["port"]
    assert (tidx.IndexedReader(paths["jax"], unpickle=False)[2]
            == jidx.IndexedReader(paths["port"], unpickle=False)[2])


# ------------------------------------------------------------------ dataset
def test_batch_by_size_and_bucket_length_match_jax():
    rng = np.random.default_rng(0)
    sizes = rng.integers(20, 900, size=300).tolist()
    order = np.argsort(sizes, kind="mergesort").tolist()
    for bs, mt, mult in ((64, 60000, 1), (8, 3000, 1), (16, 5000, 4)):
        assert tds.batch_by_size(order, sizes, bs, mt, mult) \
            == jds.batch_by_size(order, sizes, bs, mt, mult)
    assert tds.LENGTH_BUCKETS == jds.LENGTH_BUCKETS
    for n in range(0, 1400, 7):
        assert tds.bucket_length(n) == jds.bucket_length(n)


def _write_lrs3(path, n=9, seed=0):
    """A GeneFace-format database of ``n`` random items of varied length."""
    rng = np.random.default_rng(seed)
    w = jidx.IndexedWriter(path, index_size=1 << 16)
    for i in range(n):
        t = 2 * int(rng.integers(20, 90))
        w.add_item({
            "item_id": f"spk{i}",
            "mel": rng.normal(size=(t, 80)).astype(np.float32),
            "hubert": rng.normal(size=(t, 1024)).astype(np.float32),
            "coeff": rng.normal(scale=0.3, size=(t // 2, 257)),
            "idexp_lm3d": rng.normal(size=(t // 2, 68, 3)),
        })
    w.finalize()


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "item_id":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_atom_dataset_matches_jax(tmp_path):
    """Loading, collation, the epoch's batches and the iterator give the JAX
    package's arrays exactly on the same seed."""
    _write_lrs3(str(tmp_path / "train"))
    j = jds.AtomSequenceDataset(str(tmp_path), "train")
    t = tds.AtomSequenceDataset(str(tmp_path), "train")
    assert t.sizes == j.sizes and len(t) == len(j)
    for a, b in zip(t.items, j.items):
        _same_batch(a, b)
    for static in (True, False):
        _same_batch(t.collate([0, 3, 5], static_shapes=static,
                              pad_batch_to=4 if static else None),
                    j.collate([0, 3, 5], static_shapes=static,
                              pad_batch_to=4 if static else None))
    assert t.epoch_batches(4, seed=3, repeats=2) \
        == j.epoch_batches(4, seed=3, repeats=2)
    got = list(t.iter_epoch(4, seed=2))
    want = list(j.iter_epoch(4, seed=2))
    assert len(got) == len(want) > 0
    for a, b in zip(got[:6], want[:6]):
        _same_batch(a, b)
        for x, y in zip(tds.training_arrays(a, H), jds.training_arrays(b, H)):
            np.testing.assert_array_equal(x, y)


def test_synthetic_batch_matches_jax():
    a = tds.synthetic_batch(3, horizon=H, seed=5)
    b = jds.synthetic_batch(3, horizon=H, seed=5)
    _same_batch(a, b)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("kw", [
    dict(schedule="cosine", n_timesteps=1000, parameterization="x0"),
    dict(schedule="cosine", n_timesteps=50, parameterization="x0",
         p2_loss_weight_gamma=0.5),
    dict(schedule="linear", n_timesteps=1000, linear_start=0.0015,
         linear_end=0.0195, parameterization="eps"),
    dict(schedule="linear", n_timesteps=20, parameterization="eps",
         v_posterior=0.1, p2_loss_weight_gamma=1.0, p2_loss_weight_k=2.0),
])
def test_loss_weight_tables_match_jax(kw):
    want = jsched.make_schedule(**kw)
    got = tsched.make_schedule(**kw)
    for name in ("p2_loss_weight", "lvlb_weights", "betas",
                 "alphas_cumprod"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_params(dropout: float):
    mc = jcfg.AtomModelConfig(**TINY_MODEL, dropout=dropout)
    jd = JAtomDiffusion.create(mc, jcfg.AtomDiffusionConfig(**TINY_DIFF))
    params = jax.jit(jd.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, D)), jnp.zeros((1, H, D)),
        jnp.zeros((1, 2 * H, mc.cond_feature_dim)), jnp.zeros((1,), "int32"))
    return jd, jax.tree_util.tree_map(np.asarray, params)


def _port(params, dropout: float, use_p2: bool = False):
    model = MotionDecoder(tcfg.AtomModelConfig(**TINY_MODEL, dropout=dropout))
    model.load_state_dict(convert_atom_params(params))
    return AtomDiffusion.create(
        model, tcfg.AtomDiffusionConfig(**TINY_DIFF, use_p2=use_p2), "cpu")


def _jax_draws(key, b, shape, sched_t, drop_prob):
    """The draws of the JAX ``p_losses`` (its four key splits)."""
    k_t, k_noise, k_drop, _ = jax.random.split(key, 4)
    t = jax.random.randint(k_t, (b,), 0, sched_t)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    keep = jax.random.uniform(k_drop, (b,)) >= drop_prob
    return (torch.from_numpy(np.array(t)).long(), _t(noise),
            torch.from_numpy(np.array(keep)))


def _loss_inputs(b, seed=0):
    batch = tds.synthetic_batch(b, horizon=H, seed=seed)
    return [_t(a) for a in tds.training_arrays(batch, H)]


@pytest.mark.parametrize("use_p2", [False, True])
def test_p_losses_match_jax(use_p2):
    """At deterministic=True (the port's eval mode), with the JAX draws:
    total, recon and velocity within 2e-4."""
    jd0, params = _jax_params(0.1)
    jd = JAtomDiffusion.create(
        jcfg.AtomModelConfig(**TINY_MODEL),
        jcfg.AtomDiffusionConfig(**TINY_DIFF, use_p2=use_p2))
    td = _port(params, 0.1, use_p2)
    td.model.eval()
    x, face, cond = _loss_inputs(4)
    key = jax.random.PRNGKey(7)
    want, (w_recon, w_vel) = jd.p_losses(
        params, key, jnp.asarray(x.numpy()), jnp.asarray(face.numpy()),
        jnp.asarray(cond.numpy()), deterministic=True)
    draws = _jax_draws(key, 4, tuple(x.shape), jd.sched.num_timesteps,
                       jd.cfg.cond_drop_prob)
    total, (recon, vel) = td.p_losses(x, face, cond, *draws)
    for a, b in ((total, want), (recon, w_recon), (vel, w_vel)):
        np.testing.assert_allclose(a.item(), float(b), **TOL)


def test_training_mode_drops_at_the_configured_rate_and_eval_is_exact():
    """Dropout (0.1 in the decoder layers) cannot match JAX's bits: in
    training mode each dropout zeroes 10 % of its input, within 1 %; in eval
    mode the model is deterministic and equals the JAX deterministic
    forward within 2e-4."""
    jd, params = _jax_params(0.1)
    td = _port(params, 0.1)
    x, face, cond = _loss_inputs(8)
    times = torch.tensor([3, 17, 0, 9, 11, 5, 19, 1])
    keep = torch.tensor([True, False] * 4)
    kept, seen = [0], [0]

    def hook(m, inputs, out):
        nz = inputs[0] != 0
        kept[0] += int((out[nz] != 0).sum())
        seen[0] += int(nz.sum())

    drops = [m for m in td.model.modules()
             if isinstance(m, torch.nn.Dropout)]
    assert drops and all(m.p == 0.1 for m in drops)
    handles = [m.register_forward_hook(hook) for m in drops]
    td.model.train()
    torch.manual_seed(0)
    with torch.no_grad():
        a = td.model(x, face, cond, times, keep_mask=keep)
        b = td.model(x, face, cond, times, keep_mask=keep)
    for h in handles:
        h.remove()
    assert not torch.equal(a, b)
    assert seen[0] > 100_000
    assert abs(1 - kept[0] / seen[0] - 0.1) < 0.01
    td.model.eval()
    with torch.no_grad():
        c = td.model(x, face, cond, times, keep_mask=keep)
        d = td.model(x, face, cond, times, keep_mask=keep)
    assert torch.equal(c, d)
    want = jd.model.apply(params, jnp.asarray(x.numpy()),
                          jnp.asarray(face.numpy()), jnp.asarray(cond.numpy()),
                          jnp.asarray(times.numpy()),
                          keep_mask=jnp.asarray(keep.numpy()),
                          deterministic=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ trainer
# Adan divides each element's step by sqrt(n̂) + eps, so two implementations
# whose gradients differ by float32 rounding can take visibly different
# steps where the reference's own step is ill-conditioned:
# * a gradient at the noise floor (sqrt(n̂) below ADAN_ILL): the face
#   encoder's q/k projections, whose gradient is zero but for rounding (the
#   face tokens are one keypoint repeated, so their attention is uniform),
#   step by about lr in the direction of the rounding;
# * on step 2, the first with moment updates, n = b3·c² for
#   c = g + (1 − b2)(g − g_prev): where c nearly cancels the step is many
#   times lr and follows the last bits of g (to_time_tokens.weight here:
#   0.64 in JAX, 0.97 in the port, from gradients equal to 1e-7); such a
#   step is larger than ADAN_BIG·lr.
# Those elements are counted, and set to the reference's values (parameters,
# EMA and Adan state) after each step, so that every step starts from one
# state; every other element is held to 2e-4.
ADAN_ILL = 1e-4
ADAN_BIG = 25


def _ill_conditioned(n, step, moved, lr, b3=0.01):
    nhat = n / (1.0 - (1.0 - b3) ** step)
    return (nhat.sqrt() < ADAN_ILL) | (moved.abs() > ADAN_BIG * lr)


def _hold_and_align(tt, jt, step, before):
    """Every parameter of the port within 2e-4 of the JAX trainer's but at
    ill-conditioned Adan elements, which are aligned to JAX's values.
    ``before``: JAX's parameters before this step. Returns the count aligned
    and JAX's parameters now."""
    conv = lambda tree: convert_atom_params(
        jax.tree_util.tree_map(np.asarray, tree))
    want = conv(jt.state.params)
    ema_want = conv(jt.state.ema_params)
    jstate = {k: conv(getattr(jt.state.opt_state, k))
              for k in ("m", "v", "n", "prev_grad")}
    lr = tt.train_cfg.learning_rate
    aligned = 0
    with torch.no_grad():
        for name, p in tt.model.named_parameters():
            off = (p - want[name]).abs() > TOL["atol"]
            ill = _ill_conditioned(jstate["n"][name], step,
                                   want[name] - before[name], lr)
            assert not (off & ~ill).any(), (
                f"step {step} {name}: {int((off & ~ill).sum())} "
                f"well-conditioned elements off by up to "
                f"{float((p - want[name]).abs()[~ill].max()):.3e}")
            if off.any():
                aligned += int(off.sum())
                p[off] = want[name][off]
                tt.ema[name][off] = ema_want[name][off]
                for k, v in jstate.items():
                    tt.opt.state[p][k][off] = v[name][off]
    return aligned, want


def test_three_trainer_steps_match_jax():
    """The JAX ``AtomTrainer`` and the port's from the same converted weights
    on the same batch, the port handed each step's JAX draws: the first
    step's gradients, the loss, recon and velocity of each step, every
    parameter after each step but at ill-conditioned Adan elements
    (``_hold_and_align``; 1.9 % of the tiny model's over the three steps,
    most of them the face encoder's q/k projections), and the EMA after the
    third step, all
    within 2e-4. Dropout is 0 here (JAX's train step runs it, and its bits
    cannot be matched); the dropout test above covers it."""
    mc = dict(TINY_MODEL, dropout=0.0)
    tc = jcfg.AtomTrainConfig(batch_size=2, seed=0)
    jt = JAtomTrainer(jcfg.AtomModelConfig(**mc),
                      jcfg.AtomDiffusionConfig(**TINY_DIFF), tc,
                      mesh=jshard.make_mesh(1))
    params0 = jax.tree_util.tree_map(np.asarray, jt.state.params)
    before = convert_atom_params(params0)
    tt = AtomTrainer(tcfg.AtomModelConfig(**mc),
                     tcfg.AtomDiffusionConfig(**TINY_DIFF),
                     tcfg.AtomTrainConfig(batch_size=2, seed=0), device="cpu",
                     state_dict=before)
    n_params = sum(p.numel() for p in tt.model.parameters())
    batch = tds.synthetic_batch(2, horizon=H, seed=3)
    key = jt._key
    aligned = 0
    for step in range(1, 4):
        key, sub = jax.random.split(key)
        want = jt.step(batch)
        x = tds.training_arrays(batch, H)[0]
        draws = _jax_draws(sub, 2, x.shape, 20, 0.25)
        got = tt.step(batch, draws=draws)
        for k in ("loss", "recon", "velocity"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                       err_msg=f"step {step} {k}")
        if step == 1:   # the gradients (Adan keeps them as prev_grad)
            grads = convert_atom_params(jax.tree_util.tree_map(
                np.asarray, jt.state.opt_state.prev_grad))
            for name, p in tt.model.named_parameters():
                np.testing.assert_allclose(
                    tt.opt.state[p]["prev_grad"].numpy(),
                    grads[name].numpy(), **TOL, err_msg=f"grad {name}")
        n, before = _hold_and_align(tt, jt, step, before)
        aligned += n
    assert tt.step_count == 3 == int(jt.state.step)
    assert aligned <= 0.05 * n_params, aligned
    ema_want = convert_atom_params(jax.tree_util.tree_map(
        np.asarray, jt.state.ema_params))
    for k, v in tt.ema.items():
        np.testing.assert_allclose(v.numpy(), ema_want[k].numpy(), **TOL,
                                   err_msg=f"ema {k}")


class _Stream:
    """``iter_epoch`` over one synthetic batch; asks the latch to stop after
    ``stop_after`` batches."""

    def __init__(self, n, stop=None, stop_after=None):
        self.batch = tds.synthetic_batch(2, horizon=H, seed=1)
        self.n, self.stop, self.stop_after = n, stop, stop_after

    def iter_epoch(self, batch_size, seed=0):
        for i in range(self.n):
            if self.stop is not None and i == self.stop_after:
                self.stop.request()
            yield self.batch


def _tiny_trainer():
    return AtomTrainer(tcfg.AtomModelConfig(**TINY_MODEL),
                       tcfg.AtomDiffusionConfig(**TINY_DIFF),
                       tcfg.AtomTrainConfig(batch_size=2), device="cpu")


def test_fit_checkpoints_and_stops_on_request(tmp_path):
    """``fit`` saves {params, ema_params, optimizer, step} every
    ``ckpt_every`` steps, and on a stop request saves the step it stopped
    at and returns; a restored state continues the run exactly."""
    trainer = _tiny_trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=None)
    state = trainer.fit(_Stream(5), epochs=2, ckpt_manager=mgr, ckpt_every=4,
                        max_steps=9)
    assert state["step"] == 9 and mgr.latest_step() == 8
    saved = mgr.restore(4)
    assert set(saved) == {"params", "ema_params", "optimizer", "step"}
    assert saved["step"] == 4

    stop = GracefulStop()
    trainer = _tiny_trainer()
    mgr = CheckpointManager(str(tmp_path / "stop"))
    state = trainer.fit(_Stream(50, stop, stop_after=3), epochs=1,
                        ckpt_manager=mgr, ckpt_every=100, stop=stop)
    # the host thread runs ahead of the steps, so the request can land a
    # step or two before the loop reaches that batch
    assert 1 <= state["step"] <= 4
    assert mgr.latest_step() == state["step"]

    resumed = _tiny_trainer()
    resumed.load_state(mgr.restore())
    batch = tds.synthetic_batch(2, horizon=H, seed=9)
    draws = resumed.diff.draw_loss_inputs(torch.Generator().manual_seed(0),
                                          _t(tds.training_arrays(batch, H)[0]))
    a = trainer.step(batch, draws=draws, deterministic=True)
    b = resumed.step(batch, draws=draws, deterministic=True)
    assert float(a["loss"]) == float(b["loss"])
    for p, q in zip(trainer.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)


def test_trainer_runs_on_cuda_unless_asked():
    """No fallback hides the device: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AtomTrainer(tcfg.AtomModelConfig(**TINY_MODEL))


def test_train_atom_command(tmp_path):
    """``train-atom`` on the CPU at the tiny config: checkpoints at
    --ckpt-every, the final state as one file, EMA weights that
    ``atom-infer --checkpoint`` reads."""
    out = str(tmp_path / "run")
    path = cli.main(["train-atom", "--device", "cpu", "--config",
                     "configs/tiny.yaml", "--synthetic", "--steps", "3",
                     "--ckpt-every", "2", "--seed", "1", "--out-dir", out])
    assert path == os.path.join(out, "atom.pt")
    state = load_single(path)
    assert state["step"] == 3
    assert os.listdir(os.path.join(out, "atom_ckpt")) == ["2"]
    model = MotionDecoder(tcfg.load_config("configs/tiny.yaml").atom_model)
    model.load_state_dict(state["ema_params"])
    assert os.path.isfile(os.path.join(out, "logs", "log.txt"))
