"""The port's training runtime vs the JAX package: learning-rate schedules,
Adan, EMA, checkpoints, the preemption latch and the metric log.

Schedules are held at 1e-7 over 0 … 30 000 steps, Adan's 20-step
trajectory at 1e-5 on a fixed sequence of numpy gradients (ROADMAP §A12),
EMA at 1e-7. Both packages run float32 on the CPU.
"""

import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moditalker_tpu.core import adan as jadan
from moditalker_tpu.core import ema as jema
from moditalker_tpu.core import lr_schedules as jlr
from moditalker_tpu_torch.core import ema, lr_schedules
from moditalker_tpu_torch.core.adan import Adan
from moditalker_tpu_torch.core.checkpoint import (CheckpointManager,
                                                  load_single, save_single)
from moditalker_tpu_torch.core.logging import MetricLogger
from moditalker_tpu_torch.core.preempt import GracefulStop

STEPS = np.arange(0, 30001)
# the JAX schedules' default cycle_length (1e13) overflows the int32 a jitted
# argument parses into, so the comparisons name one that fits
LONG_CYCLE = 10**9


@pytest.mark.parametrize("kind,kw", [
    ("linear", dict(base_lr=1e-4, warm_up_steps=10000,
                    cycle_length=LONG_CYCLE)),
    ("linear", dict(base_lr=3e-4, warm_up_steps=500, f_start=1e-3,
                    f_min=0.5, cycle_length=20000)),
    ("cosine", dict(base_lr=1e-4, warm_up_steps=1000, cycle_length=20000)),
    ("cosine", dict(base_lr=1e-4, warm_up_steps=1000,
                    cycle_length=LONG_CYCLE)),
    ("cosine", dict(base_lr=2e-3, warm_up_steps=0, lr_min=0.1, lr_start=0.5,
                    cycle_length=15000)),
])
def test_lr_schedules_match_jax(kind, kw):
    name = {"linear": "lambda_linear_schedule",
            "cosine": "lambda_warmup_cosine_schedule"}[kind]
    want = np.asarray(getattr(jlr, name)(**kw)(jnp.asarray(STEPS)))
    sched = getattr(lr_schedules, name)(**kw)
    got = np.array([sched(int(s)) for s in STEPS])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _shapes():
    return {"w": (7, 5), "b": (5,), "emb": (3, 4, 2)}


def _grad_sequence(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32)
             for k, s in _shapes().items()} for _ in range(n)]


@pytest.mark.parametrize("lr,wd", [(4e-4, 0.02), (1e-2, 0.0), (5e-3, 0.3)])
def test_adan_trajectory_matches_jax(lr, wd):
    """20 steps from the same parameters on the same gradients: every
    parameter within 1e-5 of the JAX package's after every step."""
    rng = np.random.default_rng(1)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in _shapes().items()}
    grads = _grad_sequence()
    tx = jadan.adan(learning_rate=lr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = Adan(tp.values(), lr=lr, weight_decay=wd)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in init:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-5)


def test_adan_first_step_is_weight_decay_only():
    """No moment update on step 1: the parameters are divided by
    1 + wd·lr and nothing else; ``prev_grad`` holds step 1's gradient."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    opt = Adan([p], lr=0.1, weight_decay=0.5)
    p.grad = torch.tensor([10.0, 20.0, -5.0])
    opt.step()
    torch.testing.assert_close(p.detach(),
                               torch.tensor([1.0, -2.0, 3.0]) / 1.05)
    st = opt.state[p]
    assert st["step"] == 1
    for k in ("m", "v", "n"):
        assert not st[k].any()
    torch.testing.assert_close(st["prev_grad"], p.grad)


def test_ema_functions_match_jax():
    rng = np.random.default_rng(0)
    e0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in _shapes().items()}
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in _shapes().items()}
    want = jema.ema_update(e0, p0, 0.9)
    got = {k: torch.from_numpy(v.copy()) for k, v in e0.items()}
    ema.ema_update(got, {k: torch.from_numpy(v) for k, v in p0.items()}, 0.9)
    for k in e0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-7)
    for n in (0, 1, 5, 100, 10**6):
        assert ema.warmup_decay(n) == pytest.approx(
            float(jema.warmup_decay(n)), abs=1e-7)
    for step in (24, 25, 50):
        want = jema.ema_update_every(e0, p0, 0.99, step, 25)
        got = {k: torch.from_numpy(v.copy()) for k, v in e0.items()}
        ran = ema.ema_update_every(
            got, {k: torch.from_numpy(v) for k, v in p0.items()}, 0.99,
            step, 25)
        assert ran == (step % 25 == 0)
        for k in e0:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-7)


def test_ema_copy_is_detached_and_updates_in_place():
    m = torch.nn.Linear(3, 2)
    e = ema.ema_copy(m)
    assert set(e) == {"weight", "bias"}
    assert all(not t.requires_grad for t in e.values())
    before = e["weight"]
    with torch.no_grad():
        m.weight.add_(1.0)
    ema.ema_update(e, m.named_parameters(), 0.5)
    assert e["weight"] is before
    torch.testing.assert_close(e["weight"], m.weight.detach() - 0.5)


def _state(step):
    torch.manual_seed(step)
    m = torch.nn.Linear(4, 3)
    opt = Adan(m.parameters(), lr=1e-3, weight_decay=0.02)
    m(torch.randn(2, 4)).sum().backward()
    opt.step()
    return {"params": m.state_dict(), "ema": ema.ema_copy(m),
            "optimizer": opt.state_dict(), "step": step}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def test_checkpoint_manager_saves_async_keeps_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    states = {s: _state(s) for s in (1, 2, 3)}
    for s, st in states.items():
        mgr.save(s, st)              # on a thread
    # the save copied the tree: changing the live state does not reach it
    states[3]["params"]["weight"].add_(100.0)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]
    assert mgr.latest_step() == 3
    back = mgr.restore()
    assert back["step"] == 3
    assert not torch.equal(back["params"]["weight"],
                           states[3]["params"]["weight"])
    assert _same(mgr.restore(2), states[2])
    with pytest.raises(KeyError, match="template"):
        mgr.restore(template={"params": None, "step": None})
    mgr.save(4, _state(4), blocking=True)
    assert mgr.latest_step() == 4
    mgr.close()


def test_optimizer_resume_continues_the_trajectory(tmp_path):
    """Saving {params, optimizer} and restoring into a fresh model and Adan
    continues exactly as the uninterrupted run."""
    def batch(i):
        g = torch.Generator().manual_seed(i)
        return torch.randn(8, 4, generator=g)

    def run(m, opt, steps):
        for i in steps:
            opt.zero_grad()
            m(batch(i)).square().sum().backward()
            opt.step()

    torch.manual_seed(0)
    m = torch.nn.Linear(4, 3)
    opt = Adan(m.parameters(), lr=1e-2, weight_decay=0.02)
    run(m, opt, range(3))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"params": m.state_dict(), "optimizer": opt.state_dict()})
    run(m, opt, range(3, 6))
    m2 = torch.nn.Linear(4, 3)
    opt2 = Adan(m2.parameters(), lr=1e-2, weight_decay=0.02)
    st = mgr.restore()
    m2.load_state_dict(st["params"])
    opt2.load_state_dict(st["optimizer"])
    run(m2, opt2, range(3, 6))
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_save_single_roundtrip(tmp_path):
    st = _state(5)
    path = str(tmp_path / "exports" / "ema.pt")
    save_single(path, st)
    assert _same(load_single(path), st)


def test_graceful_stop_latches_on_a_signal_and_restores_the_handler():
    before = signal.getsignal(signal.SIGUSR1)
    stop = GracefulStop().install(signals=(signal.SIGUSR1,))
    assert not stop.requested
    os.kill(os.getpid(), signal.SIGUSR1)
    assert stop.requested
    assert signal.getsignal(signal.SIGUSR1) == before
    other = GracefulStop()
    other.request()
    assert other.requested


def test_metric_logger_writes_text_and_jsonl(tmp_path):
    log = MetricLogger(str(tmp_path / "logs"), use_tensorboard=False)
    log.log_text("hello")
    log.log_scalars(3, {"loss": torch.tensor(0.5), "recon": 1})
    log.close()
    text = (tmp_path / "logs" / "log.txt").read_text()
    assert text.endswith("hello\n")
    rec = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["recon"] == 1.0

