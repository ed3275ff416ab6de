"""The port's distribution (``core/sharding.py``, the trainers under a
process group, ``parallel/tp.py``) and data-parallel inference, on the CPU.

* Two gloo processes run each trainer (AToM, latent diffusion through the
  frozen AEs, the first stage) for a few steps on one global batch, each
  process on its half: the ranks' parameters and averaged losses are
  identical, and equal a one-process run on the whole batch within float32
  summation order (losses relative 1e-5; the first step's or cycle's
  gradient and update held as the trainers' JAX parity tests hold them,
  ``_hold_cycle``; AToM's Adan elementwise at 2e-4 with a counted share
  off). The
  first stage's discriminators normalise with the global batch's
  statistics: the gathered logits equal the one-process forward, and
  differ from per-half statistics. A stop requested on one rank stops
  every rank at one step.
* ``train-diffusion --latents-only`` with ``--coordinator`` etc. in two
  processes: rank 0 alone writes, and the final state equals one process's.
* ``init_distributed`` raises on a bad explicit configuration; torchrun's
  environment at world size 1 starts a group.
* ``tp.py`` over four gloo processes on a (2, 2) mesh at
  ``tests/test_parallel.py``'s shapes equals the dense ops and the JAX
  functions on the (2, 4) virtual mesh.
* ``sample`` and ``atom-infer`` at ``data_parallel=2``: the batch padded by
  repetition to a multiple of 2, split, trimmed, with the padded batch's
  draws; equal to ``data_parallel=1`` on the same padded batch.

Every subprocess has its own timeout (SUBPROCESS_TIMEOUT).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from moditalker_tpu_torch import cli
from moditalker_tpu_torch import config as tcfg
from moditalker_tpu_torch.core import sharding
from moditalker_tpu_torch.models.atom import MotionDecoder
from moditalker_tpu_torch.models.mtov import TriplaneUNet, ViTAutoencoder
from moditalker_tpu_torch.pipelines.atom_infer import AtomInferencePipeline
from moditalker_tpu_torch.pipelines.data_parallel import (SharedDraws,
                                                          pad_rows, round_up)
from moditalker_tpu_torch.pipelines.mtov_sample import MtovSamplePipeline

from . import torch_dist_worker as worker
from .test_torch_train_first_stage import TOL, _hold_cycle
from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT = 120
# float32 summation order (a batch mean over 4 rows against the mean of two
# 2-row means; the CPU's matmuls and convolutions block a 2-row batch
# otherwise than a 4-row one) moves a loss by ~1e-7 relative and a gradient
# by 1e-7 to 5e-5 relative L2 (held to TOL, 1e-4, the trainers' parity
# tests' limit). AdamW's first step moves an element by lr·g/(|g| + 1e-8):
# an element whose gradient lies within that difference takes the sign of
# its rounding, and one just above it a step of another size, so the update
# is held over the elements ``_hold_cycle`` finds determined, to UPDATE_TOL
# (readings 2.0e-5 to 7.1e-4), and the rest counted (at most LEFT_OUT,
# readings 0.12 to 0.26 %). AToM's Adan is ill-conditioned from its second
# step on (ROADMAP §C): its parameters are held elementwise to 2e-4
# (DESIGN.md §6) but at a counted share of at most ADAN_OFF_SHARE
LOSS_TOL = 1e-5
UPDATE_TOL = 2e-3
LEFT_OUT = 0.01
ADAN_OFF_SHARE = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(case: str, world: int, out_dir) -> list[str]:
    """``world`` worker processes of ``case``; returns their output paths
    (``out_dir`` itself for the cli case)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [str(out_dir) if case == "cli" else
            os.path.join(out_dir, f"{case}-{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", case, str(r),
         str(world), str(port), outs[r]], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SUBPROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return outs


def _rel(a: dict, b: dict) -> float:
    num = sum(float((a[k] - b[k]).square().sum()) for k in b)
    return (num / sum(float(b[k].square().sum()) for k in b)) ** 0.5


def _hold(grad, want_grad, after, want_after, init) -> tuple:
    """``_hold_cycle``'s (gradient error, update error, share left out),
    each held to its limit above."""
    errs = _hold_cycle(grad, want_grad,
                       {k: after[k] - init[k] for k in want_after},
                       {k: want_after[k] - init[k] for k in want_after})
    g_err, u_err, left = errs
    assert g_err <= TOL and u_err <= UPDATE_TOL and left <= LEFT_OUT, errs
    return errs


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    outs = _launch("trainers", 2, d)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    return ranks, worker.trainer_results()


@pytest.mark.parametrize("case", ["atom", "diffusion", "first_stage"])
def test_two_processes_equal_one_on_the_global_batch(trainer_runs, case):
    """Reads: losses within 1e-7 relative; AToM's first gradient 1.1e-7
    relative L2 and one parameter element of 149 772 off by more than 2e-4
    (2.6e-3); latent diffusion's gradient 3.2e-6, update 7.1e-4 (0.12 %
    left out); the first stage's G cycle 4.5e-6 and 1.6e-5 (0.03 %), its D
    cycle 4.5e-5 and 2.0e-5 (0.26 %)."""
    ranks, single = trainer_runs
    r0, r1 = ranks[0][case], ranks[1][case]
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    assert r0["losses"] == r1["losses"]
    want = single[case]
    for k, v in r0["init"].items():
        assert torch.equal(v, want["init"][k]), k
    for got_step, want_step in zip(r0["losses"], want["losses"], strict=True):
        for k, v in want_step.items():
            assert got_step[k] == pytest.approx(v, rel=LOSS_TOL, abs=1e-8), k
    if case == "atom":
        err = _rel(r0["grad"], want["grad"])
        assert err <= TOL, err
        off = sum(int(((r0["params"][k] - v).abs() > 2e-4).sum())
                  for k, v in want["params"].items())
        total = sum(v.numel() for v in want["params"].values())
        assert off <= ADAN_OFF_SHARE * total, (off, total)
    elif case == "diffusion":
        _hold(r0["grad"], want["grad"], r0["after"], want["after"],
              want["init"])
    else:
        assert set(want["cycles"]) == {"g", "d"}
        for kind, cyc in want["cycles"].items():
            _hold(r0["cycles"][kind]["grad"], cyc["grad"],
                  r0["cycles"][kind]["after"], cyc["after"], want["init"])
        assert r0["kinds"] == want["kinds"] == ["g", "g", "d", "d"]


def test_discriminators_see_global_batch_statistics(trainer_runs):
    """The 2D discriminator's logits, each process on its half of the
    frames and the halves gathered, equal one process on all of them
    (1e-5), and not a BatchNorm over each half alone."""
    ranks, single = trainer_runs
    got = ranks[0]["first_stage"]["disc_logits"]
    want = single["first_stage"]["disc_logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    from moditalker_tpu_torch.models.mtov.losses import PatchDiscriminator2D

    d2 = PatchDiscriminator2D(ndf=8, n_layers=1)
    d2.load_state_dict(ranks[0]["first_stage"]["disc2d"])
    frames = single["first_stage"]["disc_frames"]
    with torch.no_grad():
        per_half = torch.cat([d2(h)[0] for h in frames.chunk(2)])
    assert float((per_half - got).abs().max()) > 1e-2 * float(
        want.abs().max())


def test_a_stop_on_one_rank_stops_every_rank_at_one_step(trainer_runs):
    """A stop requested on rank 1 alone: both ranks leave ``fit`` after the
    same step, early (the one-process run stops likewise)."""
    ranks, single = trainer_runs
    steps = [r["stop"]["steps"] for r in ranks]
    assert steps[0] == steps[1] and 1 <= steps[0] < 6, steps
    assert 1 <= single["stop"]["steps"] < 6


def test_cli_trainer_over_two_processes(tmp_path):
    """``train-diffusion --latents-only --coordinator ... --num-processes 2``
    for one step: one final state, written by rank 0, equal to a
    one-process run of the same global batch (the gradient from AdamW's
    first moment, and the update, held as above)."""
    multi = tmp_path / "multi"
    _launch("cli", 2, multi)
    single = tmp_path / "single"
    cli.main(["train-diffusion", "--latents-only", "--device", "cpu",
              "--config", "configs/tiny.yaml", "--steps", "1",
              "--batch-size", str(worker.BATCH), "--out-dir", str(single)])
    assert sorted(os.listdir(multi)) == ["diffusion.pt"]
    got = torch.load(multi / "diffusion.pt", weights_only=True)
    want = torch.load(single / "diffusion.pt", weights_only=True)
    assert got["step"] == want["step"] == 1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(42)   # the trainer's seed: --seed's default
        unet = TriplaneUNet(tcfg.MtovUNetConfig(**worker.UNET))
    names = [k for k, _ in unet.named_parameters()]
    init = dict(unet.named_parameters())

    def grads(state):   # exp_avg = (1 − b1)·g after AdamW's first step
        return {k: state["optimizer"]["state"][i]["exp_avg"] / 0.1
                for i, k in enumerate(names)}

    _hold(grads(got), grads(want), got["params"], want["params"],
          {k: v.detach() for k, v in init.items()})


def test_init_distributed_refuses_a_bad_explicit_configuration():
    with pytest.raises(ValueError, match="host:port"):
        sharding.init_distributed("localhost", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        sharding.init_distributed("localhost:http", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        sharding.init_distributed("localhost:1234", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="go together"):
        sharding.init_distributed("localhost:1234", None, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_no_arguments_run_one_process_or_read_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert sharding.init_distributed(device="cpu") is False
    assert sharding.rank_world() == (0, 1) and sharding.make_mesh() is None
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert sharding.init_distributed(device="cpu") is True
        assert sharding.rank_world() == (0, 1) and sharding.is_main()
        mesh = sharding.make_mesh("cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        assert sharding.agree(False) is False and sharding.agree(True)
        assert sharding.mean_over_ranks({"a": torch.tensor(2.5)}) == {
            "a": 2.5}
        g = [torch.ones(3), torch.full((2, 2), 3.0)]
        sharding.all_reduce_grads(g)
        assert torch.equal(g[1], torch.full((2, 2), 3.0))
    finally:
        sharding.shutdown()
    assert not torch.distributed.is_initialized()


def test_shard_batch_keeps_this_ranks_rows():
    x = np.arange(12).reshape(6, 2)
    assert np.array_equal(sharding.rank_rows(x, 1, 3), x[2:4])
    with pytest.raises(ValueError):
        sharding.rank_rows(x, 0, 4)
    got = sharding.shard_batch({"a": x, "b": [x]}, "cpu")
    assert torch.equal(got["a"], torch.as_tensor(x))
    assert sharding.global_proxy(torch.zeros(2, 3)).shape == (2, 3)
    batches = [{"v": torch.full((2,), float(i))} for i in range(3)]
    assert [float(b["v"][0]) for b in
            sharding.device_prefetch(iter(batches), "cpu")] == [0, 1, 2]


# ------------------------------------------------------------------- tp.py
def test_tensor_parallel_primitives_match_dense_and_jax(tmp_path):
    """Four processes on a (2, 2) mesh, at tests/test_parallel.py's shapes:
    column → row dense and head-parallel attention (through the port's
    ``sdpa``) equal the dense ops (1e-5) and the JAX functions on the (2, 4)
    virtual mesh (1e-5)."""
    import jax.numpy as jnp

    from moditalker_tpu.parallel import (column_parallel_dense,
                                         head_parallel_attention,
                                         make_2d_mesh, row_parallel_dense)

    outs = _launch("tp", 4, tmp_path)
    got = [torch.load(o, weights_only=False) for o in outs]
    for g in got[1:]:
        assert torch.equal(g["dense"], got[0]["dense"])
        assert torch.equal(g["attention"], got[0]["attention"])
    assert tuple(got[0]["h_shard"]) == (4, 32)
    rng = np.random.default_rng(0)
    x, w1, b1, w2, b2 = (rng.normal(size=s).astype(np.float32) for s in
                         ((8, 32), (32, 64), (64,), (64, 16), (16,)))
    dense = (x @ w1 + b1) @ w2 + b2
    mesh = make_2d_mesh(2, 4)
    jax_y = np.asarray(row_parallel_dense(mesh)(
        column_parallel_dense(mesh)(x, w1, b1), w2, b2))
    for want in (dense, jax_y):
        np.testing.assert_allclose(got[0]["dense"].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(4, 16, 8, 8)).astype(np.float32)
               for _ in range(3))
    s = np.einsum("bnhd,bmhd->bhnm", q, k) / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    attn = np.einsum("bhnm,bmhd->bnhd", p, v)
    jax_attn = np.asarray(head_parallel_attention(mesh, 8)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for want in (attn, jax_attn):
        np.testing.assert_allclose(got[0]["attention"].numpy(), want,
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- data-parallel inference
def test_shared_draws_hand_each_replica_its_rows():
    g = torch.Generator().manual_seed(0)
    full = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    shared = SharedDraws(g, 2)
    a, b = shared.draw(0), shared.draw(1)
    assert torch.equal(b((2, 3), torch.float32), full[2:])
    assert torch.equal(a((2, 3), torch.float32), full[:2])
    assert round_up(3, 2) == 4 and round_up(4, 4) == 4
    assert pad_rows(np.arange(3), 2).tolist() == [0, 1, 2, 2]


def test_shared_state_under_many_threads():
    """The launch counters and ``SharedDraws`` under 16 threads with a
    shortened switch interval: no count lost, and every replica's k-th draw
    the rows of one padded-batch draw (a lost or doubled draw would shift
    them)."""
    import threading

    from moditalker_tpu_torch.ops import kernels

    n, calls = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch("packed_attention", (1, 2)) for _ in
            range(calls)]) for _ in range(n)]
        shared = SharedDraws(torch.Generator().manual_seed(7), n)
        got = [None] * n

        def draw(r):
            fn = shared.draw(r)
            got[r] = [fn((1, 4), torch.float32) for _ in range(20)]

        threads += [threading.Thread(target=draw, args=(r,))
                    for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernels.LAUNCHES["packed_attention"] == n * calls
    assert kernels.LAUNCHES_BY_SHAPE["packed_attention"][(1, 2)] == n * calls
    kernels.reset_launch_counts()
    want = torch.Generator().manual_seed(7)
    for k in range(20):
        full = torch.randn((n, 4), generator=want)
        for r in range(n):
            assert torch.equal(got[r][k], full[r:r + 1]), (k, r)


def _tiny_states():
    ae, unet = tcfg.MtovAEConfig(**worker.AE), tcfg.MtovUNetConfig(**worker.UNET)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return (ViTAutoencoder(ae).state_dict(),
                ViTAutoencoder(ae).state_dict(),
                TriplaneUNet(unet).state_dict()), ae, unet


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, 256, (1, 4, 32, 32, 3), dtype=np.uint8)
             for k in ("x_l", "masked_x", "x_ref")} for _ in range(n)]


def test_sample_data_parallel_pads_splits_and_trims():
    states, ae, unet = _tiny_states()
    diff = tcfg.MtovDiffusionConfig(**worker.MTOV_DIFF)
    pipes = {n: MtovSamplePipeline(*states, ae, unet, diff,
                                   dtype=torch.float32, device="cpu",
                                   data_parallel=n) for n in (1, 2)}
    assert len(pipes[2].replicas) == 2 and len(pipes[1].replicas) == 1
    # a window batch of 3 → padded to 4, split 2 + 2, trimmed to 3; the
    # same as one replica on the batch padded by hand
    w = _windows(3)
    stacked = {k: np.concatenate([x[k] for x in w]) for k in w[0]}
    got = pipes[2].sample_window(stacked["x_l"], stacked["masked_x"],
                                 stacked["x_ref"],
                                 torch.Generator().manual_seed(1))
    padded = {k: pad_rows(v, 2) for k, v in stacked.items()}
    want = pipes[1].sample_window(padded["x_l"], padded["masked_x"],
                                  padded["x_ref"],
                                  torch.Generator().manual_seed(1))
    assert got.shape[0] == 3 and want.shape[0] == 4
    np.testing.assert_allclose(got.numpy(), want[:3].numpy(), rtol=0,
                               atol=1e-5)
    # the autoregressive chain over two replicas (B = 2: the last frame of
    # each row is the next window's reference) and independent windows at
    # batch 3 (rounded up to 4) equal one replica's
    ar = [{k: np.concatenate([x[k], x[k]]) for k in x} for x in _windows(2, 3)]
    long = {n: pipes[n].sample_long(ar, torch.Generator().manual_seed(2))
            for n in (1, 2)}
    assert long[2].shape == (2, 8, 32, 32, 3)
    assert np.abs(long[2].astype(int) - long[1].astype(int)).max() <= 1
    ind = {n: pipes[n].sample_independent(_windows(5, 4),
                                          torch.Generator().manual_seed(3),
                                          batch=3 if n == 2 else 4)
           for n in (1, 2)}
    assert ind[2].shape == (1, 20, 32, 32, 3)
    assert np.abs(ind[2].astype(int) - ind[1].astype(int)).max() <= 1


def test_atom_infer_data_parallel_matches_one_replica(tmp_path):
    mc = tcfg.AtomModelConfig(**worker.ATOM_MODEL)
    dc = tcfg.AtomDiffusionConfig(**worker.ATOM_DIFF)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = MotionDecoder(mc).state_dict()
    rng = np.random.default_rng(0)
    ids = {f"id{i}": (rng.normal(size=(68, 3)), rng.normal(size=(30, 1024)))
           for i in range(3)}
    out = {}
    for n, batch in ((2, None), (1, 4)):   # 3 identities → one chunk of 4
        pipe = AtomInferencePipeline(state, mc, dc, device="cpu",
                                     data_parallel=n)
        paths = pipe.run_directory(ids, str(tmp_path / str(n)), seed=0,
                                   batch=batch,
                                   generator=torch.Generator().manual_seed(5))
        out[n] = {k: np.load(p) for k, p in paths.items()}
    for k in ids:
        np.testing.assert_allclose(out[2][k], out[1][k], rtol=0, atol=1e-5)


def test_data_parallel_flags_parse():
    p = cli.build_parser()
    a = p.parse_args(["sample", "--frames-dir", "f", "--aligned-dir", "a",
                      "--data-parallel", "2"])
    b = p.parse_args(["atom-infer", "--keypoint-dir", "k", "--hubert", "h"])
    t = p.parse_args(["train-atom", "--coordinator", "localhost:1",
                      "--num-processes", "2", "--process-id", "1"])
    assert a.data_parallel == 2 and b.data_parallel is None
    assert (t.coordinator, t.num_processes, t.process_id) == (
        "localhost:1", 2, 1)
