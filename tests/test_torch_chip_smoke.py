"""``chip_smoke.py``'s CPU references, computed ahead in a worker process.

The small-depth checks hold a run on the card to the same run on the CPU.
``chip_smoke.py`` hands the CPU halves to one spawned worker when its kernels
phase ends (``CpuReferences``, the plan ``cpu_reference_jobs``) and each check
takes its result by the function and arguments it would have called
(``cpu_reference``). Here, on the CPU: the worker returns what the function
returns, tensors included; and every check the plan names asks for exactly
one of its jobs, in the plan's order, so that no CPU half is computed twice
or left to the check (the card's halves are never reached: the check is
stopped where it asks).
"""

import contextlib
import importlib.util
import os
import pathlib
import sys
import tempfile

import pytest
import torch

from .torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))   # the worker imports it by name
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def test_worker_returns_what_the_function_returns():
    """Two jobs through a spawned worker: each result equals the call made
    here; a call the plan does not hold is computed here; tensors cross as
    numpy arrays and come back as equal tensors."""
    smoke = _chip_smoke()
    jobs = [(smoke.first_stage_loss, {}),
            (smoke.reference_configs, dict(heads=4, frames=32))]
    refs = smoke.CpuReferences(jobs)
    try:
        assert refs.take(smoke.first_stage_loss) == smoke.first_stage_loss()
        # the same arguments with the defaults written out find the job
        assert refs.take(smoke.reference_configs, heads=4, frames=32,
                         model_channels=128) == smoke.reference_configs(
            heads=4, frames=32)
        assert refs.take(smoke.active_switches) == ()
    finally:
        refs.close()
    t = {"a": [torch.arange(6.0).reshape(2, 3)], "b": 1.5}
    sent = smoke._tree(t, lambda v: smoke._Array(v.numpy())
                       if isinstance(v, torch.Tensor) else v)
    back = smoke._tree(sent, lambda v: torch.from_numpy(v.values)
                       if isinstance(v, smoke._Array) else v)
    assert torch.equal(back["a"][0], t["a"][0]) and back["b"] == 1.5


def test_worker_and_this_process_share_no_core():
    """While jobs are left the worker and this process run on disjoint
    halves of this process's cores, every thread of this process on its
    half; once the last job is taken this process has all of them and its
    torch threads back."""
    smoke = _chip_smoke()
    cpus = sorted(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    if len(cpus) < 2:
        pytest.skip("one core: nothing to split")
    refs = smoke.CpuReferences([(smoke.first_stage_loss, {}),
                                (smoke.active_switches, {})])
    try:
        half = len(cpus) // 2
        assert refs.take(smoke.first_stage_loss) == smoke.first_stage_loss()
        (worker,) = refs.pool._processes
        assert sorted(os.sched_getaffinity(worker)) == cpus[half:]
        for tid in os.listdir("/proc/self/task"):
            with contextlib.suppress(ProcessLookupError):   # ended since
                assert sorted(os.sched_getaffinity(int(tid))) == cpus[:half]
        assert torch.get_num_threads() == half
        assert refs.take(smoke.active_switches) == ()
        assert sorted(os.sched_getaffinity(0)) == cpus
        assert torch.get_num_threads() == threads
    finally:
        refs.close()
    assert sorted(os.sched_getaffinity(0)) == cpus


class _Asked(Exception):
    pass


def test_every_check_asks_for_its_planned_job(monkeypatch):
    """The reference windows, the train-diffusion steps and the first-stage
    checks, called with the arguments their phases give them, each ask for
    the job the plan holds at its place, in order."""
    smoke = _chip_smoke()
    asked = []

    def record(fn, **kwargs):
        asked.append(smoke._job_key(fn, kwargs))
        raise _Asked

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(smoke, "cpu_reference", record)
    for name in smoke.SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def ask(fn, *args, modular=False, **kwargs):
        with smoke.modular_attention() if modular else \
                smoke.contextlib.nullcontext():
            with pytest.raises(_Asked):
                fn(torch, 0, *args, **kwargs)

    from moditalker_tpu_torch.config import load_config

    ask(smoke.reference_phase, "fused", smoke.FUSED_PATH)
    ask(smoke.reference_phase, "modular", smoke.MODULAR_PATH, heads=4,
        batch=2, modular=True)
    ask(smoke.reference_phase, "longvid fused", smoke.LONGVID_PATH,
        model_channels=256)
    ask(smoke.reference_phase, "longvid modular", smoke.MODULAR_PATH,
        heads=4, batch=2, model_channels=256, modular=True)
    ask(smoke.train_step_check)
    ask(smoke.train_step_check, True)
    ask(smoke.train_step_check, model_channels=256)
    ask(smoke.first_stage_check)
    ask(smoke.first_stage_check,
        load_config("configs/autoencoder/base.yaml").mtov_loss)
    ask(smoke.first_stage_check,
        load_config("configs/autoencoder/base_ldmk.yaml").mtov_loss,
        freeze_decoder=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {name: load_config(smoke.variant_yaml(name, tmp))
               for name in smoke.VARIANTS}
    frames = cfg["clip32"].mtov_ae.timesteps
    ask(smoke.reference_phase, "clip32", smoke.FUSED_PATH, frames=frames)
    ask(smoke.reference_phase, "clip32 modular", smoke.MODULAR_PATH,
        heads=4, batch=2, frames=frames, modular=True)
    clip8 = cfg["clip8"]
    ask(smoke.first_stage_check, clip8.mtov_loss,
        frames=clip8.mtov_ae.timesteps)
    unet = cfg["channels192"].mtov_unet
    ask(smoke.reference_phase, "channels192", smoke.LONGVID_PATH,
        model_channels=unet.model_channels)
    unet = cfg["num_heads2"].mtov_unet
    ask(smoke.reference_phase, "num_heads2", smoke.LONGVID_PATH,
        model_channels=unet.model_channels, unet_heads=unet.num_heads)
    for h, d in smoke.VARIANT_AE_HEADS:
        ae = cfg[f"ae_heads{h}x{d}"].mtov_ae
        ask(smoke.reference_phase, "ae", smoke.FUSED_PATH, heads=ae.heads,
            dim_head=ae.dim_head)
        ask(smoke.first_stage_check, heads=ae.heads, dim_head=ae.dim_head)
    assert not any(os.environ.get(name) for name in smoke.SWITCHES)
    planned = [smoke._job_key(fn, kw)
               for fn, kw in smoke.cpu_reference_jobs(0)]
    assert asked == planned
