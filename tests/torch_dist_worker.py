"""One process of the gloo groups that ``tests/test_torch_distributed.py``
starts (it imports no JAX):

    python -m tests.torch_dist_worker <case> <rank> <world> <port> <out>

``trainers``: the three trainers at tiny sizes for a few steps on one
global batch, and a discriminator forward; ``tp``: the tensor-parallel
primitives on a (2, 2) mesh; ``cli``: ``train-diffusion --latents-only``
with the multi-process flags. Each writes what it computed to ``out``
(``torch.save``). The test calls ``trainer_results`` in its own process too,
without a group, for the one-process run of the same global batch.
"""

import sys

import numpy as np
import torch

# configs/tiny.yaml's sizes (the tests' own, copied: this module imports
# nothing of the JAX package)
ATOM_MODEL = dict(horizon=12, latent_dim=32, ff_size=64, num_layers=2,
                  num_heads=2, dropout=0.0)
ATOM_DIFF = dict(n_timesteps=20, sampling_steps=2)
AE = dict(channels=32, resolution=32, timesteps=4, embed_dim=4, depth=1,
          heads=2, dim_head=8, quant_depth=1, quant_heads=2, quant_mlp_dim=16,
          down=3)
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_heads=2, latent_res=4, latent_t=4)
MTOV_DIFF = dict(timesteps=20, sampling_timesteps=2)
LOSS = dict(disc_start=0, disc_ndf=8, disc_layers=1)
BATCH = 4           # the global batch


def _params(*modules) -> dict:
    return {f"{i}.{k}": p.detach().clone() for i, m in enumerate(modules)
            for k, p in m.named_parameters()}


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def atom_case() -> dict:
    from moditalker_tpu_torch.config import (AtomDiffusionConfig,
                                             AtomModelConfig, AtomTrainConfig)
    from moditalker_tpu_torch.core.sharding import mean_over_ranks
    from moditalker_tpu_torch.data.atom_dataset import synthetic_batch
    from moditalker_tpu_torch.train.atom import AtomTrainer

    tt = AtomTrainer(AtomModelConfig(**ATOM_MODEL),
                     AtomDiffusionConfig(**ATOM_DIFF),
                     AtomTrainConfig(batch_size=BATCH, seed=0), device="cpu")
    init = _params(tt.model)
    batch = synthetic_batch(BATCH, horizon=ATOM_MODEL["horizon"], seed=3)
    losses = [mean_over_ranks(tt.step(batch))]
    # the averaged gradient of the first step (Adan keeps it as prev_grad)
    grad = {f"0.{k}": tt.opt.state[p]["prev_grad"].clone()
            for k, p in tt.model.named_parameters()}
    losses += [mean_over_ranks(tt.step(batch)) for _ in range(2)]
    return {"losses": losses, "init": init, "params": _params(tt.model),
            "grad": grad}


def diffusion_case() -> dict:
    from moditalker_tpu_torch.config import (MtovAEConfig,
                                             MtovDiffusionConfig,
                                             MtovTrainConfig, MtovUNetConfig)
    from moditalker_tpu_torch.core.sharding import mean_over_ranks
    from moditalker_tpu_torch.data.mtov_dataset import synthetic_mtov_batch
    from moditalker_tpu_torch.models.mtov import ViTAutoencoder
    from moditalker_tpu_torch.train.mtov import (LatentDiffusionLoop,
                                                 MtovDiffusionTrainer)

    tt = MtovDiffusionTrainer(
        MtovUNetConfig(**UNET), MtovDiffusionConfig(**MTOV_DIFF),
        MtovTrainConfig(diffusion_batch_size=BATCH, seed=0), device="cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        aes = [ViTAutoencoder(MtovAEConfig(**AE)) for _ in range(2)]
    loop = LatentDiffusionLoop(tt, *aes)
    init = _params(tt.model)
    batch = synthetic_mtov_batch(BATCH, timesteps=4, resolution=32, seed=2)
    losses = [mean_over_ranks(loop.train_step(batch))]
    grad, after = _grads(tt.model), _params(tt.model)
    losses.append(mean_over_ranks(loop.train_step(batch)))
    return {"losses": losses, "init": init, "params": _params(tt.model),
            "grad": grad, "after": after}


def _grads(*modules) -> dict:
    return {f"{i}.{k}": (torch.zeros_like(p) if p.grad is None
                         else p.grad.clone())
            for i, m in enumerate(modules) for k, p in m.named_parameters()}


def first_stage_case() -> dict:
    from moditalker_tpu_torch.config import (MtovAEConfig, MtovLossConfig,
                                             MtovTrainConfig)
    from moditalker_tpu_torch.core.sharding import mean_over_ranks, rank_rows
    from moditalker_tpu_torch.train.mtov_first_stage import FirstStageTrainer

    tt = FirstStageTrainer(MtovAEConfig(**AE), MtovLossConfig(**LOSS),
                           MtovTrainConfig(batch_size=BATCH, accum_iter=2),
                           device="cpu")
    init = _params(tt.ae, tt.disc2d, tt.disc3d)
    rng = np.random.default_rng(1)
    videos = [rng.uniform(-1, 1, (BATCH, 4, 32, 32, 3)).astype(np.float32)
              for _ in range(4)]
    losses, kinds, cycles = [], [], {}
    for i, v in enumerate(videos):           # G, G, D, D
        kinds.append("d" if tt._disc_phase else "g")
        losses.append(mean_over_ranks(tt.step(v)))
        if i % 2:           # a cycle's mean gradient and where it stepped to
            nets = (tt.ae, tt.disc2d, tt.disc3d)
            keep = lambda d: {k: v for k, v in d.items()
                              if (k[0] == "0") == (i == 1)}
            cycles[kinds[-1]] = {"grad": keep(_grads(*nets)),
                                 "after": keep(_params(*nets))}
    frames = torch.from_numpy(rng.normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        logits = _gather_rows(tt.disc2d(rank_rows(frames))[0])
    return {"losses": losses, "kinds": kinds, "init": init,
            "params": _params(tt.ae, tt.disc2d, tt.disc3d), "cycles": cycles,
            "disc_frames": frames, "disc_logits": logits,
            "disc2d": {k: v.clone() for k, v in tt.disc2d.state_dict().items()}}


def stop_case() -> dict:
    """``AtomTrainer.fit`` with a stop requested on the last rank alone,
    while its batches are prepared: every rank must leave the loop at the
    same step (the latch is agreed each step), none waiting in a
    collective."""
    from moditalker_tpu_torch.config import (AtomDiffusionConfig,
                                             AtomModelConfig, AtomTrainConfig)
    from moditalker_tpu_torch.core.preempt import GracefulStop
    from moditalker_tpu_torch.core.sharding import rank_world
    from moditalker_tpu_torch.data.atom_dataset import synthetic_batch
    from moditalker_tpu_torch.train.atom import AtomTrainer

    tt = AtomTrainer(AtomModelConfig(**ATOM_MODEL),
                     AtomDiffusionConfig(**ATOM_DIFF),
                     AtomTrainConfig(batch_size=BATCH, seed=0), device="cpu")
    batch = synthetic_batch(BATCH, horizon=ATOM_MODEL["horizon"], seed=3)
    stop = GracefulStop()
    rank, world = rank_world()

    class Stream:
        def iter_epoch(self, batch_size, seed=0):
            for i in range(6):
                if i == 1 and rank == world - 1:
                    stop.request()
                yield batch

    tt.fit(Stream(), epochs=1, log_every=1, stop=stop)
    return {"steps": tt.step_count}


def trainer_results() -> dict:
    return {"atom": atom_case(), "diffusion": diffusion_case(),
            "first_stage": first_stage_case(), "stop": stop_case()}


def tp_results() -> dict:
    from moditalker_tpu_torch.parallel import tp

    mesh = tp.make_2d_mesh(2, 2, device_type="cpu")
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, w1, b1, w2, b2 = t(8, 32), t(32, 64), t(64), t(64, 16), t(16)
    data = lambda a: tp.shard(a, mesh, tp.DATA_AXIS, 0)
    h = tp.column_parallel_dense(mesh)(
        data(x), tp.shard(w1, mesh, tp.MODEL_AXIS, 1),
        tp.shard(b1, mesh, tp.MODEL_AXIS, 0))
    y = tp.row_parallel_dense(mesh)(h, tp.shard(w2, mesh, tp.MODEL_AXIS, 0),
                                    b2)
    dense = tp.gather(y, mesh, tp.DATA_AXIS, 0)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 16, 8, 8)).astype(
        np.float32)) for _ in range(3))
    local = lambda a: tp.shard(data(a), mesh, tp.MODEL_AXIS, 2)
    out = tp.head_parallel_attention(mesh, 8)(local(q), local(k), local(v))
    attn = tp.gather(tp.gather(out, mesh, tp.MODEL_AXIS, 2), mesh,
                     tp.DATA_AXIS, 0)
    return {"dense": dense, "attention": attn, "h_shard": h.shape}


def main() -> None:
    case, rank, world, port, out = sys.argv[1:]
    torch.set_num_threads(1)
    from moditalker_tpu_torch.core import sharding

    if case == "cli":
        from moditalker_tpu_torch import cli

        cli.main(["train-diffusion", "--latents-only", "--device", "cpu",
                  "--config", "configs/tiny.yaml", "--steps", "1",
                  "--batch-size", str(BATCH), "--out-dir", out,
                  "--coordinator", f"localhost:{port}", "--num-processes",
                  world, "--process-id", rank])
        sharding.shutdown()
        return
    sharding.init_distributed(f"localhost:{port}", int(world), int(rank),
                              device="cpu")
    result = trainer_results() if case == "trainers" else tp_results()
    torch.save(result, out)
    sharding.shutdown()


if __name__ == "__main__":
    main()
