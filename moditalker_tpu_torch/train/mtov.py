"""MToV latent-diffusion training (port of ``moditalker_tpu/train/mtov.py``;
ref MToV/tools/trainer.py:23-131 and exps/diffusion.py:56-177): frozen-AE
latent extraction, the DDPM loss, AdamW (lr 1e-4; the reference never steps
its LambdaLinearScheduler, so the warm-up is an option), an EMA of the UNet
every 25 steps, EMA-only checkpoints.

One device, chosen explicitly (``cuda`` unless the caller asks for the
CPU); models in float32, as the JAX trainer builds them. On the card the
frozen AEs' divided space and time attention and the UNet's packed and
one-pass attention run the hand-written kernels in float32 (bf16 operands,
fp32 accumulators, ``ops/kernels/convert.py``), and the UNet's gradient
flows through them (``ops/kernels/autograd.py``). The loss's draws (t,
noise) come from a CPU ``torch.Generator`` seeded from the config, so a run
on the card and one on the CPU see the same numbers. A background thread
prepares the host batches, as the JAX package's ``background_iter`` does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import MtovDiffusionConfig, MtovTrainConfig, MtovUNetConfig
from ..core.ema import ema_copy, ema_update_every
from ..data.prefetch import background_iter
from ..device import resolve_device
from ..models.mtov import MtovDDPM, TriplaneUNet

EMA_DECAY = 0.9999
VIDEO_KEYS = ("x", "x_l", "masked_x", "x_ref")


def make_optimizer(params, train_cfg: MtovTrainConfig,
                   use_warmup: bool = False):
    """(AdamW, LambdaLR or None) with optax.adamw's defaults, not torch's:
    betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's AdamW
    defaults to 1e-2). ``use_warmup``: LambdaLinearScheduler's warm-up
    (tools/scheduler.py:81-97) as optax.linear_schedule, a linear ramp from
    lr·1e-6 to lr over ``warmup_steps``, then constant."""
    opt = torch.optim.AdamW(params, lr=train_cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    if not use_warmup:
        return opt, None
    warm = max(train_cfg.warmup_steps, 1)
    ramp = lambda step: 1e-6 + (1.0 - 1e-6) * min(step, warm) / warm
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, ramp)


def _host_tensors(batch: dict, keys, pin: bool) -> dict:
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
        out[k] = t.pin_memory() if pin else t
    return out


class MtovDiffusionTrainer:
    """Second-stage trainer: the UNet, AdamW, the EMA and the loss's
    generator on one device. ``state_dict``: the UNet's weights to start
    from (default: drawn from ``train_cfg.seed``)."""

    def __init__(self, unet_cfg: MtovUNetConfig = MtovUNetConfig(),
                 diff_cfg: MtovDiffusionConfig = MtovDiffusionConfig(),
                 train_cfg: MtovTrainConfig = MtovTrainConfig(),
                 device=None, state_dict: dict | None = None):
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            model = TriplaneUNet(unet_cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.ddpm = MtovDDPM.create(self.model, diff_cfg, self.device)
        self.opt, _ = make_optimizer(self.model.parameters(), train_cfg)
        self.ema = ema_copy(self.model)
        self.step_count = 0
        self.generator = torch.Generator().manual_seed(train_cfg.seed + 1)

    def state(self) -> dict:
        return {"params": self.model.state_dict(), "ema_params": self.ema,
                "optimizer": self.opt.state_dict(), "step": self.step_count}

    def train_step(self, latents: dict, draws=None) -> dict:
        """One step on device latents {z [B,4,L], cond [B,8,L], image_cond
        [B,4,L]}; ``draws``: (t, noise), else from the trainer's generator.
        Returns the loss terms as device tensors (no sync)."""
        z = latents["z"]
        if draws is None:
            draws = self.ddpm.draw_loss_inputs(self.generator, z)
        loss, aux = self.ddpm.p_losses(z, latents["cond"],
                                       latents["image_cond"], *draws)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        ema_update_every(self.ema, self.model.named_parameters(), EMA_DECAY,
                         self.step_count, self.train_cfg.ema_interval)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    def step(self, batch: dict, draws=None) -> dict:
        """One step on host latents (numpy or tensors)."""
        return self.train_step({k: torch.as_tensor(v).to(self.device)
                                for k, v in batch.items()}, draws)

    @contextlib.contextmanager
    def ema_weights(self):
        """The UNet holds its EMA weights inside the block, its own after."""
        params = dict(self.model.named_parameters())
        kept = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self.ema[k])
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(kept[k])


@torch.no_grad()
def extract_latents(ae_rgb, ae_ldmk, batch: dict) -> dict:
    """Frozen-AE latent extraction (the reference does it under no_grad each
    step, trainer.py:88-96; the JAX package under stop_gradient). batch:
    {x, x_l, masked_x, x_ref} videos [B, T, H, W, 3] in [-1, 1] →
    {z, cond, image_cond}."""
    z = ae_rgb.extract(batch["x"])
    z_l = ae_ldmk.extract(batch["x_l"])
    masked_z = ae_rgb.extract(batch["masked_x"])
    image_cond = ae_rgb.extract(batch["x_ref"])
    return {"z": z, "cond": torch.cat([z_l, masked_z], dim=1),
            "image_cond": image_cond}


class LatentDiffusionLoop:
    """The second-stage loop: frozen AEs → latents → DDPM step, with the
    reference's EMA-save cadence (trainer.py:122-124). ``ae_rgb`` and
    ``ae_ldmk``: ``ViTAutoencoder``s with their weights loaded; they are
    frozen (``eval()``, no gradient) and moved to the trainer's device."""

    def __init__(self, trainer: MtovDiffusionTrainer, ae_rgb, ae_ldmk):
        self.trainer = trainer

        def freeze(ae):
            return ae.to(trainer.device).eval().requires_grad_(False)

        self.ae_rgb, self.ae_ldmk = freeze(ae_rgb), freeze(ae_ldmk)

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.trainer.device,
                                                non_blocking=True)
                for k in VIDEO_KEYS}

    def train_step(self, batch: dict, draws=None) -> dict:
        """One step on a video batch (host or device)."""
        dev = self.to_device(batch)
        return self.trainer.train_step(
            extract_latents(self.ae_rgb, self.ae_ldmk, dev), draws)

    @torch.no_grad()
    def sample(self, batch: dict, generator=None):
        """The in-training sample probe: a DDIM sample of the EMA UNet
        conditioned on the batch, decoded to video [B, T, H, W, 3]; the
        draws come from ``generator`` (a generator on the trainer's device,
        or a callable, as the samplers take)."""
        lat = extract_latents(self.ae_rgb, self.ae_ldmk,
                              self.to_device(batch))
        with self.trainer.ema_weights():
            z = self.trainer.ddpm.ddim_sample(
                tuple(lat["z"].shape), lat["cond"], lat["image_cond"],
                generator=generator)
        return self.ae_rgb.decode_from_sample(z)

    def fit(self, batches, max_steps: int, logger=None, ckpt_manager=None,
            ckpt_every: int = 1000, log_every: int = 50,
            eval_every: int | None = None, eval_fn=None, stop=None):
        """``eval_fn(loop, it) -> dict`` runs every ``eval_every`` steps
        (default ``ckpt_every``: the reference probes and checkpoints at one
        cadence, trainer.py:122-130). ``stop``: a ``GracefulStop`` polled
        each step; on preemption a final checkpoint is saved and written
        before returning. Checkpoints hold the EMA weights and the step."""
        eval_every = ckpt_every if eval_every is None else eval_every
        pin = self.trainer.device.type == "cuda"
        host = (_host_tensors(b, VIDEO_KEYS, pin) for b in batches)
        it = 0
        last_saved = None

        def save():
            ckpt_manager.save(it, {"ema_params": self.trainer.ema,
                                   "step": self.trainer.step_count})

        for batch in background_iter(host):
            metrics = self.train_step(batch)
            it += 1
            if logger is not None and it % log_every == 0:
                logger.log_scalars(it, {k: float(v)
                                        for k, v in metrics.items()})
            if eval_fn is not None and it % eval_every == 0:
                probe = eval_fn(self, it)
                if logger is not None and probe:
                    logger.log_scalars(it, probe)
            if ckpt_manager is not None and it % ckpt_every == 0:
                save()
                last_saved = it
            if it >= max_steps or (stop is not None and stop.requested):
                break
        if ckpt_manager is not None:
            if stop is not None and stop.requested and it != last_saved:
                save()
            ckpt_manager.wait()
        return self.trainer.state()
