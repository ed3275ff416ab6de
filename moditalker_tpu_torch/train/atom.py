"""AToM training (port of ``moditalker_tpu/train/atom.py``; ref
AToM/AToM.py:32-236): the x0 loss (7.5·recon + 1.5·velocity), Adan (lr 4e-4,
wd 0.02), an EMA of the parameters every step at 0.9999, checkpoints of
{params, ema_params, optimizer, step} every ``ckpt_every`` steps, and a
``GracefulStop`` polled every step.

One device, chosen explicitly (``cuda`` unless the caller asks for the
CPU); the model is float32, as the JAX trainer builds it. The loss's draws
(t, noise, keep_mask) come from a CPU ``torch.Generator`` seeded from the
config, so a run on the card and one on the CPU see the same numbers; the
decoder's dropout follows the module's mode (``step(deterministic=True)``
switches it off). A background thread collates the host batches, as the JAX
package's ``background_iter`` does; the copy to the card is the step's own.
AToM's attentions are outside every kernel gate: no kernel launches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AtomDiffusionConfig, AtomModelConfig, AtomTrainConfig
from ..core.adan import Adan
from ..core.ema import ema_copy, ema_update
from ..data.atom_dataset import training_arrays
from ..data.prefetch import background_iter
from ..device import resolve_device
from ..models.atom import AtomDiffusion, MotionDecoder

BATCH_KEYS = ("residual", "face", "cond")


def host_batch(batch: dict, horizon: int, pin: bool = False) -> dict:
    """(residual, face, cond) float32 tensors on the host from a collated
    batch (``training_arrays``); pinned where ``pin``, for an asynchronous
    copy to the card."""
    out = {}
    for k, a in zip(BATCH_KEYS, training_arrays(batch, horizon)):
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        out[k] = t.pin_memory() if pin else t
    return out


class AtomTrainer:
    """Model, Adan, EMA and the loss's generator on one device.
    ``state_dict``: the decoder's weights to start from (default: drawn from
    ``train_cfg.seed``)."""

    def __init__(self, model_cfg: AtomModelConfig = AtomModelConfig(),
                 diff_cfg: AtomDiffusionConfig = AtomDiffusionConfig(),
                 train_cfg: AtomTrainConfig = AtomTrainConfig(),
                 device=None, state_dict: dict | None = None):
        self.model_cfg, self.train_cfg = model_cfg, train_cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            model = MotionDecoder(model_cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.diff = AtomDiffusion.create(self.model, diff_cfg, self.device)
        self.opt = Adan(self.model.parameters(), lr=train_cfg.learning_rate,
                        weight_decay=train_cfg.weight_decay)
        self.ema = ema_copy(self.model)
        self.step_count = 0
        self.generator = torch.Generator().manual_seed(train_cfg.seed + 1)

    def state(self) -> dict:
        """{params, ema_params, optimizer, step}: what a checkpoint holds
        (``atom-infer --checkpoint`` reads its EMA weights)."""
        return {"params": self.model.state_dict(), "ema_params": self.ema,
                "optimizer": self.opt.state_dict(), "step": self.step_count}

    def load_state(self, tree: dict) -> None:
        self.model.load_state_dict(tree["params"])
        for k, v in tree["ema_params"].items():
            self.ema[k].copy_(v)
        self.opt.load_state_dict(tree["optimizer"])
        self.step_count = int(tree["step"])

    def train_step(self, dev: dict, draws=None,
                   deterministic: bool = False) -> dict:
        """One step on a batch of device tensors {residual, face, cond}.
        ``draws``: (t, noise, keep_mask), else drawn from the trainer's
        generator. Returns the loss terms as device tensors (no sync)."""
        x = dev["residual"]
        if draws is None:
            draws = self.diff.draw_loss_inputs(self.generator, x)
        self.model.train(not deterministic)
        loss, (recon, vel) = self.diff.p_losses(x, dev["face"], dev["cond"],
                                                *draws)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        ema_update(self.ema, self.model.named_parameters(),
                   self.train_cfg.ema_decay)
        self.step_count += 1
        return {"loss": loss.detach(), "recon": recon.detach(),
                "velocity": vel.detach()}

    def to_device(self, host: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in host.items()}

    def step(self, batch: dict, draws=None,
             deterministic: bool = False) -> dict:
        """One step on a collated host batch (``training_arrays`` keys)."""
        dev = self.to_device(host_batch(batch, self.model_cfg.horizon))
        return self.train_step(dev, draws, deterministic)

    def fit(self, dataset, epochs: int | None = None, log_every: int = 100,
            ckpt_manager=None, ckpt_every: int = 2000, logger=None,
            stop=None, max_steps: int | None = None) -> dict:
        """Epochs of ``dataset.iter_epoch(batch_size, seed=epoch)``.
        ``stop``: a ``GracefulStop`` polled each step; on preemption the
        loop saves a final checkpoint and waits for pending writes before
        returning. ``max_steps`` bounds the steps across epochs."""
        epochs = epochs if epochs is not None else self.train_cfg.epochs
        pin = self.device.type == "cuda"
        horizon = self.model_cfg.horizon
        it = 0
        last_saved = None
        done = False
        for epoch in range(1, epochs + 1):
            if done or (stop is not None and stop.requested):
                break
            host = (host_batch(b, horizon, pin) for b in dataset.iter_epoch(
                self.train_cfg.batch_size, seed=epoch))
            for batch in background_iter(host):
                metrics = self.train_step(self.to_device(batch))
                it += 1
                if logger is not None and it % log_every == 0:
                    logger.log_scalars(it, {k: float(v)
                                            for k, v in metrics.items()})
                if ckpt_manager is not None and it % ckpt_every == 0:
                    ckpt_manager.save(it, self.state())
                    last_saved = it
                if ((stop is not None and stop.requested)
                        or (max_steps is not None and it >= max_steps)):
                    done = True
                    break
        if ckpt_manager is not None:
            if stop is not None and stop.requested and it != last_saved:
                ckpt_manager.save(it, self.state())
            ckpt_manager.wait()
        return self.state()
