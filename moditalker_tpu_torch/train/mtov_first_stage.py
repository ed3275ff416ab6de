"""MToV first-stage (autoencoder + GAN) training (port of
``moditalker_tpu/train/mtov_first_stage.py``; ref MToV/tools/trainer.py:
``first_stage_train`` :134-265 and ``first_stage_x_l_train`` :268-...).

A generator step and a discriminator step, each accumulated over
``accum_iter`` calls as ``optax.MultiSteps`` does (``MultiSteps`` below),
with the reference's G/D phase alternation once ``disc_start`` is reached.
Kept as the JAX package has them, on purpose:

* the loss terms are gated (``adopt_weight``) on the raw iteration count,
  which G and D steps both advance, while the phase flip reads
  ``it // accum_iter``: two units, as the reference trained;
* the G step runs the discriminators four times (fake and real, 2D and 3D),
  each with its own batch statistics, even where ``disc_factor`` is 0; the
  real features enter the feature-matching L1 detached, and the gradient
  goes to the AE's parameters only;
* the D step detaches the reconstruction, and clips each discriminator's
  gradient to global norm 1.0 on every micro-step, before accumulation
  (ref :219-220);
* AdamW with optax's defaults (eps 1e-8, weight decay 1e-4) at
  ``ae_betas``; with ``freeze_decoder`` (the landmark AE) the decoder and
  ``to_pixel`` get no update and no weight decay.

One device (``cuda`` unless the caller asks for the CPU), float32 as the JAX
trainer builds it. On the card the AE's divided space and time attention
runs the hand-written kernels in float32 (``ops/kernels/convert.py``) and
its gradient flows through them (``ops/kernels/autograd.py``). The
per-item frame index comes from a CPU ``torch.Generator`` seeded with
``seed + 1`` (the JAX trainer's ``PRNGKey(seed + 1)``), one draw per step;
``step`` also takes it as an input.

Under a process group (``core/sharding.py``, one process per card) every
process builds the global batch and draws its frame indices, keeps its own
rows, and averages each micro-step's gradients over the group before the
discriminators' clip and the accumulation, so every rank accumulates, steps
and alternates G and D alike. The discriminators' BatchNorms normalise with
the statistics of the GLOBAL batch, as the JAX trainer's do under its mesh
(``sharding.GlobalBatchNorm``). The logged losses are averaged over the
ranks, the preemption latch is agreed once per step, and rank 0 alone
writes checkpoints, behind a barrier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MtovAEConfig, MtovLossConfig, MtovTrainConfig
from ..core import sharding
from ..data.prefetch import background_iter
from ..device import resolve_device
from ..models.mtov import ViTAutoencoder
from ..models.mtov.losses import (LPIPS, PatchDiscriminator2D,
                                  PatchDiscriminator3D, adopt_weight,
                                  hinge_d_loss, select_random_frame)
from .mtov import make_optimizer

FROZEN_WITH_DECODER = ("decoder", "to_pixel")


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by min(1, max_norm / (‖grads‖ + 1e-6)), the norm
    taken over all of them (optax.global_norm)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def _grads(loss, params):
    """d loss / d params, averaged over the process group; zeros for a
    parameter the loss does not reach (as ``jax.grad`` gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    sharding.all_reduce_grads(grads)
    return grads


class MultiSteps:
    """``optax.MultiSteps`` around a torch optimizer: each ``add`` folds a
    gradient into the running mean held in the parameters' ``.grad``
    (acc + (g − acc)/(n + 1)), and every ``k``-th one steps the optimizer
    on that mean. The mean stays in ``.grad`` until the next cycle's first
    ``add`` replaces it."""

    def __init__(self, optimizer, params, k: int):
        self.optimizer, self.params, self.k = optimizer, list(params), k
        self.mini_step = 0

    @torch.no_grad()
    def add(self, grads) -> bool:
        """Fold in ``grads`` (one per parameter); True where this call
        stepped the optimizer."""
        n = self.mini_step
        for p, g in zip(self.params, grads, strict=True):
            if n == 0:
                p.grad = g.detach().clone()
            else:
                p.grad.add_(g.sub(p.grad).div_(n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step == 0:
            self.optimizer.step()
            return True
        return False

    def state_dict(self) -> dict:
        acc = ([p.grad for p in self.params] if self.mini_step else [])
        return {"optimizer": self.optimizer.state_dict(),
                "mini_step": self.mini_step, "acc_grads": acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict, names) -> None:
        """``state_dict()``'s form, or a converted optax ``MultiSteps`` state
        (``utils.convert.convert_first_stage_state``: AdamW's step and
        moments and the running mean, each by parameter name). ``names``:
        the names of ``self.params``, in order."""
        from ..utils.convert import load_optimizer_state

        self.mini_step = int(state["mini_step"])
        if "optimizer" in state:    # the port's own
            load_optimizer_state(self.optimizer, (), state["optimizer"])
            acc = list(state["acc_grads"])
        else:
            load_optimizer_state(self.optimizer, zip(names, self.params), {
                k: state[k] for k in ("step", "exp_avg", "exp_avg_sq")})
            acc = [state["acc_grads"][n] for n in names]
        for p, g in zip(self.params, acc if self.mini_step else []):
            p.grad = g.to(p.device, p.dtype).clone()


class FirstStageTrainer:
    """AE + LPIPS (frozen) + 2D/3D PatchGANs on one device. ``state``: a
    saved or converted state ({ae_params, disc2d, disc3d, lpips_params,
    g_opt, d_opt, step}, ``utils.convert.convert_first_stage_state``; the
    optimizers may be left out) to start from, else every network is drawn
    from ``train_cfg.seed`` (LPIPS's heads at one, as the JAX package
    initialises them). A state's step also sets the phase: the iteration
    count is the step, as in the JAX loop, where G and D steps both advance
    it."""

    def __init__(self, ae_cfg: MtovAEConfig = MtovAEConfig(),
                 loss_cfg: MtovLossConfig = MtovLossConfig(),
                 train_cfg: MtovTrainConfig = MtovTrainConfig(),
                 device=None, state: dict | None = None,
                 freeze_decoder: bool = False):
        self.ae_cfg, self.loss_cfg, self.train_cfg = ae_cfg, loss_cfg, train_cfg
        self.freeze_decoder = freeze_decoder
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            ae, lpips = ViTAutoencoder(ae_cfg), LPIPS()
            disc = dict(ndf=loss_cfg.disc_ndf, n_layers=loss_cfg.disc_layers,
                        in_channels=loss_cfg.disc_in_channels)
            d2, d3 = PatchDiscriminator2D(**disc), PatchDiscriminator3D(**disc)
        self.step_count = 0
        if state is not None:
            ae.load_state_dict(state["ae_params"])
            d2.load_state_dict(state["disc2d"])
            d3.load_state_dict(state["disc3d"])
            lpips.load_state_dict(state["lpips_params"])
            self.step_count = int(state["step"])
        dev = self.device
        self.ae = ae.to(dev).train()
        self.lpips = lpips.to(dev).eval().requires_grad_(False)
        self.disc2d = sharding.globalise_batch_norms(d2.to(dev).train())
        self.disc3d = sharding.globalise_batch_norms(d3.to(dev).train())

        g_params = []
        for name, p in self.ae.named_parameters():
            if freeze_decoder and set(name.split(".")) & set(
                    FROZEN_WITH_DECODER):
                p.requires_grad_(False)
            else:
                g_params.append(p)
        d_params = [*self.disc2d.parameters(), *self.disc3d.parameters()]
        self._n_d2 = len(list(self.disc2d.parameters()))
        betas = train_cfg.ae_betas
        k = train_cfg.accum_iter
        self.g_opt = MultiSteps(make_optimizer(g_params, train_cfg,
                                               betas=betas)[0], g_params, k)
        self.d_opt = MultiSteps(make_optimizer(d_params, train_cfg,
                                               betas=betas)[0], d_params, k)
        self.generator = torch.Generator().manual_seed(train_cfg.seed + 1)
        self._it = 0
        self._disc_phase = False
        if state is not None:
            if "g_opt" in state:
                self.g_opt.load_state_dict(state["g_opt"], [
                    n for n, p in self.ae.named_parameters()
                    if p.requires_grad])
                self.d_opt.load_state_dict(state["d_opt"], [
                    f"disc{t}d.{n}" for t, m in (("2", d2), ("3", d3))
                    for n, _ in m.named_parameters()])
            for _ in range(self.step_count):
                self._advance_phase()

    def _advance_phase(self) -> None:
        accum, it = self.train_cfg.accum_iter, self._it
        # the phase flip reads it // accum (trainer.py:226-230): NOT the
        # unit adopt_weight reads in the steps
        if it % accum == accum - 1 and it // accum >= self.loss_cfg.disc_start:
            self._disc_phase = not self._disc_phase
        self._it += 1

    # ------------------------------------------------------------ G step
    def g_step(self, video, frame_idx) -> dict:
        """One generator micro-step on a device video [B, T, H, W, 3]."""
        lc = self.loss_cfg
        recon = self.ae(video)
        rec_loss = lc.pixelloss_weight * (video - recon).abs().mean()
        in_2d = select_random_frame(video, frame_idx)
        re_2d = select_random_frame(recon, frame_idx)
        p_loss = lc.perceptual_weight * self.lpips(in_2d, re_2d).mean()
        # the RAW iteration count (trainer.py:186-190), not it // accum
        disc_factor = adopt_weight(self.step_count, lc.disc_start)
        lf2, pf2 = self.disc2d(re_2d)
        lf3, pf3 = self.disc3d(recon)
        with torch.no_grad():   # the real features enter detached
            _, pr2 = self.disc2d(in_2d)
            _, pr3 = self.disc3d(video)
        g_loss = -disc_factor * lc.disc_weight * (lf2.mean() + lf3.mean())
        feat = 0.0
        for fake, real in [*zip(pf2[:-1], pr2[:-1]), *zip(pf3[:-1], pr3[:-1])]:
            feat = feat + (fake - real).abs().mean()
        feat_loss = disc_factor * lc.gan_feat_weight * feat
        total = rec_loss + p_loss + g_loss + feat_loss
        self.g_opt.add(_grads(total, self.g_opt.params))
        self.step_count += 1
        return {"ae_loss": total.detach(), "rec": rec_loss.detach(),
                "perceptual": p_loss.detach(), "g": g_loss.detach(),
                "feat": feat_loss.detach()}

    # ------------------------------------------------------------ D step
    def d_step(self, video, frame_idx) -> dict:
        """One discriminator micro-step on a device video."""
        lc = self.loss_cfg
        with torch.no_grad():
            recon = self.ae(video)
        in_2d = select_random_frame(video, frame_idx)
        re_2d = select_random_frame(recon, frame_idx)
        lr2, _ = self.disc2d(in_2d)
        lf2, _ = self.disc2d(re_2d)
        lr3, _ = self.disc3d(video)
        lf3, _ = self.disc3d(recon)
        disc_factor = adopt_weight(self.step_count, lc.disc_start)
        loss = disc_factor * lc.disc_weight * (hinge_d_loss(lr2, lf2)
                                               + hinge_d_loss(lr3, lf3))
        grads = _grads(loss, self.d_opt.params)
        # per discriminator, per micro-step (ref trainer.py:219-220)
        n = self._n_d2
        self.d_opt.add(clip_by_global_norm(grads[:n], 1.0)
                       + clip_by_global_norm(grads[n:], 1.0))
        self.step_count += 1
        return {"d_loss": loss.detach()}

    # ------------------------------------------------------------ loop API
    def to_device(self, video):
        if not torch.is_tensor(video):
            video = torch.from_numpy(np.ascontiguousarray(video, np.float32))
        return video.to(self.device, torch.float32, non_blocking=True)

    def step(self, video, draws=None) -> dict:
        """One iteration with the reference's G/D phase alternation; video:
        the GLOBAL batch [B, T, H, W, 3] (host or device), of which this
        rank trains on its rows. ``draws``: the frame index per item of the
        global batch, else drawn from the trainer's generator. Returns the
        step's loss terms (this rank's rows) as device tensors (no sync)."""
        if draws is None:
            draws = torch.randint(0, self.ae_cfg.timesteps, (video.shape[0],),
                                  generator=self.generator)
        video = self.to_device(sharding.rank_rows(video))
        (frame_idx,) = sharding.local_draws((draws,), self.device)
        if self._disc_phase:
            metrics = self.d_step(video, frame_idx)
        else:
            metrics = self.g_step(video, frame_idx)
        self._advance_phase()
        return metrics

    @torch.no_grad()
    def reconstruct(self, video):
        """The AE's reconstruction of a host or device video (the probes')."""
        return self.ae(self.to_device(video))

    def state(self) -> dict:
        return {"ae_params": self.ae.state_dict(),
                "disc2d": self.disc2d.state_dict(),
                "disc3d": self.disc3d.state_dict(),
                "lpips_params": self.lpips.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "step": self.step_count}

    def fit(self, batches, max_steps: int, logger=None, ckpt_manager=None,
            eval_every: int = 2000, eval_fn=None, log_every: int = 50,
            stop=None) -> dict:
        """The reference's loop (trainer.py:232-257): the loss terms every
        ``log_every`` iterations; every ``eval_every`` the probes
        (``eval_fn(trainer) -> dict``, logged) and a full-state save.
        ``batches`` yields dicts with 'x' (or 'x_l' with
        ``freeze_decoder``), prepared on a host thread. ``stop``: a
        ``GracefulStop`` polled each step (agreed over the ranks); on
        preemption a final checkpoint is saved and written before
        returning. Checkpoints are written by rank 0 alone."""
        key = "x_l" if self.freeze_decoder else "x"
        pin = self.device.type == "cuda"

        def host(b):
            t = torch.from_numpy(np.ascontiguousarray(b[key], np.float32))
            return t.pin_memory() if pin else t

        last_saved = None
        stopped = False
        it = self._it

        def save():
            if sharding.is_main():
                ckpt_manager.save(it, self.state())
            sharding.barrier()

        for video in background_iter(host(b) for b in batches):
            metrics = self.step(video)
            it = self._it
            if it % log_every == 0:
                scalars = sharding.mean_over_ranks(metrics)
                if logger is not None:
                    logger.log_scalars(it, scalars)
            if it % eval_every == 0 and it > 0:
                if eval_fn is not None:
                    probe = eval_fn(self)
                    if logger is not None and probe:
                        logger.log_scalars(it, probe)
                if ckpt_manager is not None:
                    save()
                    last_saved = it
            stopped = stop is not None and sharding.agree(stop.requested)
            if it >= max_steps or stopped:
                break
        if ckpt_manager is not None:
            if stopped and it != last_saved:
                save()
            ckpt_manager.wait()
        return self.state()
