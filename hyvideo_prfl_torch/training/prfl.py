"""PRFL: process reward feedback learning (hyvideo_prfl_tpu/training/prfl.py).

One refl step:

  1. latent0 = N(0, 1); mid ~ U[0, steps - 2] (or ``fixed_mid``);
  2. a no-grad UniPC rollout of the policy to step ``mid``
     (``torch.no_grad``: no activations kept, the JAX stop_gradient);
  3. one gradient-carrying policy forward at t_mid and ``unipc_step`` to
     the next latent;
  4. the frozen LRM scores that latent at t_mid+1; loss = hinge(sigmoid);
  5. the gradient crosses the LRM blocks (frozen, but differentiable in
     their input), the solver step and the policy forward.

The SFT step is a flow-matching MSE step on cached latents. Both steps
take their random draws injected as optional arguments (``latent0`` and
``mid``; the SFT ``t``, ``sigma`` and ``noise``), so a test can hand them
another framework's draws; otherwise they draw from a ``torch.Generator``.

The finite guard is the JAX package's: a non-finite loss zeroes the
gradients, and the optimizer still applies that update (AdamW then still
moves the weights through its moments and the weight decay).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import reward as rw
from ..models import wan_dit
from ..schedulers import flow_match as fm
from ..schedulers import unipc
from . import common
from .pavrm import PavrmConfig, PavrmModel


@dataclasses.dataclass(frozen=True)
class PrflConfig:
    inference_steps: int = 40
    flow_shift: float = 5.0
    num_train_timesteps: int = 1000
    target_reward: float = 2.0
    hinge_scale: float = 0.1
    weighting_scheme: str = "uniform"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    fixed_mid: Optional[int] = None


class PrflModel:
    """Policy DiT (fp32 masters, trainable) + frozen LRM."""

    def __init__(self, dit_cfg: wan_dit.WanConfig, pavrm_cfg: PavrmConfig,
                 prfl_cfg: PrflConfig, device=None):
        self.cfg = prfl_cfg
        self.dit_cfg = dit_cfg
        self.dit = wan_dit.WanModel(dit_cfg, device=device, param_dtype=torch.float32)
        self.lrm = PavrmModel(dit_cfg, pavrm_cfg, device=device)
        self.lrm.requires_grad_(False)


def _finish(state, tx, loss):
    """The finite guard, then one optimizer call -> (state, loss, gnorm)."""
    finite = bool(torch.isfinite(loss))
    grads = common.collect_grads(state, finite)
    state, gnorm = common.apply_grads(state, tx, grads)
    return state, (loss.detach() if finite else torch.zeros_like(loss)), gnorm


def make_refl_step(model: PrflModel, tx: common.Optimizer):
    """The PRFL reward step: refl_step(state, batch, generator=None,
    latent0=None, mid=None) -> (state, metrics)."""
    cfg = model.cfg
    sched = unipc.unipc_schedule(cfg.inference_steps, shift=cfg.flow_shift,
                                 num_train_timesteps=cfg.num_train_timesteps)
    patch = model.dit_cfg.patch_size

    def refl_step(state: common.TrainState, batch, generator=None, latent0=None, mid=None):
        text = batch["text"]
        device = text.device
        if latent0 is None:
            latent0 = torch.randn(batch["latents"].shape, generator=generator,
                                  dtype=torch.float32, device=device)
        if mid is None:
            mid = (cfg.fixed_mid if cfg.fixed_mid is not None else int(torch.randint(
                0, cfg.inference_steps - 1, (), generator=generator,
                device=generator.device if generator is not None else "cpu")))
        latent0_t, grid = wan_dit.patchify(latent0.to(device, torch.float32), patch)

        def velocity(x, t):
            return model.dit(x, t, text, grid=grid)

        with torch.no_grad():
            latent, solver_state = unipc.rollout(sched, velocity, latent0_t, num_steps=mid)

        v = velocity(latent, float(sched.timesteps[mid]))
        latent_next, _ = unipc.unipc_step(sched, solver_state, v, latent)

        t_mid1 = float(sched.timesteps[min(mid + 1, cfg.inference_steps - 1)])
        logits = model.lrm.score(latent_next, t_mid1, text, grid=grid)
        reward = rw.reward_sigmoid(logits)[:, 0]
        loss = rw.prfl_hinge_loss(reward, cfg.target_reward, cfg.hinge_scale)
        loss.backward()
        state, loss, gnorm = _finish(state, tx, loss)
        # one-shot x0 estimate, for the sanity dumps
        sigma_mid1 = float(sched.sigmas[min(mid + 1, cfg.inference_steps)])
        with torch.no_grad():
            pred_x0 = latent_next - sigma_mid1 * v
        return state, {"loss": loss, "grad_norm": gnorm, "reward": reward.detach().mean(),
                       "mid": mid,
                       "latent_next": wan_dit.unpatchify(latent_next.detach(), grid, patch),
                       "pred_x0": wan_dit.unpatchify(pred_x0, grid, patch)}

    return refl_step


def make_sft_step(model: PrflModel, tx: common.Optimizer, schedule: fm.FlowMatchSchedule):
    """The flow-matching SFT step: sft_step(state, batch, generator=None,
    t=None, sigma=None, noise=None) -> (state, metrics)."""
    cfg = model.cfg

    def sft_step(state: common.TrainState, batch, generator=None, t=None, sigma=None,
                 noise=None):
        latents = batch["latents"]
        b = latents.shape[0]
        if t is None or sigma is None:
            t, sigma = fm.sample_train_timestep(schedule, b, cfg.weighting_scheme,
                                                cfg.logit_mean, cfg.logit_std,
                                                generator=generator)
        t = torch.as_tensor(t, dtype=torch.float32).to(latents.device)
        sig5 = torch.as_tensor(sigma, dtype=torch.float32).to(latents.device).reshape(
            -1, 1, 1, 1, 1)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=latents.device)
        noise = noise.to(latents.device, torch.float32)
        noisy = fm.add_noise(latents, noise, sig5)
        target = fm.train_target(latents, noise)
        v = model.dit(noisy, t, batch["text"])
        loss = torch.mean(fm.loss_weighting(sig5) * torch.square(v - target))
        loss.backward()
        state, loss, gnorm = _finish(state, tx, loss)
        return state, {"loss": loss, "grad_norm": gnorm}

    return sft_step
