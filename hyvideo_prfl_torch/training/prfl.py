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

Each phase is a span (utils/tracing.py): the refl step's
``prfl.rollout``, ``prfl.forward`` (the gradient-carrying forward and the
solver step), ``prfl.lrm`` (score, sigmoid, hinge), ``prfl.backward`` and
``prfl.optimizer``; the SFT step's ``sft.forward``, ``sft.backward`` and
``sft.optimizer``; inside each optimizer span its two host reads,
``optimizer.finite_guard`` and ``optimizer.clip`` (training/common.py).

With ``is_i2v`` (and ``is_flf2v``) the batch's ``cond`` and ``clip_fea``
condition every DiT call, as in the JAX package: ``y`` = the 4-channel mask
and the 16-channel condition latent (patchified once in the refl step, in
video layout for the SFT step) and the CLIP features reach the rollout,
the gradient-carrying forward, the frozen LRM and the SFT forward.

On a process mesh (``mesh``, parallel/sharding.Mesh) every rank draws
the global batch's ``latent0``, ``mid`` and SFT ``t``/``noise`` from the
same generator, as the JAX step draws once over its mesh, and keeps its
data replica's rows; the refl step then keeps its sp block of the tokens
through the rollout, the gradient-carrying forward, the solver step and
the LRM, whose pool gathers them; the SFT step's DiT splits and gathers
its video-layout input itself. An injected draw is the global batch's.
The losses are per replica; the logged values are their mean over the
data replicas, and the finite guard reads that mean, so every rank takes
the same branch.

``rollout_quant="int8"`` runs the no-grad rollout to ``mid`` through the
int8 serving path (W8A8 block matmuls and the int8 q k^T self-attention,
K10); the gradient-carrying forward, the LRM and the SFT step stay bf16
with fp32 masters.

LoRA (the JAX ``lora_mode``): with factors attached to the policy
(training/lora.attach_lora) the base is frozen and every policy call,
the rollout's included, merges them into the weights it reads, so both
steps train A and B alone; the int8 rollout quantizes the merged weights.
The frozen LRM is a model of its own and carries no factors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import reward as rw
from ..models import wan_dit
from ..parallel import sharding
from ..schedulers import flow_match as fm
from ..schedulers import unipc
from ..utils import tracing
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
    is_i2v: bool = False
    is_flf2v: bool = False
    fixed_mid: Optional[int] = None
    # "int8": the no-grad rollout runs through the int8 serving path
    rollout_quant: Optional[str] = None


ROLLOUT_QUANTS = (None, "int8")


class PrflModel:
    """Policy DiT (fp32 masters, trainable) + frozen LRM."""

    def __init__(self, dit_cfg: wan_dit.WanConfig, pavrm_cfg: PavrmConfig,
                 prfl_cfg: PrflConfig, device=None):
        self.cfg = prfl_cfg
        self.dit_cfg = dit_cfg
        self.dit = wan_dit.WanModel(dit_cfg, device=device, param_dtype=torch.float32)
        self.lrm = PavrmModel(dit_cfg, pavrm_cfg, device=device)
        self.lrm.requires_grad_(False)


def parallelize(model: PrflModel, mesh: sharding.Mesh, strategy: str = "full"
                ) -> sharding.Layout:
    """Give the policy and the frozen LRM the mesh's sp group and shard
    both under ``strategy`` (each WanBlock, then the DiT; the LRM's small
    heads stay whole) -> the policy's layout."""
    sp = mesh.seq()
    for dit in (model.dit, model.lrm.dit):
        sharding.set_sequence_parallel(dit, sp)
    sharding.shard_model(mesh, [model.lrm.dit], strategy, model.lrm.dit.blocks)
    return sharding.shard_model(mesh, [model.dit], strategy, model.dit.blocks)


def _finish(state, tx, loss, mesh: Optional[sharding.Mesh] = None):
    """The finite guard on the replicas' mean loss, then one optimizer call
    -> (state, loss, gnorm)."""
    with tracing.span("optimizer.finite_guard"):
        loss = (mesh or sharding.Mesh()).mean_over_data(loss.detach())
        finite = bool(torch.isfinite(loss))
    grads = common.collect_grads(state, finite)
    state, gnorm = common.apply_grads(state, tx, grads)
    return state, (loss.detach() if finite else torch.zeros_like(loss)), gnorm


def int8_rollout_model(model: PrflModel):
    """The int8 model of the rollout (quant_dense and quant_attn "int8"),
    built once -> (model, [(QuantLinear, the policy's nn.Linear), ...]).

    Every tensor that is not quantized is the policy's own fp32 master, so
    the rollout always sees the live weights there; the JAX package
    re-derives the same tensors from the live parameters every step. The
    QuantLinear buffers are refilled from the masters once per refl step,
    with a LoRA's factors merged in (the JAX step quantizes the merged
    parameters)."""
    qcfg = dataclasses.replace(model.dit_cfg, quant_dense="int8", quant_attn="int8")
    device = next(model.dit.parameters()).device
    qdit = wan_dit.WanModel(qcfg, device=device, param_dtype=torch.float32)
    for name, p in model.dit.named_parameters():
        owner, _, leaf = name.rpartition(".")
        sub = qdit.get_submodule(owner)
        if not isinstance(sub, wan_dit.QuantLinear):
            setattr(sub, leaf, p)
    pairs = [(sub, model.dit.get_submodule(name)) for name, sub in qdit.named_modules()
             if isinstance(sub, wan_dit.QuantLinear)]
    return qdit.eval(), pairs


def make_refl_step(model: PrflModel, tx: common.Optimizer,
                   mesh: Optional[sharding.Mesh] = None):
    """The PRFL reward step: refl_step(state, batch, generator=None,
    latent0=None, mid=None) -> (state, metrics)."""
    cfg = model.cfg
    mesh = mesh or sharding.Mesh()
    sp = mesh.seq()
    sched = unipc.unipc_schedule(cfg.inference_steps, shift=cfg.flow_shift,
                                 num_train_timesteps=cfg.num_train_timesteps)
    patch = model.dit_cfg.patch_size
    if cfg.rollout_quant not in ROLLOUT_QUANTS:
        # a typo here would silently run the bf16 rollout
        raise ValueError(f"rollout_quant must be one of {ROLLOUT_QUANTS}, "
                         f"got {cfg.rollout_quant!r}")
    if cfg.rollout_quant == "int8" and mesh.device_mesh is not None:
        raise NotImplementedError("rollout_quant int8 with a process group: the int8 "
                                  "rollout model shares the policy's unsharded weights")
    rollout_dit, quant_pairs = (int8_rollout_model(model) if cfg.rollout_quant == "int8"
                                else (model.dit, []))

    def refl_step(state: common.TrainState, batch, generator=None, latent0=None, mid=None):
        text = batch["text"]
        device = text.device
        if latent0 is None:
            shape = batch["latents"].shape
            latent0 = torch.randn((shape[0] * mesh.data, *shape[1:]), generator=generator,
                                  dtype=torch.float32, device=device)
        if mid is None:
            mid = (cfg.fixed_mid if cfg.fixed_mid is not None else int(torch.randint(
                0, cfg.inference_steps - 1, (), generator=generator,
                device=generator.device if generator is not None else "cpu")))
        latent0_t, grid = wan_dit.patchify(mesh.rows(latent0).to(device, torch.float32), patch)
        y, clip_fea = common.prepare_conditioning(batch, cfg.is_i2v, cfg.is_flf2v)
        y_t = wan_dit.patchify(y, patch)[0] if y is not None else None
        if sp is not None:
            latent0_t = sp.shard(latent0_t, 1, grid)
            y_t = sp.shard(y_t, 1, grid) if y_t is not None else None

        def velocity(x, t, dit=model.dit):
            return dit(x, t, text, y=y_t, clip_fea=clip_fea, grid=grid)

        with tracing.span("prfl.rollout"), torch.no_grad():
            # the int8 weights follow the live masters: quantized in place,
            # once per step, before the rollout reads them
            for qlayer, layer in quant_pairs:
                qlayer.quantize_(wan_dit.merged_weight(layer), layer.bias)
            latent, solver_state = unipc.rollout(
                sched, lambda x, t: velocity(x, t, rollout_dit), latent0_t, num_steps=mid)

        with tracing.span("prfl.forward"):
            v = velocity(latent, float(sched.timesteps[mid]))
            latent_next, _ = unipc.unipc_step(sched, solver_state, v, latent)

        with tracing.span("prfl.lrm"):
            t_mid1 = float(sched.timesteps[min(mid + 1, cfg.inference_steps - 1)])
            logits = model.lrm.score(latent_next, t_mid1, text, y=y_t, clip_fea=clip_fea,
                                     grid=grid)
            reward = rw.reward_sigmoid(logits)[:, 0]
            loss = rw.prfl_hinge_loss(reward, cfg.target_reward, cfg.hinge_scale)
        with tracing.span("prfl.backward"):
            loss.backward()
        with tracing.span("prfl.optimizer"):
            state, loss, gnorm = _finish(state, tx, loss, mesh)
        # one-shot x0 estimate, for the sanity dumps
        sigma_mid1 = float(sched.sigmas[min(mid + 1, cfg.inference_steps)])
        with torch.no_grad():
            pred_x0 = latent_next - sigma_mid1 * v
            latent_next = latent_next.detach()
            if sp is not None:
                pred_x0, latent_next = sp.gather(pred_x0, 1), sp.gather(latent_next, 1)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "reward": mesh.mean_over_data(reward.detach().mean()), "mid": mid,
                       "latent_next": wan_dit.unpatchify(latent_next, grid, patch),
                       "pred_x0": wan_dit.unpatchify(pred_x0, grid, patch)}

    return refl_step


def make_sft_step(model: PrflModel, tx: common.Optimizer, schedule: fm.FlowMatchSchedule,
                  mesh: Optional[sharding.Mesh] = None):
    """The flow-matching SFT step: sft_step(state, batch, generator=None,
    t=None, sigma=None, noise=None) -> (state, metrics)."""
    cfg = model.cfg
    mesh = mesh or sharding.Mesh()

    def sft_step(state: common.TrainState, batch, generator=None, t=None, sigma=None,
                 noise=None):
        latents = batch["latents"]
        b = latents.shape[0] * mesh.data
        if t is None or sigma is None:
            t, sigma = fm.sample_train_timestep(schedule, b, cfg.weighting_scheme,
                                                cfg.logit_mean, cfg.logit_std,
                                                generator=generator)
        t = mesh.rows(torch.as_tensor(t, dtype=torch.float32)).to(latents.device)
        sig5 = mesh.rows(torch.as_tensor(sigma, dtype=torch.float32)).to(
            latents.device).reshape(-1, 1, 1, 1, 1)
        if noise is None:
            noise = torch.randn((b, *latents.shape[1:]), generator=generator,
                                dtype=torch.float32, device=latents.device)
        noise = mesh.rows(noise).to(latents.device, torch.float32)
        with tracing.span("sft.forward"):
            noisy = fm.add_noise(latents, noise, sig5)
            target = fm.train_target(latents, noise)
            y, clip_fea = common.prepare_conditioning(batch, cfg.is_i2v, cfg.is_flf2v)
            v = model.dit(noisy, t, batch["text"], y=y, clip_fea=clip_fea)
            loss = torch.mean(fm.loss_weighting(sig5) * torch.square(v - target))
        with tracing.span("sft.backward"):
            loss.backward()
        with tracing.span("sft.optimizer"):
            state, loss, gnorm = _finish(state, tx, loss, mesh)
        return state, {"loss": loss, "grad_norm": gnorm}

    return sft_step
