"""PRFL post-training of the policy DiT through the program's training CLI
(scripts/train_prfl_torch.py ``build_trainer`` and ``run``): a closed
loop of outer steps, each a refl step (a no-grad UniPC rollout to the
fixed mid step, one gradient-carrying forward, the solver step, the frozen
LRM's score and the hinge loss, the backward, AdamW) and an SFT step
(flow-matching forward, backward, AdamW), on a seeded latent cache read
through the program's loader.

Set-up builds the trainer, gives it the seeded weights, and drives it
through the CLI's ``run`` for the first ``followed_steps`` outer steps,
which are the steps the reference follows; the window then runs whole
outer steps through ``run`` for about ``--seconds``. The benchmark hands
the program each step's random draws (the rollout's starting noise, the
SFT step's timestep and noise) through the step functions' own arguments.

The reference follows the followed steps from the program's own rollout:
the no-grad policy forwards are checked by themselves (the reference's
forward on the program's input at one rollout step drawn from the seed),
the solver chain from the benchmark's starting noise through the
program's velocities is checked at every rollout step, and from the
rollout's end the reference computes the refl step and the SFT step in
fp32 with its own parameters, and their AdamW updates.

The control puts the reference in fp8 (``reference.Prec``) in the
program's place at the checked rollout forward: the program runs its one
followed step for the input, and the run compares the fp8 forward with the
fp32 one there, beside the program's own reading (``sound.rollout_v``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import caches, common, reference as R, training, weights as W, work
from .common import sub_seed


class Recorder:
    """What the program did in the followed steps: every policy forward's
    token-layout input (and, without gradients, its velocity), each step's
    batch, and the first update's gradient."""

    def __init__(self):
        self.on, self.k = True, 0
        self.rollout: Dict[int, List] = {}   # k -> [(x, t, v)] of the no-grad forwards
        self.grad_x: Dict[int, torch.Tensor] = {}
        self.batches: Dict[int, tuple] = {}
        self.grad = None

    def hook(self, module, args, kwargs, output):
        if not self.on or type(module).__name__ != "WanModel" or module.head is None:
            return
        x = args[0]
        if x.dim() != 4:  # the SFT step's video-layout call
            return
        if torch.is_grad_enabled():
            self.grad_x[self.k] = x.detach().cpu()
        else:
            t = float(torch.as_tensor(args[1]).reshape(-1)[0])
            self.rollout.setdefault(self.k, []).append((x.cpu(), t, output.float().cpu()))


def build(cell: common.Cell, seed: int, device: str, root: str):
    """The trainer with the seeded weights and the benchmark's draws wired in."""
    cfg, traffic = cell.config, cell.traffic
    cache = caches.write(os.path.join(root, "cache"), sub_seed(seed, "cache"), traffic,
                         cfg["text_dim"])
    changes = {"task": cfg["task"], "train.seed": int(seed),
               "dataset.meta_file_list": [cache.meta_list], "dataset.null_dir": cache.null_dir,
               "save.output_dir": os.path.join(root, "out")}
    config = training.recipe(traffic, changes)
    cli = common.load_script("train_prfl_torch")
    trainer = cli.build_trainer(config, device)
    layers = cfg["num_layers"]
    lrm_layers = max(config.lrm.feature_layer)
    common.same_widths(trainer.model.dit_cfg, cfg)
    common.same_widths(trainer.model.lrm.dit_cfg, cfg, lrm_layers)
    with torch.no_grad():
        trainer.model.dit.load_state_dict(
            W.make(W.dit_leaves(cfg, layers), sub_seed(seed, "policy"), device), strict=True)
        trainer.model.lrm.load_state_dict(
            W.make(W.reward_leaves(cfg, lrm_layers), sub_seed(seed, "lrm"), device),
            strict=True)
    draws = training.Draws(seed, device)
    rec = Recorder()
    b1 = float(config.optimizer.adam_beta1)
    refl_fn, sft_fn = trainer.refl_fn, trainer.sft_fn

    def refl(state, batch, gen=None):
        k = state.step // 2
        rec.k = k
        if rec.on:
            rec.batches[k] = (batch["latents"].cpu().numpy(), batch["text"].cpu().numpy())
        out = refl_fn(state, batch, gen, latent0=draws.normal(batch["latents"].shape, "z", k))
        if rec.on and k == 0:
            rec.grad = training.first_grad(out[0], b1)
        return out

    def sft(state, batch, gen=None):
        t, sigma, noise = draws.flow_match(state.step // 2, batch["latents"].shape)
        return sft_fn(state, batch, gen, t=t, sigma=sigma, noise=noise)

    trainer.refl_fn, trainer.sft_fn = refl, sft
    return cli, trainer, config, cache, draws, rec


def run(cell: common.Cell, seed: int, seconds: float, traced: bool, device: str,
        control: bool = False) -> dict:
    cfg, traffic = cell.config, cell.traffic
    root = tempfile.mkdtemp(prefix="bench_prfl_")
    try:
        cli, trainer, config, cache, draws, rec = build(cell, seed, device, root)
        follow = 1 if control else int(traffic["followed_steps"])
        hook = torch.nn.modules.module.register_module_forward_hook(rec.hook, with_kwargs=True)
        try:
            warm = cli.run(trainer, follow)
        finally:
            hook.remove()
        rec.on = False
        P0 = W.make(W.dit_leaves(cfg, cfg["num_layers"]), sub_seed(seed, "policy"), device)
        prog = {"losses": [h[k] for h in warm for k in ("refl_loss", "sft_loss")],
                "grad": rec.grad, "change": training.change(trainer.state, P0)}
        del P0
        win = None
        if seconds > 0:
            step_s = warm[-1]["t_refl"] + warm[-1]["t_sft"]
            steps = training.steps_for(seconds, step_s)
            win = training.window(lambda n: cli.run(trainer, n), steps, device, traced)
        mid = int(config.train.fixed_mid)
        steps40 = int(config.get("prfl_inference_steps", 40))
        shift = float(config.extra_model.scheduler.flow_shift)
        lrm_layers = max(config.lrm.feature_layer)
        pool_heads = int(config.lrm.query_attention.num_heads)
        lr = float(config.optimizer.learning_rate)
        del trainer, cli
        training.free(device)
        ref = reference(cell, seed, device, rec, cache, draws, follow, mid, steps40, shift,
                        lrm_layers, pool_heads, lr, control)
        values = ref.pop("values")
        if not control:
            values.update(training.compare(prog, ref, 2))
        return {"window": win, "values": values,
                "work": work.prfl_step(cfg, _tokens(traffic), cfg["text_len"], mid, lrm_layers)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tokens(traffic) -> int:
    f, h, w = caches.latent_grid(traffic)
    return f * (h // 2) * (w // 2)


def reference(cell, seed, device, rec: Recorder, cache, draws, follow, mid, n_steps, shift,
              lrm_layers, pool_heads, lr, control) -> dict:
    """The followed steps in fp32, from the program's rollout."""
    R.strict_fp32()
    cfg = cell.config
    dev = torch.device(device)
    P = W.make(W.dit_leaves(cfg, cfg["num_layers"]), sub_seed(seed, "policy"), device)
    P0 = {n: t.clone() for n, t in P.items()}
    L = W.make(W.reward_leaves(cfg, lrm_layers), sub_seed(seed, "lrm"), device)
    L = W.served(L, W.bf16_stored(L, "dit."))
    for t in P.values():
        t.requires_grad_(True)
    dit = R.DiT(P, cfg, remat=True)
    low = R.DiT(P, cfg, precision="fp8") if control else None
    lrm = R.RewardModel(L, cfg, lrm_layers, pool_heads, remat=True)
    opt = R.AdamW(P, lambda n: lr)
    sched = R.unipc_table(n_steps, shift)
    ts = sched[1]
    losses, grads, chain, forwards, sound, data = [], [], [], [], [], []
    rng = np.random.default_rng(sub_seed(seed, "checked rollout steps"))
    checked = [int(rng.integers(0, mid))] if mid > 0 else []
    for k in range(follow):
        lat_np, text_np = rec.batches[k]
        found = caches.match(cache, lat_np[0], text_np[0], cfg["text_len"])
        data.append(0.0 if found is not None else 1.0)
        if found is None:
            break
        clip, text = found
        text = torch.from_numpy(text)[None].to(dev)
        x0 = torch.from_numpy(clip.latents)[None].to(dev)
        # the solver chain from the benchmark's noise through the program's velocities
        x, grid = R.patchify(draws.normal(x0.shape, "z", k))
        uni = R.UniPC(n_steps, shift)
        roll = rec.rollout.get(k, [])
        if len(roll) != mid or k not in rec.grad_x:
            chain.append(float("inf"))
            break
        for i, (xp, t, vp) in enumerate(roll):
            chain.append(R.rel_l2(xp.to(dev), x))
            if k == 0 and i in checked:
                with torch.no_grad():
                    vr = dit(xp.to(dev), t, text, grid)
                    sound.append(R.max_gap(vp.to(dev), vr))
                    got = low(xp.to(dev), t, text, grid) if control else vp.to(dev)
                forwards.append(R.max_gap(got, vr))
            x = uni.step(vp.to(dev), x)
        chain.append(R.rel_l2(rec.grad_x[k].to(dev), x))
        if control:
            return {"values": {"rollout_v": max(forwards) if forwards else float("inf"),
                               "sound.rollout_v": max(sound) if sound else float("inf")}}
        # the refl step from the rollout's end
        v = dit(x, float(ts[mid]), text, grid)
        x_next = uni.step(v, x)
        logits = lrm(x_next, float(ts[min(mid + 1, n_steps - 1)]), text, grid)
        loss = 0.1 * F.relu(2.0 - torch.sigmoid(logits)[:, 0]).mean()
        grads.append(_update(loss, P, opt, losses))
        # the SFT step
        t, sigma, noise = draws.flow_match(k, x0.shape)
        s = float(sigma[0])
        tok, grid = R.patchify((1 - s) * x0 + s * noise)
        v = dit(tok, t.to(dev), text, grid)
        loss = torch.mean(torch.square(v - R.patchify(noise - x0)[0]))
        grads.append(_update(loss, P, opt, losses))
    values = {"data": max(data), "chain_x": max(chain) if chain else float("inf"),
              "rollout_v": max(forwards) if forwards else float("inf")}
    if len(losses) < 2 * follow:
        return {"values": values, "losses": [float("nan")] * (2 * follow),
                "grads": [{n: 1.0 for n in P}], "change": {n: float("nan") for n in P}}
    with torch.no_grad():
        ch = {n: float((P[n] - P0[n]).norm()) for n in P}
    return {"values": values, "losses": losses, "grads": grads, "change": ch}


def _update(loss, P, opt: R.AdamW, losses: list) -> Dict[str, float]:
    loss.backward()
    finite = bool(torch.isfinite(loss))
    losses.append(float(loss.detach()) if finite else 0.0)
    return opt.step(R.grads_of(P, finite))
