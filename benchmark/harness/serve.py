"""Video sampling through the program's serving CLI
(scripts/inference_torch.py ``args_init``, ``build_pipeline`` and
``run_request``): one client sends requests back to back, each seeded
cond and null text contexts, batched classifier-free guidance (batch 2),
and the traffic's UniPC steps, latents out, no decode.

A forward hook on the DiT, registered from here, counts the denoising
steps and copies each step's input and the model's two outputs to host
memory; at the first step boundary past ``--seconds`` it waits for the
card and ends the request in flight. The window is every step the card
completed, from the first request's start to that moment.

The reference draws the request's starting noise from its seed as the
program does, follows the solver chain through the program's model
outputs with its own guidance and UniPC, checking each step's input, and
runs its own CFG forward on the program's input at a few steps drawn
from the seed.

The control puts the reference in fp8 (``reference.Prec``) in the
program's place at those forwards: the program serves the request for the
inputs, and the run compares the fp8 forward with the fp32 one there,
beside the program's own reading (``sound.model_v``).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from . import caches, common, reference as R, training, weights as W, work
from .common import sub_seed


class WindowClosed(Exception):
    pass


class Stepper:
    """The forward hooks: the deadline, the step count and the copies to
    host buffers allocated at the first step of set-up."""

    def __init__(self, device: str, keep: int):
        self.device, self.keep = device, keep
        self.deadline = float("inf")
        self.limit_steps = None
        self.steps = 0
        self.record = True
        self.bufs = None
        self.n = 0

    @property
    def x(self) -> List[torch.Tensor]:
        return [b[0] for b in self.bufs[:self.n]]

    @property
    def out(self) -> List[torch.Tensor]:
        return [b[1] for b in self.bufs[:self.n]]

    def sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def pre(self, module, args, kwargs):
        if time.perf_counter() > self.deadline or (
                self.limit_steps is not None and self.steps >= self.limit_steps):
            self.sync()
            raise WindowClosed

    def post(self, module, args, kwargs, output):
        self.steps += 1
        x = args[0][: args[0].shape[0] // 2]
        if self.bufs is None:
            pin = self.device == "cuda"
            self.bufs = [(torch.empty(x.shape, dtype=x.dtype, pin_memory=pin),
                          torch.empty(output.shape, dtype=output.dtype, pin_memory=pin))
                         for _ in range(self.keep)]
        if self.record and self.n < self.keep:
            for buf, t in zip(self.bufs[self.n], (x, output)):
                buf.copy_(t.detach(), non_blocking=True)
            self.n += 1


def contexts(seed: int, k: int, cfg: dict, traffic: dict, device):
    """Request k's cond and null contexts [1, text_len, text_dim]: seeded
    token embeddings of the traffic's lengths, zero-padded as the CLI pads."""
    rng = np.random.default_rng(sub_seed(seed, "request", k))
    lens = rng.permutation(traffic["caption_tokens"])
    out = []
    for n in (int(lens[0]), int(traffic["null_tokens"])):
        emb = rng.standard_normal((n, cfg["text_dim"]), np.float32)
        out.append(torch.from_numpy(caches.padded(emb, cfg["text_len"]))[None].to(device))
    return out


def run(cell: common.Cell, seed: int, seconds: float, traced: bool, device: str,
        control: bool = False) -> dict:
    cfg, traffic = cell.config, cell.traffic
    cli = common.load_script("inference_torch")
    v = traffic["video"]
    argv = ["--task", traffic["task"], "--size", f"{v['width']}*{v['height']}",
            "--frame_num", str(v["frames"]), "--sample_steps", str(traffic["steps"]),
            "--sample_shift", str(traffic["shift"]),
            "--sample_guide_scale", str(traffic["guide_scale"]),
            "--base_seed", str(sub_seed(seed, "base") % 2 ** 31), "--device", device]
    args = cli.args_init(argv)
    pipe = cli.build_pipeline(args)
    common.same_widths(pipe.cfg, cfg)
    P = W.make(W.dit_leaves(cfg, cfg["num_layers"]), sub_seed(seed, "dit"), device)
    with torch.no_grad():
        pipe.model.load_state_dict(P, strict=True)
    del P
    keep = int(traffic["steps"]) + 8
    st = Stepper(device, keep)
    hooks = [pipe.model.register_forward_pre_hook(st.pre, with_kwargs=True),
             pipe.model.register_forward_hook(st.post, with_kwargs=True)]
    reqs = []

    def request(k):
        cond, null = contexts(seed, k, cfg, traffic, device)
        req = cli.Request(seed=sub_seed(seed, "request seed", k) % 2 ** 31, context=cond,
                          context_null=null, frame_num=v["frames"],
                          sample_steps=int(traffic["steps"]), sample_shift=float(traffic["shift"]),
                          guide_scale=float(traffic["guide_scale"]))
        reqs.append(req)
        return cli.run_request(pipe, req, args.size)

    try:
        # set-up: the shapes of a step, twice (a request ended after two steps)
        st.record, st.limit_steps = False, 2
        try:
            request(-1)
        except WindowClosed:
            pass
        reqs.clear()
        st.record, st.limit_steps, st.steps = True, None, 0
        win = None
        if seconds > 0:
            def loop(_):
                st.deadline = time.perf_counter() + seconds
                k = 0
                try:
                    while True:
                        request(k)
                        k += 1
                except WindowClosed:
                    pass
                return []

            win = training.window(loop, 0, device, traced)
            win.steps = st.steps
        else:
            st.limit_steps = keep
            try:
                request(0)
            except WindowClosed:
                pass
        st.sync()
    finally:
        for h in hooks:
            h.remove()
    first = reqs[0]
    del pipe, hooks
    training.free(device)
    values = reference(cell, seed, device, st, first, traffic, control)
    f, h, w = caches.latent_grid(traffic)
    tokens = f * (h // 2) * (w // 2)
    return {"window": win, "values": values,
            "work": work.sample_step(cfg, tokens, cfg["text_len"]),
            "failed": int(sum(not bool(torch.isfinite(o).all()) for o in st.out))}


def reference(cell, seed, device, st: Stepper, req, traffic, control=False) -> dict:
    """The first request's chain and a few of its forwards, in fp32 (the
    control: those forwards in fp8 against fp32)."""
    R.strict_fp32()
    cfg = cell.config
    dev = torch.device(device)
    n = min(len(st.x), int(traffic["steps"]))
    if n == 0:
        return {"chain_x": float("inf"), "model_v": float("inf")}
    P = W.make(W.dit_leaves(cfg, cfg["num_layers"]), sub_seed(seed, "dit"), device)
    P = W.served(P, W.bf16_stored(P))
    dit = R.DiT(P, cfg)
    low = R.DiT(P, cfg, precision="fp8") if control else None
    shift, guide = float(traffic["shift"]), float(traffic["guide_scale"])
    uni = R.UniPC(int(traffic["steps"]), shift)
    ts = uni.timesteps
    f, h, w = caches.latent_grid(traffic)
    g = torch.Generator(device=dev).manual_seed(req.seed)
    x, grid = R.patchify(torch.randn((1, f, h, w, cfg["out_dim"]), generator=g, device=dev))
    ctx = torch.cat([req.context, req.context_null]).float().to(dev)
    rng = np.random.default_rng(sub_seed(seed, "checked steps"))
    picks = sorted({int(rng.integers(0, n)) for _ in range(traffic["checked_steps"] - 1)}
                   | {n - 1})
    chain, model, sound = [], [], []
    with torch.no_grad():
        for i in range(n):
            xp, out = st.x[i].to(dev).float(), st.out[i].to(dev).float()
            if out.shape[0] != 2 or xp.shape != x.shape:  # not a CFG pair of this latent
                return {"chain_x": float("inf"), "model_v": float("inf")}
            chain.append(R.rel_l2(xp, x))
            if i in picks:
                ref = dit(torch.cat([xp, xp]), float(ts[i]), ctx, grid)
                sound.append(R.max_gap(out, ref))
                got = low(torch.cat([xp, xp]), float(ts[i]), ctx, grid) if control else out
                model.append(R.max_gap(got, ref))
            cond, uncond = out[:1], out[1:]
            x = uni.step(uncond + guide * (cond - uncond), x)
    if control:
        return {"model_v": max(model), "sound.model_v": max(sound)}
    return {"chain_x": max(chain), "model_v": max(model)}
