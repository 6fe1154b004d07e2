"""Shared training utilities (hyvideo_prfl_tpu/training/common.py): the LR
schedule, the optimizer (global-norm clip + AdamW, optional gradient
accumulation) and the train state.

The optimizer is written out rather than taken from ``torch.optim`` so it
is the JAX package's optax chain step for step:

* clip: the global norm of all gradients; when it is at least
  ``max_grad_norm`` every gradient becomes ``(g / norm) * max_grad_norm``
  (optax adds no epsilon; ``clip_grad_norm_`` adds 1e-6);
* AdamW: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, bias
  correction with the update count, ``u = mu_hat / (sqrt(nu_hat) + eps)``
  (eps outside the sqrt), decoupled weight decay ``u += wd p`` on every
  parameter, ``p -= lr(count) u``; all in fp32;
* accumulation over k micro-steps: a running mean ``acc += (g - acc) / n``
  that feeds the clip + AdamW step on every k-th call.

``TrainState.step`` counts every call (the PRFL loop makes two per outer
step, refl and SFT); the LR schedule and the bias correction read the
number of optimizer updates before this one, ``step // k``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

_CHUNK = 64  # parameters per foreach group: bounds the optimizer's temporaries


def _lr_schedule(learning_rate, lr_scheduler, lr_warmup_steps, max_train_steps,
                 lr_num_cycles=1, lr_power=1.0) -> Callable[[int], float]:
    """The diffusers get_scheduler surface as optax schedules: constant,
    constant_with_warmup, linear, cosine, cosine_with_restarts, polynomial,
    each after a linear warmup 0 -> lr over lr_warmup_steps. Plain cosine
    always runs half a cycle (diffusers forwards num_cycles only to
    cosine_with_restarts)."""
    warm = int(lr_warmup_steps or 0)
    decay_steps = max(1, max_train_steps - warm)
    lr = float(learning_rate)

    def progress(step):
        return min(max(step / decay_steps, 0.0), 1.0)

    if lr_scheduler in ("constant", "constant_with_warmup"):
        def body(step):
            return lr
    elif lr_scheduler == "linear":
        def body(step):
            return lr * (1.0 - min(max(step, 0), decay_steps) / decay_steps)
    elif lr_scheduler == "cosine":
        def body(step):
            return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress(step))))
    elif lr_scheduler == "cosine_with_restarts":
        cycles = max(1, int(lr_num_cycles))

        def body(step):
            p = progress(step)
            if p >= 1.0:
                return 0.0
            return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((cycles * p) % 1.0))))
    elif lr_scheduler == "polynomial":
        lr_end = 1e-7  # diffusers default

        def body(step):
            return (lr - lr_end) * (1.0 - progress(step)) ** lr_power + lr_end
    else:
        raise ValueError(f"unknown lr_scheduler {lr_scheduler}")

    if not warm:
        return body

    def schedule(step):
        if step < warm:
            return lr * min(max(step, 0), warm) / warm
        return body(step - warm)

    return schedule


@dataclasses.dataclass
class Optimizer:
    """Global-norm clip + AdamW (+ accumulation over k micro-steps)."""

    lr: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    k: int = 1

    def init(self, params: List[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        state = {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros]}
        if self.k > 1:
            state["acc"] = [torch.zeros_like(z) for z in zeros]
        return state

    def update(self, params, grads, opt_state, step: int) -> None:
        """One call at TrainState.step ``step``, in place (``grads`` too:
        the caller hands over fp32 gradients it no longer needs)."""
        if self.k > 1:
            n = step % self.k + 1
            acc = opt_state["acc"]
            for i in range(0, len(acc), _CHUNK):
                a, g = acc[i:i + _CHUNK], grads[i:i + _CHUNK]
                torch._foreach_add_(a, torch._foreach_div(torch._foreach_sub(g, a), float(n)))
            if n < self.k:
                return
            grads = acc  # zeroed below, once the update has read it
        count = step // self.k  # optimizer updates before this one
        norm = global_norm(grads)
        if not bool(norm < self.max_grad_norm):
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.max_grad_norm)
        lr = self.lr(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        mu, nu = opt_state["mu"], opt_state["nu"]
        for i in range(0, len(params), _CHUNK):
            p, g = params[i:i + _CHUNK], grads[i:i + _CHUNK]
            m, v = mu[i:i + _CHUNK], nu[i:i + _CHUNK]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
        if self.k > 1:
            torch._foreach_zero_(opt_state["acc"])


def make_optimizer(learning_rate: float = 5e-6, adam_beta1: float = 0.9,
                   adam_beta2: float = 0.999, adam_epsilon: float = 1e-8,
                   weight_decay: float = 0.01, lr_scheduler: str = "constant",
                   lr_warmup_steps: int = 0, lr_num_cycles: int = 1, lr_power: float = 1.0,
                   max_train_steps: int = 1_000_000, max_grad_norm: float = 1.0,
                   gradient_accumulation_steps: int = 1) -> Optimizer:
    """The JAX package's make_optimizer, one parameter group."""
    return Optimizer(
        lr=_lr_schedule(learning_rate, lr_scheduler, lr_warmup_steps, max_train_steps,
                        lr_num_cycles=lr_num_cycles, lr_power=lr_power),
        b1=adam_beta1, b2=adam_beta2, eps=adam_epsilon, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm, k=max(1, int(gradient_accumulation_steps)))


@dataclasses.dataclass
class TrainState:
    """Trainable parameters (by name), optimizer state, and the count of
    optimizer calls."""

    names: List[str]
    params: List[torch.Tensor]
    opt_state: Dict[str, List[torch.Tensor]]
    step: int = 0


def init_train_state(module: torch.nn.Module, tx: Optimizer) -> TrainState:
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    return TrainState(names=[n for n, _ in named], params=params,
                      opt_state=tx.init(params), step=0)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_grads(state: TrainState, tx: Optimizer, grads: List[torch.Tensor]
                ) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer call; returns (state, global norm of ``grads``)."""
    gnorm = global_norm(grads)
    with torch.no_grad():
        tx.update(state.params, grads, state.opt_state, state.step)
    state.step += 1
    return state, gnorm


def collect_grads(state: TrainState, finite: Optional[bool] = True) -> List[torch.Tensor]:
    """The parameters' gradients (zeros where none flowed), fp32, cleared
    from the parameters; all zeros when ``finite`` is false (the finite
    guard: the update still runs, with zero gradients)."""
    grads = []
    for p in state.params:
        g = p.grad
        grads.append(torch.zeros_like(p, dtype=torch.float32) if g is None or not finite
                     else g.float())
        p.grad = None
    return grads


def slice_blocks(state_dict: Dict[str, torch.Tensor], k: int) -> Dict[str, torch.Tensor]:
    """Trim a WanModel state dict to its first k blocks and drop the head:
    the reward model's tower."""
    out = {}
    for key, v in state_dict.items():
        if key.startswith("head."):
            continue
        if key.startswith("blocks.") and int(key.split(".")[1]) >= k:
            continue
        out[key] = v
    return out


def validate_params(module: torch.nn.Module) -> dict:
    """NaN/Inf parameter health check -> {"finite": bool, "bad": [names]}."""
    bad = [n for n, p in module.named_parameters() if not bool(torch.isfinite(p).all())]
    return {"finite": not bad, "bad": bad}
