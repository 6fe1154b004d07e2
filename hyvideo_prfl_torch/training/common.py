"""Shared training utilities (hyvideo_prfl_tpu/training/common.py): the LR
schedule, the optimizer (global-norm clip + AdamW, optional gradient
accumulation), the train state and the i2v/flf2v conditioning of a batch.

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
  that feeds the clip + AdamW step on every k-th call;
* ``learning_rate_mlp``: the parameters under the ``head_keys`` prefixes
  (the reward heads ``q_attn.*`` and ``mlp.*``) take their own learning
  rate and schedule, after the one clip over all gradients (optax's
  ``chain(clip_by_global_norm, multi_transform(...))``).

Sharded and offloaded state (parallel/sharding.py): the optimizer works
on each rank's local shards of the parameters and gradients; the global
norm sums the shards' squares over the ranks that hold disjoint shards
(``TrainState.layout.norm_group``), so it is the norm of the full
gradients; under the "none" strategy the replicated gradients are first
averaged over the ranks. With ``offload`` the AdamW moments live in
(pinned) host memory between steps: each chunk of 64 parameters copies
its moments to the card, updates them and copies them back, all on the
current stream, whose order makes the copies safe to read; the update
waits for the stream at its end, so the host copies are whole when it
returns (a checkpoint may read them). The numbers are those of the
unoffloaded update, bit for bit.

``TrainState.step`` counts every call (the PRFL loop makes two per outer
step, refl and SFT); the LR schedule and the bias correction read the
number of optimizer updates before this one, ``step // k``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import sharding
from ..utils import tracing

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
    # the heads' own schedule (learning_rate_mlp) and the name prefixes it serves
    lr_head: Optional[Callable[[int], float]] = None
    head_keys: Tuple[str, ...] = ("q_attn", "mlp")

    def init(self, params: List[torch.Tensor], names: Optional[List[str]] = None,
             offload: bool = False) -> Dict[str, List[torch.Tensor]]:
        """Zero moments (and accumulator) beside the parameters, or with
        ``offload`` the moments in host memory (pinned when CUDA is there);
        with a head group, ``head`` marks the parameters whose first name
        part is one of ``head_keys``."""
        def moment(p):
            if not offload:
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32,
                               pin_memory=torch.cuda.is_available())

        state = {"mu": [moment(p) for p in params], "nu": [moment(p) for p in params]}
        if self.k > 1:
            state["acc"] = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        if self.lr_head is not None:
            if names is None:
                raise ValueError("a head learning rate needs the parameter names")
            state["head"] = [n.split(".")[0] in self.head_keys for n in names]
        return state

    def update(self, params, grads, opt_state, step: int, norm_group=None) -> None:
        """One call at TrainState.step ``step``, in place (``grads`` too:
        the caller hands over fp32 gradients it no longer needs); the
        tensors are this rank's shards, whose squares the norm sums over
        ``norm_group``."""
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
        with tracing.span("optimizer.clip"):  # the norm and its host read
            norm = global_norm(grads, norm_group)
            if not bool(norm < self.max_grad_norm):
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.max_grad_norm)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        head = opt_state.get("head", [False] * len(params))
        groups = [(False, self.lr(count))]
        if self.lr_head is not None:
            groups.append((True, self.lr_head(count)))
        for group, lr in groups:
            idx = [i for i, h in enumerate(head) if h == group]
            self._adamw([params[i] for i in idx], [grads[i] for i in idx],
                        [opt_state["mu"][i] for i in idx], [opt_state["nu"][i] for i in idx],
                        lr, bc1, bc2)
        if self.k > 1:
            torch._foreach_zero_(opt_state["acc"])

    def _adamw(self, params, grads, mu, nu, lr, bc1, bc2) -> None:
        offloaded = bool(params) and mu[0].device != params[0].device
        for i in range(0, len(params), _CHUNK):
            p, g = params[i:i + _CHUNK], grads[i:i + _CHUNK]
            m_home, v_home = mu[i:i + _CHUNK], nu[i:i + _CHUNK]
            m, v = m_home, v_home
            if offloaded:
                m = [x.to(p[0].device, non_blocking=True) for x in m_home]
                v = [x.to(p[0].device, non_blocking=True) for x in v_home]
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
            if offloaded:
                for home, dev in zip(m_home + v_home, m + v):
                    home.copy_(dev, non_blocking=True)
        if offloaded and params[0].is_cuda:
            torch.cuda.current_stream(params[0].device).synchronize()


def make_optimizer(learning_rate: float = 5e-6, adam_beta1: float = 0.9,
                   adam_beta2: float = 0.999, adam_epsilon: float = 1e-8,
                   weight_decay: float = 0.01, lr_scheduler: str = "constant",
                   lr_warmup_steps: int = 0, lr_num_cycles: int = 1, lr_power: float = 1.0,
                   max_train_steps: int = 1_000_000, max_grad_norm: float = 1.0,
                   gradient_accumulation_steps: int = 1,
                   learning_rate_mlp: Optional[float] = None,
                   head_keys: Tuple[str, ...] = ("q_attn", "mlp")) -> Optimizer:
    """The JAX package's make_optimizer: one parameter group, or two with
    ``learning_rate_mlp`` (the heads under ``head_keys``)."""
    def schedule(lr):
        return _lr_schedule(lr, lr_scheduler, lr_warmup_steps, max_train_steps,
                            lr_num_cycles=lr_num_cycles, lr_power=lr_power)

    return Optimizer(
        lr=schedule(learning_rate),
        b1=adam_beta1, b2=adam_beta2, eps=adam_epsilon, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm, k=max(1, int(gradient_accumulation_steps)),
        lr_head=None if learning_rate_mlp is None else schedule(float(learning_rate_mlp)),
        head_keys=tuple(head_keys))


def optimizer_from_config(config) -> Optimizer:
    """make_optimizer from a training config's optimizer.* and
    train.gradient_accumulation_steps; the reward heads take
    optimizer.learning_rate_mlp where it is set (a PAVRM config's)."""
    opt = config.optimizer
    return make_optimizer(
        learning_rate=opt.learning_rate, adam_beta1=opt.adam_beta1, adam_beta2=opt.adam_beta2,
        adam_epsilon=opt.get("adam_epsilon", 1e-8), weight_decay=opt.weight_decay,
        lr_scheduler=opt.lr_scheduler, lr_warmup_steps=opt.lr_warmup_steps,
        lr_num_cycles=int(opt.get("lr_num_cycles", 1)), lr_power=float(opt.get("lr_power", 1.0)),
        max_train_steps=opt.max_train_steps, max_grad_norm=float(opt.get("max_grad_norm", 1.0)),
        gradient_accumulation_steps=config.train.gradient_accumulation_steps,
        learning_rate_mlp=opt.get("learning_rate_mlp"))


@dataclasses.dataclass
class TrainState:
    """Trainable parameters (by name; DTensors under FSDP), optimizer state
    (on the local shards), the count of optimizer calls and the
    parameters' layout over the ranks."""

    names: List[str]
    params: List[torch.Tensor]
    opt_state: Dict[str, List[torch.Tensor]]
    step: int = 0
    layout: sharding.Layout = dataclasses.field(default_factory=sharding.Layout)

    def local_params(self) -> List[torch.Tensor]:
        """This rank's shards of the parameters (the parameters when plain)."""
        return [sharding.local(p.detach()) for p in self.params]


def init_train_state(module: torch.nn.Module, tx: Optimizer,
                     layout: Optional[sharding.Layout] = None,
                     offload: bool = False) -> TrainState:
    """The trainable parameters of ``module`` (sharded already, as
    ``layout`` says) and the optimizer state of their local shards."""
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    params, names = [p for _, p in named], [n for n, _ in named]
    state = TrainState(names=names, params=params, opt_state={}, step=0,
                       layout=layout or sharding.Layout())
    # the optimizer test doubles take no offload argument
    state.opt_state = tx.init(state.local_params(), names, **(
        {"offload": True} if offload else {}))
    return state


def global_norm(tensors, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32; with ``group``
    the tensors are shards and the squares are summed over its ranks."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if group is None or dist.get_world_size(group) == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square().sum()
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


def apply_grads(state: TrainState, tx: Optimizer, grads: List[torch.Tensor]
                ) -> Tuple[TrainState, torch.Tensor]:
    """One optimizer call; returns (state, global norm of ``grads``)."""
    group = state.layout.norm_group
    gnorm = global_norm(grads, group)
    with torch.no_grad():
        tx.update(state.local_params(), grads, state.opt_state, state.step,
                  **({"norm_group": group} if group is not None else {}))
    state.step += 1
    return state, gnorm


def gathered_opt_state(state: TrainState, main: bool = True) -> TrainState:
    """The state with its optimizer tensors gathered to full host tensors
    (every rank calls it; only ``main``'s copy holds them), for
    utils/checkpoint.save_opt_state."""
    full = {}
    for key, vals in state.opt_state.items():
        if all(isinstance(v, torch.Tensor) for v in vals):
            full[key] = sharding.gather_to_host(vals, state.params, main)
        else:
            full[key] = vals
    return dataclasses.replace(state, opt_state=full)


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one training step's draws, seeded by (seed, step):
    a resumed run draws at step n what an uninterrupted run draws there."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % 2 ** 63)


def collect_grads(state: TrainState, finite: Optional[bool] = True) -> List[torch.Tensor]:
    """The parameters' gradients (zeros where none flowed), fp32, cleared
    from the parameters; all zeros when ``finite`` is false (the finite
    guard: the update still runs, with zero gradients)."""
    grads = []
    for p in state.params:
        g = None if p.grad is None else sharding.local(p.grad)
        grads.append(torch.zeros_like(sharding.local(p.detach()), dtype=torch.float32)
                     if g is None or not finite else g.float())
        p.grad = None
    group = state.layout.mean_group
    if group is not None and finite:
        for g in grads:
            dist.all_reduce(g, group=group)
            g.div_(dist.get_world_size(group))
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
    """NaN/Inf parameter health check (of this rank's shards) ->
    {"finite": bool, "bad": [names]}."""
    bad = [n for n, p in module.named_parameters()
           if not bool(torch.isfinite(sharding.local(p.detach())).all())]
    return {"finite": not bad, "bad": bad}


def i2v_condition(cond: Optional[torch.Tensor], flf2v: bool = False) -> Optional[torch.Tensor]:
    """Concat the 4-channel conditioning mask onto 16-channel i2v latents:
    [B, F, H, W, 16] -> [B, F, H, W, 20], ones on latent frame 0 (and, for
    flf2v, on all four channels of the last frame: pipelines/pipeline.i2v_mask
    sets only channel 3 there), zeros elsewhere. None and conds that are
    not 16-channel pass through."""
    if cond is None:
        return None
    b, f, h, w, c = cond.shape
    if c != 16:
        return cond
    frames = torch.arange(f, device=cond.device)
    hit = frames == 0
    if flf2v:
        hit = hit | (frames == f - 1)
    mask = hit[None, :, None, None, None].to(cond.dtype).expand(b, f, h, w, 4)
    return torch.cat([mask, cond], dim=-1)


def reshape_clip(clip: Optional[torch.Tensor], tokens: int = 257) -> Optional[torch.Tensor]:
    """[B, N*257, D] stacked CLIP features -> [B*N, 257, D] (N = 2 for the
    flf2v first and last frame, 1 otherwise)."""
    if clip is None:
        return None
    b, n_s, d = clip.shape
    return clip.reshape(b * (n_s // tokens), tokens, d)


def prepare_conditioning(batch, is_i2v: bool, flf2v: bool = False):
    """(y, clip_fea) for the DiT from a dataset batch; (None, None) for t2v."""
    if not is_i2v:
        return None, None
    return i2v_condition(batch.get("cond"), flf2v), reshape_clip(batch.get("clip_fea"))
