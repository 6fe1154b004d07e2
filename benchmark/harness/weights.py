"""Seeded weights, made on the device from ``--seed`` in two draws (one
uniform, one normal, over every leaf at once) and handed to the program
and to the reference alike.

The leaves carry the program's state-dict names ([out, in] dense
weights), so ``load_state_dict(strict=True)`` checks them against the
program's model. The distributions are the JAX initialisers' (xavier-
uniform dense kernels, normal(0.02) text and time embeddings,
normal(1/sqrt(dim)) modulation) with three changes that keep a random
model from being degenerate: biases are normal(0.02) rather than zero,
the norm gains 1 + normal(0.02) rather than 1, and the DiT head is
normal(1/sqrt(dim)) rather than zero (a zero head gives every block a zero
gradient and every step a zero velocity).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind, scale): kind "u" is uniform(-scale, scale); "n" is
# normal(0, scale); "g" is 1 + normal(0, scale)
Leaf = Tuple[str, Tuple[int, ...], str, float]
BIAS_STD = 0.02
GAIN_STD = 0.02


def _dense(name, d_out, d_in, kind="xavier") -> List[Leaf]:
    w = (("n", 0.02) if kind == "normal" else ("u", math.sqrt(6.0 / (d_in + d_out))))
    return [(name + ".weight", (d_out, d_in), *w), (name + ".bias", (d_out,), "n", BIAS_STD)]


def dit_leaves(cfg: dict, n_layers: int, head: bool = True, prefix: str = "") -> List[Leaf]:
    """The DiT's leaves (t2v): embeddings, ``n_layers`` blocks, the head."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    cells = math.prod(cfg["patch_size"])
    out = (_dense("patch_embedding", d, cells * cfg["in_dim"])
           + _dense("text_0", d, cfg["text_dim"], "normal") + _dense("text_2", d, d, "normal")
           + _dense("time_0", d, cfg["freq_dim"], "normal") + _dense("time_2", d, d, "normal")
           + _dense("time_proj", 6 * d, d))
    for i in range(n_layers):
        p = f"blocks.{i}."
        out.append((p + "modulation", (1, 6, d), "n", d ** -0.5))
        for att in ("self_attn", "cross_attn"):
            for m in "qkvo":
                out += _dense(f"{p}{att}.{m}", d, d)
            out += [(f"{p}{att}.norm_q", (d,), "g", GAIN_STD),
                    (f"{p}{att}.norm_k", (d,), "g", GAIN_STD)]
        out += [(p + "norm3_scale", (d,), "g", GAIN_STD), (p + "norm3_bias", (d,), "n", BIAS_STD)]
        out += _dense(p + "ffn_0", f, d) + _dense(p + "ffn_2", d, f)
    if head:
        out_dim = cells * cfg["out_dim"]
        out += [("head.modulation", (1, 2, d), "n", d ** -0.5),
                ("head.head.weight", (out_dim, d), "n", d ** -0.5),
                ("head.head.bias", (out_dim,), "n", BIAS_STD)]
    return [(prefix + n, s, k, c) for n, s, k, c in out]


def reward_leaves(cfg: dict, layers: int) -> List[Leaf]:
    """PAVRM: the head-less tower under ``dit.``, the pool and the MLP."""
    d = cfg["dim"]
    x = math.sqrt(6.0 / (2 * d))
    pool = [("q_attn.queries", (1, d), "u", math.sqrt(6.0 / (1 + d)))]
    pool += [(f"q_attn.w{m}", (d, d), "u", x) for m in "qkvo"]
    pool += [(f"q_attn.b{m}", (d,), "n", BIAS_STD) for m in "qkvo"]
    mlp = (_dense("mlp.Dense_0", 1024, d) + _dense("mlp.Dense_1", 512, 1024)
           + _dense("mlp.Dense_2", 1, 512))
    return dit_leaves(cfg, layers, head=False, prefix="dit.") + pool + mlp


def make(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 leaves from two draws of one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_u = sum(math.prod(s) for _, s, k, _ in leaves if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in leaves if k != "u")
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, kind, scale in leaves:
        size = math.prod(shape)
        if kind == "u":
            t = uni[iu:iu + size].view(shape).mul_(2 * scale).sub_(scale)
            iu += size
        else:
            t = nor[inn:inn + size].view(shape).mul_(scale)
            inn += size
            if kind == "g":
                t.add_(1.0)
        out[name] = t
    return out


def served(P: Dict[str, torch.Tensor], bf16_names) -> Dict[str, torch.Tensor]:
    """The weights as a bf16-storing model holds them: the named leaves
    rounded to bf16 (kept fp32 here), the rest as they are."""
    return {n: (t.to(torch.bfloat16).float() if n in bf16_names else t) for n, t in P.items()}


def bf16_stored(names, prefix: str = "") -> set:
    """The leaves a DiT stores in bf16 when it serves (every linear of the
    blocks and the patch and text embeddings); time MLP, gains, modulation
    and head stay fp32."""
    keep32 = ("time_0", "time_2", "time_proj", "head.")
    out = set()
    for n in names:
        rest = n[len(prefix):] if n.startswith(prefix) else None
        if rest is None or rest.startswith(keep32):
            continue
        if rest.endswith((".weight", ".bias")):
            out.add(n)
    return out
