"""LoRA factors and their merge into the DiT's weights
(hyvideo_prfl_tpu/training/lora.py).

A LoRA is a tree of low-rank factors, one pair per targeted attention
projection of every block:

    {"lora": {attn: {m: {"A": [L, in, r], "B": [L, r, out]}}}}

attn in self_attn / cross_attn, m in q / k / v / o, as the JAX package
keeps it. The port's ``nn.Linear`` weight is [out, in], so a merge adds
(A_i B_i)^T scale to block i's weight: the product in fp32, cast to the
weight's dtype, then added in that dtype (the JAX package's arithmetic).
The port stores the self-attention q/k output rows in the half rope
layout (utils/checkpoint.py), so their B factors' columns move the same
way when a reference-format LoRA is read (``lora_from_state_dict`` with
``head_dim``); without ``head_dim`` the tree stays in the reference layout
and merges into a reference state dict, whose attention keys are the same.

Serving merges a LoRA before the weights are quantized to int8: an int8
model has no float weight to merge into.

Training (``model.lora.use_lora``): ``lora_init`` draws the tree as the
JAX package does (A ~ N(0, std), B = 0, so the first merge changes
nothing), and ``attach_lora`` freezes the DiT and gives each targeted
``nn.Linear`` its block's factors as parameters ``lora_A`` [in, r] and
``lora_B`` [r, out]. The DiT's dense call then merges them into the
weight at every use (models/wan_dit.merged_weight: the JAX ``apply_lora``
inside the loss, differentiable in A and B only), so the factors sit in
the same module, and under FSDP2 in the same unit, as the weight they
change, and the trainer's state, optimizer moments and EMA hold them
alone. ``lora_tree`` reads the stacked tree back from parameters by name,
``split_lora_state`` takes it out of a full state dict and
``merged_state`` adds it to the base for a checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.checkpoint import rope_perm_full

DEFAULT_TARGETS = ("q", "k", "v", "o")  # configs/train_*.yaml target_modules

# the attention projections a LoRA may target, per block
ATTNS = ("self_attn", "cross_attn")
_PARAM = re.compile(r"^blocks\.(\d+)\.(self_attn|cross_attn)\.(q|k|v|o)\.lora_([AB])$")

_KEY = re.compile(r"(?:transformer\.)?blocks[._](\d+)[._](self_attn|cross_attn)[._]"
                  r"(q|k|v|o)\.(?:lora_A|lora_down|lora_B|lora_up)\.weight$")


def _permutes(attn: str, m: str) -> bool:
    """Whether this projection's output rows sit in the half rope layout."""
    return attn == "self_attn" and m in ("q", "k")


def lora_from_state_dict(state: Dict, head_dim: Optional[int] = None) -> Dict:
    """A reference-format LoRA state dict, in any of the transformer
    (``blocks.N.attn.m.lora_A.weight``), kohya (``lora_unet_blocks_N_attn_m
    .lora_down.weight``) or diffusers (``transformer.blocks.N...``) key
    formats -> the factor tree (fp32 CPU tensors). With ``head_dim`` the
    self-attention q/k B factors move into the half rope layout. Other keys
    (kohya's ``.alpha``) are not read: the merge scales by its ``scale``
    alone."""
    per_layer: Dict = {}
    for key, val in state.items():
        m = _KEY.search(key.replace("lora_unet_blocks_", "blocks."))
        if not m:
            continue
        i, attn, mod = int(m.group(1)), m.group(2), m.group(3)
        which = "A" if ("lora_A" in key or "lora_down" in key) else "B"
        t = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.asarray(val))
        per_layer.setdefault((attn, mod), {}).setdefault(which, {})[i] = t.float()
    out: Dict = {}
    for (attn, mod), ab in sorted(per_layer.items()):
        n = max(ab["A"]) + 1
        a = torch.stack([ab["A"][i].t() for i in range(n)])  # [L, in, r]
        b = torch.stack([ab["B"][i].t() for i in range(n)])  # [L, r, out]
        if head_dim is not None and _permutes(attn, mod):
            b = b[:, :, torch.from_numpy(rope_perm_full(b.shape[-1], head_dim)).to(b.device)]
        out.setdefault(attn, {})[mod] = {"A": a.contiguous(), "B": b.contiguous()}
    return {"lora": out}


def lora_state_dict(lora: Dict, fmt: str = "transformer",
                    head_dim: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The factor tree -> a flat state dict in the transformer, kohya or
    diffusers key format ([r, in] A and [out, r] B per block; kohya adds
    each module's ``.alpha``, the rank). With ``head_dim`` the
    self-attention q/k B factors go back from the half rope layout to the
    reference's."""
    out = {}
    for attn, mods in lora["lora"].items():
        for m, ab in mods.items():
            a, b = ab["A"], ab["B"]
            if head_dim is not None and _permutes(attn, m):
                inv = np.argsort(rope_perm_full(b.shape[-1], head_dim))
                b = b[:, :, torch.from_numpy(inv).to(b.device)]
            for i in range(a.shape[0]):
                if fmt == "transformer":
                    base, down, up = f"blocks.{i}.{attn}.{m}", "lora_A", "lora_B"
                elif fmt == "kohya":
                    base, down, up = f"lora_unet_blocks_{i}_{attn}_{m}", "lora_down", "lora_up"
                    out[f"{base}.alpha"] = torch.tensor(float(a.shape[-1]))
                elif fmt == "diffusers":
                    base, down, up = f"transformer.blocks.{i}.{attn}.{m}", "lora_A", "lora_B"
                else:
                    raise ValueError(f"unknown LoRA key format {fmt!r}")
                out[f"{base}.{down}.weight"] = a[i].t().contiguous()
                out[f"{base}.{up}.weight"] = b[i].t().contiguous()
    return out


def lora_from_jax(tree_np: Dict) -> Dict:
    """The JAX package's factor tree (numpy leaves; already in the half
    rope layout) -> the port's (fp32 CPU tensors)."""
    return {"lora": {attn: {m: {k: torch.from_numpy(np.array(v, np.float32))
                                for k, v in ab.items()}
                            for m, ab in mods.items()}
                     for attn, mods in tree_np["lora"].items()}}


@torch.no_grad()
def merge_lora_state(state: Dict[str, torch.Tensor], lora: Dict, scale: float = 1.0) -> None:
    """In place: ``state["blocks.{i}.{attn}.{m}.weight"]`` ([out, in], the
    key the port and the reference share) += (A_i B_i)^T scale, the product
    in fp32 on the weight's device, cast to the weight's dtype and added
    in it."""
    for attn, mods in lora["lora"].items():
        for m, ab in mods.items():
            for i in range(ab["A"].shape[0]):
                key = f"blocks.{i}.{attn}.{m}.weight"
                if key not in state:
                    raise KeyError(f"the LoRA targets {key}, which the model has not "
                                   "(a LoRA merges into a float model of as many blocks)")
                w = state[key]
                a = ab["A"][i].to(w.device, torch.float32)
                b = ab["B"][i].to(w.device, torch.float32)
                w.add_(((a @ b) * scale).t().to(w.dtype))


def merge_lora(model: torch.nn.Module, lora: Dict, scale: float = 1.0) -> torch.nn.Module:
    """Merge a factor tree (half rope layout) into a WanModel's attention
    weights in place; returns the model."""
    if getattr(model.cfg, "quant_dense", None):
        raise ValueError("merge a LoRA before quantizing: an int8 model has no float "
                         "weights to merge into")
    merge_lora_state(dict(model.named_parameters()), lora, scale)
    return model


def lora_init(model: torch.nn.Module, rank: int = 128,
              target_modules: Sequence[str] = DEFAULT_TARGETS, std: float = 0.01,
              generator: Optional[torch.Generator] = None) -> Dict:
    """The factor tree of a WanModel's targeted attention projections (the
    JAX ``lora_init``): A ~ N(0, std) [L, in, r] and B = 0 [L, r, out],
    fp32 on the model's device, for each of ``target_modules`` in every
    block's self- and cross-attention (the image keys ``k_img``/``v_img``
    are never targets)."""
    blocks = model.blocks
    device = next(model.parameters()).device
    out: Dict = {}
    for attn in ATTNS:
        sub = {}
        for m in target_modules:
            if m not in ("q", "k", "v", "o"):
                continue
            layer = getattr(getattr(blocks[0], attn), m)
            dout, din = layer.weight.shape
            a = torch.randn((len(blocks), din, rank), generator=generator, device=device,
                            dtype=torch.float32) * std
            sub[m] = {"A": a, "B": torch.zeros((len(blocks), rank, dout), device=device,
                                                 dtype=torch.float32)}
        out[attn] = sub
    return {"lora": out}


def attach_lora(model: torch.nn.Module, lora: Dict) -> torch.nn.Module:
    """Freeze every parameter of a float WanModel and give each targeted
    projection of block i the trainable ``lora_A`` = A[i], ``lora_B`` =
    B[i] (copies, fp32, on the weight's device); returns the model."""
    if getattr(model.cfg, "quant_dense", None):
        raise ValueError("LoRA trains a float model; an int8 model has no float weights")
    model.requires_grad_(False)
    for attn, mods in lora["lora"].items():
        for m, ab in mods.items():
            if ab["A"].shape[0] != len(model.blocks):
                raise ValueError(f"the LoRA has {ab['A'].shape[0]} blocks, the model "
                                 f"{len(model.blocks)}")
            for i, block in enumerate(model.blocks):
                layer = getattr(getattr(block, attn), m)
                dev = layer.weight.device
                layer.lora_A = torch.nn.Parameter(ab["A"][i].to(dev, torch.float32).clone())
                layer.lora_B = torch.nn.Parameter(ab["B"][i].to(dev, torch.float32).clone())
    return model


def is_lora_name(name: str) -> bool:
    return _PARAM.match(name) is not None


def lora_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """{``blocks.i.attn.m.lora_A``/``_B``: tensor} (the trainable
    parameters by name, or their gathered copies, e.g. the EMA's) -> the
    stacked factor tree; other names are passed over."""
    per: Dict = {}
    for name, t in named.items():
        hit = _PARAM.match(name)
        if hit:
            i, attn, m, which = int(hit.group(1)), hit.group(2), hit.group(3), hit.group(4)
            per.setdefault((attn, m), {}).setdefault(which, {})[i] = t.detach()
    out: Dict = {}
    for (attn, m), ab in per.items():
        out.setdefault(attn, {})[m] = {w: torch.stack([ab[w][i] for i in range(len(ab[w]))])
                                       for w in ("A", "B")}
    return {"lora": out}


def split_lora_state(state: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """A WanModel state dict with LoRA factors attached -> (the base state
    without them, their stacked tree)."""
    base = {k: v for k, v in state.items() if not is_lora_name(k)}
    return base, lora_tree({k: v for k, v in state.items() if is_lora_name(k)})


def merged_state(base: Dict[str, torch.Tensor], lora: Dict) -> Dict[str, torch.Tensor]:
    """A copy of the base state with the tree merged (``merge_lora_state``;
    the JAX trainer's saved ``apply_lora(params, lora)``)."""
    out = dict(base)
    for attn, mods in lora["lora"].items():
        for m, ab in mods.items():
            for i in range(ab["A"].shape[0]):
                key = f"blocks.{i}.{attn}.{m}.weight"
                out[key] = out[key].clone()
    merge_lora_state(out, lora)
    return out
