"""Weight converters into the port's WanModel state
(hyvideo_prfl_tpu/utils/checkpoint.py).

Two sources:

* ``from_jax_params``: the JAX package's flax tree as numpy arrays
  (``{"params": {...}}`` with blocks stacked [L, ...]), already in the
  half rope layout; with ``with_head=False`` the first ``cfg.num_layers``
  blocks of a tree form the reward model's trimmed, head-less tower, and
  ``lrm_from_jax`` adds the QueryAttention and RewardMLP trees to give a
  ``PavrmModel`` state dict.
* ``from_reference_state``: a reference Wan state dict (released
  ``diffusion_pytorch_model*.safetensors`` keys). Self-attention q/k rows
  and their norm scales move from the adjacent-pair rope layout to the
  half layout, and the Conv3d patch kernel [dim, C, pt, ph, pw] becomes
  the patch-embedding matmul over (pt, ph, pw, C).

Both return fp32 CPU tensors keyed like ``WanModel.state_dict()``;
``load_state_dict`` casts to the model's dtypes and device.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..models.rope import rope_permutation
from ..models.wan_dit import WanConfig

_TOP_DENSE = ("patch_embedding", "text_0", "text_2", "time_0", "time_2", "time_proj")
_ATTN_DENSE = ("q", "k", "v", "o")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def rope_perm_full(dim: int, head_dim: int) -> np.ndarray:
    """rope_permutation applied per head over the flattened q/k dim."""
    per_head = rope_permutation(head_dim)
    return np.concatenate([per_head + h * head_dim for h in range(dim // head_dim)])


def from_jax_params(tree_np: Dict, cfg: WanConfig, with_head: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """JAX flax tree (numpy leaves, stacked blocks) -> port state dict of
    its first cfg.num_layers blocks, with or without the head."""
    p = tree_np["params"] if "params" in tree_np else tree_np
    state: Dict[str, torch.Tensor] = {}

    def dense(dst, node, i=None):
        k = np.asarray(node["kernel"])
        b = np.asarray(node["bias"])
        if i is not None:
            k, b = k[i], b[i]
        state[dst + ".weight"] = _t(k.T)
        state[dst + ".bias"] = _t(b)

    for name in _TOP_DENSE:
        dense(name, p[name])
    blk = p["blocks"]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        state[pre + ".modulation"] = _t(np.asarray(blk["modulation"])[i])
        for attn in ("self_attn", "cross_attn"):
            for name in _ATTN_DENSE:
                dense(f"{pre}.{attn}.{name}", blk[attn][name], i)
            for name in ("norm_q", "norm_k"):
                state[f"{pre}.{attn}.{name}"] = _t(np.asarray(blk[attn][name])[i])
        state[pre + ".norm3_scale"] = _t(np.asarray(blk["norm3_scale"])[i])
        state[pre + ".norm3_bias"] = _t(np.asarray(blk["norm3_bias"])[i])
        dense(pre + ".ffn_0", blk["ffn_0"], i)
        dense(pre + ".ffn_2", blk["ffn_2"], i)
    if with_head:
        state["head.modulation"] = _t(p["head"]["modulation"])
        dense("head.head", p["head"]["head"])
    return state


def reward_heads_from_jax(q_tree: Dict, m_tree: Dict) -> Dict[str, torch.Tensor]:
    """QueryAttention and RewardMLP flax trees -> ``q_attn.*``/``mlp.*``
    keys of a PavrmModel state dict (the pool keeps the JAX orientation;
    the MLP's kernels transpose to torch's [out, in])."""
    q = q_tree["params"] if "params" in q_tree else q_tree
    m = m_tree["params"] if "params" in m_tree else m_tree
    state = {f"q_attn.{k}": _t(np.asarray(v)) for k, v in q.items()}
    for name, node in m.items():
        state[f"mlp.{name}.weight"] = _t(np.asarray(node["kernel"]).T)
        state[f"mlp.{name}.bias"] = _t(node["bias"])
    return state


def lrm_from_jax(dit_tree: Dict, q_tree: Dict, m_tree: Dict, cfg: WanConfig
                 ) -> Dict[str, torch.Tensor]:
    """The JAX LRM tower ({"dit", "q", "m"} of the PRFL trainer) -> a
    PavrmModel state dict; ``cfg`` is the trimmed config."""
    tower = {f"dit.{k}": v for k, v in from_jax_params(dit_tree, cfg, with_head=False).items()}
    return {**tower, **reward_heads_from_jax(q_tree, m_tree)}


def seeded_jax_tree(cfg: WanConfig, seed: int) -> Dict:
    """A JAX-layout parameter tree (numpy, blocks stacked [L, ...]) of
    seeded weights, for checks that need weights without JAX: dense
    kernels N(0, 1/fan_in), small biases, norm gains near 1 (the bounded
    softmax needs tame q/k gains) and a non-zero head, so the output
    depends on every block."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_layers, dim = cfg.num_layers, cfg.dim

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=f32) * f32(std)

    def dense(i, o, lead=()):
        return {"kernel": normal(lead + (i, o), 1.0 / np.sqrt(i)),
                "bias": normal(lead + (o,), 0.02)}

    def gains():
        return (1.0 + 0.1 * rng.uniform(-1.0, 1.0, (n_layers, dim))).astype(f32)

    def attn():
        tree = {k: dense(dim, dim, (n_layers,)) for k in _ATTN_DENSE}
        return {**tree, "norm_q": gains(), "norm_k": gains()}

    cells = int(np.prod(cfg.patch_size))
    return {"params": {
        "patch_embedding": dense(cells * cfg.in_dim, dim),
        "text_0": dense(cfg.text_dim, dim), "text_2": dense(dim, dim),
        "time_0": dense(cfg.freq_dim, dim), "time_2": dense(dim, dim),
        "time_proj": dense(dim, 6 * dim),
        "blocks": {
            "modulation": normal((n_layers, 1, 6, dim), 1.0 / np.sqrt(dim)),
            "self_attn": attn(), "cross_attn": attn(),
            "norm3_scale": gains(), "norm3_bias": normal((n_layers, dim), 0.02),
            "ffn_0": dense(dim, cfg.ffn_dim, (n_layers,)),
            "ffn_2": dense(cfg.ffn_dim, dim, (n_layers,)),
        },
        "head": {"modulation": normal((1, 2, dim), 1.0 / np.sqrt(dim)),
                 "head": dense(dim, cells * cfg.out_dim)},
    }}


def from_reference_state(state: Dict[str, np.ndarray], cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """Reference Wan state dict (numpy values) -> port state dict."""
    def arr(key):
        v = state[key]
        return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out: Dict[str, torch.Tensor] = {}
    w = arr("patch_embedding.weight")  # [dim, C, pt, ph, pw]
    out["patch_embedding.weight"] = _t(np.transpose(w, (0, 2, 3, 4, 1)).reshape(w.shape[0], -1))
    out["patch_embedding.bias"] = _t(arr("patch_embedding.bias"))
    for dst, src in (("text_0", "text_embedding.0"), ("text_2", "text_embedding.2"),
                     ("time_0", "time_embedding.0"), ("time_2", "time_embedding.2"),
                     ("time_proj", "time_projection.1")):
        out[dst + ".weight"] = _t(arr(src + ".weight"))
        out[dst + ".bias"] = _t(arr(src + ".bias"))

    perm = rope_perm_full(cfg.dim, cfg.head_dim)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[pre + ".modulation"] = _t(arr(pre + ".modulation"))
        for attn in ("self_attn", "cross_attn"):
            # self-attention q/k (and their norms) move to the half rope layout
            rows = perm if attn == "self_attn" else slice(None)
            for name in _ATTN_DENSE:
                wk, bk = arr(f"{pre}.{attn}.{name}.weight"), arr(f"{pre}.{attn}.{name}.bias")
                if name in ("q", "k"):
                    wk, bk = wk[rows], bk[rows]
                out[f"{pre}.{attn}.{name}.weight"] = _t(wk)
                out[f"{pre}.{attn}.{name}.bias"] = _t(bk)
            for name in ("norm_q", "norm_k"):
                out[f"{pre}.{attn}.{name}"] = _t(arr(f"{pre}.{attn}.{name}.weight")[rows])
        out[pre + ".norm3_scale"] = _t(arr(pre + ".norm3.weight"))
        out[pre + ".norm3_bias"] = _t(arr(pre + ".norm3.bias"))
        for dst, src in (("ffn_0", "ffn.0"), ("ffn_2", "ffn.2")):
            out[f"{pre}.{dst}.weight"] = _t(arr(f"{pre}.{src}.weight"))
            out[f"{pre}.{dst}.bias"] = _t(arr(f"{pre}.{src}.bias"))
    out["head.modulation"] = _t(arr("head.modulation"))
    out["head.head.weight"] = _t(arr("head.head.weight"))
    out["head.head.bias"] = _t(arr("head.head.bias"))
    return out


def load_reference_dir(path: str, cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """A released checkpoint directory (all *.safetensors merged) -> port
    state dict. Needs the safetensors package, imported here only (its
    torch loader, since released weights are bf16)."""
    from safetensors.torch import load_file

    state: Dict[str, torch.Tensor] = {}
    for fname in sorted(f for f in os.listdir(path) if f.endswith(".safetensors")):
        state.update(load_file(os.path.join(path, fname)))
    if not state:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    return from_reference_state(state, cfg)
