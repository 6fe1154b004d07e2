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

Both return fp32 CPU tensors keyed like ``WanModel.state_dict()``, with
no q/k norm gains when ``cfg.qk_norm`` is off and no norm3 when
``cfg.cross_attn_norm`` is off (the trees and state dicts of such models
have none);
``load_state_dict`` casts to the model's dtypes and device.
``from_jax_params`` also takes the JAX int8 tree (``quantize_params``'s
``kernel_q`` [D, F] int8, ``kernel_scale`` [F], ``bias``), which goes to the
``QuantLinear`` buffers, the weight transposed; ``quantize_state`` makes
the same int8 state from the port's own float state. For i2v and flf2v
both also carry the image branch: ``img_emb`` (the CLIP projector) and each
block's ``cross_attn.{k_img, v_img, norm_k_img}``; cross-attention rows
keep their order (only the self-attention q/k move to the half layout).

Back to the reference layout: ``to_reference_state`` inverts
``from_reference_state`` and ``save_reference_dir`` writes a checkpoint
directory (safetensors shards through ``safetensors_io``, which also reads
them: the safetensors package is not needed); the reward heads go to and
from the reference torch layout (``fc1..fc3``; ``queries`` and a fused
``multihead_attn``). The trainers keep their own state as torch.save files
(``save_trainable``, ``save_opt_state``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..models.rope import rope_permutation
from ..models.wan_dit import CLIP_DIM, FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER, WanConfig, \
    WanModel, is_i2v
from ..ops.quant import quantize_weight
from ..parallel import sharding
from . import safetensors_io as st

_TOP_DENSE = ("patch_embedding", "text_0", "text_2", "time_0", "time_2", "time_proj")
_ATTN_DENSE = ("q", "k", "v", "o")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def rope_perm_full(dim: int, head_dim: int) -> np.ndarray:
    """rope_permutation applied per head over the flattened q/k dim."""
    per_head = rope_permutation(head_dim)
    return np.concatenate([per_head + h * head_dim for h in range(dim // head_dim)])


def _norm_names(cfg: WanConfig):
    return ("norm_q", "norm_k") if cfg.qk_norm else ()


def _cross_dense(cfg: WanConfig):
    return _ATTN_DENSE + (("k_img", "v_img") if is_i2v(cfg) else ())


def _cross_norms(cfg: WanConfig):
    return _norm_names(cfg) + (("norm_k_img",) if is_i2v(cfg) and cfg.qk_norm else ())


# the image projector's LayerNorm leaves (port name, reference module index)
_IMG_LN = (("ln0", 0), ("ln1", 4))


def from_jax_params(tree_np: Dict, cfg: WanConfig, with_head: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """JAX flax tree (numpy leaves, stacked blocks) -> port state dict of
    its first cfg.num_layers blocks, with or without the head."""
    p = tree_np["params"] if "params" in tree_np else tree_np
    state: Dict[str, torch.Tensor] = {}

    def dense(dst, node, i=None):
        def leaf(key):
            a = np.asarray(node[key])
            return a if i is None else a[i]

        if "kernel_q" in node:  # an int8 layer of the JAX quantized tree
            state[dst + ".weight_q"] = torch.from_numpy(np.ascontiguousarray(
                leaf("kernel_q").T.astype(np.int8)))
            state[dst + ".weight_scale"] = _t(leaf("kernel_scale"))
        else:
            state[dst + ".weight"] = _t(leaf("kernel").T)
        state[dst + ".bias"] = _t(leaf("bias"))

    for name in _TOP_DENSE:
        dense(name, p[name])
    if is_i2v(cfg):
        img = p["img_emb"]
        for ln, _ in _IMG_LN:
            state[f"img_emb.{ln}_scale"] = _t(img[f"{ln}_scale"])
            state[f"img_emb.{ln}_bias"] = _t(img[f"{ln}_bias"])
        dense("img_emb.fc1", img["fc1"])
        dense("img_emb.fc2", img["fc2"])
        if cfg.model_type == "flf2v":
            state["img_emb.emb_pos"] = _t(img["emb_pos"])
    blk = p["blocks"]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        state[pre + ".modulation"] = _t(np.asarray(blk["modulation"])[i])
        for attn, dense_names, norm_names in (
                ("self_attn", _ATTN_DENSE, _norm_names(cfg)),
                ("cross_attn", _cross_dense(cfg), _cross_norms(cfg))):
            for name in dense_names:
                dense(f"{pre}.{attn}.{name}", blk[attn][name], i)
            for name in norm_names:
                state[f"{pre}.{attn}.{name}"] = _t(np.asarray(blk[attn][name])[i])
        if cfg.cross_attn_norm:
            state[pre + ".norm3_scale"] = _t(np.asarray(blk["norm3_scale"])[i])
            state[pre + ".norm3_bias"] = _t(np.asarray(blk["norm3_bias"])[i])
        dense(pre + ".ffn_0", blk["ffn_0"], i)
        dense(pre + ".ffn_2", blk["ffn_2"], i)
    if with_head:
        state["head.modulation"] = _t(p["head"]["modulation"])
        dense("head.head", p["head"]["head"])
    return state


def quantize_state(state: Dict[str, torch.Tensor], cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """A float WanModel state (bf16 or fp32) -> the state of the int8 model
    ``cfg`` describes (cfg.quant_dense = "int8"), with the numbers of the
    JAX package's ``quantize_params``: each ``QuantLinear`` of the target
    gets its float weight quantized per output channel; every other tensor
    passes through, cast to the target's dtype. Walking the target model's
    keys keeps the list of quantized layers in the model alone."""
    target = WanModel(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in target.items():
        if key.endswith(".weight_q"):
            layer = key[: -len(".weight_q")]
            out[key], out[layer + ".weight_scale"] = quantize_weight(state[layer + ".weight"])
        elif not key.endswith(".weight_scale"):
            out[key] = state[key].to(ref.dtype)
    return out


def quantize_model(model: WanModel) -> WanModel:
    """A float WanModel -> its int8 counterpart (cfg.quant_dense "int8") on
    the same device, the weights quantized by ``quantize_state``. The new
    model takes the int8 tensors and shares every other tensor with
    ``model`` (built on the meta device and assigned), so the device holds
    the float weights and the int8 ones, and no third copy."""
    qcfg = dataclasses.replace(model.cfg, quant_dense="int8")
    state = quantize_state(model.state_dict(), qcfg)
    qmodel = WanModel(qcfg, device="meta")
    qmodel.load_state_dict(state, assign=True)
    return qmodel


def reward_heads_from_jax(q_tree: Dict, m_tree: Dict) -> Dict[str, torch.Tensor]:
    """QueryAttention and RewardMLP flax trees -> ``q_attn.*``/``mlp.*``
    keys of a PavrmModel state dict (the pool keeps the JAX orientation;
    the MLP's kernels transpose to torch's [out, in])."""
    q = q_tree["params"] if "params" in q_tree else q_tree
    m = m_tree["params"] if "params" in m_tree else m_tree
    state = {f"q_attn.{k}": _t(np.asarray(v)) for k, v in q.items() if k != "text_proj"}
    if "text_proj" in q:  # the pool's product_text Dense, in its own orientation
        state.update({f"q_attn.text_proj.{k}": _t(np.asarray(v))
                      for k, v in q["text_proj"].items()})
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
    depends on every block. For i2v/flf2v the image leaves (the projector,
    a non-zero flf2v ``emb_pos``, each block's k_img/v_img and norm_k_img)
    are drawn after all the others, so a t2v tree is the same whatever the
    model type."""
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
        return {**tree, **{name: gains() for name in _norm_names(cfg)}}

    def norm3():
        if not cfg.cross_attn_norm:
            return {}
        return {"norm3_scale": gains(), "norm3_bias": normal((n_layers, dim), 0.02)}

    # the draws run in the order the dict literals are written
    cells = int(np.prod(cfg.patch_size))
    tree = {"params": {
        "patch_embedding": dense(cells * cfg.in_dim, dim),
        "text_0": dense(cfg.text_dim, dim), "text_2": dense(dim, dim),
        "time_0": dense(cfg.freq_dim, dim), "time_2": dense(dim, dim),
        "time_proj": dense(dim, 6 * dim),
        "blocks": {
            "modulation": normal((n_layers, 1, 6, dim), 1.0 / np.sqrt(dim)),
            "self_attn": attn(), "cross_attn": attn(), **norm3(),
            "ffn_0": dense(dim, cfg.ffn_dim, (n_layers,)),
            "ffn_2": dense(cfg.ffn_dim, dim, (n_layers,)),
        },
        "head": {"modulation": normal((1, 2, dim), 1.0 / np.sqrt(dim)),
                 "head": dense(dim, cells * cfg.out_dim)},
    }}
    if not is_i2v(cfg):
        return tree
    p = tree["params"]

    def ln(width):
        return {"scale": (1.0 + 0.1 * rng.uniform(-1.0, 1.0, width)).astype(f32),
                "bias": normal((width,), 0.02)}

    ln0, fc1, fc2, ln1 = ln(CLIP_DIM), dense(CLIP_DIM, CLIP_DIM), dense(CLIP_DIM, dim), ln(dim)
    p["img_emb"] = {"ln0_scale": ln0["scale"], "ln0_bias": ln0["bias"], "fc1": fc1,
                    "fc2": fc2, "ln1_scale": ln1["scale"], "ln1_bias": ln1["bias"]}
    if cfg.model_type == "flf2v":
        p["img_emb"]["emb_pos"] = normal((1, FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER, CLIP_DIM),
                                         0.1)
    cross = p["blocks"]["cross_attn"]
    cross["k_img"] = dense(dim, dim, (n_layers,))
    cross["v_img"] = dense(dim, dim, (n_layers,))
    if cfg.qk_norm:
        cross["norm_k_img"] = gains()
    return tree


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

    if is_i2v(cfg):
        # img_emb.proj: 0 LayerNorm, 1 fc1, 2 GELU, 3 fc2, 4 LayerNorm
        for ln, idx in _IMG_LN:
            out[f"img_emb.{ln}_scale"] = _t(arr(f"img_emb.proj.{idx}.weight"))
            out[f"img_emb.{ln}_bias"] = _t(arr(f"img_emb.proj.{idx}.bias"))
        for dst, idx in (("fc1", 1), ("fc2", 3)):
            out[f"img_emb.{dst}.weight"] = _t(arr(f"img_emb.proj.{idx}.weight"))
            out[f"img_emb.{dst}.bias"] = _t(arr(f"img_emb.proj.{idx}.bias"))
        if cfg.model_type == "flf2v":
            out["img_emb.emb_pos"] = _t(arr("img_emb.emb_pos"))

    perm = rope_perm_full(cfg.dim, cfg.head_dim)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[pre + ".modulation"] = _t(arr(pre + ".modulation"))
        for attn, dense_names, norm_names in (
                ("self_attn", _ATTN_DENSE, _norm_names(cfg)),
                ("cross_attn", _cross_dense(cfg), _cross_norms(cfg))):
            # self-attention q/k (and their norms) move to the half rope layout
            rows = perm if attn == "self_attn" else slice(None)
            for name in dense_names:
                wk, bk = arr(f"{pre}.{attn}.{name}.weight"), arr(f"{pre}.{attn}.{name}.bias")
                if name in ("q", "k"):
                    wk, bk = wk[rows], bk[rows]
                out[f"{pre}.{attn}.{name}.weight"] = _t(wk)
                out[f"{pre}.{attn}.{name}.bias"] = _t(bk)
            for name in norm_names:
                out[f"{pre}.{attn}.{name}"] = _t(arr(f"{pre}.{attn}.{name}.weight")[rows])
        if cfg.cross_attn_norm:
            out[pre + ".norm3_scale"] = _t(arr(pre + ".norm3.weight"))
            out[pre + ".norm3_bias"] = _t(arr(pre + ".norm3.bias"))
        for dst, src in (("ffn_0", "ffn.0"), ("ffn_2", "ffn.2")):
            out[f"{pre}.{dst}.weight"] = _t(arr(f"{pre}.{src}.weight"))
            out[f"{pre}.{dst}.bias"] = _t(arr(f"{pre}.{src}.bias"))
    if "head.modulation" in state:  # a trimmed reward-model tower has none
        out["head.modulation"] = _t(arr("head.modulation"))
        out["head.head.weight"] = _t(arr("head.head.weight"))
        out["head.head.bias"] = _t(arr("head.head.bias"))
    return out


def to_reference_state(state: Dict[str, torch.Tensor], cfg: WanConfig
                       ) -> Dict[str, torch.Tensor]:
    """Port state dict (``WanModel.state_dict()`` keys, fp32 or bf16; a
    head-less tower has no ``head.*``) -> reference Wan state dict of fp32
    CPU tensors, the inverse of ``from_reference_state``: self-attention q/k
    rows and their norm scales go back to the adjacent-pair rope layout,
    the patch-embedding matmul back to the Conv3d kernel [dim, C, pt, ph, pw]."""
    if any(k.endswith(".weight_q") for k in state):
        raise ValueError("an int8 state has no reference layout; export the float model")

    def arr(key):
        return state[key].detach().to("cpu", torch.float32)

    out: Dict[str, torch.Tensor] = {}
    pt, ph, pw = cfg.patch_size
    w = arr("patch_embedding.weight")  # [dim, (pt, ph, pw, C)]
    out["patch_embedding.weight"] = w.reshape(w.shape[0], pt, ph, pw, -1).permute(
        0, 4, 1, 2, 3).contiguous()
    out["patch_embedding.bias"] = arr("patch_embedding.bias")
    for src, dst in (("text_0", "text_embedding.0"), ("text_2", "text_embedding.2"),
                     ("time_0", "time_embedding.0"), ("time_2", "time_embedding.2"),
                     ("time_proj", "time_projection.1")):
        out[dst + ".weight"] = arr(src + ".weight")
        out[dst + ".bias"] = arr(src + ".bias")

    inv = torch.from_numpy(np.argsort(rope_perm_full(cfg.dim, cfg.head_dim)))
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[pre + ".modulation"] = arr(pre + ".modulation")
        for attn, dense_names, norm_names in (
                ("self_attn", _ATTN_DENSE, _norm_names(cfg)),
                ("cross_attn", _cross_dense(cfg), _cross_norms(cfg))):
            for name in dense_names:
                wk, bk = arr(f"{pre}.{attn}.{name}.weight"), arr(f"{pre}.{attn}.{name}.bias")
                if attn == "self_attn" and name in ("q", "k"):
                    wk, bk = wk[inv], bk[inv]
                out[f"{pre}.{attn}.{name}.weight"] = wk
                out[f"{pre}.{attn}.{name}.bias"] = bk
            for name in norm_names:
                g = arr(f"{pre}.{attn}.{name}")
                out[f"{pre}.{attn}.{name}.weight"] = g[inv] if attn == "self_attn" else g
        if cfg.cross_attn_norm:
            out[pre + ".norm3.weight"] = arr(pre + ".norm3_scale")
            out[pre + ".norm3.bias"] = arr(pre + ".norm3_bias")
        for src, dst in (("ffn_0", "ffn.0"), ("ffn_2", "ffn.2")):
            out[f"{pre}.{dst}.weight"] = arr(f"{pre}.{src}.weight")
            out[f"{pre}.{dst}.bias"] = arr(f"{pre}.{src}.bias")
    if "head.modulation" in state:
        out["head.modulation"] = arr("head.modulation")
        out["head.head.weight"] = arr("head.head.weight")
        out["head.head.bias"] = arr("head.head.bias")
    if is_i2v(cfg):
        for ln, idx in _IMG_LN:
            out[f"img_emb.proj.{idx}.weight"] = arr(f"img_emb.{ln}_scale")
            out[f"img_emb.proj.{idx}.bias"] = arr(f"img_emb.{ln}_bias")
        for src, idx in (("fc1", 1), ("fc2", 3)):
            out[f"img_emb.proj.{idx}.weight"] = arr(f"img_emb.{src}.weight")
            out[f"img_emb.proj.{idx}.bias"] = arr(f"img_emb.{src}.bias")
        if cfg.model_type == "flf2v":
            out["img_emb.emb_pos"] = arr("img_emb.emb_pos")
    return out


def save_reference_dir(state: Dict[str, torch.Tensor], cfg: WanConfig, path: str,
                       step: Optional[int] = None) -> str:
    """Port state dict -> a reference checkpoint directory (``<path>/
    checkpoint-<step>`` when ``step`` is given): 5 GB safetensors shards of
    fp32 tensors and a config.json with the JAX ``save_wan_checkpoint``'s
    keys (``num_layers`` is ``cfg``'s: a trimmed tower says how many blocks
    it holds). Returns the directory."""
    if step is not None:
        path = os.path.join(path, f"checkpoint-{step}")
    st.save_dir(to_reference_state(state, cfg), path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"_class_name": "WanModel", "model_type": cfg.model_type, "dim": cfg.dim,
                   "ffn_dim": cfg.ffn_dim, "freq_dim": cfg.freq_dim, "in_dim": cfg.in_dim,
                   "out_dim": cfg.out_dim, "num_heads": cfg.num_heads,
                   "num_layers": cfg.num_layers, "text_len": cfg.text_len, "eps": cfg.eps},
                  f, indent=2)
    return path


def load_reference_dir(path: str, cfg: WanConfig) -> Dict[str, torch.Tensor]:
    """A reference checkpoint directory (its safetensors shards merged) ->
    port state dict of ``cfg.num_layers`` blocks, with the head where the
    directory holds one."""
    return from_reference_state(st.load_dir(path), cfg)


def load_tower_dir(path: str, cfg: WanConfig, n_blocks: int) -> Dict[str, torch.Tensor]:
    """A reference checkpoint directory -> the head-less tower of its first
    ``n_blocks`` blocks (the reward model's trimmed DiT). The directory may
    hold a whole policy-shaped transformer or the trimmed tower the PAVRM
    trainer exports: its config.json says how many blocks it has, as the
    JAX PRFL trainer reads it."""
    n_saved = cfg.num_layers
    if os.path.exists(os.path.join(path, "config.json")):
        with open(os.path.join(path, "config.json")) as f:
            n_saved = int(json.load(f).get("num_layers", n_saved))
    if n_saved < n_blocks:
        raise ValueError(f"checkpoint at {path} has {n_saved} blocks, fewer than the "
                         f"{n_blocks} the feature taps need")
    full = load_reference_dir(path, dataclasses.replace(cfg, num_layers=n_saved))
    return {k: v for k, v in full.items() if not k.startswith("head.")
            and not (k.startswith("blocks.") and int(k.split(".")[1]) >= n_blocks)}


def parse_resume_step(path: str) -> int:
    """checkpoint-<step>[-ema|-opt] -> step (0 when the name has none)."""
    m = re.search(r"checkpoint-(\d+)", os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else 0


# The reward heads in the reference torch layout (utils/network.py MLP and
# QueryAttention; mlp_step_<n>.ckpt and query_attention_step_<n>.ckpt):
# fc1..fc3 Linears, and learned queries with a fused nn.MultiheadAttention
# (in_proj q, k, v stacked; out_proj). The port's pool keeps the JAX
# orientation (``wq`` [in, out], x @ wq), so each weight transposes.


def reward_mlp_to_reference(mlp_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """RewardMLP state (``Dense_i.{weight,bias}``) -> fc1..fc3."""
    return {f"fc{i + 1}.{leaf}": mlp_state[f"Dense_{i}.{leaf}"].detach().cpu().float()
            for i in range(3) for leaf in ("weight", "bias")}


def reward_mlp_from_reference(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"Dense_{i}.{leaf}": state[f"fc{i + 1}.{leaf}"].float()
            for i in range(3) for leaf in ("weight", "bias")}


def query_attention_to_reference(q_state: Dict[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """QueryAttention state (queries, w*/b*) -> queries and multihead_attn.*"""
    q = {k: v.detach().cpu().float() for k, v in q_state.items()}
    out = {"queries": q["queries"],
           "multihead_attn.in_proj_weight": torch.cat([q["wq"].T, q["wk"].T, q["wv"].T]),
           "multihead_attn.in_proj_bias": torch.cat([q["bq"], q["bk"], q["bv"]]),
           "multihead_attn.out_proj.weight": q["wo"].T.contiguous(),
           "multihead_attn.out_proj.bias": q["bo"]}
    if "text_proj.kernel" in q:  # product_text: a torch Linear in the reference
        out["text_proj.weight"] = q["text_proj.kernel"].T.contiguous()
        out["text_proj.bias"] = q["text_proj.bias"]
    return out


def query_attention_from_reference(state: Dict[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """The inverse; a ``text_proj`` (the pool's product_text option, on in
    no shipped config) comes across too."""
    w_in, b_in = state["multihead_attn.in_proj_weight"].float(), \
        state["multihead_attn.in_proj_bias"].float()
    d = w_in.shape[1]
    out = {"queries": state["queries"].float()}
    for i, name in enumerate("qkv"):
        out[f"w{name}"] = w_in[i * d:(i + 1) * d].T.contiguous()
        out[f"b{name}"] = b_in[i * d:(i + 1) * d].contiguous()
    out["wo"] = state["multihead_attn.out_proj.weight"].float().T.contiguous()
    out["bo"] = state["multihead_attn.out_proj.bias"].float()
    if "text_proj.weight" in state:
        out["text_proj.kernel"] = state["text_proj.weight"].float().T.contiguous()
        out["text_proj.bias"] = state["text_proj.bias"].float()
    return out


def load_reward_head(path: str, kind: str) -> Dict[str, torch.Tensor]:
    """A reference reward-head checkpoint (``mlp_step_<n>.ckpt`` or
    ``query_attention_step_<n>.ckpt``, a torch state dict) -> the state of
    the port's RewardMLP (kind "mlp") or QueryAttention ("qattn")."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if kind == "mlp":
        return reward_mlp_from_reference(state)
    if kind == "qattn":
        return query_attention_from_reference(state)
    raise ValueError(f"unknown reward head kind {kind!r}")


# The trainers' own state (torch.save files in the JAX package's directory
# names): the trainable parameters by name, and the optimizer state with
# its step. Loading copies into the live tensors, so they keep their device.

TRAINABLE_FILE, OPT_STATE_FILE = "trainable.pt", "opt_state.pt"


def save_trainable(path: str, names, params) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({n: p.detach().cpu() for n, p in zip(names, params)},
               os.path.join(path, TRAINABLE_FILE))


@torch.no_grad()
def load_trainable(path: str, names, params) -> None:
    saved = torch.load(os.path.join(path, TRAINABLE_FILE), map_location="cpu",
                       weights_only=True)
    if list(saved) != list(names):
        raise ValueError(f"{path} holds other parameters than this model trains")
    for n, p in zip(names, params):
        p.copy_(saved[n])


def save_opt_state(path: str, state) -> None:
    """A TrainState's optimizer state and step -> <path>/opt_state.pt."""
    os.makedirs(path, exist_ok=True)
    opt = {k: [v.detach().cpu() if isinstance(v, torch.Tensor) else v for v in vals]
           for k, vals in state.opt_state.items()}
    torch.save({"names": list(state.names), "step": int(state.step), "opt_state": opt},
               os.path.join(path, OPT_STATE_FILE))


@torch.no_grad()
def load_opt_state(path: str, state) -> None:
    """<path>/opt_state.pt -> the TrainState's optimizer state and step, in
    place; each saved (full) tensor onto this rank's shard of its
    parameter."""
    saved = torch.load(os.path.join(path, OPT_STATE_FILE), map_location="cpu",
                       weights_only=True)
    if saved["names"] != list(state.names) or set(saved["opt_state"]) != set(state.opt_state):
        raise ValueError(f"{path} holds the optimizer state of another model or optimizer")
    for key, vals in saved["opt_state"].items():
        live = state.opt_state[key]
        for i, v in enumerate(vals):
            if isinstance(v, torch.Tensor):
                live[i].copy_(sharding.shard_of(v, state.params[i]))
            else:
                live[i] = v
    state.step = int(saved["step"])
