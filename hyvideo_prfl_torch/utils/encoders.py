"""The frozen towers' weights: the VAE, the CLIP image tower and umT5-XXL
(hyvideo_prfl_tpu/utils/convert_encoders.py).

``*_from_jax`` map the JAX package's flax trees (numpy leaves; the T5 and
CLIP blocks stacked [L, ...]) onto the reference state-dict layout, the
layout the port's modules carry, as numpy arrays:
``vae_from_jax`` (torch Conv3d [out, in, kt, kh, kw], the resample convs as
Conv2d, the RMS gains [C, 1, 1(, 1)], the attention's 1x1 Conv2d),
``clip_from_jax`` (under ``visual.``), ``t5_from_jax``, ``xlmr_from_jax``
(the XLM-R tower and its head under ``textual.``) and
``clip_full_from_jax`` (the whole CLIP: both towers, ``log_scale`` and the
image tower's unused ``post_norm``/``head``).

``load_reference_*`` read a reference ``.pth`` (``torch.load`` with
``weights_only``) into a module on a device: the VAE's config from the
file's shapes (``models/vae.infer_config``), T5's likewise (the heads from
the position embedding), the CLIP tower from the ``visual.*`` keys of the
whole-CLIP file (or a file of the tower alone) with ViT-H/14's 16 heads
(the heads leave no trace in the shapes; ViT-H/14 is the released tower),
and ``load_reference_clip`` the whole CLIP file, XLM-R with XLM-R large's
16 heads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import clip as clip_mod
from ..models import t5 as t5_mod
from ..models import vae as vae_mod
from ..models import xlm_roberta as xlmr_mod


def _lin(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w)))


def _conv3d(node):
    """flax {kernel [kt, kh, kw, in, out], bias} -> Conv3d weight and bias."""
    return (np.ascontiguousarray(np.transpose(np.asarray(node["kernel"]), (4, 3, 0, 1, 2))),
            np.asarray(node["bias"]))


def vae_from_jax(tree: Dict, cfg: vae_mod.VAEConfig) -> Dict[str, np.ndarray]:
    """The JAX WanVAE tree -> the reference WanVAE_ state dict."""
    out: Dict[str, np.ndarray] = {}

    def conv(key, node):
        out[key + ".weight"], out[key + ".bias"] = _conv3d(node)

    def res(pfx, node):
        out[pfx + ".residual.0.gamma"] = np.asarray(node["norm1_gamma"]).reshape(-1, 1, 1, 1)
        conv(pfx + ".residual.2", node["conv1"])
        out[pfx + ".residual.3.gamma"] = np.asarray(node["norm2_gamma"]).reshape(-1, 1, 1, 1)
        conv(pfx + ".residual.6", node["conv2"])
        if "shortcut" in node:
            conv(pfx + ".shortcut", node["shortcut"])

    def tower(name, p, n_res, temporal, kind):
        conv(name + ".conv1", p["conv1"])
        seq = bi = 0
        for i in range(len(cfg.dim_mult)):
            for _ in range(n_res):
                res(f"{name}.{kind}s.{seq}", p[f"block_{bi}"])
                seq, bi = seq + 1, bi + 1
            if i != len(cfg.dim_mult) - 1:
                node, rs = p[f"{kind[:-6]}_{i}"], f"{name}.{kind}s.{seq}"
                w = np.asarray(node["conv_spatial"]["kernel"])[0]  # [kh, kw, in, out]
                out[rs + ".resample.1.weight"] = np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
                out[rs + ".resample.1.bias"] = np.asarray(node["conv_spatial"]["bias"])
                if temporal[i]:
                    conv(rs + ".time_conv", node["time_conv"])
                seq += 1
        res(name + ".middle.0", p["mid_block_0"])
        a = p["mid_attn"]
        out[name + ".middle.1.norm.gamma"] = np.asarray(a["norm_gamma"]).reshape(-1, 1, 1)
        for src in ("to_qkv", "proj"):
            out[f"{name}.middle.1.{src}.weight"] = _lin(a[src]["kernel"])[:, :, None, None]
            out[f"{name}.middle.1.{src}.bias"] = np.asarray(a[src]["bias"])
        res(name + ".middle.2", p["mid_block_1"])
        out[name + ".head.0.gamma"] = np.asarray(p["head_norm_gamma"]).reshape(-1, 1, 1, 1)
        conv(name + ".head.2", p["head_conv"])

    p = tree["params"]
    tower("encoder", p["encoder"], cfg.num_res_blocks, cfg.temporal_downsample, "downsample")
    tower("decoder", p["decoder"], cfg.num_res_blocks + 1, cfg.temporal_upsample, "upsample")
    conv("conv1", p["conv1"])
    conv("conv2", p["conv2"])
    return out


def clip_from_jax(tree: Dict, cfg: clip_mod.CLIPVisionConfig,
                  prefix: str = "visual.") -> Dict[str, np.ndarray]:
    """The JAX CLIPVisionTower tree -> the reference VisionTransformer keys."""
    p = tree["params"]
    out = {
        prefix + "patch_embedding.weight": np.transpose(
            np.asarray(p["patch_embedding"]["kernel"]), (3, 2, 0, 1)),
        prefix + "cls_embedding": np.asarray(p["cls_embedding"]),
        prefix + "pos_embedding": np.asarray(p["pos_embedding"]),
        prefix + "pre_norm.weight": np.asarray(p["pre_norm_scale"]),
        prefix + "pre_norm.bias": np.asarray(p["pre_norm_bias"]),
    }
    b = p["blocks"]
    for i in range(cfg.num_layers):
        t = f"{prefix}transformer.{i}."
        for n in ("1", "2"):
            out[t + f"norm{n}.weight"] = np.asarray(b[f"norm{n}_scale"])[i]
            out[t + f"norm{n}.bias"] = np.asarray(b[f"norm{n}_bias"])[i]
        for src, dst in (("to_qkv", "attn.to_qkv"), ("proj", "attn.proj"),
                         ("mlp_fc1", "mlp.0"), ("mlp_fc2", "mlp.2")):
            out[t + dst + ".weight"] = _lin(np.asarray(b[src]["kernel"])[i])
            out[t + dst + ".bias"] = np.asarray(b[src]["bias"])[i]
    return out


def t5_from_jax(tree: Dict, cfg: t5_mod.T5Config) -> Dict[str, np.ndarray]:
    """The JAX T5Encoder tree -> the reference T5Encoder keys."""
    p = tree["params"]
    b = p["blocks"]
    out = {"token_embedding.weight": np.asarray(p["token_embedding"]),
           "norm.weight": np.asarray(p["norm"])}
    for i in range(cfg.num_layers):
        t = f"blocks.{i}."
        out[t + "norm1.weight"] = np.asarray(b["norm1"])[i]
        out[t + "norm2.weight"] = np.asarray(b["norm2"])[i]
        for m in ("q", "k", "v", "o"):
            out[t + f"attn.{m}.weight"] = _lin(np.asarray(b["attn"][m]["kernel"])[i])
        out[t + "ffn.gate.0.weight"] = _lin(np.asarray(b["gate"]["kernel"])[i])
        out[t + "ffn.fc1.weight"] = _lin(np.asarray(b["fc1"]["kernel"])[i])
        out[t + "ffn.fc2.weight"] = _lin(np.asarray(b["fc2"]["kernel"])[i])
        out[t + "pos_embedding.embedding.weight"] = np.asarray(b["rel_embedding"])[i]
    return out


def xlmr_from_jax(tree: Dict, cfg: xlmr_mod.XLMRobertaConfig,
                  prefix: str = "textual.") -> Dict[str, np.ndarray]:
    """The JAX XLMRoberta tree and its head ({"params", "head": {h0, h2}})
    -> the reference XLMRobertaWithHead keys."""
    p = tree["params"]
    out = {prefix + "token_embedding.weight": np.asarray(p["token_embedding"]),
           prefix + "type_embedding.weight": np.asarray(p["type_embedding"]),
           prefix + "pos_embedding.weight": np.asarray(p["pos_embedding"]),
           prefix + "norm.weight": np.asarray(p["norm_scale"]),
           prefix + "norm.bias": np.asarray(p["norm_bias"]),
           prefix + "head.0.weight": _lin(tree["head"]["h0"]),
           prefix + "head.2.weight": _lin(tree["head"]["h2"])}
    b = p["blocks"]
    for i in range(cfg.num_layers):
        t = f"{prefix}blocks.{i}."
        for n in ("1", "2"):
            out[t + f"norm{n}.weight"] = np.asarray(b[f"norm{n}_scale"])[i]
            out[t + f"norm{n}.bias"] = np.asarray(b[f"norm{n}_bias"])[i]
        for src, dst in (("q", "attn.q"), ("k", "attn.k"), ("v", "attn.v"), ("o", "attn.o"),
                         ("ffn_0", "ffn.0"), ("ffn_2", "ffn.2")):
            out[t + dst + ".weight"] = _lin(np.asarray(b[src]["kernel"])[i])
            out[t + dst + ".bias"] = np.asarray(b[src]["bias"])[i]
    return out


def clip_full_from_jax(tree: Dict, vis_cfg: clip_mod.CLIPVisionConfig,
                       txt_cfg: xlmr_mod.XLMRobertaConfig) -> Dict[str, np.ndarray]:
    """The JAX whole-CLIP tree ({"visual", "textual", "log_scale",
    "visual_extras"}) -> the whole reference file's keys."""
    out = clip_from_jax(tree["visual"], vis_cfg)
    out.update(xlmr_from_jax(tree["textual"], txt_cfg))
    out["log_scale"] = np.asarray(tree["log_scale"])
    extras = tree.get("visual_extras", {})
    if "post_norm_scale" in extras:
        out["visual.post_norm.weight"] = np.asarray(extras["post_norm_scale"])
        out["visual.post_norm.bias"] = np.asarray(extras["post_norm_bias"])
    if "head" in extras:
        out["visual.head"] = np.asarray(extras["head"])
    return out


def _load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _part(state: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _into(cls, cfg, state: Dict, device, **kw) -> torch.nn.Module:
    """``cls(cfg)`` filled from ``state`` on ``device``; built on the meta
    device and left uninitialised first, since the file sets every weight
    (initialising umT5's 5.7 B parameters alone takes tens of seconds)."""
    module = cls(cfg, device="meta", **kw).to_empty(device="cpu")
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return module.to(device).eval()


def load_reference_vae(path: str, device="cpu") -> vae_mod.WanVAE:
    """A reference VAE file (``Wan2.1_VAE.pth``'s layout), fp32."""
    state = _load(path)
    return _into(vae_mod.WanVAE, vae_mod.infer_config(state), state, device)


def t5_config_of(state: Dict) -> t5_mod.T5Config:
    vocab, dim = state["token_embedding.weight"].shape
    buckets, heads = state["blocks.0.pos_embedding.embedding.weight"].shape
    return t5_mod.T5Config(
        vocab_size=int(vocab), dim=int(dim),
        dim_attn=int(state["blocks.0.attn.q.weight"].shape[0]),
        dim_ffn=int(state["blocks.0.ffn.fc1.weight"].shape[0]), num_heads=int(heads),
        num_layers=len({k.split(".")[1] for k in state if k.startswith("blocks.")}),
        num_buckets=int(buckets))


def load_reference_t5(path: str, device="cpu") -> t5_mod.T5Encoder:
    """A reference umT5 encoder file (``models_t5_umt5-xxl-enc-bf16.pth``'s
    layout); the config from its shapes."""
    state = _load(path)
    return _into(t5_mod.T5Encoder, t5_config_of(state), state, device)


def clip_config_of(state: Dict) -> clip_mod.CLIPVisionConfig:
    dim, _, patch, _ = state["patch_embedding.weight"].shape
    tokens = state["pos_embedding"].shape[1]
    return clip_mod.CLIPVisionConfig(
        image_size=int(round((tokens - 1) ** 0.5)) * int(patch), patch_size=int(patch),
        dim=int(dim), num_heads=clip_mod.vit_h_14().num_heads,
        mlp_ratio=state["transformer.0.mlp.0.weight"].shape[0] / dim,
        num_layers=len({k.split(".")[1] for k in state if k.startswith("transformer.")}))


def load_reference_clip_visual(path: str, device="cpu") -> clip_mod.CLIPVisionTower:
    """The image tower of a whole-CLIP reference file
    (``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``: its
    ``visual.*`` keys, less the post-norm and the pooling head the i2v tap
    never reaches), or of a file holding the tower's keys alone."""
    state = _load(path)
    if any(k.startswith("visual.") for k in state):
        state = _part(state, "visual.")
    state = {k: v for k, v in state.items() if not k.startswith(("post_norm.", "head"))}
    return _into(clip_mod.CLIPVisionTower, clip_config_of(state), state, device)


def xlmr_config_of(state: Dict) -> xlmr_mod.XLMRobertaConfig:
    """XLM-R's config from a ``textual.``-less state's shapes (the heads:
    XLM-R large's 16)."""
    vocab, dim = state["token_embedding.weight"].shape
    return xlmr_mod.XLMRobertaConfig(
        vocab_size=int(vocab), dim=int(dim),
        max_seq_len=int(state["pos_embedding.weight"].shape[0]),
        type_size=int(state["type_embedding.weight"].shape[0]),
        num_heads=xlmr_mod.xlm_roberta_large().num_heads,
        num_layers=len({k.split(".")[1] for k in state if k.startswith("blocks.")}))


def load_reference_clip(path: str, device="cpu") -> clip_mod.XLMRobertaCLIP:
    """The whole-CLIP reference file (``visual.*``, ``textual.*``,
    ``log_scale``; the image tower's ``post_norm`` and ``head`` where the
    file has them), fp32, each config from the file's shapes."""
    state = _load(path)
    vis, txt = _part(state, "visual."), _part(state, "textual.")
    tower = {k: v for k, v in vis.items() if not k.startswith(("post_norm.", "head"))}
    return _into(clip_mod.XLMRobertaCLIP, clip_config_of(tower), state, device,
                 txt_cfg=xlmr_config_of(txt), post_norm="post_norm.weight" in vis,
                 head_shape=tuple(vis["head"].shape) if "head" in vis else None,
                 txt_mid_dim=int(txt["head.0.weight"].shape[0]),
                 txt_out_dim=int(txt["head.2.weight"].shape[0]))


def save_reference(state: Dict[str, np.ndarray], path: str, dtype=None) -> str:
    """A reference-layout state (numpy) as a ``.pth`` file of tensors, cast
    to ``dtype`` where given (the released T5 file is bf16)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}
    if dtype is not None:
        tensors = {k: v.to(dtype) for k, v in tensors.items()}
    torch.save(tensors, path)
    return path
