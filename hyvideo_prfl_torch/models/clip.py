"""CLIP ViT-H/14 image tower for i2v conditioning (hyvideo_prfl_tpu/models/clip.py).

Plain PyTorch in fp32: the JAX package leaves the tower's products and
softmax to XLA. ViT-H/14: image 224, patch 14 (a bias-free patch conv),
dim 1280, 16 heads, 32 blocks, MLP ratio 4 with exact gelu, a pre-norm
over the class and patch tokens, LayerNorm eps 1e-5. i2v takes the
penultimate block's tokens (``use_31_block``: 257 x 1280), so the last
block is not run then.

Modules are named as the reference's ``VisionTransformer`` (the
``visual.`` part of the whole-CLIP file: ``patch_embedding``,
``cls_embedding``, ``pos_embedding``, ``pre_norm``,
``transformer.{i}.{norm1, attn.{to_qkv, proj}, norm2, mlp.{0, 2}}``), so
``utils/encoders.load_reference_clip_visual`` loads it.

``preprocess_frames`` resizes in torch (bicubic, a = -0.75, half-pixel
centres, no antialias: what OpenCV's INTER_CUBIC computes, which the JAX
package calls) and normalizes by the CLIP mean and std;
``preprocess_frames_host`` is the JAX package's own host-side resize
through OpenCV, which the preprocess CLI uses, so a latent cache written by
either package puts the same pixels into CLIP.

``XLMRobertaCLIP`` holds the whole released checkpoint
(``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``): ``visual``
(this tower, with the file's ``post_norm`` and ``head``, which its forward
never reaches, carried through unchanged), ``textual`` (the XLM-R tower
with its projection head, ``models/xlm_roberta.py``) and ``log_scale``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .xlm_roberta import XLMRobertaConfig, XLMRobertaWithHead

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32
    norm_eps: float = 1e-5

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


def vit_h_14(**kw) -> CLIPVisionConfig:
    return CLIPVisionConfig(**kw)


def tiny_clip(**kw) -> CLIPVisionConfig:
    kw.setdefault("image_size", 28)
    kw.setdefault("patch_size", 14)
    kw.setdefault("dim", 64)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_layers", 3)
    return CLIPVisionConfig(**kw)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.to_qkv = nn.Linear(dim, dim * 3, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        b, l, d = x.shape
        n = self.num_heads
        q, k, v = self.to_qkv(x).view(b, l, 3, n, d // n).permute(2, 0, 3, 1, 4)
        logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(np.float32(d // n))
        o = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.proj(o.transpose(1, 2).reshape(b, l, d))


class AttentionBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        d = cfg.dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.attn = SelfAttention(d, cfg.num_heads, device)
        self.norm2 = nn.LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.mlp = nn.Sequential(nn.Linear(d, int(d * cfg.mlp_ratio), device=device), nn.GELU(),
                                 nn.Linear(int(d * cfg.mlp_ratio), d, device=device))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CLIPVisionTower(nn.Module):
    """images [B, S, S, 3] (CLIP-normalized, channels-last as the JAX
    tower takes them) -> tokens [B, 1 + patches, dim] fp32: the
    penultimate block's with ``use_31_block``, else the last's."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.dim, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False, device=device)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d, device=device))
        self.pre_norm = nn.LayerNorm(d, eps=cfg.norm_eps, device=device)
        self.transformer = nn.ModuleList(AttentionBlock(cfg, device)
                                         for _ in range(cfg.num_layers))

    @torch.no_grad()
    def forward(self, images, use_31_block: bool = True):
        b = images.shape[0]
        x = self.patch_embedding(images.permute(0, 3, 1, 2).float())
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_embedding.expand(b, -1, -1), x], dim=1) + self.pos_embedding
        x = self.pre_norm(x)
        blocks = self.transformer[:-1] if use_31_block else self.transformer
        for block in blocks:
            x = block(x)
        return x.float()


class CLIPVisualWithExtras(CLIPVisionTower):
    """The image tower of the whole-CLIP file, with the weights it holds
    beside the tower: ``post_norm`` (a LayerNorm) and ``head`` (the pooling
    projection [dim, out]), each where the file has it. The forward is the
    tower's: the i2v tap never reaches either."""

    def __init__(self, cfg: CLIPVisionConfig, post_norm: bool = False, head_shape=None,
                 device=None):
        super().__init__(cfg, device)
        if post_norm:
            self.post_norm = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps, device=device)
        if head_shape is not None:
            self.head = nn.Parameter(torch.zeros(head_shape, device=device))


class XLMRobertaCLIP(nn.Module):
    """The whole CLIP checkpoint: ``visual``, ``textual`` and ``log_scale``."""

    def __init__(self, vis_cfg: CLIPVisionConfig, txt_cfg: XLMRobertaConfig,
                 post_norm: bool = False, head_shape=None, txt_mid_dim: int = None,
                 txt_out_dim: int = None, device=None):
        super().__init__()
        self.visual = CLIPVisualWithExtras(vis_cfg, post_norm, head_shape, device)
        self.textual = XLMRobertaWithHead(txt_cfg, txt_mid_dim, txt_out_dim, device)
        self.log_scale = nn.Parameter(torch.zeros((), device=device))


@torch.no_grad()
def init_params(model: CLIPVisionTower, generator: torch.Generator) -> CLIPVisionTower:
    """Seeded weights in place (the JAX initialisers' spreads):
    normal(dim^-0.5) class and position embeddings, unit-variance kernels,
    small biases, LayerNorm scales near 1."""
    for name, p in model.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=generator.device).to(p.device)
        if name in ("cls_embedding", "pos_embedding"):
            p.copy_(r * model.cfg.dim ** -0.5)
        elif "norm" in name:
            p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * r)
        elif name.endswith("bias"):
            p.copy_(0.02 * r)
        else:
            p.copy_(r * p[0].numel() ** -0.5)
    return model


def preprocess_frames(frames_m1_1: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> CLIP-normalized [B, S, S, 3] fp32."""
    img = (frames_m1_1.float() + 1.0) / 2.0
    img = F.interpolate(img.permute(0, 3, 1, 2), size=(image_size, image_size),
                        mode="bicubic", align_corners=False, antialias=False)
    mean = torch.from_numpy(CLIP_MEAN).to(img.device).view(1, 3, 1, 1)
    std = torch.from_numpy(CLIP_STD).to(img.device).view(1, 3, 1, 1)
    return ((img - mean) / std).permute(0, 2, 3, 1)


def preprocess_frames_host(frames_m1_1: np.ndarray, image_size: int = 224) -> np.ndarray:
    """[B, H, W, 3] in [-1, 1] (numpy) -> CLIP-normalized [B, S, S, 3] fp32,
    resized on the host by OpenCV's INTER_CUBIC, as the JAX package's
    preprocess does."""
    import cv2

    out = []
    for f in frames_m1_1:
        img = (f.astype(np.float32) + 1.0) / 2.0
        img = cv2.resize(img, (image_size, image_size), interpolation=cv2.INTER_CUBIC)
        out.append((img - CLIP_MEAN) / CLIP_STD)
    return np.stack(out)
