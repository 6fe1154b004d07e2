"""XLM-RoBERTa, the text tower of the whole CLIP checkpoint
(hyvideo_prfl_tpu/models/xlm_roberta.py).

Plain PyTorch in fp32: the JAX package leaves the tower's products and
softmax to XLA. XLM-R large: vocabulary 250,002, dim 1024, 16 heads, 24
post-norm blocks (attention, then an exact-gelu MLP of ratio 4, each
followed by LayerNorm eps 1e-5), token + type + position embeddings with
RoBERTa's position ids ``pad_id + cumsum(mask) * mask`` and a LayerNorm
over their sum; padded keys are masked out of the softmax.

Modules are named as the reference's ``XLMRoberta`` under the whole-CLIP
file's ``textual.`` prefix (``token_embedding``, ``type_embedding``,
``pos_embedding``, ``norm``, ``blocks.{i}.{attn.{q, k, v, o}, norm1,
ffn.{0, 2}, norm2}``), and ``XLMRobertaWithHead`` adds the biasless
Linear/GELU/Linear projection ``head.{0, 2}`` over the masked mean of the
tokens. Only the image tower conditions generation; this one completes the
checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    eps: float = 1e-5


def xlm_roberta_large(**kw) -> XLMRobertaConfig:
    return XLMRobertaConfig(**kw)


def tiny_xlmr(**kw) -> XLMRobertaConfig:
    kw.setdefault("vocab_size", 100)
    kw.setdefault("dim", 32)
    kw.setdefault("num_heads", 2)
    kw.setdefault("num_layers", 2)
    kw.setdefault("max_seq_len", 16)
    return XLMRobertaConfig(**kw)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.o = nn.Linear(dim, dim, device=device)

    def forward(self, x, key_valid):
        b, l, d = x.shape
        n = self.num_heads

        def heads(proj):
            return proj(x).view(b, l, n, d // n).transpose(1, 2)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(np.float32(d // n))
        logits = torch.where(key_valid[:, None, None, :], logits, logits.new_tensor(-1e30))
        o = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.o(o.transpose(1, 2).reshape(b, l, d))


class AttentionBlock(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig, device=None):
        super().__init__()
        d = cfg.dim
        self.attn = SelfAttention(d, cfg.num_heads, device)
        self.norm1 = nn.LayerNorm(d, eps=cfg.eps, device=device)
        self.ffn = nn.Sequential(nn.Linear(d, 4 * d, device=device), nn.GELU(),
                                 nn.Linear(4 * d, d, device=device))
        self.norm2 = nn.LayerNorm(d, eps=cfg.eps, device=device)

    def forward(self, x, key_valid):
        x = self.norm1(x + self.attn(x, key_valid))
        return self.norm2(x + self.ffn(x))


class XLMRoberta(nn.Module):
    """ids [B, L] (int) -> tokens [B, L, dim] fp32."""

    def __init__(self, cfg: XLMRobertaConfig = XLMRobertaConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.type_embedding = nn.Embedding(cfg.type_size, cfg.dim, device=device)
        self.pos_embedding = nn.Embedding(cfg.max_seq_len, cfg.dim, device=device)
        self.norm = nn.LayerNorm(cfg.dim, eps=cfg.eps, device=device)
        self.blocks = nn.ModuleList(AttentionBlock(cfg, device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def forward(self, ids):
        key_valid = ids != self.cfg.pad_id
        mask = key_valid.long()
        pos = self.cfg.pad_id + torch.cumsum(mask, dim=1) * mask
        x = (self.token_embedding(ids) + self.type_embedding(torch.zeros_like(ids))
             + self.pos_embedding(pos))
        x = self.norm(x)
        for block in self.blocks:
            x = block(x, key_valid)
        return x


def mean_pool(x, ids, pad_id: int = 1):
    """The mean over each row's non-pad tokens: [B, L, D] -> [B, D]."""
    mask = (ids != pad_id).to(x.dtype)[..., None]
    return (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


class XLMRobertaWithHead(XLMRoberta):
    """The tower, the masked mean over its tokens and the biasless
    Linear/GELU/Linear head: ids [B, L] -> [B, out_dim] fp32
    (``encode_with_head``). The head's widths come from the file."""

    def __init__(self, cfg: XLMRobertaConfig = XLMRobertaConfig(), mid_dim: int = None,
                 out_dim: int = None, device=None):
        super().__init__(cfg, device)
        mid_dim = mid_dim or (cfg.dim + (out_dim or cfg.dim)) // 2
        self.head = nn.Sequential(nn.Linear(cfg.dim, mid_dim, bias=False, device=device),
                                  nn.GELU(),
                                  nn.Linear(mid_dim, out_dim or cfg.dim, bias=False,
                                            device=device))

    @torch.no_grad()
    def encode_with_head(self, ids):
        return self.head(mean_pool(super().forward(ids), ids, self.cfg.pad_id))


@torch.no_grad()
def init_params(model: XLMRoberta, generator: torch.Generator) -> XLMRoberta:
    """Seeded weights in place: normal(0.02) embeddings, unit-variance
    kernels over sqrt(fan-in), small biases, LayerNorm scales near 1."""
    for name, p in model.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=generator.device).to(p.device)
        if "embedding" in name:
            p.copy_(0.02 * r)
        elif "norm" in name:
            p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * r)
        elif name.endswith("bias"):
            p.copy_(0.02 * r)
        else:
            p.copy_(r * p[0].numel() ** -0.5)
    return model
