"""umT5-XXL text encoder (hyvideo_prfl_tpu/models/t5.py).

Plain PyTorch: the JAX package leaves the encoder's products and softmax to
XLA. Encoder-only umT5-XXL: vocab 256,384, dim 4096, ffn 10,240, 64 heads,
24 layers, a relative position bias per layer (``shared_pos=False``) over
bidirectional log buckets, RMS norm without the mean (eps 1e-6), a
gated-gelu FFN (``fc1(x) * gelu_tanh(gate(x))``), no biases and no
1/sqrt(d) on the logits. It computes in bf16 (the residual stream too)
with fp32 norms, logits and softmax, and returns fp32.

Modules are named as the reference ``T5Encoder`` state dict
(``token_embedding``, ``blocks.{i}.{norm1, attn.{q,k,v,o}, norm2,
ffn.{gate.0, fc1, fc2}, pos_embedding.embedding}``, ``norm``), so a
reference file loads with ``load_state_dict``
(``utils/encoders.load_reference_t5``). The dense weights and the token
embedding are stored in the compute dtype (what the JAX package casts its
fp32 parameters to at each use); the norms and the position embeddings
stay fp32, as the JAX package reads them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    compute_dtype: torch.dtype = torch.bfloat16


def umt5_xxl(**kw) -> T5Config:
    return T5Config(**kw)


def tiny_t5(**kw) -> T5Config:
    kw.setdefault("vocab_size", 1000)
    kw.setdefault("dim", 64)
    kw.setdefault("dim_attn", 64)
    kw.setdefault("dim_ffn", 128)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_layers", 2)
    return T5Config(**kw)


@functools.lru_cache(maxsize=16)
def relative_buckets(lq: int, lk: int, num_buckets: int, max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 relative position buckets [lq, lk] int64."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (np.log(np.maximum(rel_pos, 1) / max_exact)
                             / math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel_pos < max_exact, rel_pos, large)


class T5LayerNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * w, fp32 statistics, out in x's dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (y * self.weight.float()).to(x.dtype)


def _linear(cin, cout, device, dtype):
    return nn.Linear(cin, cout, bias=False, device=device, dtype=dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        cd = cfg.compute_dtype
        self.num_heads = cfg.num_heads
        self.q = _linear(cfg.dim, cfg.dim_attn, device, cd)
        self.k = _linear(cfg.dim, cfg.dim_attn, device, cd)
        self.v = _linear(cfg.dim, cfg.dim_attn, device, cd)
        self.o = _linear(cfg.dim_attn, cfg.dim, device, cd)

    def forward(self, x, mask, pos_bias):
        b, l, _ = x.shape
        n = self.num_heads

        def heads(proj):
            return proj(x).view(b, l, n, -1).transpose(1, 2)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        # no 1/sqrt(d): the T5 convention
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + pos_bias
        if mask is not None:
            logits = torch.where(mask[:, None, None, :] > 0, logits,
                                 torch.tensor(-1e30, device=logits.device))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return self.o(o.transpose(1, 2).reshape(b, l, -1))


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        cd = cfg.compute_dtype
        self.gate = nn.Sequential(_linear(cfg.dim, cfg.dim_ffn, device, cd),
                                  nn.GELU(approximate="tanh"))
        self.fc1 = _linear(cfg.dim, cfg.dim_ffn, device, cd)
        self.fc2 = _linear(cfg.dim_ffn, cfg.dim, device, cd)

    def forward(self, x):
        return self.fc2(self.fc1(x) * self.gate(x))


class T5RelativeEmbedding(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.num_buckets = cfg.num_buckets
        self.embedding = nn.Embedding(cfg.num_buckets, cfg.num_heads, device=device)

    def forward(self, l: int):
        """[1, heads, l, l] fp32."""
        idx = torch.from_numpy(relative_buckets(l, l, self.num_buckets)).to(
            self.embedding.weight.device)
        return self.embedding.weight.float()[idx].permute(2, 0, 1)[None]


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.norm1 = T5LayerNorm(cfg.dim, device)
        self.attn = T5Attention(cfg, device)
        self.norm2 = T5LayerNorm(cfg.dim, device)
        self.ffn = T5FeedForward(cfg, device)
        self.pos_embedding = T5RelativeEmbedding(cfg, device)

    def forward(self, x, mask):
        x = x + self.attn(self.norm1(x), mask, self.pos_embedding(x.shape[1])).to(x.dtype)
        return x + self.ffn(self.norm2(x)).to(x.dtype)


class T5Encoder(nn.Module):
    """ids [B, L] int, mask [B, L] (1 = token) -> [B, L, dim] fp32, the full
    padded context (the reference's ``__call__``; callers trim by the mask
    length)."""

    def __init__(self, cfg: T5Config = T5Config(), device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim, device=device,
                                             dtype=cfg.compute_dtype)
        self.blocks = nn.ModuleList(T5Block(cfg, device) for _ in range(cfg.num_layers))
        self.norm = T5LayerNorm(cfg.dim, device)

    @torch.no_grad()
    def forward(self, ids, mask=None):
        x = self.token_embedding(ids).to(self.cfg.compute_dtype)
        for block in self.blocks:
            x = block(x, mask)
        return self.norm(x).float()


@torch.no_grad()
def init_params(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Seeded weights in place (the JAX initialisers' spreads): normal(1)
    token embeddings, normal((2 * buckets * heads)^-0.5) position
    embeddings, unit-variance dense kernels, norm scales near 1."""
    cfg = model.cfg
    for name, p in model.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=generator.device).to(p.device)
        if name == "token_embedding.weight":
            p.copy_(r)
        elif name.endswith("pos_embedding.embedding.weight"):
            p.copy_(r * (2 * cfg.num_buckets * cfg.num_heads) ** -0.5)
        elif "norm" in name:
            p.copy_(1.0 + 0.1 * r)
        else:
            p.copy_(r * p.shape[1] ** -0.5)
    return model
