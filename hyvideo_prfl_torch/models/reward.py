"""PAVRM latent reward heads and objectives (hyvideo_prfl_tpu/models/reward.py).

Plain PyTorch in fp32, as the JAX package leaves them to XLA: the heads
score DiT feature taps (noisy-latent features), with no VAE decode.

Parameters keep the JAX tree's names and orientation (``wq`` is [in, out],
used as ``x @ wq``), so utils/checkpoint.py copies JAX weights across as
they are; the MLP's dense layers are torch ``Linear``s named after the
flax ``Dense_i`` modules.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _xavier(shape, generator):
    fan_in, fan_out = shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0) * bound


class QueryAttention(nn.Module):
    """Learnable-query attention pooling over [B, L, D] features
    (multi-head, fp32). ``return_type="query"`` adds the mean query to the
    pooled output; dropout is omitted (every shipped config sets 0)."""

    def __init__(self, feature_dim: int, num_queries: int = 1, num_heads: int = 8,
                 return_type: Optional[str] = None, device=None):
        super().__init__()
        d = feature_dim
        self.num_queries, self.num_heads, self.return_type = num_queries, num_heads, return_type

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device))

        self.queries = p(num_queries, d)
        self.wq, self.wk, self.wv, self.wo = p(d, d), p(d, d), p(d, d), p(d, d)
        self.bq, self.bk, self.bv, self.bo = p(d), p(d), p(d), p(d)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """The JAX initialisers: xavier-uniform queries and kernels, zero biases."""
        for name in ("queries", "wq", "wk", "wv", "wo"):
            w = getattr(self, name)
            w.copy_(_xavier(tuple(w.shape), generator))
        for name in ("bq", "bk", "bv", "bo"):
            getattr(self, name).zero_()
        return self

    def forward(self, x):
        x = x.float()
        b, l, d = x.shape
        nh, nq = self.num_heads, self.num_queries
        hd = d // nh
        q = (self.queries[None].expand(b, nq, d) @ self.wq + self.bq).reshape(b, nq, nh, hd)
        k = (x @ self.wk + self.bk).reshape(b, l, nh, hd)
        v = (x @ self.wv + self.bv).reshape(b, l, nh, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits, dim=-1)
        attended = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, nq, d)
        attended = attended @ self.wo + self.bo
        out = attended.mean(dim=1) if nq > 1 else attended[:, 0]
        if self.return_type == "query":
            out = out + self.queries.mean(dim=0)[None]
        return out


class RewardMLP(nn.Module):
    """3-layer reward scalar head d -> 1024 -> 512 -> 1, no sigmoid."""

    def __init__(self, feature_dim: int, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(feature_dim, 1024, device=device)
        self.Dense_1 = nn.Linear(1024, 512, device=device)
        self.Dense_2 = nn.Linear(512, 1, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            layer.weight.copy_(_xavier(tuple(layer.weight.shape[::-1]), generator).T)
            layer.bias.zero_()
        return self

    def forward(self, x):
        x = F.relu(self.Dense_0(x.float()))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


def reward_sigmoid(logits):
    """forward_mlp: sigmoid(r)."""
    return torch.sigmoid(logits)


def siamese_prob(r_win, r_lose):
    """Bradley-Terry preference probability sigmoid(r_win - r_lose)."""
    return torch.sigmoid(r_win - r_lose)


def bce_loss(probs, labels, eps: float = 1e-7):
    """Binary cross entropy on probabilities (torch BCELoss semantics)."""
    p = probs.clamp(eps, 1.0 - eps)
    return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))


def prfl_hinge_loss(reward_scores, target_reward: float = 2.0, scale: float = 0.1):
    """PRFL objective scale * relu(target - sigmoid(r)).mean()."""
    return scale * torch.mean(F.relu(target_reward - reward_scores))


def pool_features(features, method: str, q_attn: Optional[QueryAttention] = None):
    """Pool stacked feature taps [n_sel, B, L, D] -> [B, D]: each tap pooled
    on its own ('q_attn' | 'mean' | 'max'), then the taps averaged."""
    if method == "q_attn":
        if q_attn is None:
            raise ValueError("q_attn pooling needs a QueryAttention")
        pooled = torch.stack([q_attn(f) for f in features])
    elif method == "mean":
        pooled = features.mean(dim=2)
    elif method == "max":
        pooled = features.amax(dim=2)
    else:
        raise ValueError(f"unknown pool {method}")
    return pooled.mean(dim=0)
