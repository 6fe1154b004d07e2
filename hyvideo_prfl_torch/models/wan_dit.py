"""Wan video DiT backbone, t2v (hyvideo_prfl_tpu/models/wan_dit.py).

Same math and the same precision islands as the JAX package:

* bf16 (``compute_dtype``) matmuls: patch embedding, text embedding and
  every block q/k/v/o and ffn projection, with bf16 weights;
* fp32: the time embedding and projection, the adaLN ``modulation + e``
  add, the residual stream, and the head;
* tanh-approximate GELU in the blocks and the text embedding.

The hot ops go through the ported kernels: ``ln_scale_shift`` (K8, three
per block and one at the head), ``rmsnorm_rope``/``rmsnorm_only`` (K6,
four per block) and ``dot_product_attention`` (K1 for self-attention, K3
for the text cross-attention). q and k live in the JAX "half" rope layout;
utils/checkpoint.py permutes reference weights into it at load time.

The state dict keys follow the JAX parameter tree (``blocks.{i}.self_attn.q``
for ``params/blocks/self_attn/q`` at layer i), with torch's [out, in]
weight layout. Not ported yet: i2v/flf2v conditioning (``y``, CLIP), the
feature taps, TeaCache, int8 and the sharding policies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.qknorm_rope import rmsnorm_only, rmsnorm_rope
from ..ops.stream import ln_scale_shift
from .rope import rope_tables_rolled_np


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Model hyperparameters (the JAX WanConfig's model fields)."""

    model_type: str = "t2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def t2v_14b(**kw):
    return WanConfig(**{**dict(model_type="t2v", dim=5120, ffn_dim=13824,
                               num_heads=40, num_layers=40), **kw})


def t2v_1_3b(**kw):
    return WanConfig(**{**dict(model_type="t2v", dim=1536, ffn_dim=8960,
                               num_heads=12, num_layers=30), **kw})


def tiny_test(**kw):
    """2-layer toy config for tests (the JAX tiny_test defaults)."""
    kw.setdefault("dim", 128)
    kw.setdefault("ffn_dim", 256)
    kw.setdefault("num_heads", 2)
    kw.setdefault("num_layers", 2)
    kw.setdefault("freq_dim", 32)
    kw.setdefault("text_dim", 64)
    return WanConfig(**kw)


def patchify(x: torch.Tensor, patch_size):
    """[B, F, H, W, C] video -> ([B, L, cells, C] token cells, grid)."""
    b, f, hh, ww, c = x.shape
    pt, ph, pw = patch_size
    gf, gh, gw = f // pt, hh // ph, ww // pw
    xp = x.reshape(b, gf, pt, gh, ph, gw, pw, c)
    xp = xp.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, gf * gh * gw, pt * ph * pw, c)
    return xp, (gf, gh, gw)


def unpatchify(tokens: torch.Tensor, grid, patch_size) -> torch.Tensor:
    """[B, L, cells, C] token cells -> [B, F, H, W, C] video (inverse of
    patchify)."""
    b, _, _, c = tokens.shape
    gf, gh, gw = grid
    pt, ph, pw = patch_size
    out = tokens.reshape(b, gf, gh, gw, pt, ph, pw, c)
    return out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
        b, gf * pt, gh * ph, gw * pw, c)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoid table, fp32."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=pos.device) / half)
    ang = torch.outer(pos, freqs)
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def _linear(in_f, out_f, device, dtype):
    # parameters are filled by init_params or a checkpoint load
    return nn.utils.skip_init(nn.Linear, in_f, out_f, device=device or "cpu",
                              dtype=dtype)


def _param(*shape, device):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=torch.float32))


class _Attention(nn.Module):
    """q/k/v/o projections in compute_dtype and fp32 qk-norm gains."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cd = cfg.compute_dtype
        self.q = _linear(cfg.dim, cfg.dim, device, cd)
        self.k = _linear(cfg.dim, cfg.dim, device, cd)
        self.v = _linear(cfg.dim, cfg.dim, device, cd)
        self.o = _linear(cfg.dim, cfg.dim, device, cd)
        self.norm_q = _param(cfg.dim, device=device)
        self.norm_k = _param(cfg.dim, device=device)


class SelfAttention(_Attention):
    """qk-RMSNorm + 3D RoPE + flash attention."""

    def forward(self, x, c_tab, s_tab):
        cfg = self.cfg
        b, l, _ = x.shape
        n, d = cfg.num_heads, cfg.head_dim
        x = x.to(cfg.compute_dtype)
        q = rmsnorm_rope(self.q(x), self.norm_q, c_tab, s_tab, n, cfg.eps)
        k = rmsnorm_rope(self.k(x), self.norm_k, c_tab, s_tab, n, cfg.eps)
        v = self.v(x).view(b, l, n, d)
        out = dot_product_attention(q, k, v, qk_layout="bnld", bounded_logits=True)
        return self.o(out.reshape(b, l, cfg.dim))


class CrossAttention(_Attention):
    """Text cross-attention with qk-RMSNorm."""

    def forward(self, x, context):
        cfg = self.cfg
        b, l, _ = x.shape
        n, d = cfg.num_heads, cfg.head_dim
        x = x.to(cfg.compute_dtype)
        context = context.to(cfg.compute_dtype)
        q = rmsnorm_only(self.q(x), self.norm_q, n, cfg.eps)
        k = rmsnorm_only(self.k(context), self.norm_k, n, cfg.eps)
        v = self.v(context).view(b, -1, n, d)
        out = dot_product_attention(q, k, v, qk_layout="bnld", bounded_logits=True)
        return self.o(out.reshape(b, l, cfg.dim))


class WanBlock(nn.Module):
    """DiT block: adaLN-modulated self-attn, cross-attn, FFN. The residual
    stream is fp32; the matmuls run in compute_dtype."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cd = cfg.compute_dtype
        self.modulation = _param(1, 6, cfg.dim, device=device)
        self.self_attn = SelfAttention(cfg, device)
        self.norm3_scale = _param(cfg.dim, device=device)
        self.norm3_bias = _param(cfg.dim, device=device)
        self.cross_attn = CrossAttention(cfg, device)
        self.ffn_0 = _linear(cfg.dim, cfg.ffn_dim, device, cd)
        self.ffn_2 = _linear(cfg.ffn_dim, cfg.dim, device, cd)

    def forward(self, x, e, context, c_tab, s_tab):
        cd = self.cfg.compute_dtype
        e6 = self.modulation + e.float()  # [B, 6, dim] fp32
        h = ln_scale_shift(x, 1.0 + e6[:, 1], e6[:, 0], out_dtype=cd)
        x = x + self.self_attn(h, c_tab, s_tab).float() * e6[:, 2:3]
        h = ln_scale_shift(x, self.norm3_scale, self.norm3_bias, out_dtype=cd)
        x = x + self.cross_attn(h, context).float()
        h = ln_scale_shift(x, 1.0 + e6[:, 4], e6[:, 3], out_dtype=cd)
        h = self.ffn_2(F.gelu(self.ffn_0(h), approximate="tanh"))
        return x + h.float() * e6[:, 5:6]


class Head(nn.Module):
    """Final modulated projection to patch pixels, fp32."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        out_dim = math.prod(cfg.patch_size) * cfg.out_dim
        self.modulation = _param(1, 2, cfg.dim, device=device)
        self.head = _linear(cfg.dim, out_dim, device, torch.float32)

    def forward(self, x, e):
        e2 = self.modulation + e.float()[:, None, :]
        h = ln_scale_shift(x.float(), 1.0 + e2[:, 1], e2[:, 0], out_dtype=torch.float32)
        return self.head(h)


class WanModel(nn.Module):
    """The video DiT.

    forward(x, t, context, grid=None)
      x: [B, F, H, W, in_dim] latent video, or the token-cell layout
         [B, L, cells, in_dim] from ``patchify`` with ``grid`` given (the
         sampling loop keeps its state in that layout).
      t: [B] or scalar timesteps.  context: [B, text_len, text_dim].
    Returns fp32 [B, F, H, W, out_dim], or [B, L, cells, out_dim] in token
    mode."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cd = cfg.compute_dtype
        cells = math.prod(cfg.patch_size)
        f32 = torch.float32
        self.patch_embedding = _linear(cells * cfg.in_dim, cfg.dim, device, cd)
        self.text_0 = _linear(cfg.text_dim, cfg.dim, device, cd)
        self.text_2 = _linear(cfg.dim, cfg.dim, device, cd)
        self.time_0 = _linear(cfg.freq_dim, cfg.dim, device, f32)
        self.time_2 = _linear(cfg.dim, cfg.dim, device, f32)
        self.time_proj = _linear(cfg.dim, 6 * cfg.dim, device, f32)
        self.blocks = nn.ModuleList(WanBlock(cfg, device) for _ in range(cfg.num_layers))
        self.head = Head(cfg, device)
        self._rope = {}  # (grid, device) -> rolled [L, D] tables

    def rope_tables(self, grid, device):
        key = (tuple(grid), str(device))
        if key not in self._rope:
            c, s = rope_tables_rolled_np(tuple(grid), self.cfg.head_dim)
            self._rope[key] = (torch.from_numpy(c).to(device),
                               torch.from_numpy(s).to(device))
        return self._rope[key]

    def forward(self, x, t, context, grid: Optional[Tuple[int, int, int]] = None):
        cfg = self.cfg
        cd = cfg.compute_dtype
        pt, ph, pw = cfg.patch_size
        token_mode = x.dim() == 4
        if token_mode:
            b, seq_len, cells, c_in = x.shape
            if grid is None or cells != pt * ph * pw or seq_len != math.prod(grid):
                raise ValueError(f"token-layout input {tuple(x.shape)} needs a "
                                 f"matching grid, got {grid}")
        else:
            x, grid = patchify(x, cfg.patch_size)
            b, seq_len, cells, c_in = x.shape
        h = self.patch_embedding(x.reshape(b, seq_len, cells * c_in).to(cd)).float()

        t = torch.as_tensor(t, dtype=torch.float32, device=h.device).reshape(-1)
        t = t.expand(b) if t.numel() == 1 else t
        e = self.time_0(sinusoidal_embedding_1d(cfg.freq_dim, t))
        e = self.time_2(F.silu(e))
        e0 = self.time_proj(F.silu(e)).view(b, 6, cfg.dim)

        ctx = self.text_2(F.gelu(self.text_0(context.to(cd)), approximate="tanh"))

        c_tab, s_tab = self.rope_tables(grid, h.device)
        for block in self.blocks:
            h = block(h, e0, ctx, c_tab, s_tab)

        out = self.head(h, e).reshape(b, seq_len, cells, cfg.out_dim)
        if not token_mode:
            out = unpatchify(out, grid, cfg.patch_size)
        return out.float()


_NORMAL02 = ("text_0", "text_2", "time_0", "time_2")


@torch.no_grad()
def init_params(model: WanModel, generator: torch.Generator) -> WanModel:
    """Fill a model with the JAX package's initialisers (same distributions,
    not the same numbers): xavier-uniform dense kernels, normal(0.02) for
    the text/time embeddings, zero biases, a zero head kernel,
    normal(1/sqrt(dim)) modulation, unit norm scales."""
    dim = model.cfg.dim
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if name == "head.head":
                mod.weight.zero_()
            elif name in _NORMAL02:
                mod.weight.normal_(0.0, 0.02, generator=generator)
            else:
                fan_out, fan_in = mod.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-bound, bound, generator=generator)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "modulation":
            p.normal_(0.0, 1.0 / math.sqrt(dim), generator=generator)
        elif leaf in ("norm_q", "norm_k", "norm3_scale"):
            p.fill_(1.0)
        elif leaf == "norm3_bias":
            p.zero_()
    return model
