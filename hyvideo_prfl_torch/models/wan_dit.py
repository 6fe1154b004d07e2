"""Wan video DiT backbone, t2v, i2v and flf2v (hyvideo_prfl_tpu/models/wan_dit.py).

Same math and the same precision islands as the JAX package:

* bf16 (``compute_dtype``) matmuls: patch embedding, text embedding and
  every block q/k/v/o and ffn projection. Their weights are stored in
  ``param_dtype`` (a constructor argument) and cast to the compute dtype
  at use, as the JAX package casts its fp32 masters: the trainer builds the
  model with fp32 masters, serving with bf16 storage;
* fp32: the time embedding and projection, the adaLN ``modulation + e``
  add, the residual stream, and the head;
* tanh-approximate GELU in the blocks and the text embedding.

The hot ops go through the ported kernels, each differentiable:
``ln_scale_shift`` (K8 forward, K9 backward; three per block and one at
the head), ``rmsnorm_rope``/``rmsnorm_only`` (K6/K7, four per block) and
``dot_product_attention`` (K1 for self-attention, K3 for the text
cross-attention, or K2/K3s under HYV_FLASH_BOUNDED=0; K4/K5 backward). q
and k live in the JAX "half" rope layout; utils/checkpoint.py permutes
reference weights into it at load time.

The un-normed DiT (``qk_norm=False``, the JAX package's option) has no q/k
RMSNorm gains: its self-attention rotates token-major q and k with the
standalone rope ``rope_rotate`` (kernel R, forward and backward) and both
attentions take the shifted softmax (K2 and K3s), as the JAX package
passes ``bounded_logits=cfg.qk_norm``. ``cross_attn_norm=False`` drops the
affine norm3 before the cross-attention (no K8 there).

Training features: per-block activation checkpointing (``cfg.remat``,
policies "full" and "attn") and the feature taps the reward model reads
(``output_features``). The state dict keys follow the JAX parameter tree
(``blocks.{i}.self_attn.q`` for ``params/blocks/self_attn/q`` at layer i),
with torch's [out, in] weight layout.

The int8 serving path: ``cfg.quant_dense = "int8"`` makes the ten block
matmuls (self and cross q/k/v/o, ``ffn_0``, ``ffn_2``; twelve with the
image branch's ``k_img``/``v_img``) ``QuantLinear``
(W8A8, ops/quant.py), and ``cfg.quant_attn = "int8"`` sends the
self-attention to the int8 q k^T forward (K10) wherever its keys stream in
several blocks; the text cross-attention stays on K3. Both are forward
only.

i2v and flf2v (``model_type``; in_dim 36): the 20 conditioning channels
``y`` (mask and first-frame latent) are concatenated onto the noisy latent
before the patch embedding, and the CLIP image features ``clip_fea`` go
through ``MLPProj`` (``img_emb``, fp32, plain PyTorch: 257 or 514 rows) and
are prepended to the text context. Each block's cross-attention splits the
context at ``len - 512`` and adds a second attention over the image
tokens (``k_img``/``v_img``, int8 under ``quant_dense``, with the RMSNorm
``norm_k_img`` on K6 under ``qk_norm``): K3 at lk 257 (i2v) or 514
(flf2v).

TeaCache (ops/teacache.py, inference only): ``skip_blocks`` replaces the
block stack by ``h + residual_in``, and ``output_residual`` also returns
the time embedding e (the gate's input) and the stack's residual (out -
in, fp32). Not ported yet: the "dots" remat policies and the sharding
policies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.qknorm_rope import rmsnorm_only, rmsnorm_rope
from ..ops.quant import int8_dense, quantize_weight
from ..ops.rope import rope_rotate
from ..ops.stream import ln_scale_shift
from .rope import rope_tables_rolled_np

T5_CONTEXT_TOKEN_NUMBER = 512
FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER = 257 * 2
# the released CLIP ViT-H/14 image features: [257, 1280] per frame
CLIP_TOKENS, CLIP_DIM = 257, 1280


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """Model hyperparameters (the JAX WanConfig's model fields)."""

    model_type: str = "t2v"  # t2v | i2v | flf2v
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
    # RMSNorm gains on q and k over the model dim (the released Wan2.1
    # models); without them the attention takes the shifted softmax
    qk_norm: bool = True
    # the affine LayerNorm (norm3) before the cross-attention
    cross_attn_norm: bool = True
    eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16
    # activation checkpointing per block while gradients are on: "full"
    # recomputes the whole block in the backward; "attn" keeps the flash
    # attention's saved tensors and recomputes only the segments between
    # the attention calls, so the backward never re-runs K1/K3
    remat: bool = True
    remat_policy: str = "full"
    # "int8": the block matmuls run as W8A8 int8 GEMMs (serving and the
    # int8 rollout; QuantLinear)
    quant_dense: Optional[str] = None
    # "int8": the self-attention's q k^T runs on the int8 path (K10) where
    # its keys stream; the cross-attention stays bf16. Needs qk_norm (the
    # bounded logits), as in the JAX package; ignored without it
    quant_attn: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def t2v_14b(**kw):
    return WanConfig(**{**dict(model_type="t2v", dim=5120, ffn_dim=13824,
                               num_heads=40, num_layers=40), **kw})


def i2v_14b(**kw):
    return WanConfig(**{**dict(model_type="i2v", in_dim=36, dim=5120, ffn_dim=13824,
                               num_heads=40, num_layers=40), **kw})


def t2v_1_3b(**kw):
    return WanConfig(**{**dict(model_type="t2v", dim=1536, ffn_dim=8960,
                               num_heads=12, num_layers=30), **kw})


def i2v_1_3b(**kw):
    """1.3B-sized i2v variant (no released counterpart; the JAX package's
    small-scale i2v config, with the full 36-channel conditioning)."""
    return WanConfig(**{**dict(model_type="i2v", in_dim=36, dim=1536, ffn_dim=8960,
                               num_heads=12, num_layers=30), **kw})


def flf2v_14b(**kw):
    return WanConfig(**{**dict(model_type="flf2v", in_dim=36, dim=5120, ffn_dim=13824,
                               num_heads=40, num_layers=40), **kw})


def is_i2v(cfg: WanConfig) -> bool:
    """True for the models with the image branch (i2v, flf2v)."""
    return cfg.model_type in ("i2v", "flf2v")


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


class QuantLinear(nn.Module):
    """W8A8 int8 dense, the JAX package's QuantDense: an int8 weight
    [out, in] with fp32 per-output scales and an fp32 bias, all buffers
    (filled by utils/checkpoint.quantize_state or ``quantize_``)."""

    def __init__(self, in_f, out_f, device=None):
        super().__init__()
        device = device or "cpu"
        self.register_buffer("weight_q", torch.empty(out_f, in_f, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("weight_scale", torch.empty(out_f, device=device))
        self.register_buffer("bias", torch.empty(out_f, device=device))

    def forward(self, x):
        return int8_dense(x, self.weight_q, self.weight_scale, self.bias)

    @torch.no_grad()
    def quantize_(self, weight, bias):
        """Refill the buffers in place from a float weight [out, in] and bias."""
        q, s = quantize_weight(weight)
        self.weight_q.copy_(q)
        self.weight_scale.copy_(s)
        self.bias.copy_(bias)


def _block_linear(cfg: WanConfig, in_f, out_f, device, dtype):
    """One of the block matmuls: int8 under cfg.quant_dense."""
    if cfg.quant_dense == "int8":
        return QuantLinear(in_f, out_f, device)
    return _linear(in_f, out_f, device, dtype)


def _dense(layer, x, dtype):
    """The layer in `dtype`, whatever its storage: masters cast at use; an
    int8 layer quantizes x in `dtype` and writes `dtype`."""
    if isinstance(layer, QuantLinear):
        return layer(x.to(dtype))
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _param(*shape, device):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=torch.float32))


class _Attention(nn.Module):
    """q/k/v/o projections (stored in param_dtype) and, under cfg.qk_norm,
    fp32 qk-norm gains."""

    def __init__(self, cfg: WanConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        pd = param_dtype or cfg.compute_dtype
        self.q = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
        self.k = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
        self.v = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
        self.o = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
        if cfg.qk_norm:
            self.norm_q = _param(cfg.dim, device=device)
            self.norm_k = _param(cfg.dim, device=device)

    def attend(self, q, k, v, qk_int8=False):
        # qk-normed q/k are head-major (the K6 output), un-normed token-major;
        # qk_int8 applies only to bounded logits, so only under qk_norm
        qk_norm = self.cfg.qk_norm
        return dot_product_attention(q, k, v, qk_layout="bnld" if qk_norm else "blnd",
                                     bounded_logits=qk_norm, qk_int8=qk_int8)

    def out(self, o):
        """[B, L, N, D] attention output -> o projection, compute dtype."""
        b, l = o.shape[:2]
        return _dense(self.o, o.reshape(b, l, self.cfg.dim), self.cfg.compute_dtype)


class SelfAttention(_Attention):
    """qk-RMSNorm + 3D RoPE + flash attention (the block calls qkv, attend
    and out in turn, so remat can split around the attention)."""

    def qkv(self, x, c_tab, s_tab):
        """-> q, k (head-major [B, N, L, D] under qk_norm, else token-major
        [B, L, N, D]) and v [B, L, N, D]."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        b, l, _ = x.shape
        n, d = cfg.num_heads, cfg.head_dim
        x = x.to(cd)
        if cfg.qk_norm:
            q = rmsnorm_rope(_dense(self.q, x, cd), self.norm_q, c_tab, s_tab, n, cfg.eps)
            k = rmsnorm_rope(_dense(self.k, x, cd), self.norm_k, c_tab, s_tab, n, cfg.eps)
        else:
            q = rope_rotate(_dense(self.q, x, cd).view(b, l, n, d), c_tab, s_tab)
            k = rope_rotate(_dense(self.k, x, cd).view(b, l, n, d), c_tab, s_tab)
        return q, k, _dense(self.v, x, cd).view(b, l, n, d)

    def attend(self, q, k, v):
        return super().attend(q, k, v, qk_int8=self.cfg.quant_attn == "int8")


class CrossAttention(_Attention):
    """Text cross-attention, with qk-RMSNorm under cfg.qk_norm; for i2v and
    flf2v also the attention over the image tokens, which lead the context,
    added to the text attention's output before ``o``."""

    def __init__(self, cfg: WanConfig, device=None, param_dtype=None):
        super().__init__(cfg, device, param_dtype)
        if is_i2v(cfg):
            pd = param_dtype or cfg.compute_dtype
            self.k_img = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
            self.v_img = _block_linear(cfg, cfg.dim, cfg.dim, device, pd)
            if cfg.qk_norm:
                self.norm_k_img = _param(cfg.dim, device=device)

    def qkv(self, x, context):
        """-> q [B, N, L, D], k [B, N, Lk, D] head-major under qk_norm (else
        token-major [B, L, N, D], [B, Lk, N, D]) and v [B, Lk, N, D]; for
        i2v/flf2v also k_img and v_img, laid out as k and v."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        b, l, _ = x.shape
        n, d = cfg.num_heads, cfg.head_dim
        x = x.to(cd)
        context = context.to(cd)
        if is_i2v(cfg):
            img_len = context.shape[1] - T5_CONTEXT_TOKEN_NUMBER
            context_img, context = context[:, :img_len], context[:, img_len:]
        q, k = _dense(self.q, x, cd), _dense(self.k, context, cd)
        if cfg.qk_norm:
            q = rmsnorm_only(q, self.norm_q, n, cfg.eps)
            k = rmsnorm_only(k, self.norm_k, n, cfg.eps)
        else:
            q, k = q.view(b, l, n, d), k.view(b, -1, n, d)
        out = (q, k, _dense(self.v, context, cd).view(b, -1, n, d))
        if not is_i2v(cfg):
            return out
        k_img = _dense(self.k_img, context_img, cd)
        k_img = (rmsnorm_only(k_img, self.norm_k_img, n, cfg.eps) if cfg.qk_norm
                 else k_img.view(b, -1, n, d))
        return (*out, k_img, _dense(self.v_img, context_img, cd).view(b, -1, n, d))

    def attend(self, q, k, v, k_img=None, v_img=None):
        o = super().attend(q, k, v)
        return o if k_img is None else o + super().attend(q, k_img, v_img)


class WanBlock(nn.Module):
    """DiT block: adaLN-modulated self-attn, cross-attn, FFN. The residual
    stream is fp32; the matmuls run in compute_dtype.

    The block is written as three segments around its two attention calls,
    so the "attn" remat policy can checkpoint the segments and keep the
    attention Function's saved tensors (the JAX policy saves the flash
    residuals the same way)."""

    def __init__(self, cfg: WanConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        pd = param_dtype or cfg.compute_dtype
        self.modulation = _param(1, 6, cfg.dim, device=device)
        self.self_attn = SelfAttention(cfg, device, param_dtype)
        if cfg.cross_attn_norm:
            self.norm3_scale = _param(cfg.dim, device=device)
            self.norm3_bias = _param(cfg.dim, device=device)
        self.cross_attn = CrossAttention(cfg, device, param_dtype)
        self.ffn_0 = _block_linear(cfg, cfg.dim, cfg.ffn_dim, device, pd)
        self.ffn_2 = _block_linear(cfg, cfg.ffn_dim, cfg.dim, device, pd)

    def _pre_self(self, x, e6, c_tab, s_tab):
        h = ln_scale_shift(x, 1.0 + e6[:, 1], e6[:, 0], out_dtype=self.cfg.compute_dtype)
        return self.self_attn.qkv(h, c_tab, s_tab)

    def _mid(self, x, o, e6, context):
        x = x + self.self_attn.out(o).float() * e6[:, 2:3]
        h = (ln_scale_shift(x, self.norm3_scale, self.norm3_bias,
                            out_dtype=self.cfg.compute_dtype)
             if self.cfg.cross_attn_norm else x)
        return (x, *self.cross_attn.qkv(h, context))

    def _post(self, x, o, e6):
        cd = self.cfg.compute_dtype
        x = x + self.cross_attn.out(o).float()
        h = ln_scale_shift(x, 1.0 + e6[:, 4], e6[:, 3], out_dtype=cd)
        h = _dense(self.ffn_2, F.gelu(_dense(self.ffn_0, h, cd), approximate="tanh"), cd)
        return x + h.float() * e6[:, 5:6]

    def _body(self, x, e6, context, c_tab, s_tab, seg):
        o = self.self_attn.attend(*seg(self._pre_self, x, e6, c_tab, s_tab))
        x, *qkv = seg(self._mid, x, o, e6, context)
        return seg(self._post, x, self.cross_attn.attend(*qkv), e6)

    def forward(self, x, e, context, c_tab, s_tab):
        e6 = self.modulation + e.float()  # [B, 6, dim] fp32
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._body(x, e6, context, c_tab, s_tab, _call)
        if cfg.remat_policy == "full":
            return _ckpt(self._body, x, e6, context, c_tab, s_tab, _call)
        return self._body(x, e6, context, c_tab, s_tab, _ckpt)


def _call(fn, *args):
    return fn(*args)


def _ckpt(fn, *args):
    # Launch counts under remat: the backward re-runs a checkpointed
    # segment's forward up to its last op that saved a tensor (early stop).
    # Under "attn" that re-runs, per block, the K8 launches (three, two
    # without norm3) and the self q/k and cross q K6 launches, plus the
    # cross k K6 when the context needs a gradient (un-normed: the two R
    # launches of the self q/k); never the attention forward. Under "full"
    # it re-runs the whole block.
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


REMAT_POLICIES = ("full", "attn")


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


def _layer_norm(x, scale, bias, eps):
    """fp32 affine LayerNorm (the JAX package's _layer_norm)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, eps)


class MLPProj(nn.Module):
    """CLIP image-context projector, fp32: LayerNorm, fc1, exact GELU,
    fc2, LayerNorm. For flf2v the first- and last-frame features, stacked
    on the batch axis, are joined into one 514-token row per sample and get
    the learned ``emb_pos``."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.flf = cfg.model_type == "flf2v"
        f32 = torch.float32
        if self.flf:
            self.emb_pos = _param(1, FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER, CLIP_DIM,
                                  device=device)
        self.ln0_scale = _param(CLIP_DIM, device=device)
        self.ln0_bias = _param(CLIP_DIM, device=device)
        self.fc1 = _linear(CLIP_DIM, CLIP_DIM, device, f32)
        self.fc2 = _linear(CLIP_DIM, cfg.dim, device, f32)
        self.ln1_scale = _param(cfg.dim, device=device)
        self.ln1_bias = _param(cfg.dim, device=device)

    def forward(self, image_embeds):
        x = image_embeds.float()
        if self.flf:
            _, n, d = x.shape
            x = x.reshape(-1, 2 * n, d) + self.emb_pos
        x = _layer_norm(x, self.ln0_scale, self.ln0_bias, 1e-5)
        x = self.fc2(F.gelu(self.fc1(x)))
        return _layer_norm(x, self.ln1_scale, self.ln1_bias, 1e-5)


class WanModel(nn.Module):
    """The video DiT.

    WanModel(cfg, device=None, param_dtype=None, with_head=True):
    ``param_dtype`` stores the dense weights (default: the compute dtype;
    the trainer passes fp32 masters); ``with_head=False`` builds the
    head-less tower the reward model trims to.

    forward(x, t, context, y=None, clip_fea=None, grid=None,
            output_features=False, selected_layers=(), skip_blocks=False,
            residual_in=None, output_residual=False)
      x: [B, F, H, W, C] latent video, or the token-cell layout
         [B, L, cells, C] from ``patchify`` with ``grid`` given (the
         sampling loop keeps its state in that layout).
      t: [B] or scalar timesteps.  context: [B, text_len, text_dim].
      y: i2v/flf2v conditioning in x's layout, concatenated on the channel
         axis (C + C_y = in_dim).  clip_fea: CLIP image features
         [B, 257, 1280] (flf2v: [2B, 257, 1280], first and last frame of
         each sample in turn), projected by ``img_emb`` and prepended to
         the text context.
    Returns fp32 [B, F, H, W, out_dim], or [B, L, cells, out_dim] in token
    mode; with output_features, the residual stream after block ``idx``
    for each ``idx + 1`` in selected_layers, stacked [n_sel, B, L, dim]
    fp32, and no head. TeaCache: with ``skip_blocks`` the block stack is
    replaced by adding ``residual_in`` [B, L, dim]; ``output_residual``
    returns (out, e, residual_out), e the fp32 time embedding [B, dim] and
    residual_out the stack's output minus its input, fp32."""

    def __init__(self, cfg: WanConfig, device=None, param_dtype=None, with_head: bool = True):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported (have {REMAT_POLICIES})")
        self.cfg = cfg
        pd = param_dtype or cfg.compute_dtype
        cells = math.prod(cfg.patch_size)
        f32 = torch.float32
        self.patch_embedding = _linear(cells * cfg.in_dim, cfg.dim, device, pd)
        self.text_0 = _linear(cfg.text_dim, cfg.dim, device, pd)
        self.text_2 = _linear(cfg.dim, cfg.dim, device, pd)
        self.time_0 = _linear(cfg.freq_dim, cfg.dim, device, f32)
        self.time_2 = _linear(cfg.dim, cfg.dim, device, f32)
        self.time_proj = _linear(cfg.dim, 6 * cfg.dim, device, f32)
        self.img_emb = MLPProj(cfg, device) if is_i2v(cfg) else None
        self.blocks = nn.ModuleList(WanBlock(cfg, device, param_dtype)
                                    for _ in range(cfg.num_layers))
        self.head = Head(cfg, device) if with_head else None
        self._rope = {}  # (grid, device) -> rolled [L, D] tables

    def rope_tables(self, grid, device):
        key = (tuple(grid), str(device))
        if key not in self._rope:
            c, s = rope_tables_rolled_np(tuple(grid), self.cfg.head_dim)
            self._rope[key] = (torch.from_numpy(c).to(device),
                               torch.from_numpy(s).to(device))
        return self._rope[key]

    def forward(self, x, t, context, y=None, clip_fea=None,
                grid: Optional[Tuple[int, int, int]] = None,
                output_features: bool = False, selected_layers: Sequence[int] = (),
                skip_blocks: bool = False, residual_in: Optional[torch.Tensor] = None,
                output_residual: bool = False):
        cfg = self.cfg
        cd = cfg.compute_dtype
        pt, ph, pw = cfg.patch_size
        token_mode = x.dim() == 4
        if y is not None:
            # a channel concat in token-cell layout is the video-layout one
            x = torch.cat([x, y.to(x.dtype)], dim=-1)
        if token_mode:
            b, seq_len, cells, c_in = x.shape
            if grid is None or cells != pt * ph * pw or seq_len != math.prod(grid):
                raise ValueError(f"token-layout input {tuple(x.shape)} needs a "
                                 f"matching grid, got {grid}")
        else:
            x, grid = patchify(x, cfg.patch_size)
            b, seq_len, cells, c_in = x.shape
        h = _dense(self.patch_embedding, x.reshape(b, seq_len, cells * c_in), cd).float()

        t = torch.as_tensor(t, dtype=torch.float32, device=h.device).reshape(-1)
        e = time_embed_only(self, t.expand(b) if t.numel() == 1 else t)
        e0 = self.time_proj(F.silu(e)).view(b, 6, cfg.dim)

        ctx = _dense(self.text_2, F.gelu(_dense(self.text_0, context, cd), approximate="tanh"),
                     cd)
        if clip_fea is not None:
            ctx = torch.cat([self.img_emb(clip_fea).to(cd), ctx], dim=1)

        c_tab, s_tab = self.rope_tables(grid, h.device)
        sel = tuple(selected_layers)
        if output_features:
            if not sel or max(sel) > len(self.blocks) or min(sel) < 1:
                raise ValueError(f"selected_layers {sel} must name blocks 1..{len(self.blocks)}")
            taps = {}
            for idx, block in enumerate(self.blocks[:max(sel)]):
                h = block(h, e0, ctx, c_tab, s_tab)
                if idx + 1 in sel:
                    taps[idx + 1] = h
            return torch.stack([taps[i] for i in sel])
        h_in = h
        if skip_blocks:
            h = h + residual_in.to(h.dtype)
        else:
            for block in self.blocks:
                h = block(h, e0, ctx, c_tab, s_tab)

        if self.head is None:
            raise ValueError("a head-less WanModel only returns feature taps")
        out = self.head(h, e).reshape(b, seq_len, cells, cfg.out_dim)
        if not token_mode:
            out = unpatchify(out, grid, cfg.patch_size)
        if output_residual:
            return out.float(), e, h - h_in
        return out.float()


def time_embed_only(model: WanModel, t) -> torch.Tensor:
    """The fp32 time embedding e [B, dim] alone (the forward's time MLP
    before its projection): TeaCache's gate input."""
    t = torch.as_tensor(t, dtype=torch.float32, device=model.time_0.weight.device).reshape(-1)
    e = model.time_0(sinusoidal_embedding_1d(model.cfg.freq_dim, t))
    return model.time_2(F.silu(e))


_NORMAL02 = ("text_0", "text_2", "time_0", "time_2")


@torch.no_grad()
def init_params(model: WanModel, generator: torch.Generator) -> WanModel:
    """Fill a model with the JAX package's initialisers (same distributions,
    not the same numbers): xavier-uniform dense kernels, normal(0.02) for
    the text/time embeddings, zero biases, a zero head kernel,
    normal(1/sqrt(dim)) modulation, unit norm and LayerNorm scales, zero
    LayerNorm biases and a zero flf2v ``emb_pos``."""
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
        elif leaf in ("norm_q", "norm_k", "norm_k_img", "norm3_scale", "ln0_scale",
                      "ln1_scale"):
            p.fill_(1.0)
        elif leaf in ("norm3_bias", "ln0_bias", "ln1_bias", "emb_pos"):
            p.zero_()
    return model
