"""Fixed-max ("bounded") flash attention, forward and backward
(hyvideo_prfl_tpu/ops/flash_attention.py).

Layout contract, as the JAX package's ``flash_attention(...,
qk_layout="bnld")``: q [B, N, Lq, D] and k [B, N, Lk, D] head-major (the
qknorm_rope output), v [B, Lk, N, D]; returns o [B, Lq, N, D].

The softmax is the bounded form the DiT's qk-normed attention opts into:

    q' = bf16(q * scale * log2(e));  p = exp2(q' k^T);  o = bf16(p) v / sum p

with no running max, exact while the logits stay under ~70 (the JAX
package's FLASH_BOUNDED note). The op is a ``torch.autograd.Function``
(the JAX ``custom_vjp``) that saves (q, k, v, o, lse), lse [B*N, Lq] fp32,
and recomputes p from lse in its backward. On a CUDA tensor the forward
runs K1 (streaming, lk > FULL_K_MAX after padding to 128) or K3
(single-K-block), both csrc/flash_fwd.cu, and the backward runs K4
(merged) or K5 (split), both csrc/flash_bwd.cu, routed by the JAX rule
(``uses_merged_bwd``). A CPU tensor runs the plain versions below.

``qk_int8=True`` (WanConfig.quant_attn) takes the JAX package's int8
serving forward wherever the keys stream in several blocks (not
``uses_single_block``; FULL_K_MAX is read at call time): q and k are
quantized to int8 with one symmetric scale per (batch, head), and

    s32 = q8 k8^T;  p = exp2(s32 c);  o = bf16(p) v / sum p

with c = fp32(sq sk) fp32(scale log2(e)). A CUDA tensor runs K10
(csrc/flash_fwd_qk8.cu). It has no backward, as in the JAX package, and
refuses a call that could need one. The shifted online-softmax form (K2)
is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from .quant import over_127

FULL_K_MAX = 3584
DEFAULT_BLOCK_Q = 512
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _qscale(d: int) -> float:
    """scale * log2(e) as the fp32 value both versions multiply by."""
    return float(np.float32(LOG2E / math.sqrt(d)))


def _f32(x: float) -> float:
    return float(np.float32(x))


def uses_single_block(lk: int) -> bool:
    """True when the key range fits the single-K-block forward (K3)."""
    return (lk + 127) // 128 * 128 <= FULL_K_MAX


# The backward route is the JAX package's rule, taken literally with its
# TPU block geometry (pick_blocks, _bwd_blocks_merged) rather than the
# port's tile sizes, so both packages pick the merged or the split
# backward for the same shapes. These helpers are copies of its code.

def _pad_len(n: int, b: int) -> int:
    return (n + b - 1) // b * b


def _divisor_block(l_p: int, cap: int) -> int:
    for mult in (128, 8):
        for b in range(cap - cap % mult, mult - 1, -mult):
            if l_p % b == 0:
                return b
    return l_p


def _pick_block_q(lq: int, lk: int) -> int:
    """The forward block_q of the JAX package's pick_blocks."""
    full_k = _pad_len(lk, 128) <= FULL_K_MAX
    lq128 = _pad_len(lq, 128)
    if lq128 <= DEFAULT_BLOCK_Q:
        return lq128
    cands = (256, 384, 512) if full_k else (384, 512)
    block_q = min(cands, key=lambda bq: (_pad_len(lq, bq), -bq))
    if _pad_len(lq, max(cands)) <= _pad_len(lq, block_q) * 1.04:
        block_q = max(cands)
    return block_q


def uses_merged_bwd(lq: int, lk: int) -> bool:
    """True when the JAX package takes its merged backward (K4) for these
    lengths: its padded q range holds at least four backward q blocks
    (flash_attention.py:763, blocks from _bwd_blocks_merged). K5 otherwise."""
    lq_p = _pad_len(lq, _pick_block_q(lq, lk))
    return lq_p // _divisor_block(lq_p, 512) >= 4


def _bounded_fwd_plain(scores, v, b, n, lq, q_chunk):
    """The bounded softmax and p v over chunks of q rows, given the log2-domain
    scores of rows i0:i1 as scores(i0, i1) -> [B, N, i1 - i0, Lk] fp32, so the
    score block is [B, N, q_chunk, Lk] rather than the whole [B, N, Lq, Lk]."""
    d = v.shape[-1]
    vf = v.movedim(2, 1).float()  # [B, N, Lk, D]
    o = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=v.device)
    for i0 in range(0, lq, q_chunk):
        i1 = min(i0 + q_chunk, lq)
        p = torch.exp2(scores(i0, i1))
        l = p.sum(dim=-1, keepdim=True)
        acc = p.to(v.dtype).float() @ vf
        l_safe = torch.where(l <= 0.0, torch.ones_like(l), l)
        o[:, i0:i1] = (acc / l_safe).to(v.dtype).movedim(1, 2)
        lse[:, :, i0:i1] = torch.log2(l.clamp_min(1e-30))[..., 0] * LN2
    return o, lse.reshape(b * n, lq)


def flash_attention_plain(q, k, v, q_chunk: int = 512):
    """Plain bounded forward -> (o [B, Lq, N, D], lse [B*N, Lq] fp32)."""
    b, n, lq, d = q.shape
    qscale = _qscale(d)
    kt = k.float().transpose(-1, -2)

    def scores(i0, i1):
        return (q[:, :, i0:i1].float() * qscale).to(q.dtype).float() @ kt

    return _bounded_fwd_plain(scores, v, b, n, lq, q_chunk)


def quantize_bn(x):
    """[B, N, L, D] float -> (int8 of x's shape, fp32 scales [B*N]): one
    symmetric absmax scale per (batch, head), s = max(a, 1e-30) / 127 (the
    JAX package's _quantize_bn)."""
    b, n = x.shape[:2]
    xf = x.float()
    s = over_127(xf.abs().amax(dim=(2, 3)).clamp_min(1e-30))
    x8 = torch.round(xf / s[:, :, None, None]).clamp(-127, 127).to(torch.int8)
    return x8, s.reshape(b * n)


def qk8_scale(sq, sk, d: int):
    """c = fp32(sq sk) * fp32(scale * log2(e)), as the JAX package forms it."""
    return (sq * sk) * _f32((1.0 / d ** 0.5) * LOG2E)


def flash_attention_qk8_plain(q8, k8, v, c, q_chunk: int = 512):
    """Plain int8-score bounded forward -> (o [B, Lq, N, D], lse [B*N, Lq]).

    q8 [B, N, Lq, D], k8 [B, N, Lk, D] int8, v [B, Lk, N, D], c [B*N] fp32.
    The integer scores are exact in an fp32 product: |s32| <= 128 * 127^2
    < 2^24."""
    b, n, lq, _ = q8.shape
    kt = k8.float().transpose(-1, -2)
    cf = c.float().reshape(b, n, 1, 1)

    def scores(i0, i1):
        return (q8[:, :, i0:i1].float() @ kt) * cf

    return _bounded_fwd_plain(scores, v, b, n, lq, q_chunk)


def flash_attention_bwd_plain(q, k, v, o, lse, do, q_chunk: int = 512):
    """The backward written out, over chunks of q rows -> (dq [B, N, Lq, D],
    dk [B, N, Lk, D], dv [B, Lk, N, D]) in the inputs' dtypes:

        q' = bf16(q scale log2e),  p = exp2(q' k^T - lse log2e)
        dv = bf16(p)^T dO,  dp = dO v^T,  ds = p (dp - delta)
        dk = bf16(ds)^T bf16(q scale),  dq = bf16(ds) bf16(k scale)

    with delta = rowsum(dO o) over the bf16 o the forward wrote."""
    b, n, lq, d = q.shape
    qscale, sc = _qscale(d), _f32(1.0 / math.sqrt(d))
    kf = k.float()
    ks = (kf * sc).to(k.dtype).float()
    vf = v.movedim(2, 1).float()              # [B, N, Lk, D]
    dof = do.movedim(2, 1).float()            # [B, N, Lq, D]
    delta = (dof * o.movedim(2, 1).float()).sum(dim=-1)  # [B, N, Lq]
    lse2 = lse.reshape(b, n, lq) * _f32(LOG2E)
    dq = torch.empty((b, n, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, lq, q_chunk):
        i1 = min(i0 + q_chunk, lq)
        qf = q[:, :, i0:i1].float()
        qp = (qf * qscale).to(q.dtype).float()
        qs = (qf * sc).to(q.dtype).float()
        p = torch.exp2(qp @ kf.transpose(-1, -2) - lse2[..., i0:i1, None])
        dc = dof[:, :, i0:i1]
        dv += p.to(do.dtype).float().transpose(-1, -2) @ dc
        ds = p * (dc @ vf.transpose(-1, -2) - delta[..., i0:i1, None])
        dk += ds.to(q.dtype).float().transpose(-1, -2) @ qs
        dq[:, :, i0:i1] = ds.to(k.dtype).float() @ ks
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype).movedim(1, 2)


def _check_rows(x, name):
    _build.require(x.dtype == torch.bfloat16, f"{name} must be bf16, got {x.dtype}")
    _build.require(x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:-1])
                   and _build.aligned16(x),
                   f"{name}: feature dim must be contiguous with 16-byte aligned rows")


def flash_fwd_kernel(q, k, v, single: bool):
    """Launch K3 (single=True) or K1 on CUDA tensors -> (o, lse)."""
    b, n, lq, d = q.shape
    lk = k.shape[2]
    _build.require(d == 128, f"the kernel takes head_dim 128, got {d}")
    _build.require(k.shape == (b, n, lk, d) and v.shape == (b, lk, n, d),
                   f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
                   " do not match the BNLD/BNLD/BLND contract")
    _build.require(q.device.type == "cuda" and k.device == q.device and v.device == q.device,
                   "q, k, v must be on one CUDA device")
    _build.require(not single or lk <= FULL_K_MAX, f"K3 takes lk <= {FULL_K_MAX}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(x, name)
    o = torch.empty((b, lq, n, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b * n, lq), dtype=torch.float32, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    os_ = o.stride()
    err = _build.lib().hyv_flash_fwd_bounded(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, n, lq, lk,
        qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[2],
        vs[0], vs[2], vs[1],          # v is [B, L, N, D]: (batch, head, row)
        os_[0], os_[2], os_[1],       # o likewise
        _qscale(d), int(single), _build.stream_ptr(q.device))
    _build.check(err, "K3" if single else "K1")
    return o, lse


def flash_qk8_kernel(q8, k8, v, c):
    """Launch K10 on CUDA tensors -> (o, lse) as flash_attention_qk8_plain."""
    b, n, lq, d = q8.shape
    lk = k8.shape[2]
    _build.require(d == 128, f"the kernel takes head_dim 128, got {d}")
    _build.require(k8.shape == (b, n, lk, d) and v.shape == (b, lk, n, d),
                   f"shapes q8 {tuple(q8.shape)} k8 {tuple(k8.shape)} v {tuple(v.shape)}"
                   " do not match the BNLD/BNLD/BLND contract")
    _build.require(q8.device.type == "cuda"
                   and all(x.device == q8.device for x in (k8, v, c)),
                   "q8, k8, v, c must be on one CUDA device")
    for x, name in ((q8, "q8"), (k8, "k8")):
        _build.require(x.dtype == torch.int8, f"{name} must be int8, got {x.dtype}")
        _build.require(x.stride(-1) == 1 and all(s % 16 == 0 for s in x.stride()[:-1])
                       and _build.aligned16(x),
                       f"{name}: feature dim must be contiguous with 16-byte aligned rows")
    _check_rows(v, "v")
    _build.require(c.shape == (b * n,) and c.dtype == torch.float32 and c.is_contiguous(),
                   f"c must be contiguous fp32 [{b * n}]")
    o = torch.empty((b, lq, n, d), dtype=torch.bfloat16, device=q8.device)
    lse = torch.empty((b * n, lq), dtype=torch.float32, device=q8.device)
    qs, ks, vs, os_ = q8.stride(), k8.stride(), v.stride(), o.stride()
    err = _build.lib().hyv_flash_fwd_qk8(
        q8.data_ptr(), k8.data_ptr(), v.data_ptr(), c.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, n, lq, lk,
        qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[2],
        vs[0], vs[2], vs[1],          # v is [B, L, N, D]: (batch, head, row)
        os_[0], os_[2], os_[1],       # o likewise
        _build.stream_ptr(q8.device))
    _build.check(err, "K10")
    return o, lse


def bwd_kernel(q, k, v, o, lse, do, merged: bool):
    """Launch K4 (merged) or K5 on CUDA tensors -> (dq, dk, dv) as
    flash_attention_bwd_plain."""
    b, n, lq, d = q.shape
    lk = k.shape[2]
    _build.require(d == 128, f"the kernel takes head_dim 128, got {d}")
    _build.require(k.shape == (b, n, lk, d) and v.shape == (b, lk, n, d)
                   and o.shape == (b, lq, n, d) and do.shape == o.shape,
                   "shapes do not match the BNLD/BNLD/BLND contract")
    _build.require(lse.shape == (b * n, lq) and lse.dtype == torch.float32
                   and lse.is_contiguous(), f"lse must be contiguous fp32 [{b * n}, {lq}]")
    _build.require(all(x.device == q.device for x in (k, v, o, lse, do))
                   and q.device.type == "cuda", "q, k, v, o, lse, dO must be on one CUDA device")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (do, "dO")):
        _check_rows(x, name)
    # delta = rowsum(dO o) over the bf16 o, as the JAX package computes it
    # outside its kernels
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).reshape(b * n, lq)
    delta = delta.contiguous()
    dq = (torch.zeros if merged else torch.empty)((b * n, lq, d), dtype=torch.float32,
                                                  device=q.device)
    dk = torch.empty((b, n, lk, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty((b, lk, n, d), dtype=torch.bfloat16, device=q.device)
    qs, ks, vs, dos, dks, dvs = (q.stride(), k.stride(), v.stride(), do.stride(),
                                 dk.stride(), dv.stride())
    err = _build.lib().hyv_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, lq, lk,
        qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[2],
        vs[0], vs[2], vs[1],          # v, dO, dv are [B, L, N, D]: (batch, head, row)
        dos[0], dos[2], dos[1],
        dks[0], dks[1], dks[2],
        dvs[0], dvs[2], dvs[1],
        _qscale(d), _f32(1.0 / math.sqrt(d)), int(merged), _build.stream_ptr(q.device))
    _build.check(err, "K4" if merged else "K5")
    return dq.view(b, n, lq, d).to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v)
        else:
            o, lse = flash_fwd_kernel(q, k, v, single=uses_single_block(k.shape[2]))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, o, lse, do)
        return bwd_kernel(q, k, v, o, lse, do.contiguous(),
                          merged=uses_merged_bwd(q.shape[2], k.shape[2]))


def flash_attention_qk8(q, k, v):
    """The int8 q k^T bounded forward -> (o [B, Lq, N, D], lse [B*N, Lq]).

    Serving only: it has no backward, so a call that could need one (grad
    mode on and an input that requires a gradient) raises rather than
    giving no gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("the int8 q k^T attention has no backward: "
                           "call it under torch.no_grad() on inputs that need no gradient")
    q8, sq = quantize_bn(q)
    k8, sk = quantize_bn(k)
    c = qk8_scale(sq, sk, q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_qk8_plain(q8, k8, v, c)
    return flash_qk8_kernel(q8, k8, v, c)


def flash_attention(q, k, v, qk_layout: str = "bnld", bounded_logits: bool = True,
                    return_lse: bool = False, qk_int8: bool = False):
    """Bounded flash attention, differentiable in q, k, v; returns
    o [B, Lq, N, D] (and lse). ``qk_int8`` takes the int8 score forward
    (no backward) where the keys stream in several blocks, and keeps the
    bf16 one otherwise, by the JAX package's rule."""
    if qk_layout != "bnld" or not bounded_logits:
        raise NotImplementedError(
            "only the bounded, head-major q/k attention is ported "
            f"(qk_layout={qk_layout!r}, bounded_logits={bounded_logits})")
    if qk_int8 and not uses_single_block(k.shape[2]):
        o, lse = flash_attention_qk8(q, k, v)
    else:
        o, lse = _FlashAttention.apply(q, k, v)
    return (o, lse) if return_lse else o
