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
(``uses_merged_bwd``). A CPU tensor runs the plain versions below. The
shifted online-softmax form (K2) is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

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


def flash_attention_plain(q, k, v, q_chunk: int = 512):
    """Plain bounded forward -> (o [B, Lq, N, D], lse [B*N, Lq] fp32).

    Runs over chunks of q rows, so the fp32 score block is
    [B, N, q_chunk, Lk] rather than the whole [B, N, Lq, Lk]."""
    b, n, lq, d = q.shape
    qscale = _qscale(d)
    kf = k.float()
    vf = v.movedim(2, 1).float()  # [B, N, Lk, D]
    o = torch.empty((b, lq, n, d), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
    for i0 in range(0, lq, q_chunk):
        i1 = min(i0 + q_chunk, lq)
        qs = (q[:, :, i0:i1].float() * qscale).to(q.dtype).float()
        p = torch.exp2(qs @ kf.transpose(-1, -2))  # [B, N, c, Lk] fp32
        l = p.sum(dim=-1, keepdim=True)
        acc = p.to(v.dtype).float() @ vf
        l_safe = torch.where(l <= 0.0, torch.ones_like(l), l)
        o[:, i0:i1] = (acc / l_safe).to(v.dtype).movedim(1, 2)
        lse[:, :, i0:i1] = torch.log2(l.clamp_min(1e-30))[..., 0] * LN2
    return o, lse.reshape(b * n, lq)


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


def flash_attention(q, k, v, qk_layout: str = "bnld", bounded_logits: bool = True,
                    return_lse: bool = False):
    """Bounded flash attention, differentiable in q, k, v; returns
    o [B, Lq, N, D] (and lse)."""
    if qk_layout != "bnld" or not bounded_logits:
        raise NotImplementedError(
            "only the bounded, head-major q/k attention is ported "
            f"(qk_layout={qk_layout!r}, bounded_logits={bounded_logits})")
    o, lse = _FlashAttention.apply(q, k, v)
    return (o, lse) if return_lse else o
