"""Fixed-max ("bounded") flash-attention forward
(hyvideo_prfl_tpu/ops/flash_attention.py, forward only).

Layout contract, as the JAX package's ``flash_attention(...,
qk_layout="bnld")``: q [B, N, Lq, D] and k [B, N, Lk, D] head-major (the
qknorm_rope output), v [B, Lk, N, D]; returns o [B, Lq, N, D].

The softmax is the bounded form the DiT's qk-normed attention opts into:

    q' = bf16(q * scale * log2(e));  p = exp2(q' k^T);  o = bf16(p) v / sum p

with no running max, exact while the logits stay under ~70 (the JAX
package's FLASH_BOUNDED note). A CUDA tensor runs K1 (streaming,
lk > FULL_K_MAX after padding to 128) or K3 (single-K-block), both
csrc/flash_fwd.cu; a CPU tensor runs the plain version below. The shifted
online-softmax form (K2) is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

FULL_K_MAX = 3584
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _qscale(d: int) -> float:
    """scale * log2(e) as the fp32 value both versions multiply by."""
    return float(np.float32(LOG2E / math.sqrt(d)))


def uses_single_block(lk: int) -> bool:
    """True when the key range fits the single-K-block forward (K3)."""
    return (lk + 127) // 128 * 128 <= FULL_K_MAX


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


def flash_attention(q, k, v, qk_layout: str = "bnld", bounded_logits: bool = True,
                    return_lse: bool = False):
    """Bounded flash attention; returns o [B, Lq, N, D] (and lse)."""
    if qk_layout != "bnld" or not bounded_logits:
        raise NotImplementedError(
            "only the bounded, head-major q/k forward is ported "
            f"(qk_layout={qk_layout!r}, bounded_logits={bounded_logits})")
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v)
    else:
        o, lse = flash_fwd_kernel(q, k, v, single=uses_single_block(k.shape[2]))
    return (o, lse) if return_lse else o
