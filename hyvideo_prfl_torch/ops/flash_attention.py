"""Flash attention, forward and backward (hyvideo_prfl_tpu/ops/flash_attention.py).

Layout contract, as the JAX package's ``flash_attention``: v [B, Lk, N, D];
q [B, Lq, N, D] and k [B, Lk, N, D] token-major (``qk_layout="blnd"``, the
default), or head-major [B, N, L, D] (``"bnld"``, the qknorm_rope output);
returns o [B, Lq, N, D]. The kernels read every layout through strides.

Two softmax forms, as in the JAX package. The bounded form, which a caller
with qk-normed logits opts into (``bounded_logits=True``):

    q' = bf16(q * scale * log2(e));  p = exp2(q' k^T);  o = bf16(p) v / sum p

with no running max, exact while the logits stay under ~70 (the JAX
package's FLASH_BOUNDED note). The shifted (online-softmax) form, taken
by every other call, by any call with a key mask ``k_valid_len``, and by
every call when ``HYV_FLASH_BOUNDED=0``:

    s = q' k^T (keys past k_valid_len at -inf);  m = rowmax s
    p = exp2(s - m);  o = bf16(p) v / sum p;  lse = (m + log2 sum p) ln 2

The op is a ``torch.autograd.Function`` (the JAX ``custom_vjp``) that saves
(q, k, v, o, lse), lse [B*N, Lq] fp32, and recomputes p from lse in its
backward, which is therefore the same for both forms. On a CUDA tensor the
forward runs K1 (bounded, streaming: lk padded to 128 exceeds FULL_K_MAX)
or K2 (shifted, streaming), or K3 (bounded, single-K-block) or K3s (K3's
shifted form): the four instances of one kernel in csrc/flash_fwd.cu (TMA
and wgmma on a persistent warp-specialised grid, so q, k, v need 16-byte
aligned bases and strides); the backward runs K4 (merged: one dk/dv
kernel that also adds dq by TMA reductions) or K5 (split: the same dk/dv
kernel without dq, then a dq pass that writes dq once per q tile, so its
dq is bitwise deterministic), both in csrc/flash_bwd.cu on TMA and wgmma,
both masking keys past k_valid_len, routed by the JAX rule
(``uses_merged_bwd``; every call goes to K5 when HYV_FLASH_MERGED_BWD=0).
Where the tiles alone leave SMs idle, a sweep splits over several blocks
(``q_splits``). A CPU tensor runs the plain versions below.

``qk_int8=True`` (WanConfig.quant_attn) takes the JAX package's int8
serving forward wherever the bounded form applies and the keys stream in
several blocks (not ``uses_single_block``; FULL_K_MAX is read at call
time): q and k are quantized to int8 with one symmetric scale per
(batch, head), and

    s32 = q8 k8^T;  p = exp2(s32 c);  o = bf16(p) v / sum p

with c = fp32(sq sk) fp32(scale log2(e)). A CUDA tensor runs K10
(csrc/flash_fwd_qk8.cu, TMA and int8 wgmma). It has no backward, as in the
JAX package, and refuses a call that could need one. Elsewhere, and
everywhere when HYV_FLASH_QK8=0, qk_int8 falls back to the bf16 route, as
in the JAX package.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import _build
from .quant import over_127

FULL_K_MAX = 3584
DEFAULT_BLOCK_Q = 512
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
# Kill switch for the bounded (fixed-max) forward, read as the JAX package
# reads it: "0" sends every call, bounded_logits or not, to the shifted
# form, for a checkpoint whose logits could pass ~70 (attn_logit_bound).
FLASH_BOUNDED = os.environ.get("HYV_FLASH_BOUNDED", "1") == "1"
# Kill switch for the int8 q k^T forward (K10): "0" sends every qk_int8
# call to the bf16 route, as in the JAX package.
FLASH_QK8 = os.environ.get("HYV_FLASH_QK8", "1") == "1"
# "0" sends every backward to the split form (K5, whose dq is written once
# per q tile and so is bitwise deterministic), as in the JAX package.
FLASH_MERGED_BWD = os.environ.get("HYV_FLASH_MERGED_BWD", "1") == "1"


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
    lengths: FLASH_MERGED_BWD is on and its padded q range holds at least
    four backward q blocks (flash_attention.py:763, blocks from
    _bwd_blocks_merged). K5 otherwise."""
    if not FLASH_MERGED_BWD:
        return False
    lq_p = _pad_len(lq, _pick_block_q(lq, lk))
    return lq_p // _divisor_block(lq_p, 512) >= 4


def attn_logit_bound(state, head_dim: int = 128):
    """(typical, worst_case) attention-logit bounds from a checkpoint's
    qk-RMSNorm gains (the JAX package's ``attn_logit_bound``), given a
    WanModel state dict or module: with gq = max|norm_q|, gk = max|norm_k|
    (norm_k_img included) over all blocks and D their length,

        typical = gq gk sqrt(head_dim),  worst = gq gk D / sqrt(head_dim).

    The bounded forward is exact while the realized logits stay below
    ~70; past that, set HYV_FLASH_BOUNDED=0. (0.0, 0.0) when the state has
    no qk-norm gains: unknown, not safe."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    gq = gk = 0.0
    dim = 0
    for name, leaf in state.items():
        leaf_name = name.rsplit(".", 1)[-1]
        if "norm_q" in leaf_name:
            gq = max(gq, float(leaf.detach().abs().max()))
            dim = max(dim, int(leaf.shape[-1]))
        elif "norm_k" in leaf_name:
            gk = max(gk, float(leaf.detach().abs().max()))
    if not (gq and gk and dim):
        return 0.0, 0.0
    return gq * gk * head_dim ** 0.5, gq * gk * dim / head_dim ** 0.5


def _key_mask(kvalid, b, n, lk, device):
    """[B*N] valid lengths -> a [B, N, 1, Lk] bool mask of the kept keys."""
    if kvalid is None:
        return None
    keys = torch.arange(lk, device=device)
    return keys < kvalid.to(device).reshape(b, n, 1, 1)


def _softmax_pv_plain(scores, v, b, n, lq, q_chunk, shifted=False):
    """The softmax and p v over chunks of q rows, given the log2-domain
    scores of rows i0:i1 as scores(i0, i1) -> [B, N, i1 - i0, Lk] fp32, so the
    score block is [B, N, q_chunk, Lk] rather than the whole [B, N, Lq, Lk].
    Bounded: p = exp2(s); shifted: p = exp2(s - rowmax s)."""
    d = v.shape[-1]
    vf = v.movedim(2, 1).float()  # [B, N, Lk, D]
    o = torch.empty((b, lq, n, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=v.device)
    for i0 in range(0, lq, q_chunk):
        i1 = min(i0 + q_chunk, lq)
        s = scores(i0, i1)
        m = s.amax(dim=-1, keepdim=True) if shifted else None
        p = torch.exp2(s - m if shifted else s)
        l = p.sum(dim=-1, keepdim=True)
        acc = p.to(v.dtype).float() @ vf
        l_safe = torch.where(l <= 0.0, torch.ones_like(l), l)
        o[:, i0:i1] = (acc / l_safe).to(v.dtype).movedim(1, 2)
        log2l = torch.log2(l.clamp_min(1e-30))
        lse[:, :, i0:i1] = ((m + log2l) if shifted else log2l)[..., 0] * LN2
    return o, lse.reshape(b * n, lq)


def _scores_plain(q, k, kvalid=None):
    """scores(i0, i1) of q' k^T for q, k head-major [B, N, L, D] (views
    allowed), masked keys at NEG_INF."""
    b, n, _, d = q.shape
    qscale = _qscale(d)
    kt = k.float().transpose(-1, -2)
    keep = _key_mask(kvalid, b, n, k.shape[2], q.device)

    def scores(i0, i1):
        s = (q[:, :, i0:i1].float() * qscale).to(q.dtype).float() @ kt
        return s if keep is None else s.masked_fill(~keep, NEG_INF)

    return scores


def flash_attention_plain(q, k, v, q_chunk: int = 512):
    """Plain bounded forward -> (o [B, Lq, N, D], lse [B*N, Lq] fp32)."""
    b, n, lq, _ = q.shape
    return _softmax_pv_plain(_scores_plain(q, k), v, b, n, lq, q_chunk)


def flash_attention_shifted_plain(q, k, v, kvalid=None, q_chunk: int = 512):
    """Plain shifted forward -> (o [B, Lq, N, D], lse [B*N, Lq] fp32), what
    the JAX package's shifted forward computes; kvalid [B*N] int32 masks
    keys at and past each (batch, head)'s valid length (each >= 1)."""
    b, n, lq, _ = q.shape
    return _softmax_pv_plain(_scores_plain(q, k, kvalid), v, b, n, lq, q_chunk,
                             shifted=True)


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

    return _softmax_pv_plain(scores, v, b, n, lq, q_chunk)


def flash_attention_bwd_plain(q, k, v, o, lse, do, kvalid=None, q_chunk: int = 512):
    """The backward written out, over chunks of q rows -> (dq [B, N, Lq, D],
    dk [B, N, Lk, D], dv [B, Lk, N, D]) in the inputs' dtypes:

        q' = bf16(q scale log2e),  p = exp2(q' k^T - lse log2e)
        dv = bf16(p)^T dO,  dp = dO v^T,  ds = p (dp - delta)
        dk = bf16(ds)^T bf16(q scale),  dq = bf16(ds) bf16(k scale)

    with delta = rowsum(dO o) over the bf16 o the forward wrote, and p = 0
    for keys past kvalid [B*N] (so their dk and dv are exactly 0). Both
    forward forms share it: lse carries the shift."""
    b, n, lq, d = q.shape
    qscale, sc = _qscale(d), _f32(1.0 / math.sqrt(d))
    kf = k.float()
    ks = (kf * sc).to(k.dtype).float()
    vf = v.movedim(2, 1).float()              # [B, N, Lk, D]
    dof = do.movedim(2, 1).float()            # [B, N, Lq, D]
    delta = (dof * o.movedim(2, 1).float()).sum(dim=-1)  # [B, N, Lq]
    lse2 = lse.reshape(b, n, lq) * _f32(LOG2E)
    keep = _key_mask(kvalid, b, n, k.shape[2], q.device)
    dq = torch.empty((b, n, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, lq, q_chunk):
        i1 = min(i0 + q_chunk, lq)
        qf = q[:, :, i0:i1].float()
        qp = (qf * qscale).to(q.dtype).float()
        qs = (qf * sc).to(q.dtype).float()
        p = torch.exp2(qp @ kf.transpose(-1, -2) - lse2[..., i0:i1, None])
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
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


def _check_valid(kvalid, b, n, device):
    """kvalid: None, or contiguous int32 [B*N] on the device."""
    if kvalid is None:
        return 0
    _build.require(kvalid.shape == (b * n,) and kvalid.dtype == torch.int32
                   and kvalid.is_contiguous() and kvalid.device == device,
                   f"k_valid_len must be contiguous int32 [{b * n}] on {device}")
    return kvalid.data_ptr()


# (single, shifted) -> the kernel's name in the launch counters
FWD_NAMES = {(False, False): "K1", (True, False): "K3", (False, True): "K2",
             (True, True): "K3s"}


def flash_fwd_kernel(q, k, v, single: bool, shifted: bool = False, kvalid=None):
    """Launch K1 or K3 (bounded), K2 or K3s (shifted; single=True for the
    K3 forms) on CUDA tensors -> (o, lse); kvalid [B*N] int32 masks keys
    of the shifted forms."""
    b, n, lq, d = q.shape
    lk = k.shape[2]
    name = FWD_NAMES[bool(single), bool(shifted)]
    _build.require(d == 128, f"the kernel takes head_dim 128, got {d}")
    _build.require(k.shape == (b, n, lk, d) and v.shape == (b, lk, n, d),
                   f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
                   " do not match the BNLD/BNLD/BLND contract")
    _build.require(q.device.type == "cuda" and k.device == q.device and v.device == q.device,
                   "q, k, v must be on one CUDA device")
    _build.require(not single or lk <= FULL_K_MAX, f"{name} takes lk <= {FULL_K_MAX}")
    _build.require(shifted or kvalid is None, "a key mask needs the shifted form")
    for x, x_name in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(x, x_name)
    valid_ptr = _check_valid(kvalid, b, n, q.device)
    o = torch.empty((b, lq, n, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b * n, lq), dtype=torch.float32, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    os_ = o.stride()
    err = _build.lib().hyv_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), valid_ptr,
        b, n, lq, lk,
        qs[0], qs[1], qs[2],
        ks[0], ks[1], ks[2],
        vs[0], vs[2], vs[1],          # v is [B, L, N, D]: (batch, head, row)
        os_[0], os_[2], os_[1],       # o likewise
        _qscale(d), int(single), int(shifted), _build.stream_ptr(q.device))
    _build.check(err, name)
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


# at most this many blocks share one tile's sweep: K4's and K5's dk/dv
# split of a key tile's q sweep, K5's dq split of a q tile's key range
MAX_Q_SPLITS = 16


def q_splits(tiles: int, sweep: int, sms: int) -> int:
    """How many blocks share each tile's sweep: for the dk/dv kernel (K4,
    K5's first pass) ``tiles`` are batch * heads * key tiles of 128 and the
    sweep runs over ``sweep`` q tiles of 64; for K5's dq pass ``tiles`` are
    batch * heads * q tiles of 128 and the sweep runs over key tiles of 64.

    One while the tiles alone fill the card's ``sms`` SMs, as at
    self-attention. Fewer tiles (the text cross-attention's 4 key tiles a
    head; K5's dq pass at lq 1,024) leave SMs idle, so the sweep is split:
    the count (up to ``sweep`` and MAX_Q_SPLITS) whose waves of one block
    per SM finish first, the smallest on a tie."""
    if tiles >= sms:
        return 1
    return min(range(1, min(MAX_Q_SPLITS, sweep) + 1),
               key=lambda s: (-(-tiles * s // sms) / s, s))


def bwd_kernel(q, k, v, o, lse, do, merged: bool, kvalid=None, dq_splits=None):
    """Launch K4 (merged) or K5 on CUDA tensors -> (dq, dk, dv) as
    flash_attention_bwd_plain, keys past kvalid [B*N] int32 masked.
    dq_splits: K5's split of each q tile's key range (None: q_splits)."""
    b, n, lq, d = q.shape
    lk = k.shape[2]
    name = "K4" if merged else "K5"
    _build.require(d == 128, f"the kernel takes head_dim 128, got {d}")
    _build.require(k.shape == (b, n, lk, d) and v.shape == (b, lk, n, d)
                   and o.shape == (b, lq, n, d) and do.shape == o.shape,
                   "shapes do not match the BNLD/BNLD/BLND contract")
    _build.require(lse.shape == (b * n, lq) and lse.dtype == torch.float32
                   and lse.is_contiguous(), f"lse must be contiguous fp32 [{b * n}, {lq}]")
    dev = q.device
    _build.require(all(x.device == dev for x in (k, v, o, lse, do)) and dev.type == "cuda",
                   "q, k, v, o, lse, dO must be on one CUDA device")
    for x, x_name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "dO")):
        _check_rows(x, x_name)
    n_qt, n_kt = -(-lq // 64), -(-lk // 128)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = q_splits(b * n * n_kt, n_qt, sms)
    if not merged and dq_splits is None:
        dq_splits = q_splits(b * n * -(-lq // 128), -(-lk // 64), sms)
    # K4 adds into a zeroed fp32 dq; K5 writes one fp32 partial per key split
    dq = (torch.zeros((b * n, lq, d), dtype=torch.float32, device=dev) if merged
          else torch.empty((dq_splits, b * n, lq, d), dtype=torch.float32, device=dev))
    dk = torch.empty((b, n, lk, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty((b, lk, n, d), dtype=torch.bfloat16, device=dev)
    # scratch: q' and bf16(q * scale); per 64-row q tile, lse * log2e and
    # delta; K5 also bf16(k * scale)
    qp = torch.empty((2, b * n, lq, d), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((b * n, n_qt, 2, 64), dtype=torch.float32, device=dev)
    part = (torch.empty((2, splits, b * n, lk, d), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    qs, ks, vs, os_, dos, dks, dvs = (q.stride(), k.stride(), v.stride(), o.stride(),
                                      do.stride(), dk.stride(), dv.stride())
    strides = (qs[0], qs[1], qs[2],
               ks[0], ks[1], ks[2],
               vs[0], vs[2], vs[1],          # v, o, dO, dv are [B, L, N, D]: (batch, head, row)
               os_[0], os_[2], os_[1],
               dos[0], dos[2], dos[1],
               dks[0], dks[1], dks[2],
               dvs[0], dvs[2], dvs[1],
               _qscale(d), _f32(1.0 / math.sqrt(d)), _build.stream_ptr(dev))
    valid_ptr = _check_valid(kvalid, b, n, dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), valid_ptr, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), qp.data_ptr())
    part_ptr = None if part is None else part.data_ptr()
    if merged:
        err = _build.lib().hyv_flash_bwd_merged(*ptrs, stats.data_ptr(), part_ptr,
                                                b, n, lq, lk, splits, *strides)
    else:
        k_s = torch.empty((b * n, lk, d), dtype=torch.bfloat16, device=dev)
        err = _build.lib().hyv_flash_bwd(*ptrs, k_s.data_ptr(), stats.data_ptr(), part_ptr,
                                         b, n, lq, lk, splits, dq_splits, *strides)
    _build.check(err, name)
    if part is not None:
        # the second pass over the q-split partials, in a fixed order
        dk.copy_(part[0].sum(dim=0).view(b, n, lk, d))
        dv.copy_(part[1].sum(dim=0).view(b, n, lk, d).movedim(1, 2))
    if not merged:
        # K5's key-split partials, in a fixed order: dq stays deterministic
        dq = dq[0] if dq_splits == 1 else dq.sum(dim=0)
    return dq.view(b, n, lq, d).to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kvalid, shifted):
        if q.device.type == "cpu":
            o, lse = (flash_attention_shifted_plain(q, k, v, kvalid) if shifted
                      else flash_attention_plain(q, k, v))
        else:
            o, lse = flash_fwd_kernel(q, k, v, uses_single_block(k.shape[2]), shifted, kvalid)
        ctx.save_for_backward(q, k, v, o, lse, kvalid)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, kvalid = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_plain(q, k, v, o, lse, do, kvalid)
        else:
            grads = bwd_kernel(q, k, v, o, lse, do.contiguous(),
                               uses_merged_bwd(q.shape[2], k.shape[2]), kvalid)
        return (*grads, None, None)


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


def flash_attention(q, k, v, k_valid_len=None, qk_layout: str = "blnd",
                    bounded_logits: bool = False, return_lse: bool = False,
                    qk_int8: bool = False):
    """Flash attention, differentiable in q, k, v; returns o [B, Lq, N, D]
    (and lse [B*N, Lq]). The JAX package's signature and defaults: q/k
    token-major unless qk_layout="bnld", the shifted softmax unless the
    caller asserts bounded logits (and HYV_FLASH_BOUNDED allows it).

    k_valid_len: optional [B] integers, each >= 1; keys at positions
    >= k_valid_len[b] are masked (always the shifted form). ``qk_int8``
    takes the int8 score forward (no backward) where the bounded form
    applies, no mask is given and the keys stream in several blocks, and
    the bf16 route otherwise, by the JAX package's rule."""
    if qk_layout not in ("blnd", "bnld"):
        raise ValueError(f"qk_layout must be 'blnd' or 'bnld', got {qk_layout!r}")
    if qk_layout == "blnd":  # head-major views; the kernels read strides
        q, k = q.movedim(1, 2), k.movedim(1, 2)
    kvalid = None
    if k_valid_len is not None:
        kvalid = torch.as_tensor(k_valid_len, device=q.device).to(torch.int32)
        kvalid = kvalid.reshape(q.shape[0]).repeat_interleave(q.shape[1]).contiguous()
    bounded = bounded_logits and FLASH_BOUNDED and kvalid is None
    if qk_int8 and FLASH_QK8 and bounded and not uses_single_block(k.shape[2]):
        o, lse = flash_attention_qk8(q, k, v)
    else:
        o, lse = _FlashAttention.apply(q, k, v, kvalid, not bounded)
    return (o, lse) if return_lse else o
