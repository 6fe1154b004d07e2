"""Fused qk-RMSNorm + rolled-half RoPE (hyvideo_prfl_tpu/ops/qknorm_rope.py).

Layout contract, as in the JAX package: x [B, L, N*D] (the q/k projection
output) -> [B, N, L, D] (the attention kernel's q/k layout).

    r   = rsqrt(mean(x^2 over all N*D) + eps)       fp32
    t   = bf16(x * r) * bf16(w)
    out = bf16(f32(t) * C + roll(f32(t), D/2) * S)  (rmsnorm_rope only)

A CUDA tensor runs kernel K6 (csrc/qknorm_rope.cu); a CPU tensor runs the
plain version below, the same math as the JAX package's ``_xla_ref``.
"""

from __future__ import annotations

import torch

from . import _build


def rmsnorm_rope_plain(x, w, c_tab, s_tab, num_heads: int, eps: float = 1e-6,
                       do_rope: bool = True):
    """Unfused reference. x [B, L, N*D], w [N*D] -> [B, N, L, D]."""
    b, l, m = x.shape
    n = num_heads
    d = m // n
    xf = x.float()
    ms = (xf * xf).mean(dim=2, keepdim=True)
    t = (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w.reshape(1, 1, m).to(x.dtype)
    t = t.reshape(b, l, n, d)
    if do_rope:
        tf = t.float()
        half = d // 2
        rolled = torch.cat([tf[..., half:], tf[..., :half]], dim=-1)
        t = (tf * c_tab[None, :, None, :] + rolled * s_tab[None, :, None, :]).to(x.dtype)
    return t.movedim(2, 1)


def _kernel(x, w, c_tab, s_tab, num_heads, eps, do_rope):
    b, l, m = x.shape
    n = num_heads
    d = m // n
    _build.require(x.dtype == torch.bfloat16, f"K6 takes bf16 x, got {x.dtype}")
    _build.require(d == 128 and n in (2, 4, 8, 12, 16, 40),
                   f"K6 has no instance for {n} heads of {d}")
    w = w.float().contiguous()
    _build.require(x.is_contiguous() and _build.aligned16(x, w),
                   "K6 takes contiguous, 16-byte aligned x and w")
    _build.require(w.numel() == m and w.device == x.device, "K6: w must be [N*D] on x's device")
    if do_rope:
        _build.require(c_tab.shape == (l, d) and s_tab.shape == (l, d),
                       f"K6: tables must be [{l}, {d}]")
        _build.require(c_tab.dtype == torch.float32 and s_tab.dtype == torch.float32
                       and c_tab.is_contiguous() and s_tab.is_contiguous()
                       and _build.aligned16(c_tab, s_tab)
                       and c_tab.device == x.device and s_tab.device == x.device,
                       "K6: tables must be contiguous, aligned fp32 on x's device")
        c_ptr, s_ptr = c_tab.data_ptr(), s_tab.data_ptr()
    else:
        c_ptr = s_ptr = None
    out = torch.empty((b, n, l, d), dtype=x.dtype, device=x.device)
    err = _build.lib().hyv_rmsnorm_rope(
        x.data_ptr(), w.data_ptr(), c_ptr, s_ptr, out.data_ptr(), b, l, n, d,
        float(eps), int(do_rope), _build.stream_ptr(x.device))
    _build.check(err, "K6")
    return out


def _dispatch(x, w, c_tab, s_tab, num_heads, eps, do_rope):
    if x.device.type == "cpu":
        return rmsnorm_rope_plain(x, w, c_tab, s_tab, num_heads, eps, do_rope)
    _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    return _kernel(x, w, c_tab, s_tab, num_heads, eps, do_rope)


def rmsnorm_rope(x, w, c_tab, s_tab, num_heads: int, eps: float = 1e-6):
    """Fused full-dim RMSNorm + rolled-table rope.

    x: [B, L, dim]; w: [dim]; tables [L, D] fp32. Returns [B, N, L, D]."""
    return _dispatch(x, w, c_tab, s_tab, num_heads, eps, do_rope=True)


def rmsnorm_only(x, w, num_heads: int, eps: float = 1e-6):
    """Fused full-dim RMSNorm over [B, L, dim] -> [B, N, L, D] (the
    cross-attention q/k norms, which have no rope)."""
    return _dispatch(x, w, None, None, num_heads, eps, do_rope=False)
