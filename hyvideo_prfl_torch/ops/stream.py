"""Fused LayerNorm + scale/shift (hyvideo_prfl_tpu/ops/stream.py).

    out = LN(x; eps) * s + t        x [B, L, D] fp32, s and t [B, D] fp32

with s = 1 + e_scale at the adaLN sites and s = broadcast(norm3 scale) at
the cross-attention norm. A CUDA tensor runs kernel K8
(csrc/ln_scale_shift.cu); a CPU tensor runs the plain version below, which
is the same math as the JAX package's ``_xla_ref``.
"""

from __future__ import annotations

import torch

from . import _build


def ln_scale_shift_plain(x, s, t, eps: float = 1e-6, out_dtype=torch.bfloat16):
    """Unfused reference: fp32 two-pass LayerNorm, modulate, cast."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    yn = (xf - mean) * torch.rsqrt(var + eps)
    return (yn * s[:, None, :] + t[:, None, :]).to(out_dtype)


def _kernel(x, s, t, eps, out_dtype):
    b, l, d = x.shape
    _build.require(x.dtype == torch.float32, f"K8 takes fp32 x, got {x.dtype}")
    _build.require(out_dtype in (torch.bfloat16, torch.float32),
                   f"K8 writes bf16 or fp32, got {out_dtype}")
    _build.require(d in (128, 256, 512, 1024, 1536, 2048, 5120),
                   f"K8 has no instance for D={d}")
    _build.require(x.is_contiguous() and s.is_contiguous() and t.is_contiguous()
                   and _build.aligned16(x, s, t),
                   "K8 takes contiguous, 16-byte aligned x, s, t")
    out = torch.empty((b, l, d), dtype=out_dtype, device=x.device)
    err = _build.lib().hyv_ln_scale_shift(
        x.data_ptr(), s.data_ptr(), t.data_ptr(), out.data_ptr(), b, l, d,
        float(eps), int(out_dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "K8")
    return out


def ln_scale_shift(x, s, t, eps: float = 1e-6, out_dtype=torch.bfloat16):
    """Fused LayerNorm(x) * s + t over the feature dim.

    x: [B, L, D]; s, t: [B, D], [1, D] or [D] (precompute 1 + e_scale at
    the adaLN sites). Returns [B, L, D] in out_dtype."""
    b, l, d = x.shape
    s = s.float().reshape(-1, d).expand(b, d).contiguous()
    t = t.float().reshape(-1, d).expand(b, d).contiguous()
    if x.device.type == "cpu":
        return ln_scale_shift_plain(x, s, t, eps, out_dtype)
    _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    _build.require(s.device == x.device and t.device == x.device,
                   "K8: s and t must be on x's device")
    return _kernel(x, s, t, eps, out_dtype)
