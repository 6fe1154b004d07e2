"""Fused LayerNorm + scale/shift (hyvideo_prfl_tpu/ops/stream.py).

    out = LN(x; eps) * s + t        x [B, L, D] fp32, s and t [B, D] fp32

with s = 1 + e_scale at the adaLN sites and s = broadcast(norm3 scale) at
the cross-attention norm. The op is a ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): it saves (x, s), as the JAX residuals do, and
its backward recomputes the statistics. A CUDA tensor runs kernel K8
(csrc/ln_scale_shift.cu) forward and K9 (csrc/ln_scale_shift_bwd.cu)
backward; a CPU tensor runs the plain versions below, which are the same
math as the JAX package's ``_xla_ref`` and ``_bwd_kernel``.
"""

from __future__ import annotations

import torch

from . import _build

# K8 and K9 take every multiple of 128 up to this width (the JAX kernels
# take every multiple of 128); narrow rows are a warp's, wide ones a block's
MAX_DIM = 8192


def _has_instance(d: int) -> bool:
    return d % 128 == 0 and 0 < d <= MAX_DIM


def ln_scale_shift_plain(x, s, t, eps: float = 1e-6, out_dtype=torch.bfloat16):
    """Unfused reference: fp32 two-pass LayerNorm, modulate, cast."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    yn = (xf - mean) * torch.rsqrt(var + eps)
    return (yn * s[:, None, :] + t[:, None, :]).to(out_dtype)


def ln_scale_shift_bwd_plain(x, s, g, eps: float = 1e-6):
    """The backward written out -> (dx fp32 [B, L, D], ds, dt [B, D]):

        yn = (x - mean) * rstd,  dyn = g * s
        dx = rstd * (dyn - mean(dyn) - yn * mean(dyn * yn))
        ds = sum_L g * yn,  dt = sum_L g
    """
    xf = x.float()
    gf = g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    yn = xc * rstd
    dyn = gf * s[:, None, :]
    m1 = dyn.mean(dim=-1, keepdim=True)
    m2 = (dyn * yn).mean(dim=-1, keepdim=True)
    dx = rstd * (dyn - m1 - yn * m2)
    return dx, (gf * yn).sum(dim=1), gf.sum(dim=1)


def _check_rows(x, s, name):
    b, l, d = x.shape
    _build.require(x.dtype == torch.float32, f"{name} takes fp32 x, got {x.dtype}")
    _build.require(s.shape == (b, d) and s.dtype == torch.float32,
                   f"{name}: s must be fp32 [{b}, {d}]")
    _build.require(x.is_contiguous() and s.is_contiguous() and _build.aligned16(x, s),
                   f"{name} takes contiguous, 16-byte aligned x and s")


def _kernel(x, s, t, eps, out_dtype):
    b, l, d = x.shape
    _check_rows(x, s, "K8")
    _build.require(out_dtype in (torch.bfloat16, torch.float32),
                   f"K8 writes bf16 or fp32, got {out_dtype}")
    _build.require(_has_instance(d), f"K8 has no instance for D={d}")
    _build.require(t.shape == s.shape and t.dtype == torch.float32 and t.is_contiguous()
                   and _build.aligned16(t), "K8: t must be contiguous fp32 like s")
    out = torch.empty((b, l, d), dtype=out_dtype, device=x.device)
    err = _build.lib().hyv_ln_scale_shift(
        x.data_ptr(), s.data_ptr(), t.data_ptr(), out.data_ptr(), b, l, d,
        float(eps), int(out_dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "K8")
    return out


def bwd_kernel(x, s, g, eps):
    """Launch K9 on CUDA tensors -> (dx, ds, dt) as ln_scale_shift_bwd_plain."""
    b, l, d = x.shape
    _check_rows(x, s, "K9")
    _build.require(_has_instance(d), f"K9 has no instance for D={d}")
    _build.require(g.shape == x.shape and g.dtype in (torch.bfloat16, torch.float32),
                   f"K9: g must be bf16 or fp32 {tuple(x.shape)}")
    _build.require(g.device == x.device and g.is_contiguous() and _build.aligned16(g),
                   "K9 takes a contiguous, 16-byte aligned g on x's device")
    n_tiles = (l + 31) // 32
    dx = torch.empty_like(x)
    ds_part = torch.empty((b, n_tiles, d), dtype=torch.float32, device=x.device)
    dt_part = torch.empty_like(ds_part)
    err = _build.lib().hyv_ln_scale_shift_bwd(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(), ds_part.data_ptr(),
        dt_part.data_ptr(), b, l, d, float(eps), int(g.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(err, "K9")
    # the second pass over the per-tile partials, in a fixed order
    return dx, ds_part.sum(dim=1), dt_part.sum(dim=1)


def _on_card(x):
    _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")


class _LnScaleShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, t, eps, out_dtype):
        ctx.eps = eps
        ctx.save_for_backward(x, s)
        if x.device.type == "cpu":
            return ln_scale_shift_plain(x, s, t, eps, out_dtype)
        _on_card(x)
        _build.require(s.device == x.device and t.device == x.device,
                       "K8: s and t must be on x's device")
        return _kernel(x, s, t, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, ds, dt = ln_scale_shift_bwd_plain(x, s, g, ctx.eps)
        else:
            _on_card(x)
            dx, ds, dt = bwd_kernel(x, s, g.contiguous(), ctx.eps)
        return dx.to(x.dtype), ds, dt, None, None


def ln_scale_shift(x, s, t, eps: float = 1e-6, out_dtype=torch.bfloat16):
    """Fused LayerNorm(x) * s + t over the feature dim, differentiable.

    x: [B, L, D]; s, t: [B, D], [1, D] or [D] (precompute 1 + e_scale at
    the adaLN sites). Returns [B, L, D] in out_dtype. The broadcast of s and
    t to [B, D] is a torch op outside the kernel, so a shared [D] scale
    gets the sum of its per-batch gradients."""
    b, l, d = x.shape
    s = s.float().reshape(-1, d).expand(b, d).contiguous()
    t = t.float().reshape(-1, d).expand(b, d).contiguous()
    return _LnScaleShift.apply(x, s, t, eps, out_dtype)
