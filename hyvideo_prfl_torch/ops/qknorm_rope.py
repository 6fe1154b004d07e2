"""Fused qk-RMSNorm + rolled-half RoPE (hyvideo_prfl_tpu/ops/qknorm_rope.py).

Layout contract, as in the JAX package: x [B, L, N*D] (the q/k projection
output) -> [B, N, L, D] (the attention kernel's q/k layout).

    r   = rsqrt(mean(x^2 over all N*D) + eps)       fp32
    t   = bf16(x * r) * bf16(w)
    out = bf16(f32(t) * C + roll(f32(t), D/2) * S)  (rmsnorm_rope only)

The op is a ``torch.autograd.Function`` (the JAX package's ``custom_vjp``)
that saves (x, w, C, S) and recomputes r in its backward. A CUDA tensor
runs kernel K6 (csrc/qknorm_rope.cu) forward and K7
(csrc/qknorm_rope_bwd.cu) backward; a CPU tensor runs the plain versions
below, the same math as the JAX package's ``_xla_ref`` and ``_bwd_kernel``.
"""

from __future__ import annotations

import torch

from . import _build

# K6 and K7 take head_dim 128 and every head count up to this one (the JAX
# kernels take any); narrow rows are a warp's, wide ones a block's
MAX_HEADS = 64


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


def rmsnorm_rope_bwd_plain(x, w, c_tab, s_tab, g, num_heads: int, eps: float = 1e-6,
                           do_rope: bool = True):
    """The backward written out -> (dx [B, L, N*D] in x's dtype, dw fp32 [N*D]).

    g is the head-major cotangent [B, N, L, D]:

        du = g * C + roll(g, D/2) * roll(S, D/2)     (du = g without rope)
        dx = r * du * w - x * r^3 * mean(du * w * x)
        dw = sum_{B, L} du * bf16(x * r)             (the forward's rounding)
    """
    b, l, m = x.shape
    d = m // num_heads
    gf = g.float().movedim(1, 2)  # [B, L, N, D]
    if do_rope:
        half = d // 2
        g_roll = torch.cat([gf[..., half:], gf[..., :half]], dim=-1)
        s_roll = torch.cat([s_tab[:, half:], s_tab[:, :half]], dim=-1)
        du = gf * c_tab[None, :, None, :] + g_roll * s_roll[None, :, None, :]
    else:
        du = gf
    du = du.reshape(b, l, m)
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dt = du * w.float().reshape(1, 1, m)
    r3dot = (r * r * r) * (dt * xf).mean(dim=-1, keepdim=True)
    dx = r * dt - xf * r3dot
    dw = (du * (xf * r).to(x.dtype).float()).sum(dim=(0, 1))
    return dx.to(x.dtype), dw


def _kernel(x, w, c_tab, s_tab, num_heads, eps, do_rope):
    _build.plain(x, w, c_tab, s_tab)
    b, l, m = x.shape
    n = num_heads
    d = m // n
    _build.require(x.dtype == torch.bfloat16, f"K6 takes bf16 x, got {x.dtype}")
    _build.require(d == 128 and 1 <= n <= MAX_HEADS, f"K6 has no instance for {n} heads of {d}")
    w = w.float().contiguous()
    _build.require(x.is_contiguous() and _build.aligned16(x, w),
                   "K6 takes contiguous, 16-byte aligned x and w")
    _build.require(w.numel() == m and w.device == x.device, "K6: w must be [N*D] on x's device")
    if do_rope:
        _check_tables(c_tab, s_tab, x, l, d, "K6")
        c_ptr, s_ptr = c_tab.data_ptr(), s_tab.data_ptr()
    else:
        c_ptr = s_ptr = None
    out = torch.empty((b, n, l, d), dtype=x.dtype, device=x.device)
    err = _build.lib().hyv_rmsnorm_rope(
        x.data_ptr(), w.data_ptr(), c_ptr, s_ptr, out.data_ptr(), b, l, n, d,
        float(eps), int(do_rope), _build.stream_ptr(x.device))
    _build.check(err, "K6")
    return out


def _check_tables(c_tab, s_tab, x, l, d, name):
    _build.require(c_tab.shape == (l, d) and s_tab.shape == (l, d),
                   f"{name}: tables must be [{l}, {d}]")
    _build.require(c_tab.dtype == torch.float32 and s_tab.dtype == torch.float32
                   and c_tab.is_contiguous() and s_tab.is_contiguous()
                   and _build.aligned16(c_tab, s_tab)
                   and c_tab.device == x.device and s_tab.device == x.device,
                   f"{name}: tables must be contiguous, aligned fp32 on x's device")


def bwd_kernel(x, w, c_tab, s_tab, g, num_heads, eps, do_rope):
    """Launch K7 on CUDA tensors -> (dx, dw) as rmsnorm_rope_bwd_plain."""
    _build.plain(x, w, c_tab, s_tab, g)
    b, l, m = x.shape
    n = num_heads
    d = m // n
    _build.require(x.dtype == torch.bfloat16 and g.dtype == torch.bfloat16,
                   f"K7 takes bf16 x and g, got {x.dtype} and {g.dtype}")
    _build.require(d == 128 and 1 <= n <= MAX_HEADS, f"K7 has no instance for {n} heads of {d}")
    _build.require(g.shape == (b, n, l, d), f"K7: g must be [{b}, {n}, {l}, {d}]")
    w = w.float().contiguous()
    _build.require(w.numel() == m and w.device == x.device, "K7: w must be [N*D] on x's device")
    _build.require(x.is_contiguous() and g.is_contiguous() and g.device == x.device
                   and _build.aligned16(x, g, w),
                   "K7 takes contiguous, 16-byte aligned x, g and w on one device")
    if do_rope:
        _check_tables(c_tab, s_tab, x, l, d, "K7")
        c_ptr, s_ptr = c_tab.data_ptr(), s_tab.data_ptr()
    else:
        c_ptr = s_ptr = None
    lib = _build.lib()
    parts = lib.hyv_rmsnorm_rope_bwd_parts(b, l, n, int(do_rope))  # the grid
    dx = torch.empty_like(x)
    dw_part = torch.empty((parts, m), dtype=torch.float32, device=x.device)
    err = lib.hyv_rmsnorm_rope_bwd(
        x.data_ptr(), w.data_ptr(), c_ptr, s_ptr, g.data_ptr(), dx.data_ptr(),
        dw_part.data_ptr(), b, l, n, d, float(eps), int(do_rope), _build.stream_ptr(x.device))
    _build.check(err, "K7")
    # the second pass over the per-block partials, in a fixed order
    return dx, dw_part.sum(dim=0)


class _RmsNormRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, c_tab, s_tab, num_heads, eps, do_rope):
        ctx.save_for_backward(x, w, c_tab, s_tab)
        ctx.args = (num_heads, eps, do_rope)
        if x.device.type == "cpu":
            return rmsnorm_rope_plain(x, w, c_tab, s_tab, num_heads, eps, do_rope)
        _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")
        return _kernel(x, w, c_tab, s_tab, num_heads, eps, do_rope)

    @staticmethod
    def backward(ctx, g):
        x, w, c_tab, s_tab = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw = rmsnorm_rope_bwd_plain(x, w, c_tab, s_tab, g, *ctx.args)
        else:
            _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")
            dx, dw = bwd_kernel(x, w, c_tab, s_tab, g.contiguous(), *ctx.args)
        return dx, dw.to(w.dtype).reshape(w.shape), None, None, None, None, None


def rmsnorm_rope(x, w, c_tab, s_tab, num_heads: int, eps: float = 1e-6):
    """Fused full-dim RMSNorm + rolled-table rope, differentiable in x and w.

    x: [B, L, dim]; w: [dim]; tables [L, D] fp32. Returns [B, N, L, D]."""
    return _RmsNormRope.apply(x, w, c_tab, s_tab, num_heads, eps, True)


def rmsnorm_only(x, w, num_heads: int, eps: float = 1e-6):
    """Fused full-dim RMSNorm over [B, L, dim] -> [B, N, L, D] (the
    cross-attention q/k norms, which have no rope), differentiable."""
    return _RmsNormRope.apply(x, w, None, None, num_heads, eps, False)
