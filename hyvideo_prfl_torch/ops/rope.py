"""Standalone rolled rope, R (hyvideo_prfl_tpu/ops/rope_pallas.py).

With the expanded tables C = [cos | cos], S = [-sin | sin] ([L, D] fp32,
models/rope.rope_tables_rolled_np), the half-layout rotation is

    out = x * C + roll(x, D/2) * S        x [B, L, N, D] bf16 or fp32

computed in fp32 and written in x's dtype. The op is linear in x, so its
backward is the same function with S_bwd = roll(S, D/2) = [sin | -sin], as
the JAX ``custom_vjp`` has it. The un-normed DiT self-attention rotates its
q and k with it (the qk-normed one has the rope inside K6). A CUDA tensor
runs kernel R (csrc/rope.cu) forward and backward; a CPU tensor runs the
plain version below.
"""

from __future__ import annotations

import torch

from . import _build


def rope_rotate_plain(x, c_tab, s_tab):
    """Unfused reference: fp32 x C + roll(x, D/2) S, cast to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    rolled = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * c_tab[None, :, None, :] + rolled * s_tab[None, :, None, :]).to(x.dtype)


def rope_kernel(x, c_tab, s_tab):
    """Launch R on CUDA tensors -> rope_rotate_plain(x, c_tab, s_tab)."""
    _build.plain(x, c_tab, s_tab)
    b, l, n, d = x.shape
    _build.require(d == 128, f"R takes head_dim 128, got {d}")
    _build.require(x.dtype in (torch.bfloat16, torch.float32),
                   f"R takes bf16 or fp32 x, got {x.dtype}")
    _build.require(x.device.type == "cuda" and c_tab.device == x.device
                   and s_tab.device == x.device, "x and the tables must be on one CUDA device")
    for t, name in ((c_tab, "C"), (s_tab, "S")):
        _build.require(t.shape == (l, d) and t.dtype == torch.float32,
                       f"R: the {name} table must be fp32 [{l}, {d}]")
    _build.require(all(t.is_contiguous() for t in (x, c_tab, s_tab))
                   and _build.aligned16(x, c_tab, s_tab),
                   "R takes contiguous, 16-byte aligned x and tables")
    out = torch.empty_like(x)
    err = _build.lib().hyv_rope(x.data_ptr(), c_tab.data_ptr(), s_tab.data_ptr(),
                                out.data_ptr(), b * l * n, l, n,
                                int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "R")
    return out


def _rotate(x, c_tab, s_tab):
    if x.device.type == "cpu":
        return rope_rotate_plain(x, c_tab, s_tab)
    _build.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    return rope_kernel(x.contiguous(), c_tab, s_tab)


class _RopeRotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c_tab, s_tab):
        ctx.save_for_backward(c_tab, s_tab)
        return _rotate(x, c_tab, s_tab)

    @staticmethod
    def backward(ctx, g):
        c_tab, s_tab = ctx.saved_tensors
        s_bwd = torch.roll(s_tab, s_tab.shape[-1] // 2, dims=-1).contiguous()
        return _rotate(g, c_tab, s_bwd), None, None


def rope_rotate(x, c_tab, s_tab):
    """x [B, L, N, D] (bf16/fp32) -> rotated, same dtype; differentiable in
    x. Tables [L, D] fp32 (no gradient)."""
    return _RopeRotate.apply(x, c_tab.float(), s_tab.float())
