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

import dataclasses
import functools

import torch

from . import _build

# K8 and K9 take every multiple of 128 up to this width (the JAX kernels
# take every multiple of 128). K8: narrow rows are a warp's, wide ones a
# block's (csrc/row_norm.cuh); K9: S warps a row on a persistent grid
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
    _build.plain(x, s, t)
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


# K9's persistent grid (csrc/ln_scale_shift_bwd.cu), computed here so the
# wrapper allocates from it and a CPU test can check it; the kernel checks
# what it is given against the same limits
K9_WARPS = 8            # consumer warps a block; a ninth issues the copies
K9_MAX_GROUPS = 8       # 128-feature groups a lane takes per row
K9_MAX_STAGES = 8
K9_SMEM_MAX = 227 * 1024
K9_HEADER = 1024        # barriers and row-sum slots, before s[b] and the ds/dt region
K9_IN_FLIGHT = 48 * 1024  # bytes of x and g a block keeps loading (at least 2 stages)


@dataclasses.dataclass(frozen=True)
class K9Geometry:
    """Tiles of ``T`` rows of one batch element, ``S`` warps a row, a ring
    of ``stages`` stages from byte ``ring`` of shared memory; block i owns
    tiles ``run(i)``, and its ds/dt partial for batch element b lies in
    slot i + b of ``slots``."""

    b: int
    l: int
    d: int
    S: int
    T: int
    stages: int
    stage_bytes: int
    ring: int
    smem: int
    tiles_per_b: int
    tiles: int
    grid: int

    @property
    def slots(self) -> int:
        return self.grid + self.b - 1

    def run(self, i: int) -> range:
        return range(i * self.tiles // self.grid, (i + 1) * self.tiles // self.grid)

    def rows(self, tile: int):
        """(b, first row, row count) of a tile."""
        b, k = divmod(tile, self.tiles_per_b)
        return b, k * self.T, min(self.T, self.l - k * self.T)

    def owner(self, tile: int) -> int:
        return ((tile + 1) * self.grid - 1) // self.tiles

    def blocks_of(self, b: int) -> range:
        """The blocks whose runs hold rows of batch element b, in order."""
        return range(self.owner(b * self.tiles_per_b),
                     self.owner((b + 1) * self.tiles_per_b - 1) + 1)


def k9_geometry(b: int, l: int, d: int, g_bytes: int, sms: int) -> K9Geometry:
    """K9's partition of a call: the fewest warps per row S (1, 2, 4 or 8)
    that leave a lane at most K9_MAX_GROUPS groups, T = 8 / S rows a tile
    (at most L), and stages enough to keep K9_IN_FLIGHT bytes loading, at
    least two (on the H100 a deeper ring was slower at every width
    measured), after the header, s[b] and the [2, D] region where the row
    groups add their ds/dt partials; one block per SM at most."""
    _build.require(_has_instance(d) and b * l > 0 and sms > 0 and g_bytes in (2, 4),
                   f"K9 has no partition for [{b}, {l}, {d}]")
    groups = d // 128
    S = 1
    while -(-groups // S) > K9_MAX_GROUPS:
        S *= 2
    T = min(K9_WARPS // S, l)
    ring = K9_HEADER + 4 * d + (8 * d if T > 1 else 0)
    stage_bytes = T * d * (4 + g_bytes)
    stages = min(K9_MAX_STAGES, (K9_SMEM_MAX - ring) // stage_bytes,
                 max(2, -(-K9_IN_FLIGHT // stage_bytes)))
    tiles_per_b = -(-l // T)
    tiles = b * tiles_per_b
    return K9Geometry(b, l, d, S, T, stages, stage_bytes, ring, ring + stages * stage_bytes,
                      tiles_per_b, tiles, min(tiles, sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one word per (device, stream) for K9's grid-wide ticket: zero at first,
# and the kernel leaves it so
_K9_SYNC: dict = {}


def _k9_sync(device):
    key = (device.index, _build.stream_ptr(device))
    if key not in _K9_SYNC:
        _K9_SYNC[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _K9_SYNC[key]


def bwd_kernel(x, s, g, eps):
    """Launch K9 on CUDA tensors -> (dx, ds, dt) as ln_scale_shift_bwd_plain."""
    _build.plain(x, s, g)
    b, l, d = x.shape
    _check_rows(x, s, "K9")
    _build.require(_has_instance(d), f"K9 has no instance for D={d}")
    _build.require(g.shape == x.shape and g.dtype in (torch.bfloat16, torch.float32),
                   f"K9: g must be bf16 or fp32 {tuple(x.shape)}")
    _build.require(g.device == x.device and g.is_contiguous() and _build.aligned16(g),
                   "K9 takes a contiguous, 16-byte aligned g on x's device")
    dx = torch.empty_like(x)
    if b * l == 0:
        return dx, x.new_zeros(b, d), x.new_zeros(b, d)
    geo = k9_geometry(b, l, d, g.element_size(), _sm_count(x.device.index))
    ds = torch.empty((b, d), dtype=torch.float32, device=x.device)
    dt = torch.empty_like(ds)
    part = torch.empty((geo.slots, 2, d), dtype=torch.float32, device=x.device)
    err = _build.lib().hyv_ln_scale_shift_bwd(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(), part.data_ptr(),
        ds.data_ptr(), dt.data_ptr(), _k9_sync(x.device).data_ptr(), b, l, d, float(eps),
        int(g.dtype == torch.bfloat16), geo.S, geo.T, geo.stages, geo.ring, geo.grid,
        _build.stream_ptr(x.device))
    _build.check(err, "K9")
    return dx, ds, dt


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
