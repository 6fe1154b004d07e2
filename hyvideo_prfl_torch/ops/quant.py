"""W8A8 int8 dense path (hyvideo_prfl_tpu/ops/quant.py).

The symmetric absmax recipe of the JAX package:

  weights      int8 with one fp32 scale per output channel, reduced over
               the contraction axis (torch's [out, in] weight: dim -1)
  activations  int8 with one dynamic fp32 scale per token (absmax over the
               features)
  product      int8 x int8 -> int32, rescaled in fp32: y = o * (xs * ws) + b

Rounding is half to even (``torch.round`` and ``jnp.round`` agree), then a
clip to +-127. The JAX package leaves the product to XLA, outside any
Pallas kernel; here it goes to ``torch._int_mm``, on the card and on the
CPU alike. The int8 weight is stored [out, in], so ``weight_q.t()`` is the
column-major operand cuBLAS's int8 GEMM takes, with no copy. The
quantization and rescale around the product are plain PyTorch, as they are
XLA work in the JAX package.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def over_127(a: torch.Tensor) -> torch.Tensor:
    """a / 127, correctly rounded on every device. CUDA turns a division by
    a Python number into a product with its reciprocal, which can differ in
    the last bit, and a scale off by one bit moves values across a rounding
    step; a divisor tensor on a's device keeps the true division."""
    return a / torch.full((), 127.0, device=a.device)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of a dense weight.

    w: [..., out, in] float. Returns (q int8 of w's shape, scale fp32
    [..., out])."""
    wf = w.float()
    s = over_127(wf.abs().amax(dim=-1)).clamp_min(EPS)
    q = torch.round(wf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_tokens(x: torch.Tensor):
    """Per-token symmetric int8 quantization: x [..., D] float ->
    (x8 int8 [..., D], xs fp32 [..., 1]). An all-zero token gets scale EPS
    and quantizes to exact zeros."""
    xf = x.float()
    xs = over_127(xf.abs().amax(dim=-1, keepdim=True)).clamp_min(EPS)
    return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs


def int8_dense(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
               bias: torch.Tensor = None, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(wq, ws)^T + bias through an int8 GEMM.

    x [..., D] float; wq [F, D] int8; ws [F] fp32; bias [F] or None.
    Returns [..., F] in out_dtype (default x's dtype)."""
    x8, xs = quantize_tokens(x)
    lead = x.shape[:-1]
    o = torch._int_mm(x8.reshape(-1, x.shape[-1]), wq.t())
    y = o.reshape(*lead, wq.shape[0]).float() * (xs * ws)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)
