"""Attention dispatch for the video DiT (hyvideo_prfl_tpu/ops/attention.py).

The JAX signature and defaults: q and k token-major [B, L, N, D] unless
``qk_layout="bnld"`` (the qk-norm kernel's head-major output), the shifted
softmax unless the caller asserts bounded logits. On a CUDA tensor every
call runs a kernel (ops/flash_attention.py): K1/K3 bounded, K2/K3s shifted
(any key mask, any un-normed caller, every call under HYV_FLASH_BOUNDED=0),
K10 for a bounded streaming self-attention under ``qk_int8``. On a CPU
tensor it runs the plain versions. The XLA backend and the multi-device
wrappers of the JAX module are not ported yet.
"""

from __future__ import annotations

from .flash_attention import flash_attention


def dot_product_attention(q, k, v, k_valid_len=None, qk_layout: str = "blnd",
                          bounded_logits: bool = False, qk_int8: bool = False):
    """Multi-head attention. q, k: [B, L, N, D] (or [B, N, L, D] with
    qk_layout="bnld"); v: [B, Lk, N, D]; k_valid_len: optional [B] key
    counts. Returns [B, Lq, N, D] in v's dtype."""
    return flash_attention(q, k, v, k_valid_len=k_valid_len, qk_layout=qk_layout,
                           bounded_logits=bounded_logits, qk_int8=qk_int8)
