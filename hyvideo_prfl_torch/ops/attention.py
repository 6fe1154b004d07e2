"""Attention dispatch for the video DiT (hyvideo_prfl_tpu/ops/attention.py).

The DiT calls attention with q and k head-major from the qk-norm kernel and
bounded logits. On a CUDA tensor that always runs a kernel: K1 when lk,
padded to 128, exceeds FULL_K_MAX (self-attention), K3 otherwise (text
cross-attention), or K10 for a streaming self-attention under
``qk_int8``. On a CPU tensor it runs the plain versions. The XLA backend
and the multi-device wrappers of the JAX module are not ported yet.
"""

from __future__ import annotations

from .flash_attention import flash_attention


def dot_product_attention(q, k, v, qk_layout: str = "bnld",
                          bounded_logits: bool = True, qk_int8: bool = False):
    """Multi-head attention. q, k: [B, N, L, D]; v: [B, Lk, N, D].
    Returns [B, Lq, N, D] in v's dtype."""
    return flash_attention(q, k, v, qk_layout=qk_layout,
                           bounded_logits=bounded_logits, qk_int8=qk_int8)
