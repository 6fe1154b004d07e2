"""Attention dispatch for the video DiT (hyvideo_prfl_tpu/ops/attention.py).

The JAX signature and defaults: q and k token-major [B, L, N, D] unless
``qk_layout="bnld"`` (the qk-norm kernel's head-major output), the shifted
softmax unless the caller asserts bounded logits. On a CUDA tensor every
call runs a kernel (ops/flash_attention.py): K1/K3 bounded, K2/K3s shifted
(any key mask, any un-normed caller, every call under HYV_FLASH_BOUNDED=0),
K10 for a bounded streaming self-attention under ``qk_int8``. On a CPU
tensor it runs the plain versions.

Sequence parallelism gives each rank a block of the tokens
(parallel/sharding.SeqParallel). The self-attention goes through
``ulysses_attention`` (an all-to-all trades tokens for heads, the per-rank
kernel sees the whole sequence for 1/sp of the heads, and the inverse
exchange returns the tokens). The cross-attention on a token shard is the
plain call: each rank's queries against the replicated context, with no
collective (the JAX ``token_parallel_attention``). The replicated k/v
receive this rank's share of their gradient; the sum over the sp ranks,
which JAX's shard_map transpose inserts as a psum, happens in the
gradient reduction of the parameters behind them (parallel/sharding.py).
The XLA backend of the JAX module is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .flash_attention import flash_attention


def dot_product_attention(q, k, v, k_valid_len=None, qk_layout: str = "blnd",
                          bounded_logits: bool = False, qk_int8: bool = False):
    """Multi-head attention. q, k: [B, L, N, D] (or [B, N, L, D] with
    qk_layout="bnld"); v: [B, Lk, N, D]; k_valid_len: optional [B] key
    counts. Returns [B, Lq, N, D] in v's dtype."""
    return flash_attention(q, k, v, k_valid_len=k_valid_len, qk_layout=qk_layout,
                           bounded_logits=bounded_logits, qk_int8=qk_int8)


def ulysses_chunks(n_heads: int, sp: int, chunks: Optional[int] = None) -> int:
    """Head chunks of the Ulysses exchange (``chunks``, else
    HYV_ULYSSES_CHUNKS; 1 = one exchange): clamped so every chunk keeps at
    least one head per rank, and lowered until sp * chunks divides the
    heads. The JAX clamping."""
    c = int(chunks if chunks is not None else os.environ.get("HYV_ULYSSES_CHUNKS", "1"))
    if c <= 1:
        return 1
    c = min(c, n_heads // sp) if sp > 0 else c
    while c > 1 and n_heads % (sp * c):
        c -= 1
    return max(c, 1)


def ulysses_attention(q, k, v, sp, qk_layout: str = "blnd", bounded_logits: bool = False,
                      qk_int8: bool = False):
    """Ulysses sequence-parallel attention over this rank's tokens: q, k
    [B, L/sp, N, D] (head-major [B, N, L/sp, D] with "bnld", as the
    qk-norm kernel writes them) and v [B, L/sp, N, D] -> [B, L/sp, N, D].

    Each head chunk (``ulysses_chunks``; identical numbers, heads are
    independent) goes through an all-to-all that scatters its heads and
    gathers the sequence, the per-rank kernel on the whole sequence, and
    the inverse all-to-all. The exchange keeps q and k head-major, the
    kernel's own layout, where the JAX sandwich moves them token-major
    first; the values are the same. At degree 1 it is the plain call."""
    size = 1 if sp is None else sp.size
    if size == 1:
        return dot_product_attention(q, k, v, qk_layout=qk_layout,
                                     bounded_logits=bounded_logits, qk_int8=qk_int8)
    bnld = qk_layout == "bnld"
    qk_heads, qk_tokens = (1, 2) if bnld else (2, 1)
    n = v.shape[2]
    c = ulysses_chunks(n, size, sp.chunks)
    outs = []
    for i in range(c):
        lo, w = i * n // c, n // c
        qh = sp.all_to_all(q.narrow(qk_heads, lo, w), qk_heads, qk_tokens)
        kh = sp.all_to_all(k.narrow(qk_heads, lo, w), qk_heads, qk_tokens)
        vh = sp.all_to_all(v.narrow(2, lo, w), 2, 1)
        o = dot_product_attention(qh, kh, vh, qk_layout=qk_layout,
                                  bounded_logits=bounded_logits, qk_int8=qk_int8)
        outs.append(sp.all_to_all(o, 1, 2))
    return outs[0] if c == 1 else torch.cat(outs, dim=2)

