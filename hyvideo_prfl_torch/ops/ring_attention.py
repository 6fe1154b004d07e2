"""Ring attention and USP, ring x Ulysses (hyvideo_prfl_tpu/ops/ring_attention.py).

Ring attention keeps each rank's queries and rotates the key/value blocks
around a ring of ranks: at hop h rank r holds the keys of rank r - h,
attends its queries to them with the flash forward (``_block_attention_with_lse``:
K1/K3, or K2/K3s on the shifted route, on the card) and merges the hop's
normalised output into its running one by the log-sum-exp (``_merge``, the
JAX online merge; o accumulates in fp32 and is cast to q's dtype at the
end). No rank holds more than L / ring keys.

The backward is a ``torch.autograd.Function`` (the JAX custom VJP), so
memory stays O(L / ring): it saves q, k, v, the global o and the global
lse, re-rotates the key/value blocks and runs the flash backward of each
hop (``_block_bwd``: K4 or K5 by the JAX route rule) against the global o
and lse, whose p are the globally normalised probabilities, so the hops'
partial gradients sum to the full attention's. dq sums locally in fp32;
the dk/dv partials (fp32) ride the same rotation as their blocks, and one
last rotation brings each block's dk/dv home.

The rotation is the only collective, and a parameter of the hop loops
(``ring_forward``/``ring_backward``): ``DistRing`` sends each block to the
next rank of a process group with ``dist.batch_isend_irecv`` (gloo and
NCCL); ``LocalRing`` runs r virtual ranks in one process, each a token
block of one tensor, so one card holds the ring's hops against the
whole-sequence kernels. The kernels take every q row as it is: the rows
past lq that the TPU code pads (with an lse of 1e9) do not exist here.

USP (``usp_attention``, the xfuser topology): the tokens are split over
ring x Ulysses ranks, rank (r, u) holding block r * ulysses + u. Per head
chunk (``ulysses_chunks``) an all-to-all over the Ulysses ranks trades
tokens for heads, ring attention runs over the ring ranks, and the
inverse all-to-all returns the tokens. At ring degree 1 it is
``ulysses_attention`` (K10 allowed under ``qk_int8``); above, the int8 q k^T
is not used, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from . import flash_attention as fa


class LocalRing:
    """``size`` virtual ranks in one process: rank r holds token block r
    of each tensor, and a rotation moves every block to the next rank."""

    def __init__(self, size: int):
        self.size = size

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        if x.shape[dim] % self.size:
            raise ValueError(f"{x.shape[dim]} tokens do not divide by the ring of {self.size}")
        return list(x.chunk(self.size, dim))

    @staticmethod
    def join(xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(xs), dim)

    @staticmethod
    def rotate(*blocks: List[torch.Tensor]):
        """Each list's block of rank r - 1 to rank r."""
        return tuple([xs[-1], *xs[:-1]] for xs in blocks)


class DistRing:
    """This rank's place in a ring of processes (a torch.distributed group):
    it holds one token block, sends it to the next rank and receives the
    previous rank's."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (rank - 1) % self.size)

    @staticmethod
    def split(x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return [x]

    @staticmethod
    def join(xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def rotate(self, *blocks: List[torch.Tensor]):
        """One exchange for all of ``blocks`` (each a one-element list)."""
        sends = [xs[0].contiguous() for xs in blocks]
        recvs = [torch.empty_like(x) for x in sends]
        ops = [dist.P2POp(dist.isend, x, self.next, self.group) for x in sends]
        ops += [dist.P2POp(dist.irecv, x, self.prev, self.group) for x in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple([x] for x in recvs)


def _block_attention_with_lse(q, k, v, bounded: bool):
    """One hop: q [B, N, Lq, D] and k [B, N, Lk, D] head-major, v [B, Lk, N,
    D] -> (o fp32 [B, Lq, N, D], lse fp32 [B*N, Lq], natural log). The
    dispatch of ``flash_attention``: K3 (K3s shifted) while the hop's keys
    fit FULL_K_MAX, else K1 (K2); the plain versions on the CPU."""
    if q.device.type == "cpu":
        o, lse = (fa.flash_attention_plain(q, k, v) if bounded
                  else fa.flash_attention_shifted_plain(q, k, v))
    else:
        o, lse = fa.flash_fwd_kernel(q, k, v, fa.uses_single_block(k.shape[2]), not bounded)
    return o.float(), lse


def _rows(lse: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """[B*N, Lq] -> [B, Lq, N, 1], to weight o's rows."""
    return lse.view(b, n, -1).transpose(1, 2)[..., None]


def _merge(o_acc, lse_acc, o_blk, lse_blk):
    """The online merge of two normalised partials (fp32) -> (o, lse)."""
    b, _, n, _ = o_acc.shape
    m = torch.maximum(lse_acc, lse_blk)
    w_acc, w_blk = torch.exp(lse_acc - m), torch.exp(lse_blk - m)
    denom = w_acc + w_blk
    o = (o_acc * _rows(w_acc, b, n) + o_blk * _rows(w_blk, b, n)) / _rows(denom, b, n)
    return o, m + torch.log(denom)


def _block_bwd(q, k, v, o, lse, do):
    """One hop's gradients against the global o and lse -> (dq [B, N, Lq,
    D], dk [B, N, Lk, D], dv [B, Lk, N, D]) in the inputs' dtypes: K4 or K5
    by ``uses_merged_bwd`` (the JAX ``_flash_bwd`` dispatch), the plain
    backward on the CPU."""
    if q.device.type == "cpu":
        return fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    return fa.bwd_kernel(q, k, v, o, lse.contiguous(), do,
                         fa.uses_merged_bwd(q.shape[2], k.shape[2]))


def ring_forward(qs, ks, vs, rotate, hops: int, bounded: bool):
    """The forward of every rank this process holds (lists of blocks):
    ``hops`` hops, the key/value blocks rotated between them -> (o per
    rank in q's dtype, global lse per rank)."""
    acc = [_block_attention_with_lse(q, k, v, bounded) for q, k, v in zip(qs, ks, vs)]
    for _ in range(hops - 1):
        ks, vs = rotate(ks, vs)
        acc = [_merge(*a, *_block_attention_with_lse(q, k, v, bounded))
               for a, q, k, v in zip(acc, qs, ks, vs)]
    return [o.to(q.dtype) for (o, _), q in zip(acc, qs)], [lse for _, lse in acc]


def ring_backward(qs, ks, vs, os_, lses, dos, rotate, hops: int):
    """The backward of every rank this process holds -> (dq, dk, dv) per
    rank in the inputs' dtypes; dq sums in fp32 locally, the fp32 dk/dv
    partials travel with their blocks and one last rotation brings them
    home."""
    dq, dk, dv = [], [], []
    for q, k, v, o, lse, do in zip(qs, ks, vs, os_, lses, dos):
        g = _block_bwd(q, k, v, o, lse, do)
        dq.append(g[0].float())
        dk.append(g[1].float())
        dv.append(g[2].float())
    for _ in range(hops - 1):
        ks, vs, dk, dv = rotate(ks, vs, dk, dv)
        for i, (q, k, v, o, lse, do) in enumerate(zip(qs, ks, vs, os_, lses, dos)):
            g = _block_bwd(q, k, v, o, lse, do)
            dq[i] += g[0]
            dk[i] += g[1]
            dv[i] += g[2]
    if hops > 1:
        dk, dv = rotate(dk, dv)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)], [g.to(k.dtype) for g, k in zip(dk, ks)],
            [g.to(v.dtype) for g, v in zip(dv, vs)])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, bounded):
        qs, ks, vs = ring.split(q, 2), ring.split(k, 2), ring.split(v, 1)
        os_, lses = ring_forward(qs, ks, vs, ring.rotate, ring.size, bounded)
        o, lse = ring.join(os_, 1), ring.join(lses, 1)
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring = ctx.ring
        dq, dk, dv = ring_backward(ring.split(q, 2), ring.split(k, 2), ring.split(v, 1),
                                   ring.split(o, 1), ring.split(lse, 1),
                                   ring.split(do.contiguous(), 1), ring.rotate, ring.size)
        return ring.join(dq, 2), ring.join(dk, 2), ring.join(dv, 1), None, None


def ring_attention(q, k, v, ring, qk_layout: str = "blnd", bounded_logits: bool = False):
    """Attention over the ring's whole key range, differentiable in q, k, v.

    q, k: [B, L, N, D] token-major (or [B, N, L, D] with qk_layout="bnld");
    v [B, L, N, D]; ``ring`` a DistRing (this rank's token block) or a
    LocalRing (the whole sequence, split into its virtual ranks). Returns
    o [B, L, N, D] in v's dtype. The bounded softmax under
    ``bounded_logits`` (and HYV_FLASH_BOUNDED), else the shifted one, as
    ``flash_attention`` chooses."""
    if qk_layout not in ("blnd", "bnld"):
        raise ValueError(f"qk_layout must be 'blnd' or 'bnld', got {qk_layout!r}")
    if qk_layout == "blnd":
        q, k = q.movedim(1, 2), k.movedim(1, 2)
    return _RingAttention.apply(q, k, v, ring, bool(bounded_logits and fa.FLASH_BOUNDED))


def usp_attention(q, k, v, sp, qk_layout: str = "blnd", bounded_logits: bool = False,
                  qk_int8: bool = False):
    """USP self-attention over this rank's token block (parallel/sharding
    SeqParallel with a ring): q, k [B, L/(r u), N, D] (head-major with
    "bnld"), v [B, L/(r u), N, D] -> [B, L/(r u), N, D]. Per head chunk the
    Ulysses all-to-all, ring attention over the ring, the inverse
    all-to-all. Without a ring it is ``ulysses_attention``."""
    from .attention import ulysses_attention, ulysses_chunks

    if sp is None or sp.ring is None:
        return ulysses_attention(q, k, v, sp, qk_layout=qk_layout,
                                 bounded_logits=bounded_logits, qk_int8=qk_int8)
    u = sp.ulysses_size
    bnld = qk_layout == "bnld"
    qk_heads, qk_tokens = (1, 2) if bnld else (2, 1)
    n = v.shape[2]
    c = ulysses_chunks(n, u, sp.chunks)
    outs = []
    for i in range(c):
        lo, w = i * n // c, n // c
        qh, kh, vh = q.narrow(qk_heads, lo, w), k.narrow(qk_heads, lo, w), v.narrow(2, lo, w)
        if u > 1:
            qh = sp.all_to_all(qh, qk_heads, qk_tokens)
            kh = sp.all_to_all(kh, qk_heads, qk_tokens)
            vh = sp.all_to_all(vh, 2, 1)
        o = ring_attention(qh, kh, vh, sp.ring, qk_layout=qk_layout,
                           bounded_logits=bounded_logits)
        outs.append(sp.all_to_all(o, 1, 2) if u > 1 else o)
    return outs[0] if c == 1 else torch.cat(outs, dim=2)
