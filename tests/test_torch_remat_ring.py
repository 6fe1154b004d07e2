"""The ring on one process and the matmul-keeping remat policies, on the CPU.

Ring attention with r virtual ranks (ops/ring_attention.LocalRing: the
hops, the merge and the ring backward that chip_smoke.py runs on one card)
against the whole-sequence attention and against the JAX ring body's
plain math; the remat policies "dots" and "dots_all" (the JAX package's
dots_with_no_batch_dims_saveable and dots_saveable) give the gradients of
"full" and "attn" bit for bit, and keep the matmul outputs they name. The
ring across processes and USP ride the gloo spawns of
tests/test_torch_parallel.py.
"""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hyvideo_prfl_tpu.ops import ring_attention as jring
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import ring_attention as tring
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128


def _qkvg(seed, dtype=torch.float32, shape=(2, 96, 3, 128)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("bounded", [True, False])
def test_local_ring_matches_the_whole_attention(ring, bounded):
    """fp32: the ring's output and gradients equal the single call's (the
    same plain hops, merged) to 1e-5 of each tensor's largest."""
    q, k, v, g = _qkvg(ring + 2 * bounded)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tring.ring_attention(*xs, tring.LocalRing(ring), bounded_logits=bounded)
    (out * g).sum().backward()
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = tfa.flash_attention(*ys, bounded_logits=bounded)
    (want * g).sum().backward()
    for got, ref in [(out, want)] + [(a.grad, b.grad) for a, b in zip(xs, ys)]:
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.detach().abs().max()))


def test_local_ring_bf16_and_the_jax_block_math():
    """bf16 inputs (the card's dtype): each hop's block attention and
    backward against the JAX ring's plain _block_attention_with_lse and
    _block_bwd, and the bf16 ring against the fp32 whole attention to the
    bf16 rounding of its output."""
    q, k, v, g = _qkvg(7, torch.bfloat16, (1, 64, 2, 128))
    qh, kh = q.movedim(1, 2), k.movedim(1, 2)
    o, lse = tring._block_attention_with_lse(qh, kh, v, bounded=False)
    jo, jlse = jring._block_attention_with_lse(*(jnp.asarray(x.float().numpy())
                                                 for x in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-2)
    np.testing.assert_allclose(lse.view(1, 2, 64).transpose(1, 2).numpy(), np.asarray(jlse),
                               rtol=0, atol=2e-2)
    out = tring.ring_attention(q, k, v, tring.LocalRing(2), bounded_logits=True)
    ref = tfa.flash_attention(q.float(), k.float(), v.float(), bounded_logits=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=2e-2)
    dq, dk, dv = tring._block_bwd(qh, kh, v, o.to(v.dtype), lse, g)
    jdq, jdk, jdv = jring._block_bwd(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                     jnp.asarray(o.to(v.dtype).float().numpy()), jlse,
                                     jnp.asarray(g.float().numpy()))
    for got, want in ((dq.movedim(1, 2), jdq), (dk.movedim(1, 2), jdk), (dv, jdv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_dots_policies_give_equal_grads_and_keep_the_matmuls():
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    state = tck.from_jax_params(tck.seeded_jax_tree(cfg, 0), cfg)
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(1, 3, 8, 8, 16, generator=g), torch.randn(1, 16, 64, generator=g)
    grads, recomputed = {}, {}
    for policy in ("full", "attn", "dots", "dots_all"):
        model = tdit.WanModel(dataclasses.replace(cfg, remat_policy=policy),
                              param_dtype=torch.float32)
        model.load_state_dict(state)
        xi = x.clone().requires_grad_()
        loss = model(xi, torch.tensor([500.0]), ctx).square().mean()
        with _Count() as count:
            loss.backward()
        recomputed[policy] = count.ops
        grads[policy] = [xi.grad] + [p.grad for p in model.parameters()]
    for policy, gs in grads.items():
        # the recompute replays the same CPU ops, or reads what the forward kept
        for a, b in zip(gs, grads["full"]):
            assert torch.equal(a, b), policy
    # the blocks' dense layers (addmm) re-run under "full", not under the dots
    # policies; "dots_all" also keeps the plain attention's batched products
    assert recomputed["full"]["addmm"] > 0
    assert recomputed["dots"]["addmm"] == recomputed["dots_all"]["addmm"] == 0
    assert recomputed["dots_all"]["bmm"] < recomputed["dots"]["bmm"] == recomputed["full"]["bmm"]
