"""The Hopper kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
files.) chip_smoke.py makes the same comparisons at the serving slice's
full shapes; these cover small and ragged shapes, the launch counters and,
for the backward kernels, that the outputs stay in the autograd graph.
"""

import pytest
import torch

from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
from hyvideo_prfl_torch.ops import _build
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream

BF16_ULP = 2.0 ** -7  # one bf16 ulp at the top binade, relative to max|ref|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    return torch.device("cuda")


def _close(got, ref, ulps):
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= ulps * BF16_ULP * ref.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("l,out_dtype", [(36, torch.bfloat16), (4680, torch.bfloat16),
                                         (37, torch.float32)])
def test_k8_matches_plain(cuda, l, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, l, 1536, device=cuda, generator=g)
    s = 1 + 0.1 * torch.randn(2, 1536, device=cuda, generator=g)
    t = 0.1 * torch.randn(2, 1536, device=cuda, generator=g)
    before = _build.LAUNCHES["K8"]
    got = tstream.ln_scale_shift(x, s, t, out_dtype=out_dtype)
    assert _build.LAUNCHES["K8"] == before + 1
    # fp32 sums in another order: one bf16 ulp (and far less in fp32)
    _close(got, tstream.ln_scale_shift_plain(x, s, t, out_dtype=out_dtype), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("l,rope", [(36, True), (4680, True), (512, False)])
def test_k6_matches_plain(cuda, l, rope):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, l, 1536, device=cuda, generator=g).bfloat16()
    w = 1 + 0.1 * torch.randn(1536, device=cuda, generator=g)
    grid = {36: (3, 4, 3), 4680: (3, 30, 52), 512: (1, 16, 32)}[l]
    c, s = (torch.from_numpy(a).to(cuda) for a in rope_tables_rolled_np(grid, 128))
    before = _build.LAUNCHES["K6"]
    got = tqr.rmsnorm_rope(x, w, c, s, 12) if rope else tqr.rmsnorm_only(x, w, 12)
    assert _build.LAUNCHES["K6"] == before + 1
    # r in another summation order can flip bf16(x r), and rope adds two such
    # values: two bf16 ulps
    _close(got, tqr.rmsnorm_rope_plain(x, w, c, s, 12, do_rope=rope), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(100, 77), (4680, 512), (4680, 4680), (9360, 9360),
                                   (300, 4000)])
def test_flash_matches_plain(cuda, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 12, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 12, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16()
    name = "K3" if tfa.uses_single_block(lk) else "K1"
    before = _build.LAUNCHES[name]
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert _build.LAUNCHES[name] == before + 1
    po, plse = tfa.flash_attention_plain(q, k, v)
    # exp2 within 2 ulp of torch.exp2 can flip bf16(p); o rounds to bf16
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_flash_reads_strided_v_and_q(cuda):
    # q/k as views of a wider [B, L, N, D] buffer (no copy), v as the
    # natural [B, L, N, D] slice of a packed qkv projection
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(1, 300, 3, 4, 128, device=cuda, generator=g).bfloat16()
    q, k = qkv[:, :, 0].movedim(2, 1), qkv[:, :, 1].movedim(2, 1)
    v = qkv[:, :, 2]
    o = tfa.flash_attention(q, k, v)
    _close(o, tfa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())[0], 2)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 8, 1000, device=cuda)
    s = torch.ones(1, 1000, device=cuda)
    with pytest.raises(ValueError, match="no instance"):
        tstream.ln_scale_shift(x, s, s)
    with pytest.raises(ValueError, match="bf16"):
        tqr.rmsnorm_only(torch.randn(1, 8, 256, device=cuda), torch.ones(256, device=cuda), 2)
    q = torch.randn(1, 2, 8, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head_dim 128"):
        tfa.flash_attention(q, q, q.movedim(1, 2))
    q = torch.randn(1, 2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q, q, q.movedim(1, 2))
    x = torch.randn(1, 8 * 1536 + 2, device=cuda)[:, 2:].reshape(1, 8, 1536)  # 8 B off
    with pytest.raises(ValueError, match="aligned"):
        tstream.ln_scale_shift(x, torch.ones(1536, device=cuda), torch.zeros(1536, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(100, 77), (1024, 4680), (4680, 512), (4680, 4680)])
def test_flash_bwd_matches_plain(cuda, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 12, lq, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    k = torch.randn(1, 12, lk, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    v = torch.randn(1, lk, 12, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert o.grad_fn is not None  # the kernel's output stays in the graph
    do = torch.randn(o.shape, device=cuda, generator=g).bfloat16()
    name = "K4" if tfa.uses_merged_bwd(lq, lk) else "K5"
    before = _build.LAUNCHES[name]
    got = torch.autograd.grad(o, (q, k, v), do)
    assert _build.LAUNCHES[name] == before + 1
    ref = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), lse, do)
    # bf16(p), bf16(ds) and the bf16 outputs may round the other way (K4's
    # dq also adds in a run-dependent order): two bf16 ulps
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        _close(a, b, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("merged", [True, False])
def test_flash_bwd_routes_are_interchangeable(cuda, merged):
    # K4 and K5 compute the same gradients; only the dq reduction differs
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, 2, 777, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(1, 2, 300, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(1, 300, 2, 128, device=cuda, generator=g).bfloat16()
    o, lse = tfa.flash_fwd_kernel(q, k, v, single=True)
    do = torch.randn(o.shape, device=cuda, generator=g).bfloat16()
    got = tfa.bwd_kernel(q, k, v, o, lse, do, merged)
    for a, b in zip(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _close(a, b, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("l,rope", [(37, True), (4680, True), (512, False)])
def test_k7_matches_plain(cuda, l, rope):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, l, 1536, device=cuda, generator=g).bfloat16().requires_grad_()
    w = (1 + 0.1 * torch.randn(1536, device=cuda, generator=g)).requires_grad_()
    grid = {37: (1, 1, 37), 4680: (3, 30, 52)}.get(l)
    c, s = ((torch.from_numpy(a).to(cuda) for a in rope_tables_rolled_np(grid, 128))
            if rope else (None, None))
    y = tqr.rmsnorm_rope(x, w, c, s, 12) if rope else tqr.rmsnorm_only(x, w, 12)
    assert y.grad_fn is not None
    gy = torch.randn(y.shape, device=cuda, generator=g).bfloat16()
    before = _build.LAUNCHES["K7"]
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    assert _build.LAUNCHES["K7"] == before + 1
    rdx, rdw = tqr.rmsnorm_rope_bwd_plain(x.detach(), w.detach(), c, s, gy, 12, do_rope=rope)
    # dx: r in another order flips bf16 roundings, two ulps; dw: row sums
    # in another order and bf16(x r) flips, one ulp of max|dw|
    _close(dx, rdx, 2)
    _close(dw, rdw, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("l,out_dtype", [(36, torch.bfloat16), (4685, torch.bfloat16),
                                         (37, torch.float32)])
def test_k9_matches_plain(cuda, l, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, l, 1536, device=cuda, generator=g).requires_grad_()
    s = (1 + 0.1 * torch.randn(1536, device=cuda, generator=g)).requires_grad_()
    t = (0.1 * torch.randn(2, 1536, device=cuda, generator=g)).requires_grad_()
    y = tstream.ln_scale_shift(x, s, t, out_dtype=out_dtype)
    assert y.grad_fn is not None
    gy = torch.randn(y.shape, device=cuda, generator=g).to(out_dtype)
    before = _build.LAUNCHES["K9"]
    got = torch.autograd.grad(y, (x, s, t), gy)
    assert _build.LAUNCHES["K9"] == before + 1
    rdx, rds, rdt = tstream.ln_scale_shift_bwd_plain(x.detach(), s.detach().expand(2, -1), gy)
    # fp32 throughout; sums in another order: 1e-5 of each output's max
    for a, b in zip(got, (rdx, rds.sum(0), rdt)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
