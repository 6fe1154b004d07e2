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
from hyvideo_prfl_torch.ops import int8_probe
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import quant as tquant
from hyvideo_prfl_torch.ops import rope as trope
from hyvideo_prfl_torch.ops import stream as tstream

BF16_ULP = 2.0 ** -7  # one bf16 ulp at the top binade, relative to max|ref|
# head-major q/k with bounded logits, as the qk-normed DiT calls attention
BNLD_BOUNDED = dict(qk_layout="bnld", bounded_logits=True)


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


# (lq, lk) at the forward's tile and schedule edges: 128 q rows and 128 keys
# per tile, one tile per block up to the SM count, then several per block
FLASH_EDGES = [(1, 1), (129, 127), (4680, 128), (4680, 129), (300, 769), (200, 3584)]
# streaming key ranges (past FULL_K_MAX) whose last tile holds 1, 80, 84,
# 120 and 127 keys (the 14B shapes end on 80 and 84, the 81-frame 1.3B one
# on 120), at lq under and over lk
STREAM_TAILS = [(300, 3713), (5000, 3920), (777, 4052), (4680, 4216), (129, 4351)]


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(100, 77), (4680, 512), (4680, 4680), (9360, 9360),
                                   (300, 4000), *FLASH_EDGES, *STREAM_TAILS])
def test_flash_matches_plain(cuda, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 12, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 12, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16()
    name = "K3" if tfa.uses_single_block(lk) else "K1"
    before = _build.LAUNCHES[name]
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **BNLD_BOUNDED)
    assert _build.LAUNCHES[name] == before + 1
    po, plse = tfa.flash_attention_plain(q, k, v)
    # exp2 within 2 ulp of torch.exp2 can flip bf16(p); o rounds to bf16
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,lq,lk", [(1, 64, 300), (1, 300, 300), (1, 64, 4000), (1, 300, 4000),
                                     (5, 3715, 3713), (3, 5000, 4216)])
def test_flash_single_tile_grid(cuda, n, lq, lk):
    # B 1, N 1: one q tile (lq 64) or three, each block of the persistent
    # grid owning one; K3 and K3s (lk 300), K1 and K2 (lk 4000). Then grids
    # of 150 tiles (a full wave of 132 and a ragged one of 18) and of 120
    # (one partial wave)
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(1, n, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(1, n, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(1, lk, n, 128, device=cuda, generator=g).bfloat16()
    for shifted, plain in ((False, tfa.flash_attention_plain),
                           (True, tfa.flash_attention_shifted_plain)):
        o, lse = tfa.flash_fwd_kernel(q, k, v, tfa.uses_single_block(lk), shifted)
        po, plse = plain(q, k, v)
        _close(o, po, 2)
        torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("l", [300, 3920])
def test_flash_reads_strided_v_and_q(cuda, bounded, l):
    # q/k as views of a wider [B, L, N, D] buffer (no copy), v as the
    # natural [B, L, N, D] slice of a packed qkv projection; l 300 takes
    # K3 (bounded) or K3s, l 3920 K1 or K2
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(1, l, 3, 4, 128, device=cuda, generator=g).bfloat16()
    q, k = qkv[:, :, 0].movedim(2, 1), qkv[:, :, 1].movedim(2, 1)
    v = qkv[:, :, 2]
    name = {(True, True): "K3", (True, False): "K3s", (False, True): "K1",
            (False, False): "K2"}[tfa.uses_single_block(l), bounded]
    before = _build.LAUNCHES[name]
    o = tfa.flash_attention(q, k, v, qk_layout="bnld", bounded_logits=bounded)
    assert _build.LAUNCHES[name] == before + 1
    plain = tfa.flash_attention_plain if bounded else tfa.flash_attention_shifted_plain
    _close(o, plain(q.contiguous(), k.contiguous(), v.contiguous())[0], 2)


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
        tfa.flash_attention(q, q, q.movedim(1, 2), **BNLD_BOUNDED)
    q = torch.randn(1, 2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q, q, q.movedim(1, 2), **BNLD_BOUNDED)
    x = torch.randn(1, 8 * 1536 + 2, device=cuda)[:, 2:].reshape(1, 8, 1536)  # 8 B off
    with pytest.raises(ValueError, match="aligned"):
        tstream.ln_scale_shift(x, torch.ones(1536, device=cuda), torch.zeros(1536, device=cuda))
    # q 8 bytes off a 16-byte boundary: the tensor maps of K3 need 16
    q = torch.randn(2 * 128 * 128 + 4, device=cuda).bfloat16()[4:].reshape(1, 2, 128, 128)
    k = torch.randn(1, 2, 77, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, k, k.movedim(1, 2), **BNLD_BOUNDED)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,k4", [
    (100, 77, False), (1024, 4680, False), (4680, 512, False), (4680, 4680, False),
    # K4 at the edges of its pipeline (k4: taken where the JAX rule would
    # take K5): a q sweep of one and of two tiles, shorter than its ring of
    # two stages; an odd tile count with lq not a multiple of 64; kv_splits
    # 11 at 512 keys (two or three tiles a block); the 257 image keys
    (64, 77, True), (128, 300, True), (4650, 4680, False), (2048, 512, False),
    (4680, 257, False)])
def test_flash_bwd_matches_plain(cuda, lq, lk, k4, monkeypatch):
    if k4:
        monkeypatch.setattr(tfa, "uses_merged_bwd", lambda lq, lk: True)
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 12, lq, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    k = torch.randn(1, 12, lk, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    v = torch.randn(1, lk, 12, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **BNLD_BOUNDED)
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
    # and the two kernels against each other: each within two ulps of the
    # plain backward, so within four of one another
    other = tfa.bwd_kernel(q, k, v, o, lse, do, not merged)
    for a, b in zip(got, other):
        _close(a, b, 4)


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
                                         (37, torch.float32), (1, torch.bfloat16),
                                         (3, torch.float32), (1, torch.float32)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(100, 3700), (4680, 4680), (300, 4100), (9360, 9360)])
def test_k10_matches_plain(cuda, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(2, 12, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 12, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16()
    before = _build.LAUNCHES["K10"]
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, qk_int8=True, return_lse=True, **BNLD_BOUNDED)
    assert _build.LAUNCHES["K10"] == before + 1
    q8, sq = tfa.quantize_bn(q)
    k8, sk = tfa.quantize_bn(k)
    po, plse = tfa.flash_attention_qk8_plain(q8, k8, v, tfa.qk8_scale(sq, sk, 128))
    # the same int32 scores; exp2 within 2 ulp can flip bf16(p), o rounds
    # to bf16: two bf16 ulps
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_k10_has_no_backward_and_checks_its_inputs(cuda):
    q = torch.randn(1, 2, 4000, 128, device=cuda).bfloat16().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, q, q.movedim(1, 2), qk_int8=True, **BNLD_BOUNDED)
    q8 = torch.zeros(1, 2, 4000, 128, device=cuda, dtype=torch.int8)
    v = torch.zeros(1, 4000, 2, 128, device=cuda).bfloat16()
    c = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        tfa.flash_qk8_kernel(q8.float(), q8, v, c)
    with pytest.raises(ValueError, match="fp32"):
        tfa.flash_qk8_kernel(q8, q8, v, c.double())


@pytest.mark.gpu
def test_int8_dense_on_the_card_matches_the_cpu(cuda):
    # torch._int_mm on the [out, in] weight's transpose view: the int32
    # product is exact on both devices, so y agrees to fp32 rounding
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 300, 1536, generator=g).bfloat16()
    wq, ws = tquant.quantize_weight(torch.randn(8960, 1536, generator=g) * 0.02)
    bias = torch.randn(8960, generator=g) * 0.1
    want = tquant.int8_dense(x, wq, ws, bias, out_dtype=torch.float32)
    got = tquant.int8_dense(x.to(cuda), wq.to(cuda), ws.to(cuda), bias.to(cuda),
                            out_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("chain", [False, True])
def test_probes_match_plain(cuda, dtype, chain):
    g = torch.Generator(device=cuda).manual_seed(10)
    k = 128 // (1 if dtype == torch.int8 else 2) * 3   # three 128-byte chunks of K
    nblocks, reps = (1, 9) if chain else (3, 5)
    a8, a16 = int8_probe.ternary((512, k), g, cuda)
    b8, b16 = int8_probe.ternary((nblocks * 256, k), g, cuda)
    a, bt = (a8, b8) if dtype == torch.int8 else (a16, b16)
    name = "P2" if chain else "P1"
    before = _build.LAUNCHES[name]
    got = (int8_probe.probe_chain(a, bt, reps) if chain
           else int8_probe.probe_rate(a, bt, nblocks, reps))
    assert _build.LAUNCHES[name] == before + 1
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32)
    # integer partial sums far below 2^24: exact in any order, fp32 too
    assert torch.equal(got.double(), int8_probe.probe_plain(a8, b8, nblocks, reps))


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,valid", [(100, 77, None), (4680, 512, [512, 300]),
                                         (300, 4000, None), (4680, 4680, None),
                                         (4680, 4680, [4680, 1001]), (1000, 9360, [64, 9300]),
                                         *((lq, lk, None) for lq, lk in FLASH_EDGES),
                                         (300, 769, [1, 128]), (4680, 512, [200, 129]),
                                         *((lq, lk, None) for lq, lk in STREAM_TAILS),
                                         (300, 4000, [1, 128]), (777, 4052, [129, 2345])])
def test_shifted_flash_matches_plain(cuda, lq, lk, valid):
    # K2 (streaming) and K3s (one K block): no mask, a ragged key tail, and a
    # user mask (lengths on a tile edge and inside one); token-major q/k
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(2, lq, 12, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16()
    name = "K3s" if tfa.uses_single_block(lk) else "K2"
    tvalid = None if valid is None else torch.tensor(valid, device=cuda)
    before = _build.LAUNCHES[name]
    o, lse = tfa.flash_attention(q, k, v, tvalid, return_lse=True)
    assert _build.LAUNCHES[name] == before + 1
    kvalid = None if valid is None else tvalid.int().repeat_interleave(12)
    po, plse = tfa.flash_attention_shifted_plain(q.movedim(1, 2), k.movedim(1, 2), v, kvalid)
    # bf16(p) is rounded at the running max rather than the row max, so it
    # may round the other way on any key (the errors average over the keys),
    # and o rounds to bf16: two bf16 ulps
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [8.0, 9.5])
def test_shifted_flash_is_finite_where_the_bounded_one_overflows(cuda, scale):
    g = torch.Generator(device=cuda).manual_seed(12)
    # logits of standard deviation scale^2 (64, 90): each row's largest is
    # ~240 or ~330; 4,680 keys stream (K1 against K2)
    q = (scale * torch.randn(1, 9, 4680, 128, device=cuda, generator=g)).bfloat16()
    k = (scale * torch.randn(1, 9, 4680, 128, device=cuda, generator=g)).bfloat16()
    v = torch.randn(1, 4680, 9, 128, device=cuda, generator=g).bfloat16()
    bounded = tfa.flash_attention(q, k, v, **BNLD_BOUNDED)
    assert not torch.isfinite(bounded.float()).all()  # logits past ~88 overflow exp
    o = tfa.flash_attention(q, k, v, qk_layout="bnld")
    _close(o, tfa.flash_attention_shifted_plain(q, k, v)[0], 2)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,merged", [(4680, 4680, True), (4680, 512, True),
                                          (1024, 4680, False), (200, 77, False),
                                          # K4: a masked tail at the 257 image keys and
                                          # kv_splits 11 over 32 q tiles
                                          (4650, 257, True), (2048, 512, True)])
def test_masked_flash_bwd_matches_plain(cuda, lq, lk, merged):
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(2, lq, 12, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    k = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    v = torch.randn(2, lk, 12, 128, device=cuda, generator=g).bfloat16().requires_grad_()
    valid = [lk, lk // 3 + 1]
    assert tfa.uses_merged_bwd(lq, lk) == merged
    tvalid = torch.tensor(valid, device=cuda)
    o, lse = tfa.flash_attention(q, k, v, tvalid, return_lse=True)
    do = torch.randn(o.shape, device=cuda, generator=g).bfloat16()
    name = "K4" if merged else "K5"
    before = _build.LAUNCHES[name]
    got = torch.autograd.grad(o, (q, k, v), do)
    assert _build.LAUNCHES[name] == before + 1
    kvalid = tvalid.int().repeat_interleave(12)
    qh, kh = q.detach().movedim(1, 2), k.detach().movedim(1, 2)
    ref = tfa.flash_attention_bwd_plain(qh, kh, v.detach(), o.detach(), lse, do, kvalid)
    ref = (ref[0].movedim(1, 2), ref[1].movedim(1, 2), ref[2])
    # as the unmasked backward: two bf16 ulps; the masked keys' gradients
    # are exactly 0
    for a, b in zip(got, ref):
        _close(a, b, 2)
    for grad in got[1:]:
        assert not grad[1, valid[1]:].any()
        assert grad[1, :valid[1]].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", [(3, 30, 52), (1, 3, 7)])
def test_rope_matches_plain(cuda, dtype, grid):
    g = torch.Generator(device=cuda).manual_seed(14)
    c, s = (torch.from_numpy(a).to(cuda) for a in rope_tables_rolled_np(grid, 128))
    l = grid[0] * grid[1] * grid[2]
    x = torch.randn(2, l, 12, 128, device=cuda, generator=g).to(dtype).requires_grad_()
    before = _build.LAUNCHES["R"]
    y = trope.rope_rotate(x, c, s)
    assert _build.LAUNCHES["R"] == before + 1 and y.grad_fn is not None
    gy = torch.randn(y.shape, device=cuda, generator=g).to(dtype)
    (dx,) = torch.autograd.grad(y, x, gy)
    assert _build.LAUNCHES["R"] == before + 2
    # the same unfused fp32 products and sum, then one rounding: bit for bit
    assert torch.equal(y, trope.rope_rotate_plain(x.detach(), c, s))
    assert torch.equal(dx, trope.rope_rotate_plain(gy, c, torch.roll(s, 64, dims=-1)))


# K6-K9 at the widths of bench.py (dim 1280, 10 heads) and of the 14B
# models (dim 5120, 40 heads: K6/K8's wide row layout, a block per row),
# with ragged row counts; K8/K9 also at the edges of their range (D 128,
# 8192) and at a width of an odd group count (1920), at L 1 and under a
# tile of K9; g in both types; the bounds are those of the 1536-wide tests
# above
@pytest.mark.gpu
@pytest.mark.parametrize("d,l", [(1280, 37), (5120, 37), (5120, 4685), (1280, 3121),
                                 (128, 37), (1920, 37), (8192, 37), (8192, 1), (1920, 3),
                                 (128, 4685)])
def test_k8_k9_at_every_model_width(cuda, d, l):
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(2, l, d, device=cuda, generator=g).requires_grad_()
    s = (1 + 0.1 * torch.randn(2, d, device=cuda, generator=g)).requires_grad_()
    t = (0.1 * torch.randn(2, d, device=cuda, generator=g)).requires_grad_()
    for out_dtype in (torch.bfloat16, torch.float32):
        before = _build.LAUNCHES["K8"], _build.LAUNCHES["K9"]
        y = tstream.ln_scale_shift(x, s, t, out_dtype=out_dtype)
        _close(y, tstream.ln_scale_shift_plain(x, s, t, out_dtype=out_dtype), 1)
        gy = torch.randn(y.shape, device=cuda, generator=g).to(out_dtype)
        got = torch.autograd.grad(y, (x, s, t), gy)
        assert (_build.LAUNCHES["K8"], _build.LAUNCHES["K9"]) == (before[0] + 1, before[1] + 1)
        ref = tstream.ln_scale_shift_bwd_plain(x.detach(), s.detach(), gy)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


# K9 on its persistent grid: with the partition of a card with few SMs (a
# grid that fits on any card), block runs cross batch boundaries (B 2: a
# run ends inside batch element 1) and span several (B 5, L under a tile),
# and at the card's own count with B 5; dx, ds and dt the same to the bit
# on a second call, as a bitwise resume needs
@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,sms,g_dtype", [
    (2, 37, 1536, 3, torch.bfloat16), (2, 4685, 1280, 7, torch.float32),
    (5, 3, 1920, 4, torch.bfloat16), (2, 100, 8192, 3, torch.float32),
    (5, 937, 5120, None, torch.bfloat16)])
def test_k9_across_batch_boundaries(cuda, monkeypatch, b, l, d, sms, g_dtype):
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(b, l, d, device=cuda, generator=g) * 0.5 + 0.3
    s = 1 + 0.1 * torch.randn(b, d, device=cuda, generator=g)
    gy = torch.randn(b, l, d, device=cuda, generator=g).to(g_dtype)
    if sms:
        monkeypatch.setattr(tstream, "_sm_count", lambda index: sms)
        geo = tstream.k9_geometry(b, l, d, gy.element_size(), sms)
        assert any(len({geo.rows(t)[0] for t in geo.run(i)}) > 1 for i in range(geo.grid))
    before = _build.LAUNCHES["K9"]
    got = tstream.bwd_kernel(x, s, gy, 1e-6)
    assert _build.LAUNCHES["K9"] == before + 1
    ref = tstream.ln_scale_shift_bwd_plain(x, s, gy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5 * r.abs().max().item())
    assert all(torch.equal(a, a2) for a, a2 in zip(got, tstream.bwd_kernel(x, s, gy, 1e-6)))


@pytest.mark.gpu
@pytest.mark.parametrize("l,d,g_dtype", [(3120, 1280, torch.bfloat16),
                                         (32760, 1536, torch.float32),
                                         (32760, 5120, torch.bfloat16), (1, 8192, torch.float32)])
def test_k9_bitwise_on_a_second_call(cuda, l, d, g_dtype):
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn(1, l, d, device=cuda, generator=g)
    s = 1 + 0.1 * torch.randn(1, d, device=cuda, generator=g)
    gy = torch.randn(1, l, d, device=cuda, generator=g).to(g_dtype)
    first = tstream.bwd_kernel(x, s, gy, 1e-6)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, tstream.bwd_kernel(x, s, gy, 1e-6)))


@pytest.mark.gpu
@pytest.mark.parametrize("n,l", [(10, 37), (40, 37), (40, 4685), (1, 33), (17, 5)])
def test_k6_k7_at_every_head_count(cuda, n, l):
    g = torch.Generator(device=cuda).manual_seed(22)
    m = n * 128
    x = torch.randn(2, l, m, device=cuda, generator=g).bfloat16().requires_grad_()
    w = (1 + 0.1 * torch.randn(m, device=cuda, generator=g)).requires_grad_()
    c, s = (torch.from_numpy(a).to(cuda) for a in rope_tables_rolled_np((1, 1, l), 128))
    for rope in (True, False):
        before = _build.LAUNCHES["K6"], _build.LAUNCHES["K7"]
        y = tqr.rmsnorm_rope(x, w, c, s, n) if rope else tqr.rmsnorm_only(x, w, n)
        cc, ss = (c, s) if rope else (None, None)
        _close(y, tqr.rmsnorm_rope_plain(x, w, cc, ss, n, do_rope=rope), 2)
        gy = torch.randn(y.shape, device=cuda, generator=g).bfloat16()
        dx, dw = torch.autograd.grad(y, (x, w), gy)
        assert (_build.LAUNCHES["K6"], _build.LAUNCHES["K7"]) == (before[0] + 1, before[1] + 1)
        rdx, rdw = tqr.rmsnorm_rope_bwd_plain(x.detach(), w.detach(), cc, ss, gy, n, do_rope=rope)
        _close(dx, rdx, 2)
        _close(dw, rdw, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", range(1, 65))
def test_k7_ring_at_every_head_count(cuda, n):
    # the persistent ring kernel at every head count, with and without rope,
    # at a ragged L (no tile size divides 2 x 45 rows of 8, 4, 2 or 1 but
    # the last) and at fewer rows than a tile holds
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    m = n * 128
    w = 1 + 0.1 * torch.randn(m, device=cuda, generator=g)
    for l in (45, 3):
        x = torch.randn(2, l, m, device=cuda, generator=g).bfloat16()
        gy = torch.randn(2, n, l, 128, device=cuda, generator=g).bfloat16()
        c, s = (torch.from_numpy(a).to(cuda) for a in rope_tables_rolled_np((1, 1, l), 128))
        for rope in (True, False):
            cc, ss = (c, s) if rope else (None, None)
            before = _build.LAUNCHES["K7"]
            dx, dw = tqr.bwd_kernel(x, w, cc, ss, gy, n, 1e-6, rope)
            assert _build.LAUNCHES["K7"] == before + 1
            rdx, rdw = tqr.rmsnorm_rope_bwd_plain(x, w, cc, ss, gy, n, do_rope=rope)
            _close(dx, rdx, 2)
            _close(dw, rdw, 1)
            # dw is summed in a fixed order: the same bits on a second call
            dx2, dw2 = tqr.bwd_kernel(x, w, cc, ss, gy, n, 1e-6, rope)
            assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 128, 2048, 16, 4096), (512, 1024, 2048, 16, 512),
                                   (512, 512, 512, 1, 64)], ids=["P1qk", "P1bigK", "P2"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probes_exact_at_their_shapes(cuda, shape, dtype):
    # P1's two shapes and P2's, as the probe scripts run them
    m, k, n_cols, nblocks, reps = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    a8, a16 = int8_probe.ternary((m, k), g, cuda)
    b8, b16 = int8_probe.ternary((nblocks * n_cols, k), g, cuda)
    a, bt = (a8, b8) if dtype == torch.int8 else (a16, b16)
    got = (int8_probe.probe_chain(a, bt, reps) if nblocks == 1
           else int8_probe.probe_rate(a, bt, nblocks, reps))
    assert torch.equal(got.double(), int8_probe.probe_plain(a8, b8, nblocks, reps))
    assert 1 <= int8_probe.cluster_size(a, n_cols, reps) <= 8


def _k4_case(cuda, seed, b, n, lq, lk, valid=None, wide_rows=False, merged=True,
             dq_splits=None):
    """K4 (or K5: merged=False) called directly against the plain backward
    -> the kernel's gradients. wide_rows: v and dO as strided views of
    wider token-major buffers."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, n, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(b, n, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(b, lk, n, 256 if wide_rows else 128, device=cuda, generator=g).bfloat16()
    v = v[..., 64:192] if wide_rows else v
    kvalid = None
    if valid is not None:
        kvalid = torch.tensor(valid, device=cuda, dtype=torch.int32).repeat_interleave(n)
    o, lse = tfa.flash_fwd_kernel(q, k, v, tfa.uses_single_block(lk), valid is not None,
                                  kvalid)
    do = torch.randn(b, lq, n, 256 if wide_rows else 128, device=cuda, generator=g).bfloat16()
    do = do[..., 128:] if wide_rows else do
    name = "K4" if merged else "K5"
    before = _build.LAUNCHES[name]
    got = tfa.bwd_kernel(q, k, v, o, lse, do, merged, kvalid, dq_splits)
    assert _build.LAUNCHES[name] == before + 1  # the prologue (and K5's dq pass) in the one
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, kvalid)
    # bf16(p), bf16(ds) and the bf16 outputs may round the other way, and
    # K4's dq adds in a run-dependent order: two bf16 ulps
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        _close(a, r, 2)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(1, 1), (129, 127), (4680, 512), (4680, 4680)])
def test_k4_matches_plain_at_tile_edges(cuda, lq, lk):
    # 64-row q tiles and 128-key tiles: one of each, one row or key past a
    # tile, the cross-attention's 4 key tiles, the self-attention's ragged
    # last ones
    _k4_case(cuda, 23, 1, 12, lq, lk)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,lq,lk", [(1, 12, 4680, 512), (2, 3, 1000, 300), (1, 1, 64, 100)])
def test_k4_q_split_and_one_tile_grid(cuda, b, n, lq, lk):
    # few key tiles: each key tile's q sweep splits over several blocks
    # (fp32 dk/dv partials summed by the wrapper); B 1, N 1, lq 64, lk 100:
    # a grid of one block with one q tile
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = tfa.q_splits(b * n * -(-lk // 128), -(-lq // 64), sms)
    assert (splits > 1) == (lq > 64)
    _k4_case(cuda, 24, b, n, lq, lk)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,valid", [(700, 600, [1, 128]), (700, 600, [129, 333]),
                                         (4680, 4680, [4680, 2001]), (4680, 512, [512, 77])])
def test_k4_masks_keys_exactly(cuda, lq, lk, valid):
    # key masks at 1, 128 and 129 (tile edges) and inside a tile; masked
    # keys' gradients are exactly 0, kept keys' are not
    dq, dk, dv = _k4_case(cuda, 25, 2, 3, lq, lk, valid)
    for bi, vl in enumerate(valid):
        assert not dk[bi, :, vl:].any() and not dv[bi, vl:].any()
        assert dk[bi, :, :vl].abs().sum() > 0 and dv[bi, :vl].abs().sum() > 0


# the image cross-attention of i2v (257 CLIP tokens) and flf2v (514): one
# and two keys past a 128-key tile, at the 1.3B and the 14B head counts
IMAGE_LKS = (257, 514)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12, 40])
@pytest.mark.parametrize("lk", IMAGE_LKS)
@pytest.mark.parametrize("shifted", [False, True])
def test_k3_at_the_image_key_lengths(cuda, n, lk, shifted):
    g = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn(2, n, 1560, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, n, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, lk, n, 128, device=cuda, generator=g).bfloat16()
    assert tfa.uses_single_block(lk)
    name = "K3s" if shifted else "K3"
    before = _build.LAUNCHES[name]
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, qk_layout="bnld",
                                 bounded_logits=not shifted)
    assert _build.LAUNCHES[name] == before + 1
    plain = tfa.flash_attention_shifted_plain if shifted else tfa.flash_attention_plain
    po, plse = plain(q, k, v)
    # as test_flash_matches_plain: two bf16 ulps of max|o|, lse 1e-5
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12, 40])
def test_k4_at_the_i2v_image_keys(cuda, n):
    # 257 keys: one key in the last 128-key tile
    _k4_case(cuda, 32, 2, n, 1560, 257)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [[257, 129], [256, 1]])
def test_k4_masks_the_image_key_tail_exactly(cuda, valid):
    dq, dk, dv = _k4_case(cuda, 33, 2, 12, 1560, 257, valid)
    for bi, vl in enumerate(valid):
        assert not dk[bi, :, vl:].any() and not dv[bi, vl:].any()
        assert dk[bi, :, :vl].abs().sum() > 0 and dv[bi, :vl].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(1000, 1000), (4680, 512)])
def test_k4_reads_strided_token_major_v_and_do(cuda, lq, lk):
    _k4_case(cuda, 26, 1, 4, lq, lk, wide_rows=True)


# K5: key ranges ending 1, 64 and 127 keys past a 128-key tile (64-key
# tiles in the dq pass: 1, 0 and 63 past one), q ranges ending inside a
# 64-row and a 128-row tile
K5_EDGES = [(1, 1), (64, 127), (129, 4097), (1000, 4160), (300, 4223), (4680, 4680),
            (4680, 512), (777, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", K5_EDGES)
def test_k5_matches_plain_at_tile_edges(cuda, lq, lk):
    _k4_case(cuda, 27, 1, 12, lq, lk, merged=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dq_splits", [None, 1, 3])
def test_k5_short_q_over_a_long_key_range(cuda, dq_splits):
    # the shape that reaches K5 by default: lq 1,024 over the 81-frame
    # self-attention's 32,760 keys, 12 heads; the dq pass's key range split
    # as the wrapper picks it (None), not at all, and in three
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert not tfa.uses_merged_bwd(1024, 32760)
    assert tfa.q_splits(12 * 8, -(-32760 // 64), sms) > 1
    _k4_case(cuda, 28, 1, 12, 1024, 32760, merged=False, dq_splits=dq_splits)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,valid", [(700, 600, [1, 128]), (700, 600, [129, 333]),
                                         (1024, 4680, [4680, 2001]), (4680, 512, [512, 77]),
                                         (300, 4223, [64, 4160])])
def test_k5_masks_keys_exactly(cuda, lq, lk, valid):
    # key masks at 1, 64, 128 and 129 (tile edges of both passes) and
    # inside a tile; masked keys' gradients are exactly 0, kept keys' are not
    dq, dk, dv = _k4_case(cuda, 29, 2, 3, lq, lk, valid, merged=False)
    for bi, vl in enumerate(valid):
        assert not dk[bi, :, vl:].any() and not dv[bi, vl:].any()
        assert dk[bi, :, :vl].abs().sum() > 0 and dv[bi, :vl].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(1000, 1000), (1024, 4680), (4680, 512)])
def test_k5_reads_strided_token_major_v_and_do(cuda, lq, lk):
    _k4_case(cuda, 30, 1, 4, lq, lk, wide_rows=True, merged=False)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(1024, 32760), (4680, 4680)])
def test_k5_dq_is_bitwise_deterministic(cuda, lq, lk):
    # dq is written once per q tile (and K5's key-split partials are summed
    # in a fixed order): two calls give the same bits, dk and dv too
    g = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn(1, 12, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(1, 12, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(1, lk, 12, 128, device=cuda, generator=g).bfloat16()
    o, lse = tfa.flash_fwd_kernel(q, k, v, tfa.uses_single_block(lk))
    do = torch.randn(o.shape, device=cuda, generator=g).bfloat16()
    first = tfa.bwd_kernel(q, k, v, o, lse, do, False)
    second = tfa.bwd_kernel(q, k, v, o, lse, do, False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K10: key ranges ending 1, 80 and 127 keys past a 128-key tile, lq above
# and below lk, B 1 and B 2 (called directly: the route takes only
# streaming key ranges, flash_attention's tests above hold it)
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("lq,lk", [(1, 1), (129, 127), (300, 3713), (5000, 3920), (777, 4095),
                                   (4680, 129)])
def test_k10_at_tile_edges(cuda, b, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn(b, 12, lq, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(b, 12, lk, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(b, lk, 12, 128, device=cuda, generator=g).bfloat16()
    q8, sq = tfa.quantize_bn(q)
    k8, sk = tfa.quantize_bn(k)
    c = tfa.qk8_scale(sq, sk, 128)
    before = _build.LAUNCHES["K10"]
    o, lse = tfa.flash_qk8_kernel(q8, k8, v, c)
    assert _build.LAUNCHES["K10"] == before + 1
    po, plse = tfa.flash_attention_qk8_plain(q8, k8, v, c)
    # the same int32 scores; exp2 within 2 ulp can flip bf16(p), o rounds
    # to bf16: two bf16 ulps
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero_head", "near_bound"])
def test_k10_zero_head_and_logits_near_the_bound(cuda, case):
    # an all-zero head (scale 1e-30 / 127, every score 0: o is the mean of
    # v), and logits up to ~60 (q, k of standard deviation 3.5: logits of
    # standard deviation ~12), where exp2 stays finite without a running max
    g = torch.Generator(device=cuda).manual_seed(33)
    sd = 3.5 if case == "near_bound" else 1.0
    q = (sd * torch.randn(2, 12, 1000, 128, device=cuda, generator=g)).bfloat16()
    k = (sd * torch.randn(2, 12, 4000, 128, device=cuda, generator=g)).bfloat16()
    v = torch.randn(2, 4000, 12, 128, device=cuda, generator=g).bfloat16()
    if case == "zero_head":
        q[1, 5] = 0
        k[0, 3] = 0
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, qk_int8=True, return_lse=True, **BNLD_BOUNDED)
    q8, sq = tfa.quantize_bn(q)
    k8, sk = tfa.quantize_bn(k)
    c = tfa.qk8_scale(sq, sk, 128)
    po, plse = tfa.flash_attention_qk8_plain(q8, k8, v, c)
    if case == "zero_head":
        assert c[1 * 12 + 5] < 1e-30 and not q8[1, 5].any()
    else:
        logits = (q8[0, 0, :64].float() @ k8[0, 0].float().T) * c[0] / tfa.LOG2E
        assert logits.max() > 40
    assert torch.isfinite(plse).all()
    _close(o, po, 2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
