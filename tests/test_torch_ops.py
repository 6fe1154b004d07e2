"""The port's ops (hyvideo_prfl_torch/ops) against the JAX package.

On the CPU each port op runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode (PALLAS_INTERPRET=1, as the JAX
package's own kernel tests do), so this holds the plain versions, which
chip_smoke.py then holds the Hopper kernels to, against the TPU kernels'
math. Inputs are made by numpy from a seed and handed to both.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hyvideo_prfl_tpu.models import rope as jrope
from hyvideo_prfl_tpu.ops import flash_attention as jfa
from hyvideo_prfl_tpu.ops import qknorm_rope as jqr
from hyvideo_prfl_tpu.ops import stream as jstream
from hyvideo_prfl_torch.models import rope as trope
from hyvideo_prfl_torch.ops import attention as tattn
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # one bf16 ulp at the top binade, relative to max|ref|
# head-major q/k with bounded logits, as the qk-normed DiT calls attention
BNLD_BOUNDED = dict(qk_layout="bnld", bounded_logits=True)


@pytest.fixture(autouse=True)
def _pallas_kernel_path(monkeypatch):
    # the JAX dispatchers skip interpret-mode Pallas on the CPU unless asked
    monkeypatch.setenv("PALLAS_INTERPRET", "1")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


def _jt(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


@pytest.mark.parametrize("grid", [(3, 4, 4), (21, 30, 52), (1, 1, 7)])
def test_rope_tables_equal_jax(grid):
    # exact: the same float64 numpy recipe rounded once to fp32
    for a, b in zip(trope.rope_tables_np(grid, 128), jrope._rope_tables_np(grid, 128)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trope.rope_tables_rolled_np(grid, 128),
                    jrope._rolled_tables_np(grid, 128)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trope.rope_permutation(128), jrope.rope_permutation(128))


def _bwd_close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


# d 256 (the tiny DiT's width), then the bench.py width 1280 (10 heads) and
# the 14B width 5120 (40 heads), where the kernels take a wide row layout
@pytest.mark.parametrize("out_dtype,l,affine,d", [
    pytest.param("bfloat16", 48, False, 256, id="bfloat16-48-False"),
    pytest.param("bfloat16", 36, True, 256, id="bfloat16-36-True"),
    pytest.param("float32", 36, False, 256, id="float32-36-False"),
    ("bfloat16", 48, False, 1280), ("float32", 36, True, 1280),
    ("bfloat16", 36, False, 5120), ("float32", 48, True, 5120)])
def test_ln_scale_shift_matches_jax(out_dtype, l, affine, d):
    rng = np.random.RandomState(0)
    b = 2
    x = rng.randn(b, l, d) * 0.5
    s = 1.0 + 0.1 * rng.randn(d if affine else b * d).reshape(-1, d)
    t = 0.1 * rng.randn(*s.shape)
    jd, td = getattr(jnp, out_dtype), getattr(torch, out_dtype)

    # the JAX custom_vjp through its single-device _local (what the public
    # wrapper runs on one device), whose forward and backward are the
    # Pallas kernels
    def jfun(x_, s_, t_):
        sb = jnp.broadcast_to(s_.reshape(-1, d), (b, d))
        tb = jnp.broadcast_to(t_.reshape(-1, d), (b, d))
        return jstream._local(x_, sb, tb, 1e-6, jd)

    out, vjp = jax.vjp(jfun, _jt(x), _jt(s), _jt(t))
    want = _np(out)
    tx, ts, tt_ = (_tt(a).requires_grad_() for a in (x, s, t))
    y = tstream.ln_scale_shift(tx, ts, tt_, out_dtype=td)
    got = y.detach().float().numpy()
    # identical math; the mean/variance sums may run in another order, which
    # can move a value across a bf16 rounding boundary (one ulp) or change
    # fp32 in the last bits
    if out_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULP * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # backward: the port's plain backward against the JAX kernel's
    g = _np(_jt(rng.randn(b, l, d), jd))  # the cotangent, exact in out_dtype
    grads = torch.autograd.grad(y, (tx, ts, tt_), _tt(g, td))
    # fp32 formulas on both sides; the row and column sums run in another
    # order (and JAX sums ds/dt by tile through a ones-row matmul)
    for name, a, w in zip(("dx", "ds", "dt"), grads, vjp(_jt(g, jd))):
        _bwd_close(a.numpy(), _np(w), 1e-5, name)


# n 2 (the tiny DiT), then 10 heads (bench.py) and 40 (the 14B width),
# where the kernels take a wide row layout
@pytest.mark.parametrize("dtype,rope,l,n", [
    pytest.param("bfloat16", True, 48, 2, id="bfloat16-True-48"),
    pytest.param("bfloat16", True, 36, 2, id="bfloat16-True-36"),
    pytest.param("bfloat16", False, 36, 2, id="bfloat16-False-36"),
    pytest.param("float32", True, 36, 2, id="float32-True-36"),
    pytest.param("float32", False, 48, 2, id="float32-False-48"),
    ("bfloat16", True, 48, 10), ("float32", False, 36, 10),
    ("bfloat16", True, 36, 40), ("float32", False, 48, 40)])
def test_rmsnorm_rope_matches_jax(dtype, rope, l, n):
    d = 128
    grid = {48: (3, 4, 4), 36: (3, 4, 3)}[l]
    rng = np.random.RandomState(1)
    x = rng.randn(1, l, n * d)
    w = rng.rand(n * d) + 0.5
    c, s = trope.rope_tables_rolled_np(grid, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # the JAX custom_vjp through its single-device _local (what the public
    # wrappers run on one device), whose forward and backward are the
    # Pallas kernels; rmsnorm_only is its no-rope mode
    cj, sj = (c, s) if rope else (np.zeros((l, d), np.float32),) * 2
    out, vjp = jax.vjp(lambda x_, w_: jqr._local(x_, w_, jnp.asarray(cj), jnp.asarray(sj),
                                                  1e-6, rope),
                       _jt(x, jd), _jt(w).reshape(n, d))
    want = _np(out)
    tx, tw = _tt(x, td).requires_grad_(), _tt(w).requires_grad_()
    if rope:
        y = tqr.rmsnorm_rope(tx, tw, torch.from_numpy(c), torch.from_numpy(s), n)
    else:
        y = tqr.rmsnorm_only(tx, tw, n)
    got = y.detach().float().numpy()
    assert got.shape == (1, n, l, d)
    # identical math; the sum of squares may run in another order, so
    # bf16(x r) can round the other way, and the rope sum mixes two such
    # values: two bf16 ulps in bf16, fp32 rounding in fp32
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * BF16_ULP * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # backward: the port's plain backward against the JAX kernel's
    g = _np(_jt(rng.randn(1, n, l, d), jd))
    want_dx, want_dw = vjp(_jt(g, jd))
    got_dx, got_dw = torch.autograd.grad(y, (tx, tw), _tt(g, td))
    assert got_dx.dtype == td and got_dw.dtype == torch.float32
    if dtype == "float32":
        # the same fp32 formulas; sums of squares and dots in another order
        _bwd_close(got_dx.numpy(), _np(want_dx), 1e-5, "dx")
        _bwd_close(got_dw.numpy(), _np(want_dw).reshape(-1), 1e-5, "dw")
    else:
        # dx rounds to bf16 (one ulp either way); r differs in its last
        # fp32 bits, so bf16(x r) in dw may round the other way: two ulps
        _bwd_close(got_dx.float().numpy(), _np(want_dx), BF16_ULP, "dx")
        _bwd_close(got_dw.numpy(), _np(want_dw).reshape(-1), 2 * BF16_ULP, "dw")


@pytest.mark.parametrize("dtype,lq,lk,block", [
    ("bfloat16", 200, 77, None),      # single K block (K3), padded to 128
    ("float32", 200, 77, None),
    # K3's key-tile edges: one full 128-key tile, one key past it, and the
    # i2v text + CLIP length (six tiles, the last holding one key)
    *((dtype, 200, lk, None) for lk in (128, 129, 769) for dtype in ("bfloat16", "float32")),
    ("bfloat16", 2000, 2000, 512),    # streaming (K1): 4 k blocks, 48 padded keys
    ("float32", 2000, 2000, 512)])
def test_flash_matches_jax(dtype, lq, lk, block):
    b, n, d = 1, 2, 128
    rng = np.random.RandomState(2)
    q = rng.randn(b, n, lq, d)
    k = rng.randn(b, n, lk, d)
    v = rng.randn(b, lk, n, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _np(jfa.flash_attention(_jt(q, jd), _jt(k, jd), _jt(v, jd), block_q=block,
                                   block_k=block, qk_layout="bnld", bounded_logits=True))
    got, lse = tfa.flash_attention(_tt(q, td), _tt(k, td), _tt(v, td), return_lse=True,
                                   **BNLD_BOUNDED)
    got = got.float().numpy()
    assert got.shape == (b, lq, n, d) and lse.shape == (b * n, lq)
    # fp32: the same fixed-max softmax; JAX's padded keys add exp2(0) = 1
    # each to l and subtract the count at the end, the port masks them, so
    # l differs in the last bits. bf16: bf16(p) may round the other way for
    # a few keys, and o rounds to bf16: two ulps of the largest |o|
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * BF16_ULP * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # lse is the natural-units log of the row sum
    qs = (_tt(q, td).float() * tfa._qscale(d)).to(td).float()
    p = torch.exp2(qs @ _tt(k, td).float().transpose(-1, -2))
    np.testing.assert_allclose(lse.numpy(), torch.log(p.sum(-1)).reshape(b * n, lq).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("lk", [77, 512, 3584, 3585, 4680, 32760])
def test_attention_route_matches_jax_blocking(lk):
    # K3 exactly where the JAX package takes its single-K-block kernel
    _, block_k = jfa.pick_blocks(4096, lk)
    assert tfa.uses_single_block(lk) == (block_k == (lk + 127) // 128 * 128)


def test_dot_product_attention_is_flash_attention():
    rng = np.random.RandomState(3)
    q, k = _tt(rng.randn(1, 2, 20, 128)), _tt(rng.randn(1, 2, 9, 128))
    v = _tt(rng.randn(1, 9, 2, 128))
    torch.testing.assert_close(tattn.dot_product_attention(q, k, v, **BNLD_BOUNDED),
                               tfa.flash_attention(q, k, v, **BNLD_BOUNDED), rtol=0, atol=0)
    torch.testing.assert_close(tattn.dot_product_attention(q.movedim(1, 2), k.movedim(1, 2), v),
                               tfa.flash_attention(q.movedim(1, 2), k.movedim(1, 2), v),
                               rtol=0, atol=0)


def test_wrappers_refuse_devices_without_a_kernel():
    # no quiet fallback: a tensor that is neither on the CPU nor on CUDA
    # raises instead of running the plain version
    x = torch.empty(1, 8, 256, device="meta")
    s = torch.empty(1, 256, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tstream.ln_scale_shift(x, s, s)
    with pytest.raises(ValueError, match="no kernel"):
        tqr.rmsnorm_only(x.to(torch.bfloat16), s[0], 2)
    q = torch.empty(1, 2, 8, 128, device="meta", dtype=torch.bfloat16)
    v = torch.empty(1, 8, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, v, **BNLD_BOUNDED)
    # the shifted form is ported too: it refuses the device the same way
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, v, qk_layout="bnld")
    with pytest.raises(ValueError, match="qk_layout"):
        tfa.flash_attention(q, q, v, qk_layout="lbnd")
