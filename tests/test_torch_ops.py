"""The port's ops (hyvideo_prfl_torch/ops) against the JAX package.

On the CPU each port op runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode (PALLAS_INTERPRET=1, as the JAX
package's own kernel tests do), so this holds the plain versions, which
chip_smoke.py then holds the Hopper kernels to, against the TPU kernels'
math. Inputs are made by numpy from a seed and handed to both.
"""

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


@pytest.mark.parametrize("out_dtype,l,affine", [
    ("bfloat16", 48, False), ("bfloat16", 36, True), ("float32", 36, False)])
def test_ln_scale_shift_matches_jax(out_dtype, l, affine):
    rng = np.random.RandomState(0)
    b, d = 2, 256
    x = rng.randn(b, l, d) * 0.5
    s = 1.0 + 0.1 * rng.randn(d if affine else b * d).reshape(-1, d)
    t = 0.1 * rng.randn(*s.shape)
    want = _np(jstream.ln_scale_shift(_jt(x), _jt(s), _jt(t),
                                      out_dtype=getattr(jnp, out_dtype)))
    got = tstream.ln_scale_shift(_tt(x), _tt(s), _tt(t),
                                 out_dtype=getattr(torch, out_dtype)).float().numpy()
    # identical math; the mean/variance sums may run in another order, which
    # can move a value across a bf16 rounding boundary (one ulp) or change
    # fp32 in the last bits
    if out_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULP * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,rope,l", [
    ("bfloat16", True, 48), ("bfloat16", True, 36), ("bfloat16", False, 36),
    ("float32", True, 36), ("float32", False, 48)])
def test_rmsnorm_rope_matches_jax(dtype, rope, l):
    n, d = 2, 128
    grid = {48: (3, 4, 4), 36: (3, 4, 3)}[l]
    rng = np.random.RandomState(1)
    x = rng.randn(1, l, n * d)
    w = rng.rand(n * d) + 0.5
    c, s = trope.rope_tables_rolled_np(grid, d)
    jx, tx = _jt(x, getattr(jnp, dtype)), _tt(x, getattr(torch, dtype))
    if rope:
        want = _np(jqr.rmsnorm_rope(jx, _jt(w), jnp.asarray(c), jnp.asarray(s), n))
        got = tqr.rmsnorm_rope(tx, _tt(w), torch.from_numpy(c), torch.from_numpy(s), n)
    else:
        want = _np(jqr.rmsnorm_only(jx, _jt(w), n))
        got = tqr.rmsnorm_only(tx, _tt(w), n)
    got = got.float().numpy()
    assert got.shape == (1, n, l, d)
    # identical math; the sum of squares may run in another order, so
    # bf16(x r) can round the other way, and the rope sum mixes two such
    # values: two bf16 ulps in bf16, fp32 rounding in fp32
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * BF16_ULP * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


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
