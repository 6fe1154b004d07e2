"""Gradients of the port's ops and DiT against the JAX package.

On the CPU each port op's ``autograd.Function`` runs its plain forward
and its plain backward (the formulas the Hopper kernels K4/K5, K7 and K9
compute, held to those kernels on the card by chip_smoke.py). The JAX side
runs its ``custom_vjp`` with the Pallas backward kernels in interpret mode
(PALLAS_INTERPRET=1, as the JAX package's own kernel tests do). The
stream and qk-norm ops are called through their single-device ``_local``
functions: the public JAX wrappers take the multi-device path on the
8-device test mesh, whose backward is XLA's, not the kernel's. Inputs come
from numpy with a seed and go to both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import flash_attention as jfa
from hyvideo_prfl_tpu.ops import qknorm_rope as jqr
from hyvideo_prfl_tpu.ops import stream as jstream
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
from hyvideo_prfl_torch.ops import attention as tattn
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # one bf16 ulp at the top binade, relative to max|ref|
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128


@pytest.fixture(autouse=True)
def _pallas_kernel_path(monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET", "1")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tt(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _jt(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("out_dtype,l,s_shape", [
    ("bfloat16", 36, "bd"),    # ragged last tile (JAX block 32), per-batch adaLN scale
    ("float32", 37, "d"),      # the head's fp32 cotangent; a [D] scale broadcast to [B, D]
    ("bfloat16", 48, "1d")])
def test_ln_scale_shift_bwd_matches_jax(out_dtype, l, s_shape):
    rng = np.random.RandomState(4)
    b, d = 2, 256
    x = rng.randn(b, l, d)
    lead = {"bd": (b,), "d": (), "1d": (1,)}[s_shape]
    s = 1.0 + 0.1 * rng.randn(*lead, d)
    t = 0.1 * rng.randn(*lead, d)
    jd, td = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    g = _np(_jt(rng.randn(b, l, d), jd))  # the cotangent, exact in out_dtype

    def jfun(x_, s_, t_):
        sb = jnp.broadcast_to(s_.reshape(-1, d), (b, d))
        tb = jnp.broadcast_to(t_.reshape(-1, d), (b, d))
        return jstream._local(x_, sb, tb, 1e-6, jd)

    out, vjp = jax.vjp(jfun, _jt(x), _jt(s), _jt(t))
    want = vjp(_jt(g, jd))
    tx, ts, tt_ = _tt(x, grad=True), _tt(s, grad=True), _tt(t, grad=True)
    y = tstream.ln_scale_shift(tx, ts, tt_, out_dtype=td)
    got = torch.autograd.grad(y, (tx, ts, tt_), _tt(g, td))
    # fp32 formulas on both sides; the row and column sums run in another
    # order (and JAX sums ds/dt by tile through a ones-row matmul)
    for name, a, w in zip(("dx", "ds", "dt"), got, want):
        _close(a.numpy(), _np(w), 1e-5, name)


@pytest.mark.parametrize("dtype,rope,l", [
    ("float32", True, 36), ("float32", False, 36), ("bfloat16", True, 48),
    ("bfloat16", False, 37)])
def test_rmsnorm_rope_bwd_matches_jax(dtype, rope, l):
    n, d = 2, 128
    grid = {36: (3, 4, 3), 48: (3, 4, 4), 37: (1, 1, 37)}[l]
    rng = np.random.RandomState(5)
    x = rng.randn(1, l, n * d)
    w = rng.rand(n * d) + 0.5
    c, s = rope_tables_rolled_np(grid, d) if rope else (np.zeros((l, d), np.float32),) * 2
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    g = _np(_jt(rng.randn(1, n, l, d), jd))
    out, vjp = jax.vjp(lambda x_, w_: jqr._local(x_, w_, jnp.asarray(c), jnp.asarray(s),
                                                  1e-6, rope),
                       _jt(x, jd), _jt(w).reshape(n, d))
    want_dx, want_dw = vjp(_jt(g, jd))
    tx, tw = _tt(x, td, grad=True), _tt(w, grad=True)
    if rope:
        y = tqr.rmsnorm_rope(tx, tw, torch.from_numpy(c), torch.from_numpy(s), n)
    else:
        y = tqr.rmsnorm_only(tx, tw, n)
    got_dx, got_dw = torch.autograd.grad(y, (tx, tw), _tt(g, td))
    assert got_dx.dtype == td and got_dw.dtype == torch.float32
    if dtype == "float32":
        # the same fp32 formulas; sums of squares and dots in another order
        _close(got_dx.numpy(), _np(want_dx), 1e-5, "dx")
        _close(got_dw.numpy(), _np(want_dw).reshape(-1), 1e-5, "dw")
    else:
        # dx rounds to bf16 (one ulp either way); r differs in its last
        # fp32 bits, so bf16(x r) in dw may round the other way: two ulps
        _close(got_dx.float().numpy(), _np(want_dx), BF16_ULP, "dx")
        _close(got_dw.numpy(), _np(want_dw).reshape(-1), 2 * BF16_ULP, "dw")


@pytest.mark.parametrize("dtype,lq,lk,block", [
    ("float32", 2000, 2000, 512),   # padded streaming shape: the merged route (K4)
    ("float32", 200, 77, None),     # one q block: the split route (K5)
    ("bfloat16", 200, 77, None),
    ("float32", 1024, 300, None)])  # two backward q blocks: split
def test_flash_bwd_matches_jax(dtype, lq, lk, block):
    b, n, d = 1, 2, 128
    rng = np.random.RandomState(6)
    q, k = rng.randn(b, n, lq, d), rng.randn(b, n, lk, d)
    v, g = rng.randn(b, lk, n, d), rng.randn(b, lq, n, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, block_q=block, block_k=block, qk_layout="bnld", bounded_logits=True),
        _jt(q, jd), _jt(k, jd), _jt(v, jd))
    want = vjp(_jt(g, jd))
    tq, tk, tv = (_tt(a, td, grad=True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, qk_layout="bnld", bounded_logits=True)
    got = torch.autograd.grad(o, (tq, tk, tv), _tt(g, td))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and a.shape == w.shape, name
        if dtype == "float32":
            # the same fp32 math; JAX's padded keys carry p != 0 into pad
            # rows only, and sums run in another order
            _close(a.numpy(), _np(w), 2e-5, name)
        else:
            # bf16(p), bf16(ds) and the bf16 outputs may round the other
            # way: two ulps of the largest gradient
            _close(a.float().numpy(), _np(w), 2 * BF16_ULP, name)


@pytest.mark.parametrize("lq,lk", [(200, 77), (1024, 300), (1024, 32760), (2000, 2000),
                                   (4680, 4680), (4680, 512), (9360, 9360), (9360, 512),
                                   (32760, 32760), (32760, 512), (1536, 1536)])
def test_bwd_route_matches_jax(lq, lk):
    # K4 exactly where the JAX package takes its merged backward
    bq, bk = jfa.pick_blocks(lq, lk)
    lq_p, lk_p = jfa._pad_len(lq, bq), jfa._pad_len(lk, bk)
    merged = jfa.FLASH_MERGED_BWD and lq_p // jfa._bwd_blocks_merged(lq_p, lk_p)[0] >= 4
    assert tfa.uses_merged_bwd(lq, lk) == merged


@pytest.mark.parametrize("switch", [True, False])
@pytest.mark.parametrize("lq,lk", [(200, 77), (1024, 32760), (4680, 4680), (32760, 512)])
def test_bwd_route_follows_the_merged_switch(monkeypatch, switch, lq, lk):
    # HYV_FLASH_MERGED_BWD (read at import in both packages): off, every
    # backward takes the split form (K5), as the JAX package's _flash_bwd
    monkeypatch.setattr(jfa, "FLASH_MERGED_BWD", switch)
    monkeypatch.setattr(tfa, "FLASH_MERGED_BWD", switch)
    bq, bk = jfa.pick_blocks(lq, lk)
    lq_p, lk_p = jfa._pad_len(lq, bq), jfa._pad_len(lk, bk)
    merged = jfa.FLASH_MERGED_BWD and lq_p // jfa._bwd_blocks_merged(lq_p, lk_p)[0] >= 4
    assert tfa.uses_merged_bwd(lq, lk) == merged


def _grid_tables(grid):
    return tuple(torch.from_numpy(a) for a in rope_tables_rolled_np(grid, 128))


def _ops():
    c, s = _grid_tables((3, 4, 3))
    rng = np.random.RandomState(7)
    return {
        "ln_scale_shift": (lambda x, s_, t: tstream.ln_scale_shift(x, s_, t, out_dtype=torch.float32),
                           lambda x, s_, t: tstream.ln_scale_shift_plain(
                               x, s_.expand(2, -1), t, out_dtype=torch.float32),
                           [rng.randn(2, 36, 256), 1 + 0.1 * rng.randn(1, 256),
                            0.1 * rng.randn(2, 256)]),
        "rmsnorm_rope": (lambda x, w: tqr.rmsnorm_rope(x, w, c, s, 2),
                         lambda x, w: tqr.rmsnorm_rope_plain(x, w, c, s, 2),
                         [rng.randn(1, 36, 256), rng.rand(256) + 0.5]),
        "rmsnorm_only": (lambda x, w: tqr.rmsnorm_only(x, w, 2),
                         lambda x, w: tqr.rmsnorm_rope_plain(x, w, None, None, 2, do_rope=False),
                         [rng.randn(1, 36, 256), rng.rand(256) + 0.5]),
        "dot_product_attention": (lambda q, k, v: tattn.dot_product_attention(
                                      q, k, v, qk_layout="bnld", bounded_logits=True),
                                  lambda q, k, v: _attention_plain(q, k, v),
                                  [rng.randn(1, 2, 40, 128), rng.randn(1, 2, 21, 128),
                                   rng.randn(1, 21, 2, 128)]),
        # the shifted form with a key mask, token-major q/k (the defaults)
        "shifted_attention": (lambda q, k, v: tattn.dot_product_attention(
                                  q, k, v, k_valid_len=torch.tensor([13, 21])),
                              lambda q, k, v: tfa.flash_attention_shifted_plain(
                                  q.movedim(1, 2), k.movedim(1, 2), v,
                                  torch.tensor([13, 13, 21, 21], dtype=torch.int32))[0],
                              [rng.randn(2, 40, 2, 128), rng.randn(2, 21, 2, 128),
                               rng.randn(2, 21, 2, 128)]),
    }


def _attention_plain(q, k, v):
    return tfa.flash_attention_plain(q, k, v)[0]


@pytest.mark.parametrize("name", ["ln_scale_shift", "rmsnorm_rope", "rmsnorm_only",
                                  "dot_product_attention", "shifted_attention"])
def test_op_grads_are_the_function_backward(name):
    fn, plain, arrays = _ops()[name]
    inputs = [_tt(a, grad=True) for a in arrays]
    out = fn(*inputs)
    # the public op is the autograd Function, never a graph-less output
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, inputs, g)
    want = torch.autograd.grad(plain(*inputs), inputs, g)
    # fp32: the written-out backward against autograd through the plain
    # forward, which differ only in the order of the sums
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


def _tiny_model(param_dtype=None, **kw):
    cfg = tdit.tiny_test(**TINY, compute_dtype=kw.pop("compute_dtype", torch.bfloat16), **kw)
    model = tdit.WanModel(cfg, param_dtype=param_dtype)
    model.load_state_dict(tck.from_jax_params(tck.seeded_jax_tree(cfg, 0), cfg))
    return model


def _inputs(seed=0, f=3, hw=8):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(1, f, hw, hw, 16).astype(np.float32)),
            torch.tensor([700.0]),
            torch.from_numpy(rng.randn(1, 16, 64).astype(np.float32)))


def test_fp32_masters_take_small_updates():
    x, t, ctx = _inputs()
    moved = {}
    for pd in (torch.float32, torch.bfloat16):
        model = _tiny_model(param_dtype=pd)
        w = model.blocks[0].ffn_0.weight
        assert w.dtype == pd and model.blocks[0].norm3_scale.dtype == torch.float32
        model(x, t, ctx).square().sum().backward()
        before = w.detach().clone()
        with torch.no_grad():
            w -= 1e-7 * w.grad  # |update| <= ~1e-6, far below half a bf16 ulp of w
        moved[pd] = float((w.detach() != before).float().mean())
    # fp32 masters keep the update (all but the smallest gradients clear an
    # fp32 ulp); a bf16 store rounds it away except on the few weights
    # within ~1e-4 of zero, whose ulp is that small
    assert moved[torch.float32] > 0.8
    assert moved[torch.bfloat16] < 1e-3


def test_fp32_masters_compute_like_the_bf16_store():
    # the forward casts masters to the compute dtype at use: same output
    x, t, ctx = _inputs(1)
    with torch.no_grad():
        a = _tiny_model(param_dtype=torch.float32)(x, t, ctx)
        b = _tiny_model()(x, t, ctx)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_feature_taps_match_jax():
    cfg = tdit.tiny_test(**{**TINY, "num_layers": 3}, compute_dtype=torch.float32)
    tree = tck.seeded_jax_tree(cfg, 2)
    x, t, ctx = _inputs(2)
    jcfg = jdit.tiny_test(**{**TINY, "num_layers": 3}, compute_dtype=jnp.float32)
    want = np.asarray(jdit.WanModel(jcfg).apply(
        tree, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()), jnp.asarray(ctx.numpy()),
        output_features=True, selected_layers=(3, 1)))
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    with torch.no_grad():
        got = model(x, t, ctx, output_features=True, selected_layers=(3, 1)).numpy()
    assert got.shape == want.shape == (2, 1, 48, 256)
    # fp32 blocks; matmul sums in another order and the fixed-max softmax
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_remat_policies_give_equal_grads():
    x, t, ctx = _inputs(3)
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "attn")):
        model = _tiny_model(param_dtype=torch.float32, compute_dtype=torch.float32,
                            remat=remat, remat_policy=policy)
        xi = x.clone().requires_grad_()
        model(xi, t, ctx).square().mean().backward()
        grads[(remat, policy)] = [xi.grad] + [p.grad for p in model.parameters()]
    ref = grads[(False, "full")]
    for key, gs in grads.items():
        # recompute replays the same deterministic CPU ops: equal grads
        for a, b in zip(gs, ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_dots_remat_policies_are_not_ported():
    for policy in ("dots", "dots_all"):
        with pytest.raises(NotImplementedError, match=policy):
            tdit.WanModel(dataclasses.replace(tdit.tiny_test(), remat_policy=policy))


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_tiny_model_launches(monkeypatch, bwd_key):
    """Kernel launches of one forward and backward of the 2-block tiny
    model: on the CPU the same Functions call the plain versions; each is
    counted by the kernel the card would launch for it (the flash backward
    by ``bwd_key(q, k)``)."""
    counts = {}

    def counted(mod, name, key_fn):
        fn = getattr(mod, name)

        def wrapper(*args, **kw):
            key = key_fn(*args)
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    counted(tstream, "ln_scale_shift_plain", lambda *a: "K8")
    counted(tstream, "ln_scale_shift_bwd_plain", lambda *a: "K9")
    counted(tqr, "rmsnorm_rope_plain", lambda *a: "K6")
    counted(tqr, "rmsnorm_rope_bwd_plain", lambda *a: "K7")
    counted(tfa, "flash_attention_plain",
            lambda q, k, v: "K3" if tfa.uses_single_block(k.shape[2]) else "K1")
    counted(tfa, "flash_attention_shifted_plain",
            lambda q, k, v, kvalid: "K3s" if tfa.uses_single_block(k.shape[2]) else "K2")
    counted(tfa, "flash_attention_bwd_plain", lambda q, k, *a: bwd_key(q, k))
    x, t, ctx = _inputs(4)
    model = _tiny_model(param_dtype=torch.float32, remat_policy="attn")
    model(x.requires_grad_(), t, ctx).square().mean().backward()
    assert tfa.uses_single_block(48)  # the tiny grid's 48 tokens
    return counts


@pytest.mark.parametrize("shifted", [False, True])
def test_launch_derivation_with_single_block_self_attention(monkeypatch, shifted):
    # chip_smoke.py holds the 14B check at 1,560 tokens to dit_launches with
    # self_single: there the self-attention's keys fit one block, so it
    # takes K3 (K3s on the shifted route) like the cross-attention
    if shifted:
        monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
    counts = _count_tiny_model_launches(monkeypatch, lambda q, k: "K4")
    assert counts == _chip_smoke().dit_launches(2, True, shifted=shifted, self_single=True)


@pytest.mark.parametrize("shifted", [False, True])
def test_launch_derivation_without_the_merged_backward(monkeypatch, shifted):
    # HYV_FLASH_MERGED_BWD=0: every flash backward is K5, so dit_launches
    # with merged_bwd=False has K5 where it had K4, call for call
    monkeypatch.setattr(tfa, "FLASH_MERGED_BWD", False)
    if shifted:
        monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
    counts = _count_tiny_model_launches(
        monkeypatch,
        lambda q, k: "K4" if tfa.uses_merged_bwd(q.shape[2], k.shape[2]) else "K5")
    smoke = _chip_smoke()
    want = smoke.dit_launches(2, True, shifted=shifted, self_single=True, merged_bwd=False)
    assert counts == want
    merged = smoke.dit_launches(2, True, shifted=shifted, self_single=True)
    assert want == {("K5" if name == "K4" else name): n for name, n in merged.items()}
