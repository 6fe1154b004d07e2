"""The port's shifted-softmax route and un-normed DiT against the JAX package.

On the CPU the port runs its plain versions: the shifted forward
(``flash_attention_shifted_plain``, what K2 and K3s compute), the masked
backward (K4/K5), the standalone rope (R) and the un-normed DiT built on
them. The JAX side runs its Pallas kernels in interpret mode, with
FULL_K_MAX and DEFAULT_BLOCK_K shrunk to 128 where a test needs its
streaming forward (K2) at test size, as tests/test_quant.py does; the
port reads its own FULL_K_MAX at call time and gets the same shrink. Its
DiT runs the XLA attention on the CPU, the plain softmax. Inputs come from
numpy with a seed and go to both.
"""

import dataclasses
import functools
import importlib.util
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import rope as jrope
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import attention as jattn
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_tpu.ops import flash_attention as jfa
from hyvideo_prfl_tpu.ops import rope_pallas as jrp
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
from hyvideo_prfl_torch.ops import attention as tattn
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import rope as trope
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BF16_ULP = 2.0 ** -7  # one bf16 ulp at the top binade, relative to max|ref|
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128
UNNORMED = {"no-qk-norm": dict(qk_norm=False),
            "no-norms": dict(qk_norm=False, cross_attn_norm=False)}


@pytest.fixture(autouse=True)
def _pallas_kernel_path(monkeypatch):
    monkeypatch.setenv("PALLAS_INTERPRET", "1")


@pytest.fixture
def streaming(monkeypatch):
    """Both packages stream keys past 128 (the shifted forward K2)."""
    monkeypatch.setattr(jfa, "FULL_K_MAX", 128)
    monkeypatch.setattr(jfa, "DEFAULT_BLOCK_K", 128)
    monkeypatch.setattr(tfa, "FULL_K_MAX", 128)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tt(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _jt(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _blnd(lq, lk, seed, b=2, n=2, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, n, 128) * scale, rng.randn(b, lk, n, 128) * scale,
            rng.randn(b, lk, n, 128))


# -- the shifted forward and the masked backward ----------------------------

# (lq, lk, k_valid_len, streaming): one K block (K3s) with a ragged key
# tail, streaming (K2) with a ragged tail, and each with a user mask; the
# last masks every key of the streaming run's second block for batch 0
FWD_CASES = {
    "single": (200, 77, None, False),
    "single-mask": (200, 77, [40, 77], False),
    "single-mask-tile-edge": (200, 129, [128, 129], False),
    "stream": (300, 200, None, True),
    "stream-mask": (300, 200, [113, 200], True),
    "stream-mask-one-block": (130, 300, [128, 250], True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_shifted_forward_matches_jax(monkeypatch, dtype, case):
    lq, lk, valid, stream = FWD_CASES[case]
    if stream:
        monkeypatch.setattr(jfa, "FULL_K_MAX", 128)
        monkeypatch.setattr(jfa, "DEFAULT_BLOCK_K", 128)
        monkeypatch.setattr(tfa, "FULL_K_MAX", 128)
    assert tfa.uses_single_block(lk) == (not stream)
    q, k, v = _blnd(lq, lk, seed=len(case))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    want = _np(jfa.flash_attention(_jt(q, jd), _jt(k, jd), _jt(v, jd), k_valid_len=jvalid))
    tvalid = None if valid is None else torch.tensor(valid)
    got, lse = tfa.flash_attention(_tt(q, td), _tt(k, td), _tt(v, td), k_valid_len=tvalid,
                                   return_lse=True)
    got = got.float().numpy()
    assert got.shape == (2, lq, 2, 128) and lse.shape == (4, lq)
    if dtype == "float32":
        # the same fp32 softmax; JAX shifts by its running block max (and
        # pad columns can lift it to 0) where the plain version shifts by
        # the row max: the same quotient, rounded in other places
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # bf16(p) rounds p = exp2(s - m) at another m (the online block
        # maxima), so each p may round the other way, and o rounds to bf16:
        # two bf16 ulps of the largest |o|
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * BF16_ULP * np.abs(want).max())
    # lse is the natural-units log-sum-exp of the unmasked scores, in fp64
    qs = (_tt(q, td).float() * tfa._qscale(128)).to(td).double().movedim(1, 2)
    s = qs @ _tt(k, td).double().movedim(1, 2).transpose(-1, -2)
    if valid is not None:
        keep = torch.arange(lk) < torch.tensor(valid)[:, None, None, None]
        s = s.masked_fill(~keep, -np.inf)
    ref = (torch.logsumexp(s * np.log(2.0), dim=-1)).reshape(4, lq)
    np.testing.assert_allclose(lse.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_shifted_forward_survives_logits_past_the_bounded_range():
    # logits near 300: exp2 of the unshifted scores overflows fp32 (the
    # bounded form's inf / inf); the shifted form stays finite and is the
    # softmax of the same scores
    q, k, v = _blnd(64, 90, seed=3, scale=8.0)
    tq, tk, tv = _tt(q), _tt(k), _tt(v)
    logits = (torch.einsum("bqnd,bknd->bnqk", tq, tk) / np.sqrt(128)).abs().max().item()
    assert logits > 250
    bounded = tfa.flash_attention(tq, tk, tv, bounded_logits=True)
    assert not torch.isfinite(bounded).all()
    got = tfa.flash_attention(tq, tk, tv)
    ref = torch.einsum("bnqk,bknd->bqnd", torch.softmax(
        torch.einsum("bqnd,bknd->bnqk", tq.double(), tk.double()) / np.sqrt(128), -1),
        tv.double())
    # fp32 scores of magnitude ~300 carry ~3e-5 absolute error each, which
    # moves the softmax weights by that relative amount
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-3 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["single-mask", "stream", "stream-mask"])
def test_shifted_backward_matches_jax(monkeypatch, dtype, case):
    lq, lk, valid, stream = FWD_CASES[case]
    if stream:
        monkeypatch.setattr(jfa, "FULL_K_MAX", 128)
        monkeypatch.setattr(jfa, "DEFAULT_BLOCK_K", 128)
        monkeypatch.setattr(tfa, "FULL_K_MAX", 128)
    q, k, v = _blnd(lq, lk, seed=7 + len(case))
    g = np.random.RandomState(8).randn(2, lq, 2, 128)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, k_valid_len=jvalid),
                     _jt(q, jd), _jt(k, jd), _jt(v, jd))
    want = vjp(_jt(g, jd))
    tq, tk, tv = (_tt(a, td, grad=True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, k_valid_len=None if valid is None else torch.tensor(valid))
    got = torch.autograd.grad(o, (tq, tk, tv), _tt(g, td))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float().numpy(), _np(w)
        assert a.shape == w.shape, name
        # fp32: the same lse-recompute backward, sums in another order;
        # bf16: bf16(p), bf16(ds) and the outputs may round the other way,
        # two ulps of the largest gradient
        tol = 2e-5 if dtype == "float32" else 2 * BF16_ULP
        np.testing.assert_allclose(a, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=name)
        if valid is not None and name != "dq":
            for bi, n_valid in enumerate(valid):  # masked keys: exactly 0 on both sides
                assert not a[bi, n_valid:].any() and not w[bi, n_valid:].any()


def test_masked_key_gradients_are_exactly_zero_on_both_routes():
    # the lengths at which the JAX rule takes the merged (K4) and the split
    # (K5) backward; on the CPU both run the plain version
    for lq, merged in ((2048, True), (1024, False)):
        assert tfa.uses_merged_bwd(lq, 96) == merged
        q, k, v = _blnd(lq, 96, seed=11, b=1)
        tq, tk, tv = (_tt(a, torch.bfloat16, grad=True) for a in (q, k, v))
        o = tfa.flash_attention(tq, tk, tv, k_valid_len=torch.tensor([50]))
        dq, dk, dv = torch.autograd.grad(o.float().square().sum(), (tq, tk, tv))
        assert not dk[:, 50:].any() and not dv[:, 50:].any()
        assert dk[:, :50].abs().sum() > 0 and dq.abs().sum() > 0


# -- routing: HYV_FLASH_BOUNDED and the int8 fallback ----------------------


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tfa, name)
    monkeypatch.setattr(tfa, name, lambda *a, **kw: calls.append(a[1].shape[2]) or fn(*a, **kw))
    return calls


def _load_script(name):
    key = f"{name}_shifted_route"  # the dataclasses need the module registered
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(REPO, "scripts",
                                                                         name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def test_bounded_off_routes_the_dit_to_the_shifted_form(monkeypatch):
    shifted = _spy(monkeypatch, "flash_attention_shifted_plain")
    bounded = _spy(monkeypatch, "flash_attention_plain")
    tree = tck.seeded_jax_tree(tdit.tiny_test(**TINY), 5)
    x, t, ctx = _dit_inputs(5)
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    want = np.asarray(jdit.WanModel(jcfg).apply(tree, *map(jnp.asarray, (x, t, ctx))))
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    with torch.no_grad():
        on = model(*map(torch.from_numpy, (x, t, ctx))).numpy()
        assert len(bounded) == 4 and not shifted
        monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
        off = model(*map(torch.from_numpy, (x, t, ctx))).numpy()
    # every attention of the qk-normed DiT took the shifted form: the self-
    # (48 keys) and the cross-attention (16) of both blocks
    assert len(bounded) == 4 and sorted(shifted) == [16, 16, 48, 48]
    # fp32: JAX's CPU DiT takes the plain softmax, so the shifted route
    # agrees with it as closely as the bounded one (1e-4 of the output
    # scale over two blocks, as tests/test_torch_wan_dit.py holds it)
    for got in (on, off):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_bounded_off_sends_qk_int8_to_the_bf16_route(streaming, monkeypatch):
    qk8 = _spy(monkeypatch, "flash_attention_qk8_plain")
    shifted = _spy(monkeypatch, "flash_attention_shifted_plain")
    q, k, v = (_tt(a, torch.bfloat16) for a in _blnd(200, 200, seed=12))
    with torch.no_grad():
        tfa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True)
        assert len(qk8) == 1 and not shifted
        # a user mask keeps the shifted form, as in the JAX package
        tfa.flash_attention(q, k, v, torch.tensor([100, 7]), bounded_logits=True, qk_int8=True)
        monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
        tfa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True)
    assert len(qk8) == 1 and len(shifted) == 2


def test_cli_serves_on_the_shifted_route(monkeypatch):
    # the serving CLI's request path on a tiny DiT under HYV_FLASH_BOUNDED=0
    shifted = _spy(monkeypatch, "flash_attention_shifted_plain")
    bounded = _spy(monkeypatch, "flash_attention_plain")
    monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "latent_grid", lambda size, frame_num, sp_size=1: (3, 8, 8))
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tdit.init_params(tdit.WanModel(cfg), torch.Generator().manual_seed(0))
    ctx = torch.from_numpy(np.random.RandomState(6).randn(1, 16, 64).astype(np.float32))
    req = cli.Request(seed=7, context=ctx, context_null=torch.zeros_like(ctx), frame_num=9,
                      sample_steps=2)
    with torch.no_grad():
        lat = cli.run_request(tpipe.WanT2V(model.eval()), req, "832*480")
    assert lat.shape == (1, 3, 8, 8, 16) and torch.isfinite(lat).all()
    # two batched-CFG forwards, each with a self- and a cross-attention per block
    assert len(shifted) == 2 * 2 * cfg.num_layers and not bounded


def test_defaults_follow_the_jax_signatures():
    pairs = ((tfa.flash_attention, jfa.flash_attention),
             (tattn.dot_product_attention, jattn.dot_product_attention))
    for port_fn, jax_fn in pairs:
        port, ref = (inspect.signature(f).parameters for f in (port_fn, jax_fn))
        shared = [name for name in ref if name in port]
        assert {"k_valid_len", "qk_layout", "bounded_logits", "qk_int8"} <= set(shared)
        for name in shared:
            assert port[name].default == ref[name].default, (port_fn.__name__, name)
        # the shared arguments come in the JAX order
        assert shared == [name for name in port if name in ref]


# -- R: the standalone rope ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rotate_matches_jax(monkeypatch, dtype):
    # interpret mode for the JAX kernel, whose call names no interpret flag
    monkeypatch.setattr(jrp.pl, "pallas_call",
                        functools.partial(jrp.pl.pallas_call, interpret=True))
    grid = (3, 4, 4)
    c, s = rope_tables_rolled_np(grid, 128)
    rng = np.random.RandomState(13)
    x, g = rng.randn(2, 48, 3, 128), rng.randn(2, 48, 3, 128)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jc, js = jnp.asarray(c), jnp.asarray(s)
    out, vjp = jax.vjp(lambda x_: jrp.rope_rotate(x_, jc, js), _jt(x, jd))
    (jdx,) = vjp(_jt(g, jd))
    tx = _tt(x, td, grad=True)
    got = trope.rope_rotate(tx, torch.from_numpy(c), torch.from_numpy(s))
    (tdx,) = torch.autograd.grad(got, tx, _tt(g, td))
    assert got.dtype == td and tdx.dtype == td
    xla = _np(jrope.apply_rope_rolled(_jt(x, jd), jc, js))
    # the same unfused fp32 products and sum as the XLA formulation: bit for bit
    np.testing.assert_array_equal(got.float().detach().numpy(), xla)
    if dtype == "bfloat16":
        # the JAX kernel too, forward and backward, once rounded to bf16
        np.testing.assert_array_equal(got.float().detach().numpy(), _np(out))
        np.testing.assert_array_equal(tdx.float().numpy(), _np(jdx))
    else:
        # in fp32 the interpreted kernel fuses one product into the sum on
        # some elements: one fp32 ulp of the output scale
        for a, w in ((got.detach().numpy(), _np(out)), (tdx.numpy(), _np(jdx))):
            np.testing.assert_allclose(a, w, rtol=0, atol=2.0 ** -22 * np.abs(w).max())


def test_rope_backward_is_the_rotation_by_the_rolled_table():
    # linear in x: the backward is the forward with S_bwd = roll(S, D/2),
    # the adjoint of the rotation
    c, s = (torch.from_numpy(a) for a in rope_tables_rolled_np((2, 3, 5), 128))
    rng = np.random.RandomState(14)
    x, g = _tt(rng.randn(1, 30, 2, 128), grad=True), _tt(rng.randn(1, 30, 2, 128))
    (dx,) = torch.autograd.grad((trope.rope_rotate(x, c, s) * g).sum(), x)
    want = trope.rope_rotate_plain(g, c, torch.roll(s, 64, dims=-1))
    torch.testing.assert_close(dx, want, rtol=0, atol=0)
    # and the rotation keeps each head's norm, as a rotation must
    y = trope.rope_rotate_plain(x.detach().double(), c.double(), s.double())
    torch.testing.assert_close(y.norm(dim=-1), x.detach().double().norm(dim=-1))


def test_rope_refuses_devices_without_a_kernel():
    x = torch.empty(1, 4, 2, 128, device="meta")
    tab = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trope.rope_rotate(x, tab, tab)


# -- the un-normed DiT --------------------------------------------------------


def _dit_inputs(seed, b=2, f=3, hw=8, text_len=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, f, hw, hw, 16).astype(np.float32),
            np.array([900.0, 250.0][:b], np.float32),
            rng.randn(b, text_len, 64).astype(np.float32))


def _unnormed(kind, compute_dtype=torch.float32, param_dtype=None, **kw):
    cfg = tdit.tiny_test(**TINY, **UNNORMED[kind], compute_dtype=compute_dtype, **kw)
    tree = tck.seeded_jax_tree(cfg, 21)
    model = tdit.WanModel(cfg, param_dtype=param_dtype)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    return model, tree


@pytest.mark.parametrize("kind", list(UNNORMED))
def test_unnormed_tree_matches_the_jax_structure(kind):
    cfg = tdit.tiny_test(**TINY, **UNNORMED[kind])
    jcfg = jdit.tiny_test(**TINY, **UNNORMED[kind])
    shapes = jax.eval_shape(lambda: jdit.init_params(jcfg, jax.random.PRNGKey(0), text_len=16))
    tree = tck.seeded_jax_tree(cfg, 0)
    assert (jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(lambda a: a.shape, tree))
    leaves = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert not any("norm_q" in k or "norm_k" in k for k in leaves)
    assert any("norm3" in k for k in leaves) == cfg.cross_attn_norm
    # both converters give exactly the model's keys
    state = tck.from_jax_params(tree, cfg)
    ref = tck.from_reference_state(jck.flax_to_torch_state(tree, jcfg), cfg)
    model = tdit.init_params(tdit.WanModel(cfg), torch.Generator().manual_seed(0))
    assert state.keys() == ref.keys() == model.state_dict().keys()
    for key in state:
        torch.testing.assert_close(state[key], ref[key], rtol=0, atol=0, msg=key)


def test_unnormed_t2v_sample_matches_jax():
    # the pipeline takes an un-normed WanConfig: three batched-CFG UniPC
    # steps against the JAX pipeline's, from the JAX noise draw
    cfg = tdit.tiny_test(**TINY, **UNNORMED["no-norms"], compute_dtype=torch.float32)
    tree = tck.seeded_jax_tree(cfg, seed=29)
    rng = np.random.RandomState(30)
    ctx = rng.randn(1, 16, 64).astype(np.float32)
    ctx_null = rng.randn(1, 16, 64).astype(np.float32) * 0.1
    shape = (1, 3, 8, 8, 16)
    key = jax.random.PRNGKey(31)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    jcfg = jdit.tiny_test(**TINY, **UNNORMED["no-norms"], compute_dtype=jnp.float32)
    jgen = jpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    want = np.asarray(jpipe.WanT2V(jcfg, tree).sample(key, shape, jnp.asarray(ctx),
                                                      jnp.asarray(ctx_null), jgen))
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    gen = tpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    got = tpipe.WanT2V(model.eval()).generate(
        None, torch.from_numpy(ctx), torch.from_numpy(ctx_null), 3, 8, 8, gen,
        noise=torch.from_numpy(noise)).numpy()
    assert np.abs(want - noise).max() > 0.1  # the DiT moved the latent
    # fp32 end to end, three steps of a DiT held to 1e-4 per forward: as
    # tests/test_torch_pipeline.py holds the qk-normed sample
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", list(UNNORMED))
def test_unnormed_remat_policies_give_equal_grads(kind):
    x, t, ctx = (torch.from_numpy(a) for a in _dit_inputs(25, b=1))
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "attn")):
        model, _ = _unnormed(kind, param_dtype=torch.float32, remat=remat, remat_policy=policy)
        xi = x.clone().requires_grad_()
        model(xi, t, ctx).square().mean().backward()
        grads[(remat, policy)] = [xi.grad] + [p.grad for p in model.parameters()]
    # recompute replays the same deterministic CPU ops: equal grads
    for gs in grads.values():
        for a, b in zip(gs, grads[(False, "full")]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_unnormed_dit_ignores_quant_attn(monkeypatch):
    # the int8 q k^T needs the bounded logits of qk-norm: without it the
    # self-attention stays on the shifted bf16 route, as in the JAX package
    qk8 = _spy(monkeypatch, "flash_attention_qk8_plain")
    model, _ = _unnormed("no-qk-norm", compute_dtype=torch.bfloat16, quant_attn="int8")
    monkeypatch.setattr(tfa, "FULL_K_MAX", 0)  # every call would stream
    with torch.no_grad():
        model(*map(torch.from_numpy, _dit_inputs(26)))
    assert not qk8


def test_attn_logit_bound_matches_jax():
    cfg = tdit.tiny_test(**{**TINY, "num_layers": 3})
    tree = tck.seeded_jax_tree(cfg, 27)
    blocks = tree["params"]["blocks"]
    blocks["cross_attn"]["norm_k"][1, 5] = -3.0  # the largest |gain| anywhere
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    want = jfa.attn_logit_bound(jax.tree.map(jnp.asarray, tree))
    for state in (model, model.state_dict()):
        got = tfa.attn_logit_bound(state)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    gq = max(np.abs(blocks[a]["norm_q"]).max() for a in ("self_attn", "cross_attn"))
    assert got[0] == pytest.approx(gq * 3.0 * np.sqrt(128), rel=1e-6)
    unnormed, _ = _unnormed("no-qk-norm")
    assert tfa.attn_logit_bound(unnormed) == (0.0, 0.0)


def test_unnormed_config_fields_match_jax():
    for name in ("qk_norm", "cross_attn_norm"):
        assert (getattr(tdit.WanConfig(), name)
                == getattr(jdit.WanConfig(), name) is True)
    cfg = dataclasses.replace(tdit.t2v_1_3b(), qk_norm=False)
    model = tdit.WanModel(dataclasses.replace(cfg, num_layers=1), device="meta")
    keys = model.state_dict().keys()
    assert not any("norm_q" in k or "norm_k" in k for k in keys)
    assert "blocks.0.norm3_scale" in keys


@pytest.mark.parametrize("kind", list(UNNORMED))
@pytest.mark.parametrize("remat_policy", ["attn", "full"])
def test_unnormed_launch_derivation_counts_the_calls(monkeypatch, kind, remat_policy):
    # chip_smoke.py holds the card's launch counters to dit_launches; on the
    # CPU the same Functions call the plain versions, so counting those
    # calls checks the derivation for the un-normed DiT (R forward, its
    # recompute under remat and its backward; K2/K3s; no K6/K7)
    import importlib.util
    import os

    from hyvideo_prfl_torch.ops import stream as tstream

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
    counted(trope, "rope_rotate_plain", lambda *a: "R")
    counted(tfa, "flash_attention_shifted_plain",
            lambda q, k, v, kvalid: "K3s" if k.shape[2] == 16 else "K2")
    counted(tfa, "flash_attention_bwd_plain", lambda *a: "K4")
    model, _ = _unnormed(kind, param_dtype=torch.float32, remat_policy=remat_policy)
    x, t, ctx = (torch.from_numpy(a) for a in _dit_inputs(28, b=1))
    model(x.requires_grad_(), t, ctx.requires_grad_()).square().mean().backward()
    cfg = model.cfg
    assert counts == smoke.dit_launches(2, True, remat_policy=remat_policy, qk_norm=False,
                                        cross_attn_norm=cfg.cross_attn_norm)
