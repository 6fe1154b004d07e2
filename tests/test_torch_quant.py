"""The port's int8 paths against the JAX package, on the CPU: the W8A8
dense ops (ops/quant.py), the int8 q k^T attention (K10's plain version),
the int8 checkpoint converters, a tiny int8 DiT, the int8 serving loop, one
refl step with the int8 rollout, and the probes' plain versions.

Inputs come from numpy with a seed and go to both packages. The JAX side
runs its Pallas kernels in interpret mode with the flash backend, and, as
tests/test_quant.py does, with FULL_K_MAX and DEFAULT_BLOCK_K shrunk so the
self-attention streams in several key blocks (the int8 kernel's regime)
at test size; the port reads its own FULL_K_MAX at call time and gets the
same shrink.
"""

import dataclasses
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import attention as jattn
from hyvideo_prfl_tpu.ops import flash_attention as jfa
from hyvideo_prfl_tpu.ops import quant as jquant
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_tpu.training.pavrm import PavrmConfig as JPavrmConfig
from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import int8_probe
from hyvideo_prfl_torch.ops import quant as tquant
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.training.pavrm import PavrmConfig
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128
INT8 = dict(quant_dense="int8", quant_attn="int8")
SHAPE = (1, 3, 16, 16, 16)  # 192 tokens: two 128-key blocks once shrunk
TEXT_LEN = 16
BF16_ULP = 2.0 ** -7
# head-major q/k with bounded logits, as the qk-normed DiT calls attention
BNLD_BOUNDED = dict(qk_layout="bnld", bounded_logits=True)


@pytest.fixture
def streaming(monkeypatch):
    """Interpret-mode Pallas and the flash backend on the JAX side; both
    packages stream self-attention above 128 keys, so 192 tokens take the
    int8 kernel and the 16 text tokens the single-block one."""
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "FULL_K_MAX", 128)
    monkeypatch.setattr(jfa, "DEFAULT_BLOCK_K", 128)
    monkeypatch.setattr(tfa, "FULL_K_MAX", 128)
    jattn.set_default_backend("flash")
    yield
    jattn.set_default_backend("auto")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(seed, num_layers=2):
    return tck.seeded_jax_tree(tdit.tiny_test(**{**TINY, "num_layers": num_layers}), seed)


def _jax_quantized(tree, jcfg_q):
    qshapes = jax.eval_shape(lambda: jdit.init_params(jcfg_q, jax.random.PRNGKey(0),
                                                      text_len=TEXT_LEN))
    return jquant.quantize_params(tree, qshapes)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- ops/quant.py ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)  # JAX layout [..., in, out]
    w[..., 5] = 0.0  # an all-zero output channel: scale EPS, values 0
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2))))
    # the same fp32 division, round-half-even and clip: bit for bit
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(tq.numpy(), -1, -2), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[..., 5].eq(tquant.EPS).all() and not tq[..., 5, :].any()


def test_int8_dense_matches_jax():
    rng = np.random.RandomState(1)
    d, f, n_tok = 96, 40, 24
    x = jnp.asarray(rng.randn(2, n_tok, d).astype(np.float32), jnp.bfloat16)
    x = x.at[1, 3].set(0.0)  # a zero-row token
    w = jnp.asarray(rng.randn(d, f).astype(np.float32) * 0.05)
    bias = jnp.asarray(rng.randn(f).astype(np.float32) * 0.1)
    jq, js = jquant.quantize_weight(w)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    twq = torch.from_numpy(np.ascontiguousarray(np.asarray(jq).T))
    tws = torch.from_numpy(np.asarray(js))
    # x8 and its scale: through an identity int8 weight, JAX's int8_dense
    # returns x8 * xs exactly; the port's quantize_tokens must give the same
    eye = jnp.eye(d, dtype=jnp.int8)
    want_x = np.asarray(jquant.int8_dense(x, eye, jnp.ones(d), out_dtype=jnp.float32))
    x8, xs = tquant.quantize_tokens(tx)
    np.testing.assert_array_equal((x8.float() * xs).numpy(), want_x)
    # y: the int32 product is exact on both sides; the fp32 rescale and bias
    # add are the same operations, so they agree to fp32 rounding
    want = np.asarray(jquant.int8_dense(x, jq, js, bias, out_dtype=jnp.float32))
    got = tquant.int8_dense(tx, twq, tws, torch.from_numpy(np.asarray(bias)),
                            out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the zero-row token gives exact zeros without its bias (as in JAX)
    assert not tquant.int8_dense(tx, twq, tws)[1, 3].any()
    # the default output type is x's (bf16), from the same fp32 values
    assert tquant.int8_dense(tx, twq, tws).dtype == torch.bfloat16


# -- K10's plain version --------------------------------------------------


def _qkv(lq, lk, seed=2, b=2, n=2):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sd: (rng.randn(*s) * sd).astype(np.float32)  # noqa: E731
    return mk(b, n, lq, 128, sd=0.08), mk(b, n, lk, 128, sd=0.08), mk(b, lk, n, 128, sd=1.0)


@pytest.mark.parametrize("l", [1024, 900])  # aligned, and ragged keys
def test_qk8_attention_matches_jax(streaming, l):
    q, k, v = _qkv(l, l)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = _np(jfa.flash_attention(jb(q), jb(k), jb(v), block_q=256, block_k=256,
                                   qk_layout="bnld", bounded_logits=True, qk_int8=True))
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    with torch.no_grad():
        got, lse = tfa.flash_attention(tb(q), tb(k), tb(v), qk_int8=True, return_lse=True,
                                       **BNLD_BOUNDED)
    assert got.shape == (2, l, 2, 128) and lse.shape == (4, l)
    # q8, k8 and the integer scores are the same on both sides; exp2 may
    # differ in its last ulp, so bf16(p) can round the other way on a few
    # keys, and o rounds to bf16: two bf16 ulps of the largest |o|
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * BF16_ULP * np.abs(want).max())
    # the int8 quantization error itself stays small against the bf16 forward
    ref = tfa.flash_attention(tb(q), tb(k), tb(v), **BNLD_BOUNDED).float().numpy()
    assert np.abs(got.float().numpy() - ref).max() < 5e-3


def test_qk8_attention_routes_by_the_jax_rule(streaming, monkeypatch):
    calls = []
    plain = tfa.flash_attention_qk8_plain
    monkeypatch.setattr(tfa, "flash_attention_qk8_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(200, 200))
    _, kt, vt = (torch.from_numpy(a).bfloat16() for a in _qkv(200, 100))
    with torch.no_grad():
        tfa.flash_attention(q, k, v, qk_int8=True, **BNLD_BOUNDED)    # 256 padded keys: K10
        tfa.flash_attention(q, kt, vt, qk_int8=True, **BNLD_BOUNDED)  # 128: one block, K3
        tfa.flash_attention(q, k, v, **BNLD_BOUNDED)                  # not asked for
    assert len(calls) == 1
    monkeypatch.setattr(tfa, "FULL_K_MAX", 3584)      # read at call time
    with torch.no_grad():
        tfa.flash_attention(q, k, v, qk_int8=True, **BNLD_BOUNDED)
    assert len(calls) == 1
    monkeypatch.setattr(tfa, "FULL_K_MAX", 128)
    # no backward: a call that could need one is refused, never silent zeros
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), k, v, qk_int8=True, **BNLD_BOUNDED)


def test_qk8_switch_off_takes_the_bf16_route_as_jax(streaming, monkeypatch):
    # HYV_FLASH_QK8=0 (read at import in both packages): a qk_int8 call
    # runs the bf16 forward, in the JAX package and in the port alike
    monkeypatch.setattr(jfa, "FLASH_QK8", False)
    monkeypatch.setattr(tfa, "FLASH_QK8", False)
    calls = []
    plain = tfa.flash_attention_qk8_plain
    monkeypatch.setattr(tfa, "flash_attention_qk8_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = _qkv(300, 300)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = _np(jfa.flash_attention(jb(q), jb(k), jb(v), block_q=256, block_k=256,
                                   qk_layout="bnld", bounded_logits=True, qk_int8=True))
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    with torch.no_grad():
        got = tfa.flash_attention(tb(q), tb(k), tb(v), qk_int8=True, **BNLD_BOUNDED)
    assert not calls
    # the bf16 forward on both sides: exp2 may differ in its last ulp, so
    # bf16(p) can round the other way on a few keys, and o rounds to bf16:
    # two bf16 ulps of the largest |o|, as test_qk8_attention_matches_jax
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * BF16_ULP * np.abs(want).max())


def test_qk8_scale_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 3, 50, 128) * 0.3).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero head: scale 1e-30 / 127, values 0
    x8, s = tfa.quantize_bn(torch.from_numpy(x))
    j8, js = jfa._quantize_bn(jnp.asarray(x.reshape(6, 50, 128)))
    np.testing.assert_array_equal(x8.numpy().reshape(6, 50, 128), np.asarray(j8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # c as the JAX package forms it: fp32(sq sk) * fp32(scale log2e)
    want = np.asarray(js * js * (1.0 / 128 ** 0.5 * jfa.LOG2E))
    np.testing.assert_array_equal(tfa.qk8_scale(s, s, 128).numpy(), want)


# -- the converters -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_converters_agree_bit_for_bit(dtype):
    tree = _tree(4)
    if dtype == "bfloat16":  # serving's bf16 weights, as both packages hold them
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    tcfg = tdit.tiny_test(**TINY)
    jq = jax.tree.map(np.asarray, _jax_quantized(tree, jdit.tiny_test(**TINY, **INT8)))
    qcfg = dataclasses.replace(tcfg, **INT8)
    from_jax = tck.from_jax_params(jq, qcfg)
    model = tdit.WanModel(dataclasses.replace(tcfg, compute_dtype=getattr(torch, dtype)))
    model.load_state_dict(tck.from_jax_params(tree, tcfg))
    own = tck.quantize_state(model.state_dict(), qcfg)
    target = tdit.WanModel(qcfg).state_dict()
    assert own.keys() == from_jax.keys() == target.keys()
    assert sum(k.endswith(".weight_q") for k in own) == 10 * TINY["num_layers"]
    for key in own:
        # the int8 model's dtypes: int8 weights, fp32 scales and biases, and
        # the bf16 serving storage of every tensor that is not quantized
        assert own[key].dtype == target[key].dtype, key
        torch.testing.assert_close(own[key], from_jax[key].to(own[key].dtype), rtol=0, atol=0,
                                   msg=key)


# -- the tiny int8 DiT ----------------------------------------------------


def _inputs(seed=5, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, *SHAPE[1:]).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    ctx = rng.randn(b, TEXT_LEN, 64).astype(np.float32)
    return x, t, ctx


def _port_int8(tree, compute_dtype):
    cfg = tdit.tiny_test(**TINY, compute_dtype=compute_dtype)
    qcfg = dataclasses.replace(cfg, **INT8)
    model = tdit.WanModel(qcfg)
    model.load_state_dict(tck.quantize_state(tck.from_jax_params(tree, cfg), qcfg))
    return model.eval()


@pytest.mark.parametrize("dtype,tol", [
    # fp32: the quantization is bit-exact on equal inputs and the int32
    # products are exact, but an activation whose fp32 value differs in its
    # last bit (sums in another order) can round to the neighbouring int8
    # step. One flip moves a dense output by ~4 / (127 sqrt(D)), 2e-3 of its
    # scale, and the next layer requantizes the moved values, so flips
    # spread: measured 2.9e-3 of max|out| over two blocks; bound 1e-2
    ("float32", 1e-2),
    # bf16: the bf16 model tests' tolerance, a few bf16 ulps of max|out|
    ("bfloat16", 3e-2)])
def test_int8_model_matches_jax(streaming, monkeypatch, dtype, tol):
    calls = []
    plain = tfa.flash_attention_qk8_plain
    monkeypatch.setattr(tfa, "flash_attention_qk8_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    tree = _tree(6)
    x, t, ctx = _inputs()
    jcfg_q = jdit.tiny_test(**TINY, **INT8, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(jdit.WanModel(jcfg_q).apply(_jax_quantized(tree, jcfg_q), jnp.asarray(x),
                                                  jnp.asarray(t), jnp.asarray(ctx)))
    model = _port_int8(tree, getattr(torch, dtype))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert len(calls) == TINY["num_layers"]  # one int8 self-attention per block
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    if dtype == "bfloat16":
        # the port's own int8 drift from its bf16 model (tests/test_quant.py's bound)
        bf16 = tdit.WanModel(tdit.tiny_test(**TINY))
        bf16.load_state_dict(tck.from_jax_params(tree, tdit.tiny_test(**TINY)))
        with torch.inference_mode():
            ref = bf16(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
        assert 0 < _rel(got, ref) < 0.02


# -- the int8 serving loop ------------------------------------------------


def test_int8_sample_matches_jax(streaming):
    tree = _tree(7)
    rng = np.random.RandomState(8)
    ctx = rng.randn(1, TEXT_LEN, 64).astype(np.float32)
    ctx_null = rng.randn(1, TEXT_LEN, 64).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))  # JAX's draw
    jcfg_q = jdit.tiny_test(**TINY, **INT8, compute_dtype=jnp.float32)
    jgen = jpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    want = np.asarray(jpipe.WanT2V(jcfg_q, _jax_quantized(tree, jcfg_q)).sample(
        key, SHAPE, jnp.asarray(ctx), jnp.asarray(ctx_null), jgen))
    model = _port_int8(tree, torch.float32)
    gen = tpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    got = tpipe.WanT2V(model).generate(None, torch.from_numpy(ctx), torch.from_numpy(ctx_null),
                                       *SHAPE[1:4], gen, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == SHAPE and np.isfinite(got).all()
    assert np.abs(want - noise).max() > 0.1  # the DiT moved the latent
    # three CFG steps of the fp32 int8 DiT, each forward held to 1e-2 above;
    # guidance 5 scales the cond - uncond difference, so a step's velocity
    # may move by a few times that: 3e-2 of the latents' scale
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


# -- one refl step with the int8 rollout ----------------------------------

STEPS, MID, LR = 4, 2, 1e-3


def test_refl_step_with_int8_rollout_matches_jax(streaming, monkeypatch):
    tcfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32, remat_policy="attn")
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    policy, lrm_dit = _tree(10), _tree(11)
    pav = dict(feature_layer=(2,), trainable_blocks=(0, 1))
    jmodel = jprfl.PrflModel(jcfg, JPavrmConfig(**pav), jprfl.PrflConfig(
        inference_steps=STEPS, fixed_mid=MID, rollout_quant="int8"))
    qp, mp = jmodel.lrm.init_head_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(12)
    batch = {"latents": rng.randn(*SHAPE).astype(np.float32),
             "text": rng.randn(1, TEXT_LEN, 64).astype(np.float32)}
    jtx = jcommon.make_optimizer(learning_rate=LR)
    step = jax.jit(jprfl.make_refl_step(jmodel, jtx))
    _, m = step(jcommon.init_train_state(policy, jtx), {k: jnp.asarray(v) for k, v in
                                                        batch.items()},
                jax.random.PRNGKey(0), {"dit": lrm_dit, "q": qp, "m": mp})
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    latent0 = torch.from_numpy(np.array(jax.random.normal(k_noise, SHAPE, jnp.float32)))

    requantized, k10 = [], []
    quantize_ = tdit.QuantLinear.quantize_
    monkeypatch.setattr(tdit.QuantLinear, "quantize_",
                        lambda self, *a: requantized.append(1) or quantize_(self, *a))
    plain = tfa.flash_attention_qk8_plain
    monkeypatch.setattr(tfa, "flash_attention_qk8_plain",
                        lambda *a, **kw: k10.append(1) or plain(*a, **kw))
    ttx = tcommon.make_optimizer(learning_rate=LR)
    model = tprfl.PrflModel(tcfg, PavrmConfig(**pav), tprfl.PrflConfig(
        inference_steps=STEPS, fixed_mid=MID, rollout_quant="int8"))
    model.dit.load_state_dict(tck.from_jax_params(policy, tcfg))
    model.lrm.load_state_dict(tck.lrm_from_jax(lrm_dit, jax.tree.map(np.asarray, qp),
                                               jax.tree.map(np.asarray, mp),
                                               model.lrm.dit_cfg))
    state = tcommon.init_train_state(model.dit, ttx)
    refl = tprfl.make_refl_step(model, ttx)
    state, met = refl(state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
                      latent0=latent0)
    assert met["mid"] == MID and float(met["grad_norm"]) > 0
    # fp32 everywhere but the int8 rollout, whose activation rounding may
    # flip on a few elements (the int8 model test above); the flips move the
    # mid latent slightly, and the loss, reward and gradient follow it
    for key in ("loss", "reward", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-3, err_msg=key)
    # the step requantized the ten block matmuls of every block from the
    # masters, and only the rollout's forwards took the int8 attention
    assert len(requantized) == 10 * TINY["num_layers"]
    assert len(k10) == MID * TINY["num_layers"]


def test_int8_rollout_shares_the_policy_and_follows_it():
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tprfl.PrflModel(cfg, PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(rollout_quant="int8"))
    model.dit.load_state_dict(tck.from_jax_params(_tree(13), cfg))
    qdit, pairs = tprfl.int8_rollout_model(model)
    assert len(pairs) == 10 * TINY["num_layers"]
    shared = dict(qdit.named_parameters())
    for name, p in model.dit.named_parameters():
        if name in shared:  # every tensor that is not quantized is the master itself
            assert shared[name] is p, name
    assert "blocks.0.ffn_0.weight" not in shared and "patch_embedding.weight" in shared
    qlayer, layer = pairs[0]
    with torch.no_grad():
        layer.weight.mul_(2.0)
    qlayer.quantize_(layer.weight, layer.bias)
    q, s = tquant.quantize_weight(layer.weight)
    assert torch.equal(qlayer.weight_q, q) and torch.equal(qlayer.weight_scale, s)


def test_rollout_quant_rejects_a_typo():
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tprfl.PrflModel(cfg, PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(rollout_quant="int9"))
    with pytest.raises(ValueError, match="rollout_quant"):
        tprfl.make_refl_step(model, tcommon.make_optimizer(learning_rate=LR))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_cli_trains_two_steps_with_the_int8_rollout(tmp_path):
    cli = _load_script("train_prfl_torch")
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(tmp_path)
    cfg.model.ema.use_ema = False  # the smoke config asks for EMA; not needed here
    cfg.train.rollout_quant = "int8"
    trainer = cli.build_trainer(cfg, "cpu")
    assert trainer.model.cfg.rollout_quant == "int8"
    history = cli.run(trainer, 2)
    for m in history:
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            assert math.isfinite(m[key]), (key, m)
        assert m["grad_norm"] > 0


@pytest.mark.parametrize("flags", [("--quant", "int8"), ("--quant_attn", "int8"),
                                   ("--quant", "int8", "--quant_attn", "int8")])
def test_serving_cli_quantizes_after_the_weights_load(monkeypatch, flags):
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "dit_config_for_task",
                        lambda task, **kw: tdit.tiny_test(**TINY, **kw))
    base = cli.build_pipeline(cli.args_init(["--device", "cpu"])).model
    args = cli.args_init(["--device", "cpu", *flags])
    model = cli.build_pipeline(args).model
    assert model.cfg.quant_attn == (None if args.quant_attn == "none" else "int8")
    assert model.cfg.quant_dense == (None if args.quant == "none" else "int8")
    want = base.state_dict()
    if args.quant == "int8":  # the loaded weights, quantized once
        want = tck.quantize_state(want, model.cfg)
        assert isinstance(model.blocks[0].ffn_2, tdit.QuantLinear)
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(SystemExit):
        cli.args_init(["--quant", "fp8"])


# -- the probes' plain versions -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_cols,nblocks,reps", [(256, 64, 128, 3, 5), (32, 40, 24, 1, 7)])
def test_probe_plain_versions_are_exact(dtype, m, k, n_cols, nblocks, reps):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    bt = torch.randint(-127, 128, (nblocks * n_cols, k), generator=g, dtype=torch.int8)
    if dtype == torch.bfloat16:  # integers of bf16 are exact up to 256
        a, bt = a.bfloat16(), bt.bfloat16()
    an, bn = a.float().numpy().astype(np.int64), bt.float().numpy().astype(np.int64)
    want = sum(an @ bn[i * n_cols:(i + 1) * n_cols].T for i in range(nblocks)) * reps
    got = int8_probe.probe_rate(a, bt, nblocks, reps)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if nblocks == 1:
        np.testing.assert_array_equal(int8_probe.probe_chain(a, bt, reps).numpy(), want)
