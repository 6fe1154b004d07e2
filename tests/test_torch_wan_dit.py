"""The port's DiT and checkpoint converters against the JAX package.

Both sides get one seeded JAX-layout tree (utils/checkpoint.seeded_jax_tree:
random weights everywhere, norm gains near 1 and a non-zero head, which the
JAX initialisers would leave at ones and zeros); the port loads it through
utils/checkpoint.from_jax_params. Both run the same seeded numpy inputs on
the CPU, where the port uses its plain op versions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128


def jax_params(seed=0):
    return tck.seeded_jax_tree(tdit.tiny_test(**TINY), seed)


def _inputs(b=2, f=3, hw=8, text_len=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, f, hw, hw, 16).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    ctx = rng.randn(b, text_len, 64).astype(np.float32)
    return x, t, ctx


def _port_model(params, compute_dtype):
    cfg = tdit.tiny_test(**TINY, compute_dtype=compute_dtype)
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(params, cfg))
    return model.eval()


def test_from_jax_params_equals_from_reference_state():
    params = jax_params()
    jcfg = jdit.tiny_test(**TINY)
    cfg = tdit.tiny_test(**TINY)
    a = tck.from_jax_params(params, cfg)
    b = tck.from_reference_state(jck.flax_to_torch_state(params, jcfg), cfg)
    assert a.keys() == b.keys() == tdit.WanModel(cfg).state_dict().keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


def test_patchify_and_time_embedding_match_jax():
    x, t, _ = _inputs()
    tokens, grid = tdit.patchify(torch.from_numpy(x), (1, 2, 2))
    jtokens, jgrid = jdit.patchify(jnp.asarray(x), (1, 2, 2))
    assert grid == jgrid
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(tdit.unpatchify(tokens, grid, (1, 2, 2)).numpy(), x)
    emb = tdit.sinusoidal_embedding_1d(32, torch.from_numpy(t)).numpy()
    # same fp32 formula; pow/cos/sin implementations may differ in the last ulp
    np.testing.assert_allclose(emb, np.asarray(jdit.sinusoidal_embedding_1d(32, jnp.asarray(t))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("token_mode", [False, True])
def test_wan_model_matches_jax_fp32(token_mode):
    params = jax_params()
    x, t, ctx = _inputs()
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    want = np.asarray(jdit.WanModel(jcfg).apply(params, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx)))
    model = _port_model(params, torch.float32)
    tx = torch.from_numpy(x)
    with torch.inference_mode():
        if token_mode:
            tokens, grid = tdit.patchify(tx, (1, 2, 2))
            got = tdit.unpatchify(model(tokens, torch.from_numpy(t), torch.from_numpy(ctx),
                                        grid=grid), grid, (1, 2, 2))
        else:
            got = model(tx, torch.from_numpy(t), torch.from_numpy(ctx))
    assert np.abs(want).max() > 0.1
    # fp32 throughout: matmul sums in another order and the fixed-max
    # softmax (JAX's CPU path uses the shifted one) differ near 1e-6
    # relative; 1e-4 of the output scale leaves room over two blocks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_wan_model_matches_jax_bf16():
    params = jax_params(seed=1)
    x, t, ctx = _inputs(seed=1)
    jcfg = jdit.tiny_test(**TINY)
    want = np.asarray(jdit.WanModel(jcfg).apply(params, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx)))
    model = _port_model(params, torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    # bf16 activations round at a dozen points per block, and the two
    # frameworks round bias adds and matmul sums differently: a few bf16
    # ulps of the largest output, 3e-2 of max|out|
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


def test_seeded_tree_has_the_jax_init_structure():
    jcfg = jdit.tiny_test(**TINY)
    shapes = jax.eval_shape(lambda: jdit.init_params(jcfg, jax.random.PRNGKey(0), text_len=16))
    assert (jax.tree.map(lambda a: a.shape, shapes)
            == jax.tree.map(lambda a: a.shape, jax_params()))


def test_init_params_follows_jax_initialisers():
    cfg = tdit.tiny_test(**TINY)
    model = tdit.init_params(tdit.WanModel(cfg), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert not sd["head.head.weight"].any() and not sd["blocks.0.ffn_0.bias"].any()
    assert (sd["blocks.0.self_attn.norm_q"] == 1).all() and not sd["blocks.1.norm3_bias"].any()
    assert sd["blocks.0.ffn_0.weight"].dtype == torch.bfloat16
    assert sd["time_proj.weight"].dtype == torch.float32
    # the JAX initialisers' spreads: normal(1/sqrt(dim)) modulation,
    # normal(0.02) text/time embeddings, xavier-uniform dense kernels
    xavier = math.sqrt(2.0 / (cfg.dim + cfg.ffn_dim))
    for key, std in (("blocks.0.modulation", cfg.dim ** -0.5), ("text_0.weight", 0.02),
                     ("blocks.1.ffn_0.weight", xavier)):
        assert sd[key].float().std().item() == pytest.approx(std, rel=0.05), key


def test_config_presets_match_jax():
    for name in ("t2v_1_3b", "t2v_14b"):
        a, b = getattr(tdit, name)(), getattr(jdit, name)()
        for f in dataclasses.fields(a):
            if f.name != "compute_dtype":
                assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
