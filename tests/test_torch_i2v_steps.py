"""The port's i2v/flf2v DiT and its training steps against the JAX package,
on the CPU: the fp32 forward, the gradients, the int8 model, the refl and
SFT steps and the training CLI's i2v flags. The set-up and its helpers are
tests/test_torch_i2v.py's; these cases live in a file of their own so that
pytest-xdist's ``--dist loadfile`` runs them beside the longest file of
the suite rather than before it.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import quant as jquant
from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_torch.configs import config_from_dict
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.utils import checkpoint as tck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_i2v import (  # noqa: E402
    _assert_params,
    _batch,
    _Identity,
    _inputs,
    _j,
    _jax_forward,
    _jcfg,
    _load_script,
    _models,
    _port,
    _t,
    _tcfg,
    _tiny,
    _tree,
    _write_cache,
    INT8,
    KINDS,
    LR,
    MID,
    SHAPE,
    streaming,  # a fixture
    TEXT_LEN,
)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("token_mode", [False, True])
def test_model_matches_jax_fp32(kind, token_mode):
    tree = _tree(kind, 3)
    x, y, clip, t, ctx = _inputs(kind, 3)
    want = _jax_forward(kind, tree, x, y, clip, t, ctx)
    model = _port(kind, tree).eval()
    tx, ty, tclip, tt, tctx = _t(x, y, clip, t, ctx)
    with torch.inference_mode():
        if token_mode:
            tokens, grid = tdit.patchify(tx, (1, 2, 2))
            yt, _ = tdit.patchify(ty, (1, 2, 2))
            got = tdit.unpatchify(model(tokens, tt, tctx, y=yt, clip_fea=tclip, grid=grid),
                                  grid, (1, 2, 2))
        else:
            got = model(tx, tt, tctx, y=ty, clip_fea=tclip)
    assert np.abs(want).max() > 0.1
    # fp32 throughout: matmul sums in another order and the fixed-max
    # softmax (JAX's CPU path uses the shifted one); measured ~5e-7 of the
    # output scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["flf2v"])
def test_grads_match_jax(kind):
    tree = _tree(kind, 6)
    x, y, clip, t, ctx = _inputs(kind, 6, b=1)
    r = np.random.RandomState(7).randn(*SHAPE).astype(np.float32)
    jmodel = jdit.WanModel(_jcfg(kind))

    def loss(params, x_, y_, clip_):
        return (jmodel.apply(params, x_, jnp.asarray(t), jnp.asarray(ctx), y=y_,
                             clip_fea=clip_) * r).sum()

    jg, *jin = jax.grad(loss, argnums=(0, 1, 2, 3))(jax.tree.map(jnp.asarray, tree), *_j(x, y,
                                                                                         clip))
    model = _port(kind, tree, remat_policy="attn")
    want = tck.from_jax_params(jax.tree.map(np.asarray, jg), model.cfg)
    tx, ty, tclip = (a.requires_grad_() for a in _t(x, y, clip))
    (model(tx, *_t(t, ctx), y=ty, clip_fea=tclip) * torch.from_numpy(r)).sum().backward()
    grads = {name: (a.grad, torch.from_numpy(np.asarray(b)))
             for name, a, b in zip(("x", "y", "clip_fea"), (tx, ty, tclip), jin)}
    grads.update({name: (p.grad, want[name]) for name, p in model.named_parameters()})
    assert len(grads) == len(want) + 3
    assert {"img_emb.fc1.weight", "blocks.1.cross_attn.k_img.weight",
            "blocks.0.cross_attn.norm_k_img"} <= set(grads)
    for name, (got, ref) in grads.items():
        assert float(ref.abs().max()) > 0, name
        # fp32 both sides; sums in other orders: 1e-4 of each gradient's
        # largest entry
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(ref.numpy()).max(), err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_int8_model_matches_jax(streaming, monkeypatch, kind):
    calls = []
    plain = tfa.flash_attention_qk8_plain
    monkeypatch.setattr(tfa, "flash_attention_qk8_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    tree = _tree(kind, 11)
    shape = (2, 3, 16, 16, 16)  # 192 tokens
    x, y, clip, t, ctx = _inputs(kind, 11, shape=shape)
    jcfg_q = _jcfg(kind, **INT8)
    qshapes = jax.eval_shape(lambda: jdit.init_params(jcfg_q, jax.random.PRNGKey(0),
                                                      text_len=TEXT_LEN))
    want = np.asarray(jdit.WanModel(jcfg_q).apply(jquant.quantize_params(tree, qshapes),
                                                  *_j(x, t, ctx), y=jnp.asarray(y),
                                                  clip_fea=jnp.asarray(clip)))
    cfg = _tcfg(kind)
    qcfg = dataclasses.replace(cfg, **INT8)
    state = tck.quantize_state(tck.from_jax_params(tree, cfg), qcfg)
    # k_img and v_img are quantized too: twelve int8 matmuls per block
    assert sum(k.endswith(".weight_q") for k in state) == 12 * cfg.num_layers
    model = tdit.WanModel(qcfg)
    model.load_state_dict(state)
    with torch.inference_mode():
        got = model(*_t(x, t, ctx), y=_t(y)[0], clip_fea=_t(clip)[0]).numpy()
    assert len(calls) == cfg.num_layers  # one int8 self-attention per block
    # the fp32 int8 model test's bound (tests/test_torch_quant.py): an
    # activation that differs in its last bit may round to the next int8
    # step, and the next layer requantizes the moved values
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["i2v"])
def test_refl_step_matches_jax(kind):
    policy, lrm, jmodel, tmodel = _models(kind, 12)
    batch = _batch(kind, 13)
    jtx = jcommon.make_optimizer(learning_rate=LR)
    new, m = jax.jit(jprfl.make_refl_step(jmodel, jtx))(
        jcommon.init_train_state(policy, jtx), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), lrm)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    latent0 = torch.from_numpy(np.array(jax.random.normal(k_noise, SHAPE, jnp.float32)))
    ttx = tcommon.make_optimizer(learning_rate=LR)
    state = tcommon.init_train_state(tmodel.dit, ttx)
    state, met = tprfl.make_refl_step(tmodel, ttx)(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, latent0=latent0)
    assert met["mid"] == MID and float(met["grad_norm"]) > 0
    # fp32 through rollout, LRM and backward, as the t2v refl test
    for key in ("loss", "reward", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-4, err_msg=key)
    _assert_params(state, new.params, tmodel.dit_cfg)


@pytest.mark.parametrize("kind", ["flf2v"])
def test_sft_step_matches_jax(kind):
    # the identity optimizer: the raw gradients land in the parameters on
    # both sides, as tests/test_torch_training.py's identity refl case
    import optax

    policy, _, jmodel, tmodel = _models(kind, 14)
    batch = _batch(kind, 15)
    sched = jfm.train_schedule(1000)
    key = jax.random.PRNGKey(5)
    new, m = jax.jit(jprfl.make_sft_step(jmodel, optax.identity(), sched))(
        jcommon.init_train_state(policy, optax.identity()),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_t, k_n = jax.random.split(key)
    t, sigma = jfm.sample_train_timestep(k_t, sched, 1, "uniform")
    noise = np.asarray(jax.random.normal(k_n, SHAPE, jnp.float32))
    state = tcommon.init_train_state(tmodel.dit, _Identity())
    old = {n: p.detach().numpy().copy() for n, p in zip(state.names, state.params)}
    state, met = tprfl.make_sft_step(tmodel, _Identity(), tfm.train_schedule(1000))(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
        t=torch.from_numpy(np.asarray(t)), sigma=torch.from_numpy(np.asarray(sigma)),
        noise=torch.from_numpy(noise))
    for key_ in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key_]), float(m[key_]), rtol=1e-4, err_msg=key_)
    want = tck.from_jax_params(jax.tree.map(np.asarray, new.params), tmodel.dit_cfg)
    assert set(want) == set(state.names) and "img_emb.emb_pos" in want
    for n, p in zip(state.names, state.params):
        g, gr = p.detach().numpy() - old[n], want[n].numpy() - old[n]
        assert np.abs(gr).max() > 0, n
        # the raw gradients read back as (p + g) - p: 1e-4 of each tensor's
        # scale, plus two fp32 ulps of the weights for the cancellation
        ulp = np.spacing(np.float32(np.abs(old[n]).max()))
        np.testing.assert_allclose(g, gr, rtol=0, atol=1e-4 * np.abs(gr).max() + 2 * ulp,
                                   err_msg=n)


@pytest.mark.parametrize("task", ["i2v-1.3b", "flf2v-14B", "t2v-1.3b"])
def test_train_cli_derives_the_i2v_flags_as_jax(tmp_path, task):
    # scripts/train_prfl.py: is_i2v for an i2v or flf2v task, is_flf2v for
    # flf2v, and the dataset gets both. One outer step on an i2v cache at a
    # tiny width moves the image branch.
    cli = _load_script("train_prfl_torch")
    is_i2v, flf = "i2v" in task or "flf2v" in task, "flf2v" in task
    meta, null = _write_cache(tmp_path, 2 if flf else 1)
    tiny = {k: v for k, v in _tiny("t2v").items() if k not in ("model_type", "in_dim")}
    raw = {"task": task, "prfl_inference_steps": 4,
           "model": {"override": {**tiny, "text_dim": 64, "freq_dim": 32},
                     "remat_policy": "attn"},
           "dataset": {"meta_file_list": [meta], "null_dir": null, "batch_size": 1,
                       "uncond_prob": [0.0, 0.0]},
           "extra_model": {"scheduler": {"flow_shift": 3.0}},
           "lrm": {"feature_layer": [2], "trainable_blocks": [0, 1]},
           "train": {"fixed_mid": 1, "save_interval": 100, "sanity_check_interval": 0},
           "save": {"output_dir": str(tmp_path / "out")}}
    trainer = cli.build_trainer(config_from_dict(json.loads(json.dumps(raw))), "cpu")
    assert (trainer.model.cfg.is_i2v, trainer.model.cfg.is_flf2v) == (is_i2v, flf)
    assert trainer.model.dit_cfg.in_dim == (36 if is_i2v else 16)
    batch = next(trainer.loader)
    assert ("cond" in batch) == ("clip_fea" in batch) == is_i2v
    if not is_i2v:
        return
    assert batch["clip_fea"].shape == (1, 257 * (2 if flf else 1), 1280)
    if flf:
        return
    with torch.no_grad():  # a zero head gives every block a zero gradient
        trainer.model.dit.head.head.weight.normal_(0.0, 0.1,
                                                   generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in trainer.model.dit.named_parameters()
              if n in ("img_emb.fc1.weight", "blocks.1.cross_attn.k_img.weight")}
    (m,) = cli.run(trainer, 1)
    assert all(np.isfinite(m[k]) for k in ("refl_loss", "reward", "grad_norm", "sft_loss"))
    params = dict(trainer.model.dit.named_parameters())
    for name, p in before.items():
        assert not torch.equal(params[name], p), name
