"""The port's PAVRM and PRFL training steps against the JAX package, on the
CPU: the reward model's train step and its heads' learning rate, the
finite guard, the PRFL refl step with a loaded LRM, and resume against an
uninterrupted run. The set-up and its helpers are tests/test_torch_pavrm.py's;
these cases live in a file of their own so that pytest-xdist's
``--dist loadfile`` runs them beside the longest file of the suite rather
than before it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import pavrm as jpavrm
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import pavrm as tpavrm
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.utils import checkpoint as tck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_pavrm import (  # noqa: E402
    _cli_config,
    _Identity,
    _jcfg,
    _load_lrm,
    _load_script,
    _lrm_config,
    _params,
    _resume_cache,
    _Setup,
    _state_equal,
    _tbatch,
    _tiny,
    LR,
    LR_MLP,
    REPO,
    STEP_CASES,
)


@pytest.mark.parametrize("kind,loss,timesteps", STEP_CASES)
def test_train_step_gradients_match_jax(kind, loss, timesteps):
    # the identity optimizer: each step's raw gradients land in the weights;
    # two steps, so the fixed timestep list is cycled by the step count
    s = _Setup(kind, loss, timesteps=timesteps)
    jtx = optax.identity()
    jstate = jcommon.init_train_state(s.jtrain, jtx)
    model = s.port()
    state = tcommon.init_train_state(model, _Identity())
    step = tpavrm.make_train_step(model, _Identity(), tfm.train_schedule(1000))
    for i in range(2):
        batch = s.batch(seed=1 + i)
        old_j, old_t = s.port_state(jstate.params), _params(state)
        jstate, m, t, noise = s.jax_step(jtx, jstate, batch, jax.random.PRNGKey(9 + i))
        # a fixed list is the port's own choice (by state.step); a draw is injected
        state, met = step(state, _tbatch(batch), noise=noise,
                          t=None if timesteps else t)
        if timesteps:
            assert float(t[0]) == timesteps[i % len(timesteps)]
        # loss and grad norm at fp32 through the tower, pool and head
        for key in ("loss", "grad_norm", "acc"):
            np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-5, err_msg=key)
        assert float(met["grad_norm"]) > 0
        want = s.port_state(jstate.params)
        assert set(want) == set(state.names)
        wk_norm = (want["q_attn.wk"] - old_j["q_attn.wk"]).norm()
        for n, p in zip(state.names, state.params):
            g, gr = p.detach() - old_t[n], want[n] - old_j[n]
            if n == "q_attn.bk":
                # the pool's key bias moves every logit of a head by the same
                # q . bk, which the softmax ignores: its exact gradient is 0,
                # and both packages return rounding noise far below wk's
                assert max(g.norm(), gr.norm()) <= 1e-5 * wk_norm, (g.norm(), gr.norm())
                continue
            # 1e-4 of the gradient's norm, plus the cancellation of (p + g) - p:
            # two fp32 ulps of the weights per entry
            ulp = np.spacing(np.float32(old_t[n].abs().max()))
            tol = 1e-4 * gr.norm() + 2 * ulp * np.sqrt(gr.numel())
            assert (g - gr).norm() <= tol, (n, float((g - gr).norm()), float(gr.norm()))


def test_train_step_with_the_head_learning_rate_matches_jax():
    # the real optimizer: clip over every gradient, then AdamW with the
    # heads' own rate (learning_rate_mlp) and a warmup
    s = _Setup("t2v", "ce")
    kw = dict(learning_rate=LR, learning_rate_mlp=LR_MLP, lr_warmup_steps=3,
              lr_scheduler="cosine", max_train_steps=10)
    jtx, ttx = jcommon.make_optimizer(**kw), tcommon.make_optimizer(**kw)
    jstate = jcommon.init_train_state(s.jtrain, jtx)
    model = s.port()
    state = tcommon.init_train_state(model, ttx)
    step = tpavrm.make_train_step(model, ttx, tfm.train_schedule(1000))
    for i in range(2):
        batch = s.batch(seed=4 + i)
        jstate, m, _, noise = s.jax_step(jtx, jstate, batch, jax.random.PRNGKey(20 + i))
        state, met = step(state, _tbatch(batch), noise=noise)
        np.testing.assert_allclose(float(met["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
    want = s.port_state(jstate.params)
    for n, p in zip(state.names, state.params):
        got, ref = p.detach().numpy(), want[n].numpy()
        lr = LR_MLP if n.split(".")[0] in ("q_attn", "mlp") else LR
        if n == "q_attn.bk":
            # its gradient is rounding noise (the softmax ignores the shift
            # it makes; see the gradient test), so AdamW moves it by up to lr
            # a step in either direction, in each package alike
            start = s.port_state(s.jtrain)[n].numpy()
            assert np.abs(got - start).max() <= 2 * lr and np.abs(ref - start).max() <= 2 * lr
            continue
        # AdamW moves a weight by lr g / (|g| + eps): where |g| is near eps
        # (1e-8) that size rests on the last bits of g, which fp32 sums in
        # another order change. Such weights may differ by up to 0.1 of their
        # group's rate; every other weight agrees to 1e-5 of itself
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0.1 * lr, err_msg=n)
        off = np.abs(got - ref) > 1e-5 * np.abs(ref) + 1e-7
        assert off.mean() < 1e-3, (n, off.sum())


@pytest.mark.parametrize("loss", ["ce", "bt"])
def test_finite_guard_matches_jax(loss):
    # a NaN latent: every gradient is zeroed, the loss logged as 0, and the
    # AdamW update still runs (the weight decay moves each weight)
    s = _Setup("t2v", loss)
    jtx, ttx = jcommon.make_optimizer(learning_rate=LR), tcommon.make_optimizer(learning_rate=LR)
    batch = s.batch(seed=2)
    batch["latents"][0, 0, 0, 0, 0] = np.nan
    jstate, m, _, noise = s.jax_step(jtx, jcommon.init_train_state(s.jtrain, jtx), batch,
                                     jax.random.PRNGKey(3))
    model = s.port()
    state = tcommon.init_train_state(model, ttx)
    old = _params(state)
    state, met = tpavrm.make_train_step(model, ttx, tfm.train_schedule(1000))(
        state, _tbatch(batch), noise=noise)
    assert float(met["loss"]) == float(m["loss"]) == 0.0
    assert float(met["grad_norm"]) == float(m["grad_norm"]) == 0.0
    assert state.step == 1 and not torch.equal(state.params[0], old[state.names[0]])
    want = s.port_state(jstate.params)
    for n, p in zip(state.names, state.params):
        # p (1 - lr wd): one fp32 rounding on each side
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=2e-7, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), old[n].numpy() * (1 - LR * 0.01),
                                   rtol=2e-7, err_msg=n)


def test_prfl_refl_step_with_a_loaded_lrm_matches_jax(tmp_path):
    # the JAX PAVRM export, loaded by both PRFL trainers' loaders
    sys.path.insert(0, REPO)
    from scripts.train_pavrm import export_lrm_artifacts

    s = _Setup("t2v", "ce", seed=2)
    export_lrm_artifacts(s.jtrain, s.jfrozen, s.jmodel, str(tmp_path), 3)
    cfg = _lrm_config(str(tmp_path), "t2v", 3)
    steps, mid = 4, 1
    jcfg2 = jdit.tiny_test(**{**_tiny("t2v"), "num_layers": 2}, compute_dtype=jnp.float32)
    jmodel = jprfl.PrflModel(_jcfg("t2v"), jpavrm.PavrmConfig(feature_layer=(2,),
                                                              trainable_blocks=(0, 1)),
                             jprfl.PrflConfig(inference_steps=steps, fixed_mid=mid))
    lrm = {"dit": jck.load_wan_checkpoint(cfg.model.lrm_transformer_path, jcfg2),
           "q": jck.load_reward_head(cfg.model.lrm_query_attention_path, "qattn"),
           "m": jck.load_reward_head(cfg.model.lrm_mlp_path, "mlp")}
    policy = tck.seeded_jax_tree(s.tcfg, 4)
    tx = jcommon.make_optimizer(learning_rate=LR)
    rng = np.random.RandomState(0)
    batch = {"latents": rng.randn(1, 3, 8, 8, 16).astype(np.float32),
             "text": rng.randn(1, 16, 64).astype(np.float32)}
    new, m = jax.jit(jprfl.make_refl_step(jmodel, tx))(
        jcommon.init_train_state(policy, tx), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), lrm)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    latent0 = torch.from_numpy(np.asarray(jax.random.normal(k_noise, (1, 3, 8, 8, 16))))

    model = tprfl.PrflModel(s.tcfg, tpavrm.PavrmConfig(feature_layer=(2,),
                                                       trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(inference_steps=steps, fixed_mid=mid))
    model.dit.load_state_dict(tck.from_jax_params(policy, s.tcfg))
    _load_lrm(model.lrm, cfg)
    ttx = tcommon.make_optimizer(learning_rate=LR)
    state = tcommon.init_train_state(model.dit, ttx)
    state, met = tprfl.make_refl_step(model, ttx)(state, _tbatch(batch), latent0=latent0)
    for key in ("loss", "reward", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-5, err_msg=key)
    assert float(met["grad_norm"]) > 0


@pytest.mark.parametrize("trainer", ["prfl", "pavrm", "pavrm_bt"])
def test_resume_equals_an_uninterrupted_run(tmp_path, trainer):
    # every sample draws its caption from the dataset's random.Random, the
    # PRFL one also its text drop and the bt one its lose pair; the order
    # is shuffled per epoch, and the resumed step lies in a later epoch
    # than the checkpoint's first
    bt = trainer == "pavrm_bt"
    trainer = trainer.split("_")[0]
    cli = _load_script(f"train_{trainer}_torch")
    name = "smoke_prfl" if trainer == "prfl" else "smoke_pavrm"
    extra = ({"model__ema": {"use_ema": True, "ema_decay": 0.9},
              "dataset__uncond_prob": [0.5, 0.0]} if trainer == "prfl" else {})
    if bt:
        meta, _ = _resume_cache(tmp_path)
        extra = {"lrm__loss": "bt", "dataset__meta_file_lose_list": [meta]}
    extra["dataset__shuffle"] = True
    whole = cli.build_trainer(_cli_config(name, tmp_path, tmp_path / "a", **extra), "cpu")
    hist = cli.run(whole, 3)
    timing = ("t_refl", "t_sft", "step_time")

    def metrics(h):
        return {k: v for k, v in h.items() if k not in timing}

    first = cli.build_trainer(_cli_config(name, tmp_path, tmp_path / "b", **extra), "cpu")
    assert [metrics(h) for h in cli.run(first, 2)] == [metrics(h) for h in hist[:2]]
    out = tmp_path / "b" / name
    ckpt = out / "checkpoint-2"
    assert (ckpt / "opt_state" if trainer == "prfl" else out / "checkpoint-2-opt").is_dir()
    if trainer == "prfl":
        assert (tmp_path / "b" / f"{name}-ema" / "checkpoint-2" / "config.json").exists()
    else:
        assert (out / "transformer" / "checkpoint-2" / "config.json").exists()
        assert (out / "mlp" / "query_attention_step_2.ckpt").exists()
    resumed = cli.build_trainer(_cli_config(name, tmp_path, tmp_path / "c", **extra,
                                            model__resume_transformer_path=str(ckpt)), "cpu")
    assert resumed.step == 2 and resumed.state.step == whole.state.step - (
        2 if trainer == "prfl" else 1)
    (m,) = cli.run(resumed, 1)
    assert metrics(m) == metrics(hist[2])
    assert resumed.state.step == whole.state.step and _state_equal(resumed.state, whole.state)
    for a, b in zip(resumed.state.opt_state["mu"], whole.state.opt_state["mu"]):
        assert torch.equal(a, b)
    if trainer == "prfl":
        assert all(torch.equal(a, b) for a, b in zip(resumed.ema, whole.ema))
