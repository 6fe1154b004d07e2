"""The port's PRFL training slice against the JAX package, on the CPU.

Both packages get the same seeded weights (utils/checkpoint.seeded_jax_tree
for the policy and the LRM tower, the JAX initialisers' reward heads), the
same numpy batch and the same random draws: the JAX step draws from its
key, and the test hands those draws to the port's step. The DiT runs at
fp32 compute (``tiny_test`` at head_dim 128), where the two frameworks
differ only in the order of their sums; the port's ops run their plain
versions (the Hopper kernels are held to them on the card by
chip_smoke.py).
"""

import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyvideo_prfl_tpu.models import reward as jrw
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.schedulers import unipc as junipc
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_tpu.training.pavrm import PavrmConfig as JPavrmConfig
from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.models import reward as trw
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.schedulers import unipc as tunipc
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.training.pavrm import PavrmConfig
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128
STEPS, MID, LR = 4, 1, 1e-3
SHAPE = (1, 3, 8, 8, 16)  # 48 tokens
TEXT_LEN = 16


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    tcfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32, remat_policy="attn")
    policy = tck.seeded_jax_tree(tcfg, 0)
    lrm_dit = tck.seeded_jax_tree(tcfg, 1)
    jmodel = jprfl.PrflModel(jcfg, JPavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                             jprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID))
    qp, mp = jmodel.lrm.init_head_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    batch = {"latents": rng.randn(*SHAPE).astype(np.float32),
             "text": rng.randn(1, TEXT_LEN, 64).astype(np.float32)}
    return dict(tcfg=tcfg, policy=policy, jmodel=jmodel, batch=batch,
                lrm={"dit": lrm_dit, "q": qp, "m": mp},
                lrm_np=(lrm_dit, jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, mp)))


def _port(setup, tx, remat_policy="attn", rollout_quant=None):
    import dataclasses

    cfg = dataclasses.replace(setup["tcfg"], remat_policy=remat_policy)
    model = tprfl.PrflModel(cfg, PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID,
                                             rollout_quant=rollout_quant))
    model.dit.load_state_dict(tck.from_jax_params(setup["policy"], cfg))
    model.lrm.load_state_dict(tck.lrm_from_jax(*setup["lrm_np"], model.lrm.dit_cfg))
    return model, tcommon.init_train_state(model.dit, tx)


def _tbatch(setup):
    return {k: torch.from_numpy(v.copy()) for k, v in setup["batch"].items()}


def _jbatch(setup):
    return {k: jnp.asarray(v) for k, v in setup["batch"].items()}


def _params_np(state):
    return {n: p.detach().numpy().copy() for n, p in zip(state.names, state.params)}


def _assert_params(tstate, jparams, tcfg, old=None):
    want = tck.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    assert set(want) == set(tstate.names)
    for n, p in zip(tstate.names, tstate.params):
        got, ref = p.detach().numpy(), want[n].numpy()
        if old is None:
            # updated params: AdamW's first step moves each weight by
            # lr g / (|g| + eps). Where |g| is near eps (1e-8) that size rests
            # on the last bits of g, which fp32 sums in another order change:
            # a few such weights may differ by up to 0.1 lr; all others agree
            # to 1e-4 of the weight
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.1 * LR, err_msg=n)
            off = np.abs(got - ref) > 1e-4 * np.abs(ref) + 1e-6
            assert off.mean() < 1e-3, (n, off.sum())
        else:
            # the raw gradients (identity optimizer), read back as
            # (p + g) - p: 1e-4 of each tensor's scale, plus two fp32 ulps
            # of the weights for the cancellation
            g, gr = got - old[n], ref - old[n]
            ulp = np.spacing(np.float32(np.abs(old[n]).max()))
            np.testing.assert_allclose(g, gr, rtol=0, atol=1e-4 * np.abs(gr).max() + 2 * ulp,
                                       err_msg=n)


class _Identity:
    """p += g: the step's raw gradients land in the parameters."""

    def init(self, params, names=None):
        return {}

    def update(self, params, grads, opt_state, step):
        for p, g in zip(params, grads):
            p.add_(g)


def _jax_refl(setup, tx):
    state = jcommon.init_train_state(setup["policy"], tx)
    step = jax.jit(jprfl.make_refl_step(setup["jmodel"], tx))
    new, m = step(state, _jbatch(setup), jax.random.PRNGKey(0), setup["lrm"])
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    latent0 = np.asarray(jax.random.normal(k_noise, SHAPE, jnp.float32))
    return new, m, torch.from_numpy(latent0)


@pytest.mark.parametrize("optimizer", ["adamw", "identity"])
def test_refl_step_matches_jax(setup, optimizer):
    jtx = (jcommon.make_optimizer(learning_rate=LR) if optimizer == "adamw"
           else optax.identity())
    new, m, latent0 = _jax_refl(setup, jtx)
    ttx = tcommon.make_optimizer(learning_rate=LR) if optimizer == "adamw" else _Identity()
    model, state = _port(setup, ttx)
    old = _params_np(state)
    state, met = tprfl.make_refl_step(model, ttx)(state, _tbatch(setup), latent0=latent0)
    assert met["mid"] == MID and state.step == 1
    # loss, reward and grad norm at fp32 through rollout, LRM and backward
    for key in ("loss", "reward", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-4, err_msg=key)
    assert float(met["grad_norm"]) > 0
    _assert_params(state, new.params, setup["tcfg"], None if optimizer == "adamw" else old)


def _jax_sft(setup, tx, state, key):
    sched = jfm.train_schedule(1000)
    step = jax.jit(jprfl.make_sft_step(setup["jmodel"], tx, sched))
    new, m = step(state, _jbatch(setup), key)
    k_t, k_n = jax.random.split(key)
    t, sigma = jfm.sample_train_timestep(k_t, sched, 1, "uniform")
    noise = np.asarray(jax.random.normal(k_n, SHAPE, jnp.float32))
    draws = dict(t=torch.from_numpy(np.asarray(t)), sigma=torch.from_numpy(np.asarray(sigma)),
                 noise=torch.from_numpy(noise))
    return new, m, draws


@pytest.mark.parametrize("max_grad_norm", [1e3, 1e-3])  # the clip idle, and engaged
def test_sft_step_matches_jax(setup, max_grad_norm):
    jtx = jcommon.make_optimizer(learning_rate=LR, max_grad_norm=max_grad_norm)
    new, m, draws = _jax_sft(setup, jtx, jcommon.init_train_state(setup["policy"], jtx),
                             jax.random.PRNGKey(5))
    ttx = tcommon.make_optimizer(learning_rate=LR, max_grad_norm=max_grad_norm)
    model, state = _port(setup, ttx)
    state, met = tprfl.make_sft_step(model, ttx, tfm.train_schedule(1000))(
        state, _tbatch(setup), **draws)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-4, err_msg=key)
    assert 1e-3 < float(m["grad_norm"]) < 1e3
    _assert_params(state, new.params, setup["tcfg"])


def test_gradient_accumulation_matches_jax(setup):
    jtx = jcommon.make_optimizer(learning_rate=LR, gradient_accumulation_steps=2)
    ttx = tcommon.make_optimizer(learning_rate=LR, gradient_accumulation_steps=2)
    model, state = _port(setup, ttx)
    jstate = jcommon.init_train_state(setup["policy"], jtx)
    sft = tprfl.make_sft_step(model, ttx, tfm.train_schedule(1000))
    first = _params_np(state)
    for i, seed in enumerate((6, 7)):
        jstate, m, draws = _jax_sft(setup, jtx, jstate, jax.random.PRNGKey(seed))
        state, met = sft(state, _tbatch(setup), **draws)
        np.testing.assert_allclose(float(met["grad_norm"]), float(m["grad_norm"]), rtol=1e-4)
        if i == 0:  # the first micro-step only accumulates
            assert all(np.array_equal(p.detach().numpy(), first[n])
                       for n, p in zip(state.names, state.params))
    assert state.step == 2
    _assert_params(state, jstate.params, setup["tcfg"])


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_jax(kind, warmup):
    args = (3e-4, kind, warmup, 15)
    jsched = jcommon._lr_schedule(*args, lr_num_cycles=2, lr_power=2.0)
    tsched = tcommon._lr_schedule(*args, lr_num_cycles=2, lr_power=2.0)
    got = [tsched(s) for s in range(20)]
    want = [float(jsched(jnp.asarray(s))) for s in range(20)]
    # fp32 (JAX) against fp64 (port) evaluation of the same formulas
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def test_slice_blocks_keeps_the_reward_tower():
    cfg = tdit.tiny_test(num_layers=3)
    full = tck.from_jax_params(tck.seeded_jax_tree(cfg, 0), cfg)
    tower = tcommon.slice_blocks(full, 2)
    want = tck.from_jax_params(tck.seeded_jax_tree(cfg, 0), tdit.tiny_test(num_layers=2),
                               with_head=False)
    assert tower.keys() == want.keys()
    assert all(torch.equal(tower[k], want[k]) for k in want)


def test_finite_guard_still_applies_the_update():
    lin = torch.nn.Linear(4, 3)
    tx = tcommon.make_optimizer(learning_rate=0.1, weight_decay=0.5)
    state = tcommon.init_train_state(lin, tx)
    before = [p.detach().clone() for p in state.params]
    lin(torch.ones(1, 4)).sum().backward()
    state, loss, gnorm = tprfl._finish(state, tx, torch.tensor(float("nan")))
    assert float(loss) == 0.0 and float(gnorm) == 0.0 and state.step == 1
    # zero gradients, yet AdamW still applies its decoupled weight decay
    for p, b in zip(state.params, before):
        torch.testing.assert_close(p.detach(), b - 0.1 * 0.5 * b)


def test_unipc_step_continues_the_rollout():
    sched = tunipc.unipc_schedule(6, shift=5.0)
    jsched = junipc.unipc_schedule(6, shift=5.0)
    x0 = torch.from_numpy(np.random.RandomState(8).randn(1, 12, 4, 16).astype(np.float32))

    def vel(x, t):
        return 0.3 * x + t / 1000.0

    full, _ = tunipc.rollout(sched, vel, x0, num_steps=3)
    part, st = tunipc.rollout(sched, vel, x0, num_steps=2)
    assert st.step_index == 2
    nxt, st2 = tunipc.unipc_step(sched, st, vel(part, float(sched.timesteps[2])), part)
    torch.testing.assert_close(nxt, full, rtol=0, atol=0)
    jpart, jst = junipc.rollout(jsched, lambda x, t: 0.3 * x + t / 1000.0,
                                jnp.asarray(x0.numpy()), stop_index=2)
    assert int(jst.step_index) == 2
    jn, _ = junipc.unipc_step(jsched, jst, 0.3 * jpart + jsched.timesteps[2] / 1000.0, jpart)
    # the same fp32 coefficient table and multiply-adds
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)


def test_flow_match_matches_jax():
    jsched, tsched = jfm.train_schedule(1000), tfm.train_schedule(1000)
    # the JAX table comes from jnp.linspace's fp32 recipe: within one ulp
    np.testing.assert_allclose(tsched.sigmas.numpy(), np.asarray(jsched.sigmas), atol=1.2e-7)
    key = jax.random.PRNGKey(9)
    for scheme in ("uniform", "logit_normal"):
        jt, js = jfm.sample_train_timestep(key, jsched, 4, scheme, 0.2, 1.1)
        if scheme == "uniform":
            u = np.asarray(jax.random.uniform(key, (4,)))
        else:
            u = np.asarray(jax.nn.sigmoid(jax.random.normal(key, (4,)) * 1.1 + 0.2))
        tt, ts = tfm.sample_train_timestep(tsched, 4, scheme, 0.2, 1.1, u=torch.from_numpy(u))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1.2e-7)
        np.testing.assert_allclose(tfm.sigma_for_timestep(tsched, tt).numpy(), ts.numpy(),
                                   atol=1.2e-7)
    x0, eps, sig = np.ones(3, np.float32), np.full(3, 2.0, np.float32), np.float32(0.25)
    np.testing.assert_allclose(tfm.add_noise(torch.from_numpy(x0), torch.from_numpy(eps), sig),
                               np.asarray(jfm.add_noise(x0, eps, sig)))
    np.testing.assert_allclose(tfm.train_target(torch.from_numpy(x0), torch.from_numpy(eps)),
                               np.asarray(jfm.train_target(x0, eps)))


@pytest.mark.parametrize("pool", ["q_attn", "mean", "max"])
def test_reward_heads_match_jax(pool):
    d = 256
    q_attn = jrw.QueryAttention(feature_dim=d, num_queries=2, num_heads=8, return_type="query")
    mlp = jrw.RewardMLP()
    qp = q_attn.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, d)))
    mp = mlp.init(jax.random.PRNGKey(1), jnp.zeros((1, d)))
    feats = np.random.RandomState(10).randn(2, 3, 20, d).astype(np.float32)
    pooled = jrw.pool_features(jnp.asarray(feats), pool, lambda f: q_attn.apply(qp, f))
    want = np.asarray(jrw.reward_sigmoid(mlp.apply(mp, pooled)))
    state = tck.reward_heads_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, mp))
    tq = trw.QueryAttention(d, 2, 8, "query")
    tm = trw.RewardMLP(d)
    tq.load_state_dict({k[7:]: v for k, v in state.items() if k.startswith("q_attn.")})
    tm.load_state_dict({k[4:]: v for k, v in state.items() if k.startswith("mlp.")})
    with torch.no_grad():
        got = trw.reward_sigmoid(tm(trw.pool_features(torch.from_numpy(feats), pool, tq)))
    # fp32 heads; matmul and softmax sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    r = np.array([0.2, 0.9], np.float32)
    np.testing.assert_allclose(float(trw.prfl_hinge_loss(torch.from_numpy(r))),
                               float(jrw.prfl_hinge_loss(jnp.asarray(r))), rtol=1e-6)
    lab = np.array([1.0, 0.0], np.float32)
    np.testing.assert_allclose(float(trw.bce_loss(torch.from_numpy(r), torch.from_numpy(lab))),
                               float(jrw.bce_loss(jnp.asarray(r), jnp.asarray(lab))), rtol=1e-6)
    np.testing.assert_allclose(trw.siamese_prob(torch.tensor(0.3), torch.tensor(-0.2)).item(),
                               float(jrw.siamese_prob(0.3, -0.2)), rtol=1e-6)


@pytest.mark.parametrize("remat_policy,rollout_quant,shifted", [
    pytest.param("attn", None, False, id="attn"), pytest.param("full", None, False, id="full"),
    pytest.param("attn", "int8", False, id="attn-int8-rollout"),
    pytest.param("attn", None, True, id="attn-shifted"),
    pytest.param("full", None, True, id="full-shifted")])
def test_launch_derivation_counts_the_calls(setup, monkeypatch, remat_policy, rollout_quant,
                                            shifted):
    # chip_smoke.py checks the card's launch counters against this
    # derivation; on the CPU the same Functions call the plain versions,
    # so counting those calls checks the derivation itself. With the int8
    # rollout, FULL_K_MAX shrinks so the 48 self-attention tokens stream
    # and its forwards take K10, as the card's 9,360 and 32,760 do. The
    # shifted route (HYV_FLASH_BOUNDED=0) takes K2 and K3s instead of K1/K3
    smoke = _load_script("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    if rollout_quant:
        monkeypatch.setattr(tfa, "FULL_K_MAX", 64)
    if shifted:
        monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
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
            lambda q, k, v: "K3" if k.shape[2] == TEXT_LEN else "K1")
    counted(tfa, "flash_attention_shifted_plain",
            lambda q, k, v, kvalid: "K3s" if k.shape[2] == TEXT_LEN else "K2")
    counted(tfa, "flash_attention_bwd_plain", lambda *a: "K4")
    counted(tfa, "flash_attention_qk8_plain", lambda *a: "K10")
    tx = tcommon.make_optimizer(learning_rate=LR)
    model, state = _port(setup, tx, remat_policy, rollout_quant)
    state, _ = tprfl.make_refl_step(model, tx)(state, _tbatch(setup))
    tprfl.make_sft_step(model, tx, tfm.train_schedule(1000))(
        state, _tbatch(setup), generator=torch.Generator().manual_seed(0))
    assert counts == smoke.expected_train_launches(2, 2, MID, remat_policy, rollout_quant,
                                                   shifted)
    assert ("K10" in counts) == (rollout_quant == "int8")
    assert ("K2" in counts) == shifted and ("K1" in counts) != shifted


def _smoke_config(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    for key in ("meta_file_list",):
        cfg.dataset[key] = [os.path.join(REPO, p) for p in cfg.dataset[key]]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(tmp_path)
    return cfg


def test_cli_trains_two_steps_on_the_smoke_config(tmp_path):
    cli = _load_script("train_prfl_torch", os.path.join(REPO, "scripts", "train_prfl_torch.py"))
    cfg = _smoke_config(tmp_path)
    cfg.model.ema.use_ema = False  # the smoke config asks for EMA; not needed here
    trainer = cli.build_trainer(cfg, "cpu")
    before = trainer.model.dit.head.head.weight.detach().clone()
    history = cli.run(trainer, 2)
    assert len(history) == 2
    for m in history:
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss", "t_refl", "t_sft"):
            assert math.isfinite(m[key]), (key, m)
        assert m["grad_norm"] > 0 and 0 <= m["mid"] <= 2
    assert not torch.equal(trainer.model.dit.head.head.weight, before)
    assert trainer.state.step == 4  # refl + SFT per outer step
    logs = (tmp_path / "smoke_prfl" / "logs" / "log.txt").read_text().splitlines()
    assert len(logs) == 2
    assert (tmp_path / "smoke_prfl" / "sanity_check" / "step0_pred_x0.npy").exists()


def test_cli_refuses_what_is_not_ported(tmp_path):
    # an unknown FSDP strategy raises; LoRA builds (its factors the only
    # trainable parameters; tests/test_torch_lora_train.py trains it
    # against the JAX steps); dataset.sp_size > 1
    # (one process: sp clamps to 1, as the JAX build_mesh clamps it) and
    # optimizer-state offload build (tests/test_torch_parallel_train.py
    # runs them on gloo); EMA, resume, optimizer-state export, LRM loading
    # and a run past save_interval are ported (tests/test_torch_pavrm.py
    # holds them to the JAX trainer), and so is the VAE sanity decode
    # (tests/test_torch_vae.py)
    cli = _load_script("train_prfl_torch", os.path.join(REPO, "scripts", "train_prfl_torch.py"))
    cfg = _smoke_config(tmp_path)
    cfg.model.lora.use_lora = True
    cfg.model.lora.lora_rank = 4
    trainer = cli.build_trainer(cfg, "cpu")
    assert trainer.lora and all(".lora_" in n for n in trainer.state.names)
    cfg = _smoke_config(tmp_path)
    cfg["model"]["fsdp"] = {"fsdp_sharding_startegy": "zero3"}
    with pytest.raises(ValueError, match="zero3"):
        cli.build_trainer(cfg, "cpu")
    cfg = _smoke_config(tmp_path)
    cfg["dataset"]["sp_size"] = 2
    cfg["train"]["offload_opt_state"] = True
    trainer = cli.build_trainer(cfg, "cpu")
    assert trainer.mesh.sp == 1 and trainer.state.opt_state["mu"][0].device.type == "cpu"
    cfg = _smoke_config(tmp_path)  # asks for EMA; save_interval 4
    trainer = cli.build_trainer(cfg, "cpu")
    cli.run(trainer, int(cfg.train.save_interval))
    assert (tmp_path / "smoke_prfl" / "checkpoint-4" / "config.json").exists()
    assert (tmp_path / "smoke_prfl-ema" / "checkpoint-4" / "config.json").exists()


def test_port_imports_without_jax_or_yaml():
    code = (
        "import sys, importlib.util\n"
        "for m in ('jax', 'flax', 'chex', 'optax', 'yaml', 'hyvideo_prfl_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from hyvideo_prfl_torch.configs import config_from_dict\n"
        "from hyvideo_prfl_torch.training import common, pavrm, prfl\n"
        "from hyvideo_prfl_torch.data import dataset, loader\n"
        "from hyvideo_prfl_torch.schedulers import flow_match\n"
        "from hyvideo_prfl_torch.ops import int8_probe, quant\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'train_prfl_torch', 'scripts/train_prfl_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['train_prfl_torch'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "cfg = config_from_dict({'task': 't2v-1.3b', 'train': {'fixed_mid': 3}})\n"
        "assert mod.dit_cfg_from(cfg).num_layers == 30 and cfg.train.fixed_mid == 3\n"
        "assert cfg.train.gradient_accumulation_steps == 1\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
