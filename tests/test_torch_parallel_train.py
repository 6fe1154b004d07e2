"""The port's sharded training against the JAX package, on CPU gloo.

The ranks run in spawned processes that import no JAX
(tests/_torch_parallel_worker.py, torchrun's variables), once per world
size: at world 2 one refl + SFT step at (data 1, sp 2) and (data 2, sp 1),
the first again with the optimizer state offloaded, a PAVRM ce and a bt
step at sp 2, and scripts/train_prfl_torch.py saved and resumed at
(data 2, sp 1), and a LoRA refl + SFT step at (data 1, sp 2); at world 4
the refl + SFT step at (data 2, sp 2) under
each of the five FSDP strategies. Every step takes the JAX draws of the
global batch (2 rows); the JAX one-device steps and the port's unsharded
steps run here. The tolerances are tests/test_torch_training.py's against
JAX (metrics 1e-4, parameters 0.1 LR, the raw gradients 1e-4 of each
tensor's largest plus two ulps) and 1e-5 against the port's own unsharded
step; offload and the resume are held bit for bit.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import pavrm as jpavrm
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_torch.configs import AttrDict, load_config
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.parallel import sharding as tsharding
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import lora as tlora
from hyvideo_prfl_torch.training import pavrm as tpavrm
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.utils import checkpoint as tck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import start_group, wait_group  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)
STEPS, MID, LR = 4, 1, 1e-3
SHAPE = (2, 3, 8, 8, 16)  # the global batch: 2 rows of 48 tokens
STRATEGIES = ("full", "hybrid_full", "shard_grad_op", "hybrid_zero2", "none")
PRFL_RUNS = ("d1_sp2", "d2_sp1") + tuple(f"d2_sp2_{s}" for s in STRATEGIES)

# chip_smoke.py: its config writer and its gradient recorder
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tcfg():
    return tdit.tiny_test(**TINY, compute_dtype=torch.float32, remat_policy="attn")


def _jcfg():
    return jdit.tiny_test(**TINY, compute_dtype=jnp.float32, remat=False)


def _resume_config(d):
    """configs/smoke_prfl.yaml for 3 steps at world 2 (data 2): checkpoint
    with the optimizer state at step 2, EMA on, the stream shuffled."""
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.dataset.shuffle = True
    cfg.train.save_interval = 2
    cfg.train.save_optimizer_state = True
    cfg.model.ema = AttrDict.wrap({"use_ema": True, "ema_decay": 0.9})
    path = os.path.join(d, "resume.yaml")
    with open(path, "w") as f:
        f.write(SMOKE.yaml_text(cfg) + "\n")
    return path


def _prfl_draws():
    """The draws of the JAX refl step (key 0) and SFT step (key 5) on the
    global batch, as those steps make them."""
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    k_t, k_n = jax.random.split(jax.random.PRNGKey(5))
    t, sigma = jfm.sample_train_timestep(k_t, jfm.train_schedule(1000), SHAPE[0], "uniform")
    return {"p_latent0": np.asarray(jax.random.normal(k_noise, SHAPE, jnp.float32)),
            "p_t": np.asarray(t), "p_sigma": np.asarray(sigma),
            "p_noise": np.asarray(jax.random.normal(k_n, SHAPE, jnp.float32))}


def _recording(tx):
    """``tx`` behind a stage that passes the gradients on and keeps them in
    its state (opt_state[0]): the step's raw gradients, the update as it
    was."""
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _prfl_jax(inp, policy, jmodel, lrm):
    """The JAX refl step then the SFT step on the global batch -> (params,
    the refl step's gradients, metrics)."""
    jtx = _recording(jcommon.make_optimizer(learning_rate=LR))
    state = jcommon.init_train_state(policy, jtx)
    batch = {"latents": jnp.asarray(inp["p_latents"]), "text": jnp.asarray(inp["p_text"])}
    state, mr = jax.jit(jprfl.make_refl_step(jmodel, jtx))(state, batch,
                                                           jax.random.PRNGKey(0), lrm)
    grads = _np(state.opt_state[0])
    state, ms = jax.jit(jprfl.make_sft_step(jmodel, jtx, jfm.train_schedule(1000)))(
        state, batch, jax.random.PRNGKey(5))
    metrics = {"refl_loss": mr["loss"], "reward": mr["reward"], "refl_gnorm": mr["grad_norm"],
               "sft_loss": ms["loss"], "sft_gnorm": ms["grad_norm"]}
    return state.params, grads, {k: float(v) for k, v in metrics.items()}


def _prfl_port(inp, use_lora=False):
    """The port's unsharded refl + SFT step on the global batch (with
    ``use_lora`` the factors of ``lora.*`` on the frozen base)."""
    model = tprfl.PrflModel(_tcfg(), tpavrm.PavrmConfig(feature_layer=(2,),
                                                        trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID))
    model.dit.load_state_dict({k[7:]: torch.from_numpy(v) for k, v in inp.items()
                               if k.startswith("policy.")})
    model.lrm.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in inp.items()
                               if k.startswith("lrm.")})
    if use_lora:
        tlora.attach_lora(model.dit, tlora.lora_tree({k[5:]: torch.from_numpy(v) for k, v
                                                      in inp.items() if k.startswith("lora.")}))
    tx = SMOKE.Recording(tcommon.make_optimizer(learning_rate=LR))
    state = tcommon.init_train_state(model.dit, tx)
    batch = {"latents": torch.from_numpy(inp["p_latents"]),
             "text": torch.from_numpy(inp["p_text"])}
    state, mr = tprfl.make_refl_step(model, tx)(state, batch,
                                                latent0=torch.from_numpy(inp["p_latent0"]))
    state, ms = tprfl.make_sft_step(model, tx, tfm.train_schedule(1000))(
        state, batch, **{k: torch.from_numpy(inp[f"p_{k}"]) for k in ("t", "sigma", "noise")})
    metrics = {"refl_loss": mr["loss"], "reward": mr["reward"], "refl_gnorm": mr["grad_norm"],
               "sft_loss": ms["loss"], "sft_gnorm": ms["grad_norm"]}
    params = {n: p.detach().numpy().copy() for n, p in zip(state.names, state.params)}
    grads = {n: g.numpy() for n, g in zip(state.names, tx.grads)}
    return params, grads, {k: float(v) for k, v in metrics.items()}


def _pavrm_setup(loss, seed=0):
    """A seeded reward model, its batch and the JAX step's draws -> (port
    inputs, the JAX step to run later: () -> (want, metrics))."""
    kw = dict(loss=loss, feature_layer=(2,), trainable_blocks=(0, 1),
              timesteps=(400, 700, 100), task="t2v")
    jmodel = jpavrm.PavrmModel(_jcfg(), jpavrm.PavrmConfig(**kw))
    tree = tck.seeded_jax_tree(_tcfg(), seed)
    qp, mp = (_np(x) for x in jmodel.init_head_params(jax.random.PRNGKey(seed + 3)))
    p = tree["params"]
    jtrain = {"blocks": p["blocks"], "q_attn": qp["params"], "mlp": mp["params"]}
    jfrozen = {"params": {k: v for k, v in p.items() if k not in ("blocks", "head")}}
    model = tpavrm.PavrmModel(_tcfg(), tpavrm.PavrmConfig(**kw), param_dtype=torch.float32)
    state = tck.lrm_from_jax(tree, qp, mp, model.dit_cfg)
    rng = np.random.RandomState(7 if loss == "ce" else 8)
    batch = {"latents": rng.randn(*SHAPE).astype(np.float32),
             "text": rng.randn(SHAPE[0], 16, 64).astype(np.float32)}
    if loss == "ce":
        batch["labels"] = np.asarray([1.0, 0.0], np.float32)
    else:
        batch["latents_lose"] = rng.randn(*SHAPE).astype(np.float32)
    sched = jfm.train_schedule(1000)
    k_t, k_n = jax.random.split(jax.random.PRNGKey(9))
    t, _ = jpavrm.select_timestep(k_t, jpavrm.PavrmConfig(**kw), sched, 0, SHAPE[0])
    inp = {f"pv.{k}": v.numpy() for k, v in state.items()}
    inp.update({f"pv_{loss}_{k}": v for k, v in batch.items()})
    inp[f"pv_{loss}_t"] = np.asarray(t)
    inp[f"pv_{loss}_noise"] = np.asarray(jax.random.normal(k_n, SHAPE, jnp.float32))

    def port_names(tree):
        """A trainable tree (the parameters or their gradients) in the port's names."""
        tower = tck.from_jax_params({"params": {**jfrozen["params"],
                                                "blocks": _np(tree["blocks"])}},
                                    model.dit_cfg, with_head=False)
        out = {f"dit.{k}": v.numpy() for k, v in tower.items() if k.startswith("blocks.")}
        out.update({k: v.numpy() for k, v in tck.reward_heads_from_jax(
            _np(tree["q_attn"]), _np(tree["mlp"])).items()})
        return out

    def jax_step():
        jtx = _recording(jcommon.make_optimizer(learning_rate=LR))
        new, m = jax.jit(jpavrm.make_train_step(jmodel, jtx, sched))(
            jcommon.init_train_state(jtrain, jtx),
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(9), jfrozen)
        return (port_names(new.params), port_names(new.opt_state[0]),
                {k: float(m[k]) for k in ("loss", "grad_norm", "acc")})

    return inp, jax_step


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tcfg = _tcfg()
    policy, lrm_dit = tck.seeded_jax_tree(tcfg, 0), tck.seeded_jax_tree(tcfg, 1)
    jmodel = jprfl.PrflModel(_jcfg(), jpavrm.PavrmConfig(feature_layer=(2,),
                                                         trainable_blocks=(0, 1)),
                             jprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID))
    qp, mp = jmodel.lrm.init_head_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    inp = {"p_latents": rng.randn(*SHAPE).astype(np.float32),
           "p_text": rng.randn(SHAPE[0], 16, 64).astype(np.float32)}
    inp.update(_prfl_draws())
    inp.update({f"policy.{k}": v.numpy() for k, v in tck.from_jax_params(policy, tcfg).items()})
    lrm_port = tprfl.PrflModel(tcfg, tpavrm.PavrmConfig(feature_layer=(2,),
                                                        trainable_blocks=(0, 1)),
                               tprfl.PrflConfig()).lrm
    inp.update({f"lrm.{k}": v.numpy() for k, v in tck.lrm_from_jax(
        lrm_dit, _np(qp), _np(mp), lrm_port.dit_cfg).items()})
    # LoRA factors (rank 4) with a non-zero B, so that A has a gradient
    tree = tlora.lora_init(tprfl.PrflModel(tcfg, tpavrm.PavrmConfig(feature_layer=(2,)),
                                           tprfl.PrflConfig()).dit, rank=4,
                           generator=torch.Generator().manual_seed(2))
    for mods in tree["lora"].values():
        for ab in mods.values():
            ab["B"] = torch.from_numpy(rng.randn(*ab["B"].shape).astype(np.float32) * 0.02)
    inp.update({f"lora.blocks.{i}.{attn}.{m}.lora_{w}": ab[w][i].numpy()
                for attn, mods in tree["lora"].items() for m, ab in mods.items()
                for w in ("A", "B") for i in range(TINY["num_layers"])})
    pav_steps = {}
    for loss in ("ce", "bt"):
        pinp, pav_steps[loss] = _pavrm_setup(loss)
        inp.update(pinp)
    dirs = {w: str(tmp_path_factory.mktemp(f"train{w}")) for w in (2, 4)}
    inp["resume_config"] = np.array(_resume_config(dirs[2]))
    for d in dirs.values():
        np.savez(os.path.join(d, "inputs.npz"), **inp)
    groups = [start_group("train", w, d) for w, d in dirs.items()]
    # the references while the ranks work
    jparams, jgrads, jmet = _prfl_jax(inp, policy, jmodel, {"dit": lrm_dit, "q": qp, "m": mp})
    pav = {loss: step() for loss, step in pav_steps.items()}
    port = _prfl_port(inp)
    port_lora = _prfl_port(inp, use_lora=True)
    for procs in groups:
        wait_group(procs, timeout=600)
    want, gwant = (tck.from_jax_params(_np(tree), tcfg) for tree in (jparams, jgrads))
    return dirs, {"jax": ({k: v.numpy() for k, v in want.items()},
                          {k: v.numpy() for k, v in gwant.items()}, jmet),
                  "port": port, "pavrm": pav, "port_lora": port_lora}


def _read(d, name):
    return dict(np.load(os.path.join(d, f"{name}.npz")))


def _prfl_out(run, name):
    dirs, _ = run
    d = dirs[4] if name.startswith("d2_sp2") else dirs[2]
    return _read(d, f"prfl_{name}")


def _assert_params(got, want, steps=1):
    """tests/test_torch_training.py's rule for AdamW, per step: 1e-4 of the
    weight, or 0.1 LR for the few weights whose |g| is near AdamW's eps,
    where the update rests on the last bits of g (at most 1e-3 of a tensor,
    or one weight a step in a small one). The pool's key bias has an exact
    gradient of 0 (it moves every logit of a head alike), so AdamW turns
    each package's rounding noise into a move of up to LR: it is held to
    that bound alone."""
    assert set(want) <= set(got)
    for n, ref in want.items():
        if n.endswith("q_attn.bk"):
            assert np.abs(got[n] - ref).max() <= 2 * LR * steps, n
            continue
        np.testing.assert_allclose(got[n], ref, rtol=1e-4, atol=0.1 * LR * steps, err_msg=n)
        off = np.abs(got[n] - ref) > 1e-4 * np.abs(ref) + 1e-6
        assert off.sum() <= max(steps, 1e-3 * off.size), (n, off.sum())


@pytest.mark.parametrize("name", PRFL_RUNS)
def test_sharded_prfl_step_matches_jax(run, name):
    _, ref = run
    got = _prfl_out(run, name)
    jparams, _, jmet = ref["jax"]
    _, _, pmet = ref["port"]
    for key, want in jmet.items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-4, err_msg=key)
        # against the port's own unsharded step: only the sums' order differs
        np.testing.assert_allclose(float(got[key]), pmet[key], rtol=1e-5, err_msg=key)
    assert jmet["refl_gnorm"] > 0 and jmet["sft_gnorm"] > 0
    # two AdamW steps: the refl step's and the SFT step's
    _assert_params({k[6:]: v for k, v in got.items() if k.startswith("param.")}, jparams,
                   steps=2)


# the key biases of a softmax over keys that carry no position (the
# cross-attention's, the pool's): every logit of a query moves alike
ZERO_GRAD = ("q_attn.bk", "cross_attn.k.bias", "cross_attn.k_img.bias")


def _assert_grads(got, want, rel=1e-4):
    """Each gradient within ``rel`` of its tensor's largest plus two ulps of
    it (tests/test_torch_training.py's rule against JAX). A ZERO_GRAD
    bias has an exact gradient of 0, so each side holds rounding noise: it
    is held to ``rel`` of the largest gradient of the step."""
    assert set(want) <= set(got)
    top = max(np.abs(v).max() for v in want.values())
    for n, ref in want.items():
        scale = top if n.endswith(ZERO_GRAD) else np.abs(ref).max()
        np.testing.assert_allclose(got[n], ref, rtol=0,
                                   atol=rel * scale + 2 * np.spacing(np.float32(scale)),
                                   err_msg=n)


GRAD_RUNS = tuple(f"prfl_{r}" for r in PRFL_RUNS) + ("pavrm_ce", "pavrm_bt")


@pytest.mark.parametrize("name", GRAD_RUNS)
def test_sharded_gradients_match_jax(run, name):
    """The raw gradients of the sharded refl step (or PAVRM step) against
    the JAX one-device step's, and the refl step's against the port's
    unsharded step: a factor of sp in one tensor (a replicated input's
    gradient not summed over the sp ranks, say) shows here."""
    dirs, ref = run
    got = _prfl_out(run, name[5:]) if name.startswith("prfl_") else _read(dirs[2], name)
    got = {k[5:]: v for k, v in got.items() if k.startswith("grad.")}
    if name.startswith("prfl_"):
        _, jgrads, _ = ref["jax"]
        _, pgrads, _ = ref["port"]
        _assert_grads(got, pgrads, rel=1e-5)
    else:
        _, jgrads, _ = ref["pavrm"][name[6:]]
    assert set(got) == set(jgrads)
    _assert_grads(got, jgrads)


def test_lora_step_under_fsdp2_matches_the_unsharded_one(run):
    """LoRA at (data 1, sp 2) under "full": the factors sit in their
    blocks' FSDP2 units beside the frozen base, only they are trainable and
    reduced; the step's metrics, raw gradients and updated factors against
    the port's unsharded LoRA step (only the sums' order differs)."""
    _, ref = run
    got = _prfl_out(run, "d1_sp2_lora")
    pparams, pgrads, pmet = ref["port_lora"]
    assert set(pparams) and all(tlora.is_lora_name(n) for n in pparams)
    for key, want in pmet.items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-5, err_msg=key)
    assert pmet["refl_gnorm"] > 0
    grads = {k[5:]: v for k, v in got.items() if k.startswith("grad.")}
    assert set(grads) == set(pgrads)
    _assert_grads(grads, pgrads, rel=1e-5)
    _assert_params({k[6:]: v for k, v in got.items() if k.startswith("param.")}, pparams,
                   steps=2)


@pytest.mark.parametrize("strategy", STRATEGIES[1:])
def test_fsdp_strategies_give_the_same_step(run, strategy):
    base = _prfl_out(run, "d2_sp2_full")
    got = _prfl_out(run, f"d2_sp2_{strategy}")
    assert set(got) == set(base)
    for key in ("refl_loss", "reward", "refl_gnorm", "sft_loss", "sft_gnorm"):
        np.testing.assert_allclose(float(got[key]), float(base[key]), rtol=1e-5, err_msg=key)
    _assert_params({k: v for k, v in got.items() if k.startswith("param.")},
                   {k: v for k, v in base.items() if k.startswith("param.")}, steps=2)


def test_offload_is_bitwise_the_step(run):
    base, got = _prfl_out(run, "d1_sp2"), _prfl_out(run, "d1_sp2_offload")
    assert set(got) == set(base) and any(k.startswith("mu.") for k in got)
    for key, val in base.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_offload_moments_live_on_the_host():
    # the moments in host memory, the numbers those of the unoffloaded update
    states = []
    for offload in (False, True):
        torch.manual_seed(0)
        lin = torch.nn.Linear(4, 3)
        tx = tcommon.make_optimizer(learning_rate=0.1)
        state = tcommon.init_train_state(lin, tx, offload=offload)
        for _ in range(2):
            lin(torch.ones(2, 4)).square().sum().backward()
            state, _ = tcommon.apply_grads(state, tx, tcommon.collect_grads(state))
        states.append(state)
    ref, off = states
    assert all(m.device.type == "cpu" for m in off.opt_state["mu"] + off.opt_state["nu"])
    for a, b in zip(ref.params + ref.opt_state["mu"] + ref.opt_state["nu"],
                    off.params + off.opt_state["mu"] + off.opt_state["nu"]):
        assert torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("loss", ["ce", "bt"])
def test_pavrm_step_at_sp2_matches_jax(run, loss):
    dirs, ref = run
    want, _, met = ref["pavrm"][loss]
    got = _read(dirs[2], f"pavrm_{loss}")
    for key, val in met.items():
        np.testing.assert_allclose(float(got[key]), val, rtol=1e-4, err_msg=key)
    assert met["grad_norm"] > 0
    _assert_params({k[6:]: v for k, v in got.items() if k.startswith("param.")}, want)


def test_save_and_resume_at_world_2_repeats_the_run(run):
    dirs, _ = run
    got = _read(dirs[2], "resume")
    assert bool(got["saved"])
    np.testing.assert_array_equal(got["resumed"][0], got["whole"][2])
    assert np.isfinite(got["whole"]).all() and got["whole"].shape == (3, 5)
    for key, val in got.items():
        if key.startswith("whole."):
            np.testing.assert_array_equal(got["resumed." + key[6:]], val, err_msg=key)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


CONFIGS_720 = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                     if f.startswith("train_") and f.endswith("_720.yaml"))


@pytest.mark.parametrize("name", CONFIGS_720)
def test_720_configs_build(tmp_path, name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    assert int(cfg.dataset.sp_size) == 4
    layers = max(cfg.lrm.feature_layer)
    cfg.model.override = AttrDict.wrap(dict(dim=128, ffn_dim=256, num_heads=2, freq_dim=32,
                                            text_dim=64, num_layers=layers))
    cfg.dataset.meta_file_list = [os.path.join(REPO, "temp_data_smoke", "smoke.list")]
    if cfg.dataset.get("meta_file_lose_list"):
        cfg.dataset.meta_file_lose_list = list(cfg.dataset.meta_file_list)
    cfg.dataset.null_dir = os.path.join(REPO, "temp_data_smoke", "null")
    cfg.save.output_dir = str(tmp_path)
    cli = _load_script("train_prfl_torch" if "prfl" in name else "train_pavrm_torch")
    trainer = cli.build_trainer(cfg, "cpu")
    # one process: sp clamps to 1, as the JAX build_mesh clamps it
    assert trainer.mesh.sp == 1 and trainer.mesh.world == 1
    assert trainer.state.params and trainer.step == 0


def test_ring_size_raises_naming_ring_attention(caplog):
    """--ring_size no longer raises: it is accepted and clamped as the JAX
    CLI clamps it (ring = min(ring_size, world // ulysses_size): one
    process runs ring 1), and --quant_attn int8 beside a ring > 1 warns and
    keeps bf16 attention, as in the JAX CLI."""
    cli = _load_script("inference_torch")
    args = cli.args_init(["--ring_size", "2", "--device", "cpu"])
    assert args.ring_size == 2 and args.quant_attn == "none"
    mesh = tsharding.build_mesh(args.ulysses_size, "cpu", ring_size=args.ring_size)
    assert mesh.ring == 1 and mesh.sp == 1 and mesh.seq() is None
    with caplog.at_level("WARNING"):
        args = cli.args_init(["--ring_size", "2", "--quant_attn", "int8", "--device", "cpu"])
    assert args.quant_attn == "none" and "keeping bf16" in caplog.text
    assert cli.args_init(["--quant_attn", "int8", "--device", "cpu"]).quant_attn == "int8"
    args = cli.args_init(["--ulysses_size", "4", "--ulysses_chunks", "2", "--device", "cpu"])
    assert args.ulysses_size == 4 and args.ulysses_chunks == 2
