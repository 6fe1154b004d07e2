"""LoRA PRFL training in the port against the JAX package, on the CPU.

``lora_init`` against the JAX shapes; a refl step and an SFT step with the
factors attached (training/lora.attach_lora) against JAX
``make_refl_step``/``make_sft_step(lora_mode=True)`` given the same seeded
base, the same factor tree (non-zero B, so A has a gradient) and the JAX
draws: the loss, the factors' raw gradients (identity optimizer) and their
AdamW update, with the base bit for bit unchanged; the trainer's three
LoRA exports read back through the JAX ``lora_from_state_dict``; its merged
checkpoint against JAX ``apply_lora``; the int8 rollout quantizing the
merged weights; and ``train_prfl_torch.main`` with ``use_lora: true``.
The DiT runs at fp32 compute, where the two frameworks differ only in the
order of their sums.
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

from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import lora as jlora
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.training.pavrm import PavrmConfig as JPavrmConfig
from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import quant as tquant
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import lora as tlora
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.training.pavrm import PavrmConfig
from hyvideo_prfl_torch.utils import checkpoint as tck
from hyvideo_prfl_torch.utils import safetensors_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128
STEPS, MID, LR, RANK = 4, 1, 1e-3, 8
SHAPE = (1, 3, 8, 8, 16)  # 48 tokens
FORMATS = ("transformer", "kohya", "diffusers")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
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
    # the JAX initial tree, with a non-zero B so that A has a gradient
    lora = jlora.lora_init(jax.random.PRNGKey(4), policy, rank=RANK)
    rng = np.random.RandomState(1)
    lora = jax.tree.map(lambda a: np.asarray(a, np.float32), lora)
    for mods in lora["lora"].values():
        for ab in mods.values():
            ab["B"] = (rng.randn(*ab["B"].shape) * 0.02).astype(np.float32)
    batch = {"latents": rng.randn(*SHAPE).astype(np.float32),
             "text": rng.randn(1, 16, 64).astype(np.float32)}
    return dict(tcfg=tcfg, policy=policy, jmodel=jmodel, batch=batch, lora=lora,
                lrm={"dit": lrm_dit, "q": qp, "m": mp, "base": policy},
                lrm_np=(lrm_dit, jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, mp)))


def _port(setup, tx, rollout_quant=None):
    cfg = setup["tcfg"]
    model = tprfl.PrflModel(cfg, PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                            tprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID,
                                             rollout_quant=rollout_quant))
    model.dit.load_state_dict(tck.from_jax_params(setup["policy"], cfg))
    model.lrm.load_state_dict(tck.lrm_from_jax(*setup["lrm_np"], model.lrm.dit_cfg))
    tlora.attach_lora(model.dit, tlora.lora_from_jax(setup["lora"]))
    return model, tcommon.init_train_state(model.dit, tx)


def _batch(setup, jax_side=False):
    if jax_side:
        return {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    return {k: torch.from_numpy(v.copy()) for k, v in setup["batch"].items()}


class _Identity:
    """p += g: the step's raw gradients land in the parameters."""

    def init(self, params, names=None):
        return {}

    def update(self, params, grads, opt_state, step):
        for p, g in zip(params, grads):
            p.add_(g)


def _base(model):
    return {k: v.detach().clone() for k, v in model.dit.state_dict().items()
            if not tlora.is_lora_name(k)}


def _assert_factors(state, jtree, old=None):
    """The port's trained factors against the JAX tree: AdamW's update to
    1e-4 of each weight (a few elements whose gradient is near eps may move
    by up to 0.1 lr), or the raw gradient (p + g) - p to 1e-4 of its scale."""
    got = tlora.lora_tree(dict(zip(state.names, state.params)))["lora"]
    ref = jax.tree.map(np.asarray, jtree)["lora"]
    assert set(got) == set(ref)
    for attn, mods in ref.items():
        for m, ab in mods.items():
            for w in ("A", "B"):
                g, r = got[attn][m][w].numpy(), ab[w]
                name = f"{attn}.{m}.{w}"
                if old is None:
                    np.testing.assert_allclose(g, r, rtol=1e-4, atol=0.1 * LR, err_msg=name)
                    off = np.abs(g - r) > 1e-4 * np.abs(r) + 1e-6
                    assert off.mean() < 1e-3, (name, off.sum())
                else:
                    o = old[attn][m][w]
                    dg, dr = g - o, r - o
                    ulp = np.spacing(np.float32(np.abs(o).max()))
                    np.testing.assert_allclose(dg, dr, rtol=0, atol=1e-4 * np.abs(dr).max()
                                               + 2 * ulp, err_msg=name)
                    assert np.abs(dr).max() > 0, name


def test_lora_init_has_the_jax_shapes_and_a_zero_b(setup):
    model, _ = _port(setup, _Identity())
    tree = tlora.lora_init(model.dit, rank=RANK, generator=torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, jlora.lora_init(jax.random.PRNGKey(0), setup["policy"],
                                                  rank=RANK))
    assert set(tree["lora"]) == set(ref["lora"]) == {"self_attn", "cross_attn"}
    for attn, mods in ref["lora"].items():
        assert set(tree["lora"][attn]) == set(mods) == {"q", "k", "v", "o"}
        for m, ab in mods.items():
            a, b = tree["lora"][attn][m]["A"], tree["lora"][attn][m]["B"]
            assert tuple(a.shape) == ab["A"].shape and tuple(b.shape) == ab["B"].shape
            assert a.dtype == b.dtype == torch.float32 and not b.any()
            # N(0, 0.01), as the JAX draw
            assert abs(float(a.std()) - 0.01) < 1e-3 and abs(float(ab["A"].std()) - 0.01) < 1e-3
    # attached: the base frozen, the factors the only trainable parameters
    dit = model.dit
    names = [n for n, p in dit.named_parameters() if p.requires_grad]
    assert len(names) == 2 * 2 * 4 * TINY["num_layers"] and all(map(tlora.is_lora_name, names))
    assert not hasattr(dit.blocks[0].cross_attn, "k_img")


def _jax_lora_step(setup, kind, tx):
    state = jcommon.init_train_state(jax.tree.map(jnp.asarray, setup["lora"]), tx)
    if kind == "refl":
        step = jax.jit(jprfl.make_refl_step(setup["jmodel"], tx, lora_mode=True))
        new, m = step(state, _batch(setup, True), jax.random.PRNGKey(0), setup["lrm"])
        k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
        draws = {"latent0": torch.from_numpy(np.asarray(
            jax.random.normal(k_noise, SHAPE, jnp.float32)))}
        return new, m, draws
    sched = jfm.train_schedule(1000)
    step = jax.jit(jprfl.make_sft_step(setup["jmodel"], tx, sched, lora_mode=True,
                                       lora_base=setup["policy"]))
    key = jax.random.PRNGKey(5)
    new, m = step(state, _batch(setup, True), key)
    k_t, k_n = jax.random.split(key)
    t, sigma = jfm.sample_train_timestep(k_t, sched, 1, "uniform")
    draws = dict(t=torch.from_numpy(np.asarray(t)), sigma=torch.from_numpy(np.asarray(sigma)),
                 noise=torch.from_numpy(np.asarray(jax.random.normal(k_n, SHAPE, jnp.float32))))
    return new, m, draws


@pytest.mark.parametrize("kind", ["refl", "sft"])
@pytest.mark.parametrize("optimizer", ["adamw", "identity"])
def test_lora_step_matches_jax(setup, kind, optimizer):
    jtx = (jcommon.make_optimizer(learning_rate=LR) if optimizer == "adamw"
           else optax.identity())
    new, m, draws = _jax_lora_step(setup, kind, jtx)
    ttx = tcommon.make_optimizer(learning_rate=LR) if optimizer == "adamw" else _Identity()
    model, state = _port(setup, ttx)
    base = _base(model)
    old = tlora.lora_tree(dict(zip(state.names, [p.detach().clone() for p in state.params])))
    if kind == "refl":
        state, met = tprfl.make_refl_step(model, ttx)(state, _batch(setup), **draws)
    else:
        state, met = tprfl.make_sft_step(model, ttx, tfm.train_schedule(1000))(
            state, _batch(setup), **draws)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(m[key]), rtol=1e-4, err_msg=key)
    assert float(met["grad_norm"]) > 0
    _assert_factors(state, new.params, None if optimizer == "adamw" else {
        attn: {mm: {w: t.numpy() for w, t in ab.items()} for mm, ab in mods.items()}
        for attn, mods in old["lora"].items()})
    after = _base(model)
    assert all(torch.equal(after[k], v) for k, v in base.items())  # the base bit for bit


def test_int8_rollout_quantizes_the_merged_weights(setup, monkeypatch):
    built = []
    real = tprfl.int8_rollout_model
    monkeypatch.setattr(tprfl, "int8_rollout_model", lambda m: built.append(real(m)) or built[-1])
    model, state = _port(setup, _Identity(), rollout_quant="int8")
    step = tprfl.make_refl_step(model, _Identity())
    _, pairs = built[0]
    assert {id(layer) for _, layer in pairs} >= {id(model.dit.blocks[0].self_attn.q)}
    with torch.no_grad():
        want = [tquant.quantize_weight(tdit.merged_weight(layer)) for _, layer in pairs]
        assert not torch.equal(tdit.merged_weight(model.dit.blocks[0].self_attn.q),
                               model.dit.blocks[0].self_attn.q.weight)
    step(state, _batch(setup), latent0=torch.randn(SHAPE), mid=MID)
    for (qlayer, _), (q, s) in zip(pairs, want):
        assert torch.equal(qlayer.weight_q, q) and torch.equal(qlayer.weight_scale, s)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_prfl_torch's trainer on the smoke config with use_lora (rank 4,
    EMA on) for 2 outer steps, saved after the second; the smoke policy's
    zero head gets seeded weights so the factors receive gradients."""
    cli = _load_script("train_prfl_torch")
    out = tmp_path_factory.mktemp("lora_cli")
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(out)
    cfg.model.lora.use_lora = True
    cfg.model.lora.lora_rank = 4
    cfg.train.save_interval = 2
    trainer = cli.build_trainer(cfg, "cpu")
    with torch.no_grad():
        trainer.model.dit.head.head.weight.normal_(0.0, 0.05,
                                                   generator=torch.Generator().manual_seed(0))
    base = _base(trainer.model)
    history = cli.run(trainer, int(cfg.train.save_interval))
    return dict(cli=cli, cfg=cfg, trainer=trainer, base=base, history=history,
                ckpt=os.path.join(str(out), "smoke_prfl", f"checkpoint-{cfg.train.save_interval}"),
                ema=os.path.join(str(out), "smoke_prfl-ema",
                                 f"checkpoint-{cfg.train.save_interval}"))


def test_cli_trains_lora_and_saves_as_the_jax_trainer(trained):
    tr, dit_cfg = trained["trainer"], trained["trainer"].model.dit_cfg
    assert tr.lora and all(map(tlora.is_lora_name, tr.state.names))
    assert len(tr.state.opt_state["mu"]) == len(tr.state.names)  # moments of A and B alone
    assert len(tr.ema) == len(tr.state.names)
    assert all(h["grad_norm"] > 0 for h in trained["history"])
    after = _base(tr.model)
    assert all(torch.equal(after[k], v) for k, v in trained["base"].items())
    tree = tlora.lora_tree(dict(zip(tr.state.names, tr.state.params)))
    assert any(ab["B"].abs().max() > 0 for mods in tree["lora"].values()
               for ab in mods.values())
    files = set(os.listdir(trained["ckpt"]))
    assert {f"lora_{f}.safetensors" for f in FORMATS} <= files and "opt_state" not in files
    # the merged checkpoint: JAX apply_lora of the base and the trained tree
    saved = tck.load_reference_dir(trained["ckpt"], dit_cfg)
    want = tlora.merged_state(trained["base"], tree)
    for k, v in want.items():
        torch.testing.assert_close(saved[k], v, rtol=0, atol=0, msg=k)
    jtree = {"lora": {a: {m: {w: jnp.asarray(t.numpy()) for w, t in ab.items()}
                          for m, ab in mods.items()} for a, mods in tree["lora"].items()}}
    for i in range(dit_cfg.num_layers):
        for attn in ("self_attn", "cross_attn"):
            for m in ("q", "k", "v", "o"):
                kern = jnp.asarray(trained["base"][f"blocks.{i}.{attn}.{m}.weight"].numpy().T)
                stacked = {"params": {"blocks": {attn: {m: {"kernel": kern[None]}}}}}
                one = {"lora": {attn: {m: {w: jtree["lora"][attn][m][w][i:i + 1]
                                           for w in ("A", "B")}}}}
                merged = jlora.apply_lora(stacked, one)["params"]["blocks"][attn][m]["kernel"]
                np.testing.assert_allclose(saved[f"blocks.{i}.{attn}.{m}.weight"].numpy(),
                                           np.asarray(merged[0]).T, rtol=1e-6, atol=1e-7)
    # the EMA: its factors merged into the base
    ema_saved = tck.load_reference_dir(trained["ema"], dit_cfg)
    ema_tree = tlora.lora_tree(dict(zip(tr.state.names, tr.ema)))
    for k, v in tlora.merged_state(trained["base"], ema_tree).items():
        torch.testing.assert_close(ema_saved[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("fmt", FORMATS)
def test_lora_exports_read_back_through_jax(trained, fmt):
    tr = trained["trainer"]
    tree = tlora.lora_tree(dict(zip(tr.state.names, tr.state.params)))
    sd = safetensors_io.read_file(os.path.join(trained["ckpt"], f"lora_{fmt}.safetensors"))
    back = jlora.lora_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                      head_dim=tr.model.dit_cfg.head_dim)
    assert set(back["lora"]) == set(tree["lora"])
    for attn, mods in tree["lora"].items():
        for m, ab in mods.items():
            for w in ("A", "B"):
                np.testing.assert_array_equal(np.asarray(back["lora"][attn][m][w]),
                                              ab[w].numpy(), err_msg=f"{attn}.{m}.{w}")


def test_lora_resume_takes_the_merged_checkpoint_as_its_base(trained):
    """As the JAX trainer resumes a LoRA run: the merged DiT is the base,
    under fresh factors (B = 0: the first forward is the merged model's),
    with fresh moments; the step continues."""
    cfg = trained["cfg"]
    cfg.model.resume_transformer_path = trained["ckpt"]
    tr = trained["cli"].build_trainer(cfg, "cpu")
    assert tr.step == int(cfg.train.save_interval) and tr.lora and tr.state.step == 0
    saved = tck.load_reference_dir(trained["ckpt"], tr.model.dit_cfg)
    for k, v in _base(tr.model).items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0, msg=k)
    tree = tlora.lora_tree(dict(zip(tr.state.names, tr.state.params)))
    assert all(not ab["B"].any() for mods in tree["lora"].values() for ab in mods.values())


def test_launch_derivation_counts_the_lora_calls(setup, monkeypatch):
    """chip_smoke.py holds its LoRA step's launch counters to
    expected_train_launches(lora=True); on the CPU the same Functions call
    the plain versions, so counting those calls checks the derivation."""
    from hyvideo_prfl_torch.ops import flash_attention as tfa
    from hyvideo_prfl_torch.ops import qknorm_rope as tqr
    from hyvideo_prfl_torch.ops import stream as tstream

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
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
    counted(tqr, "rmsnorm_rope_plain", lambda *a: "K6")
    counted(tqr, "rmsnorm_rope_bwd_plain", lambda *a: "K7")
    counted(tfa, "flash_attention_plain", lambda q, k, v: "K3" if k.shape[2] == 16 else "K1")
    counted(tfa, "flash_attention_bwd_plain", lambda *a: "K4")
    tx = tcommon.make_optimizer(learning_rate=LR)
    model, state = _port(setup, tx)
    state, _ = tprfl.make_refl_step(model, tx)(state, _batch(setup))
    tprfl.make_sft_step(model, tx, tfm.train_schedule(1000))(
        state, _batch(setup), generator=torch.Generator().manual_seed(0))
    want = smoke.expected_train_launches(2, 2, MID, "attn", lora=True)
    assert counts == want
    assert want["K9"] == smoke.expected_train_launches(2, 2, MID, "attn")["K9"] - 2
