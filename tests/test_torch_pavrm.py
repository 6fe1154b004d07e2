"""The port's PAVRM slice against the JAX package, on the CPU: the reward
model's train and eval steps, the heads' own learning rate, the dataset's
reward modes, the safetensors reader and writer, the LRM artifact handoff
in both directions, the PRFL trainer's LRM loading, EMA and resume.

Both packages get the same seeded weights (utils/checkpoint.seeded_jax_tree
for the tower, the JAX initialisers' heads), the same numpy batches and the
same random draws: the JAX step draws from its key, the test recomputes
those draws and hands them to the port. The DiT runs at fp32 compute
(``tiny_test`` at head_dim 128); the port's ops run their plain versions.
"""

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.data import dataset as jds
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import ema as jema
from hyvideo_prfl_tpu.training import pavrm as jpavrm
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_torch.configs import AttrDict, config_from_dict
from hyvideo_prfl_torch.data import dataset as tds
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import ema as tema
from hyvideo_prfl_torch.training import pavrm as tpavrm
from hyvideo_prfl_torch.utils import checkpoint as tck
from hyvideo_prfl_torch.utils import safetensors_io as tst

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 3, 8, 8, 16)  # batch 2, 48 tokens
TASKS = {"t2v": "t2v-1.3b", "i2v": "i2v-14b-480p", "flf2v": "flf2v-14b-720p"}
LR, LR_MLP = 1e-4, 1e-3


def _text_len(kind):
    # the image context splits off at len - 512: i2v needs the real text length
    return 16 if kind == "t2v" else 512


def _frames(kind):
    return 2 if kind == "flf2v" else 1


def _tiny(kind):
    return dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2, model_type=kind,
                in_dim=16 if kind == "t2v" else 36)


def _tcfg(kind, **kw):
    return tdit.tiny_test(**_tiny(kind), compute_dtype=torch.float32, remat_policy="attn", **kw)


def _jcfg(kind):
    # remat changes no value, and compiles slower on the CPU
    return jdit.tiny_test(**_tiny(kind), compute_dtype=jnp.float32, remat=False)


def _pc_kw(kind, loss, timesteps=(400, 700, 100)):
    return dict(loss=loss, feature_layer=(2,), trainable_blocks=(0, 1), timesteps=timesteps,
                task=TASKS[kind])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _Setup:
    """One seeded reward model in both packages."""

    def __init__(self, kind, loss, seed=0, timesteps=(400, 700, 100)):
        self.kind = kind
        self.tcfg = _tcfg(kind)
        self.jpc = jpavrm.PavrmConfig(**_pc_kw(kind, loss, timesteps))
        self.tpc = tpavrm.PavrmConfig(**_pc_kw(kind, loss, timesteps))
        self.jmodel = jpavrm.PavrmModel(_jcfg(kind), self.jpc)
        self.tree = tck.seeded_jax_tree(self.tcfg, seed)
        qp, mp = self.jmodel.init_head_params(jax.random.PRNGKey(seed + 3))
        self.q, self.m = _np(qp), _np(mp)
        p = self.tree["params"]
        self.jtrain = {"blocks": p["blocks"], "q_attn": self.q["params"],
                       "mlp": self.m["params"]}
        self.jfrozen = {"params": {k: v for k, v in p.items() if k not in ("blocks", "head")}}

    def port(self, param_dtype=torch.float32):
        model = tpavrm.PavrmModel(self.tcfg, self.tpc, param_dtype=param_dtype)
        model.load_state_dict(tck.lrm_from_jax(self.tree, self.q, self.m, model.dit_cfg))
        return model.freeze_embeddings()

    def port_state(self, trainable):
        """A JAX trainable tree -> {port name: tensor}."""
        tree = {"params": {**self.jfrozen["params"], "blocks": _np(trainable["blocks"])}}
        tower = tck.from_jax_params(tree, self.tcfg, with_head=False)
        out = {f"dit.{k}": v for k, v in tower.items() if k.startswith("blocks.")}
        out.update(tck.reward_heads_from_jax(_np(trainable["q_attn"]),
                                             _np(trainable["mlp"])))
        return out

    def batch(self, seed=1, labels=(1.0, 0.0)):
        rng = np.random.RandomState(seed)
        b = SHAPE[0]
        out = {"latents": rng.randn(*SHAPE).astype(np.float32),
               "text": rng.randn(b, _text_len(self.kind), 64).astype(np.float32)}
        if self.jpc.loss == "ce":
            out["labels"] = np.asarray(labels, np.float32)
        else:
            out["latents_lose"] = rng.randn(*SHAPE).astype(np.float32)
        if self.kind != "t2v":
            out["cond"] = rng.randn(*SHAPE).astype(np.float32)
            if self.jpc.loss == "bt":
                out["cond_lose"] = rng.randn(*SHAPE).astype(np.float32)
            out["clip_fea"] = rng.randn(b, _frames(self.kind) * 257, 1280).astype(np.float32)
        return out

    def jax_step(self, tx, state, batch, key):
        """The JAX step and the draws it made: (state, metrics, t, noise)."""
        sched = jfm.train_schedule(1000)
        if getattr(self, "_tx", None) is not tx:  # one compile per optimizer
            self._tx, self._step = tx, jax.jit(jpavrm.make_train_step(self.jmodel, tx, sched))
        new, m = self._step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            self.jfrozen)
        k_t, k_n = jax.random.split(key)
        t, _ = jpavrm.select_timestep(k_t, self.jpc, sched, state.step, SHAPE[0])
        noise = jax.random.normal(k_n, SHAPE, jnp.float32)
        return new, m, torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(noise))


class _Identity:
    """p += g: the step's raw gradients land in the parameters."""

    def init(self, params, names=None):
        return {}

    def update(self, params, grads, opt_state, step):
        for p, g in zip(params, grads):
            p.add_(g)


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _params(state):
    return {n: p.detach().clone() for n, p in zip(state.names, state.params)}


# -- the train step ------------------------------------------------------------

STEP_CASES = [("t2v", "ce", (400, 700, 100)), ("t2v", "bt", None), ("i2v", "ce", None),
              ("i2v", "bt", (400, 700, 100)), ("flf2v", "ce", (600,))]


@pytest.mark.parametrize("k", [1, 2])
def test_head_learning_rate_optimizer_matches_jax(k):
    rng = np.random.RandomState(7)
    shapes = {"blocks": {"w": (6, 5), "b": (5,)}, "q_attn": {"wq": (4, 4)},
              "mlp": {"Dense_0": {"kernel": (3, 2)}}}
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(learning_rate=3e-3, learning_rate_mlp=2e-2, lr_warmup_steps=2,
              lr_scheduler="linear", max_train_steps=8, max_grad_norm=0.5,
              gradient_accumulation_steps=k)
    jtx, ttx = jcommon.make_optimizer(**kw), tcommon.make_optimizer(**kw)
    jstate = jcommon.init_train_state(jax.tree.map(jnp.asarray, params), jtx)
    names = ["blocks.w", "blocks.b", "q_attn.wq", "mlp.Dense_0.kernel"]
    leaves = [params["blocks"]["w"], params["blocks"]["b"], params["q_attn"]["wq"],
              params["mlp"]["Dense_0"]["kernel"]]
    tparams = [torch.from_numpy(a.copy()) for a in leaves]
    opt = ttx.init(tparams, names)
    assert opt["head"] == [False, False, True, True]
    for step in range(6):
        grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
        jstate, _ = jcommon.apply_grads(jstate, jtx, jax.tree.map(jnp.asarray, grads))
        tg = [grads["blocks"]["w"], grads["blocks"]["b"], grads["q_attn"]["wq"],
              grads["mlp"]["Dense_0"]["kernel"]]
        ttx.update(tparams, [torch.from_numpy(g.copy()) for g in tg], opt, step)
    jp = jstate.params
    for got, want in zip(tparams, [jp["blocks"]["w"], jp["blocks"]["b"], jp["q_attn"]["wq"],
                                   jp["mlp"]["Dense_0"]["kernel"]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_select_timestep_cycles_as_jax():
    sched_j, sched_t = jfm.train_schedule(1000), tfm.train_schedule(1000)
    for ts in ((400, 500, 600, 700), (999, 0, 250)):
        jpc = jpavrm.PavrmConfig(timesteps=ts)
        tpc = tpavrm.PavrmConfig(timesteps=ts)
        for step in range(9):
            jt, js = jpavrm.select_timestep(jax.random.PRNGKey(0), jpc, sched_j,
                                            jnp.asarray(step), 3)
            tt, tsig = tpavrm.select_timestep(tpc, sched_t, step, 3)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            # the port's sigma table is numpy's linspace rounded once to
            # fp32, within one fp32 ulp of 1.0 of jnp.linspace's fp32 table
            np.testing.assert_allclose(tsig.numpy(), np.asarray(js), rtol=0, atol=1.2e-7)
    # no list: a draw from the schedule, the same index rule as JAX's
    tpc = tpavrm.PavrmConfig(timesteps=None)
    t, sigma = tpavrm.select_timestep(tpc, sched_t, 0, 4, torch.Generator().manual_seed(1))
    idx = [int(np.argmin(np.abs(sched_t.timesteps.numpy() - v))) for v in t.numpy()]
    np.testing.assert_array_equal(sigma.numpy(), sched_t.sigmas.numpy()[idx])


# -- the eval step, its metrics and the bucketed eval ---------------------------


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
def test_eval_step_matches_jax(kind):
    s = _Setup(kind, "ce")
    batch = s.batch(seed=5)
    jeval = jax.jit(jpavrm.make_eval_step(s.jmodel), static_argnums=(4,))
    teval = tpavrm.make_eval_step(s.port())
    for t_value, seed in ((300.0, 42), (900.0, 42)):  # the seed is static: one compile
        want = np.asarray(jeval(s.jtrain, s.jfrozen, {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.float32(t_value), seed))
        noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), SHAPE)))
        got = teval(_tbatch(batch), t_value, seed, noise=noise).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the port's own noise: seeded, so two calls agree
    a = teval(_tbatch(batch), 500.0, 3)
    assert torch.equal(a, teval(_tbatch(batch), 500.0, 3))


def test_classification_metrics_match_jax():
    rng = np.random.RandomState(3)
    cases = [(rng.rand(50), rng.randint(0, 2, 50)), (np.zeros(0), np.zeros(0)),
             (np.full(6, 0.2), np.zeros(6)), (np.full(6, 0.9), np.ones(6))]
    for probs, labels in cases:
        for thr in (0.5, 0.3):
            assert (tpavrm.classification_metrics(probs, labels, thr)
                    == jpavrm.classification_metrics(probs, labels, thr))


def test_batched_eval_matches_jax():
    sys.path.insert(0, REPO)
    from scripts._common import batched_eval as jbatched

    rng = np.random.RandomState(4)
    samples = [{"latents": rng.randn(*shape).astype(np.float32), "prompt": "p",
                "text": rng.randn(4, 8).astype(np.float32), "labels": np.float32(i % 2)}
               for i, shape in enumerate([(2, 4, 4, 16)] * 5 + [(3, 4, 4, 16)] * 2)]

    def score(latents, text, t):  # a per-sample function, one rounding in both
        return latents[:, 0, 0, 0, 0] * t + text[:, 0, 0]

    def jeval(trainable, frozen, batch, t, seed):
        return score(batch["latents"], batch["text"], t) + seed

    def teval(batch, t, seed):
        return score(batch["latents"], batch["text"], t) + seed

    want = jbatched(jeval, None, None, samples, [100, 800], 7, batch_size=2)
    got = tpavrm.batched_eval(teval, samples, [100, 800], 7, "cpu", batch_size=2)
    assert got.keys() == want.keys()
    for t in got:
        np.testing.assert_array_equal(got[t][0], want[t][0])
        assert got[t][1] == want[t][1]


# -- the dataset's reward modes ------------------------------------------------


def _write_cache(root, n=4, i2v=False, lose=False):
    rng = np.random.RandomState(23 + lose)
    null = root / "null" / "wanx"
    null.mkdir(parents=True, exist_ok=True)
    for name, k in (("null", 1), ("uncond", 7), ("uncond_flf2v", 9)):
        np.save(null / f"{name}.npy", rng.randn(1, k, 64).astype(np.float32))
    labels = ["good", "poor", 1, 0, True, "Good "]
    lines = []
    for i in range(n):
        stem = root / f"{'lose' if lose else 'win'}{i}"
        meta = {"vae_latent_path": f"{stem}_lat.npy", "textshort_path": f"{stem}_s.npy",
                "textlong_path": f"{stem}_l.npy", "short_caption": f"s{i}",
                "long_caption": f"l{i}"}
        if i == 2:  # no lrm.task label: the first quality key present
            meta.update(blur_quality="poor", physics_quality="good")
        else:
            meta["motion_quality"] = labels[i % len(labels)]
        np.save(meta["vae_latent_path"], rng.randn(1, 16, 3, 4, 6).astype(np.float32))
        np.save(meta["textshort_path"], rng.randn(1, 5, 64).astype(np.float32))
        np.save(meta["textlong_path"], rng.randn(1, 9, 64).astype(np.float32))
        if i2v:
            meta["f1_black_path"] = f"{stem}_c.npy"
            meta["imgclip_path"] = f"{stem}_clip.npy"
            np.save(meta["f1_black_path"], rng.randn(1, 16, 3, 4, 6).astype(np.float32))
            np.save(meta["imgclip_path"], rng.randn(1, 257, 1280).astype(np.float32))
        path = root / f"{stem.name}.json"
        path.write_text(json.dumps(meta))
        lines.append(str(path))
    lst = root / f"{'lose' if lose else 'win'}.list"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst), str(root / "null")


@pytest.mark.parametrize("dataset_type,i2v", [("lrm_ce", False), ("lrm_ce", True),
                                              ("lrm_bt_online", False),
                                              ("lrm_bt_online", True)])
def test_dataset_reward_modes_match_jax(tmp_path, dataset_type, i2v):
    win, null = _write_cache(tmp_path, i2v=i2v)
    lose, _ = _write_cache(tmp_path, n=3, i2v=i2v, lose=True)
    kw = dict(meta_file_list=[win], meta_file_lose_list=[lose], uncond_prob=(0.5, 0.0),
              text_len=16, null_dir=null, is_i2v=i2v, seed=11, label_key="motion_quality")
    jset = jds.LatentCacheDataset(dataset_type=dataset_type, **kw)
    tset = tds.LatentCacheDataset(dataset_type=dataset_type, **kw)
    seen_lose = set()
    for idx in (0, 1, 2, 3, 1, 0, 2, 3):
        want, got = jset[idx], tset[idx]
        assert got.keys() == want.keys()
        for key in got:
            if isinstance(got[key], str):
                assert got[key] == want[key], key
            else:
                assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if dataset_type == "lrm_bt_online":
            assert ("cond_lose" in got) == i2v
            seen_lose.add(got["latents_lose"].tobytes())
        else:
            assert got["labels"] == tds.coerce_label(
                ["good", "poor", "poor", 0][idx]) or idx == 2
    if dataset_type == "lrm_bt_online":
        assert len(seen_lose) > 1  # the lose draws vary, in the same order in both
    for v in ("good", "GOOD ", "poor", 1, 0, None, "x"):
        assert tds.coerce_label(v) == jds.coerce_label(v)
    assert tds.QUALITY_KEYS == jds.QUALITY_KEYS


# -- safetensors -----------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
          torch.int32, torch.int64]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *s: (torch.randn(*s, generator=g) * 3).to(dtype)  # noqa: E731
    else:
        make = lambda *s: torch.randint(-100, 100, s, generator=g).to(dtype)  # noqa: E731
    return {"a.weight": make(7, 5), "b": make(3), "scalar": make(1).reshape(()),
            "empty": make(0, 4), "c.bias": make(2, 3, 4)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_safetensors_port_files_read_by_the_package_and_jax(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    ts = _tensors(dtype)
    tst.write_file(ts, str(tmp_path / "port.safetensors"))
    got = load_file(str(tmp_path / "port.safetensors"))
    assert got.keys() == ts.keys()
    for k in ts:
        assert got[k].dtype == dtype and torch.equal(got[k], ts[k]), k
    if dtype != torch.bfloat16:  # numpy has no bf16: the JAX reader's framework
        jgot = jck.load_safetensors_dir(str(tmp_path))
        for k in ts:
            np.testing.assert_array_equal(jgot[k], ts[k].numpy(), err_msg=k)
            assert jgot[k].dtype == ts[k].numpy().dtype
    # and the package's file read by the port
    save_file(ts, str(tmp_path / "pkg.safetensors"))
    back = tst.read_file(str(tmp_path / "pkg.safetensors"))
    for k in ts:
        assert back[k].dtype == dtype and back[k].shape == ts[k].shape
        assert torch.equal(back[k], ts[k]), k


def test_safetensors_shards_as_the_jax_writer(tmp_path):
    rng = np.random.RandomState(0)
    state = {f"blocks.{i}.w": rng.randn(8, 9 + i).astype(np.float32) for i in range(5)}
    jck.save_safetensors_sharded(state, str(tmp_path / "jax"), max_shard_bytes=700)
    tst.save_dir({k: torch.from_numpy(v) for k, v in state.items()}, str(tmp_path / "port"),
                 max_shard_bytes=700)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 5  # 4 + index
    index = "diffusion_pytorch_model.safetensors.index.json"
    assert (json.loads((tmp_path / "jax" / index).read_text())
            == json.loads((tmp_path / "port" / index).read_text()))
    for src in ("jax", "port"):
        got = tst.load_dir(str(tmp_path / src))
        jgot = jck.load_safetensors_dir(str(tmp_path / src))
        for k, v in state.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
            np.testing.assert_array_equal(jgot[k], v)


@pytest.mark.parametrize("kind", ["t2v", "i2v", "flf2v"])
def test_reference_checkpoints_round_trip_with_jax(tmp_path, kind):
    cfg = _tcfg(kind)
    tree = tck.seeded_jax_tree(cfg, 5)
    want = tck.from_jax_params(tree, cfg)
    # the JAX writer, read by the port: the same state, so the same forward
    jck.save_wan_checkpoint(jax.tree.map(jnp.asarray, tree), _jcfg(kind), str(tmp_path), step=3)
    got = tck.load_reference_dir(str(tmp_path / "checkpoint-3"), cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 3, 8, 8, 16).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(1, _text_len(kind), 64).astype(np.float32))
    cond = {}
    if kind != "t2v":
        cond = {"y": torch.from_numpy(rng.randn(1, 3, 8, 8, 20).astype(np.float32)),
                "clip_fea": torch.from_numpy(
                    rng.randn(_frames(kind), 257, 1280).astype(np.float32))}
    outs = []
    for state in (want, got):
        model = tdit.WanModel(cfg, param_dtype=torch.float32)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model(x, torch.tensor([700.0]), ctx, **cond))
    assert torch.equal(outs[0], outs[1])
    # the port's writer, read by the JAX package: the same tree, bit for bit
    path = tck.save_reference_dir(want, cfg, str(tmp_path / "port"), step=4)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    assert (meta["num_layers"], meta["dim"], meta["in_dim"], meta["model_type"]) == (
        cfg.num_layers, cfg.dim, cfg.in_dim, kind)
    back = jck.load_wan_checkpoint(path, _jcfg(kind))
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(_np(back))[0])
    for p, v in flat_w:
        if any(getattr(k, "key", None) == "emb_pos" for k in p) or p in flat_b:
            np.testing.assert_array_equal(flat_b[p], v, err_msg=str(p))


# -- the LRM handoff ---------------------------------------------------------------


def _score_inputs(kind, seed=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPE).astype(np.float32)
    ctx = rng.randn(SHAPE[0], _text_len(kind), 64).astype(np.float32)
    t = np.array([700.0, 200.0], np.float32)
    cond = {}
    if kind != "t2v":
        cond = {"y": rng.randn(*SHAPE[:4], 20).astype(np.float32),
                "clip_fea": rng.randn(SHAPE[0] * _frames(kind), 257, 1280).astype(np.float32)}
    return x, t, ctx, cond


def _jax_score(s, dit_params, qp, mp, kind):
    x, t, ctx, cond = _score_inputs(kind)
    return np.asarray(jax.jit(s.jmodel.score)(
        dit_params, qp, mp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        **{k: jnp.asarray(v) for k, v in cond.items()}))


def _port_score(model, kind):
    x, t, ctx, cond = _score_inputs(kind)
    with torch.no_grad():
        return model.score(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                           **{k: torch.from_numpy(v) for k, v in cond.items()}).numpy()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _lrm_config(root, kind, step):
    return config_from_dict({
        "task": TASKS[kind],
        "model": {"lrm_transformer_path": os.path.join(root, "transformer", f"checkpoint-{step}"),
                  "lrm_mlp_path": os.path.join(root, "mlp", f"mlp_step_{step}.ckpt"),
                  "lrm_query_attention_path": os.path.join(root, "mlp",
                                                           f"query_attention_step_{step}.ckpt")},
        "lrm": {"feature_layer": [2], "trainable_blocks": [0, 1]},
    })


def _load_lrm(model, cfg):
    m = cfg.model
    model.load_reference(m.lrm_transformer_path, m.lrm_mlp_path, m.lrm_query_attention_path)


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
def test_jax_lrm_export_read_by_the_port(tmp_path, kind):
    sys.path.insert(0, REPO)
    from scripts.train_pavrm import export_lrm_artifacts

    s = _Setup(kind, "ce")
    export_lrm_artifacts(s.jtrain, s.jfrozen, s.jmodel, str(tmp_path), 7)
    cfg = _lrm_config(str(tmp_path), kind, 7)
    model = tpavrm.PavrmModel(s.tcfg, s.tpc, param_dtype=torch.float32)
    _load_lrm(model, cfg)
    # the reloaded tower and heads score as the in-memory ones, and as JAX
    got = _port_score(model, kind)
    np.testing.assert_allclose(got, _port_score(s.port(), kind), rtol=1e-6, atol=1e-7)
    want = _jax_score(s, jcommon.merge_tree({"params": {"blocks": s.jtrain["blocks"]}},
                                            s.jfrozen), s.q, s.m, kind)
    # fp32 through two frameworks: their sums run in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
def test_port_lrm_export_read_by_jax(tmp_path, kind):
    s = _Setup(kind, "ce")
    model = s.port()
    _load_script("train_pavrm_torch").export_lrm_artifacts(model, str(tmp_path), 5)
    tdir = tmp_path / "transformer" / "checkpoint-5"
    meta = json.loads((tdir / "config.json").read_text())
    assert meta["num_layers"] == 2 and meta["model_type"] == kind
    jcfg = jdit.tiny_test(**{**_tiny(kind), "num_layers": 2}, compute_dtype=jnp.float32)
    dit = jck.load_wan_checkpoint(str(tdir), jcfg)
    assert "head" not in dit["params"]
    qp = jck.load_reward_head(str(tmp_path / "mlp" / "query_attention_step_5.ckpt"), "qattn")
    mp = jck.load_reward_head(str(tmp_path / "mlp" / "mlp_step_5.ckpt"), "mlp")
    # a q/k row in the wrong rope pair order would still load: scores tell
    got = _jax_score(s, dit, qp, mp, kind)
    want = _jax_score(s, jcommon.merge_tree({"params": {"blocks": s.jtrain["blocks"]}},
                                            s.jfrozen), s.q, s.m, kind)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # and the port reads its own export back to the same scores
    back = tpavrm.PavrmModel(s.tcfg, s.tpc)
    _load_lrm(back, _lrm_config(str(tmp_path), kind, 5))
    np.testing.assert_allclose(_port_score(back, kind), _port_score(model, kind),
                               rtol=1e-6, atol=1e-7)


# -- EMA -------------------------------------------------------------------------


def test_ema_matches_jax():
    rng = np.random.RandomState(9)
    params = [rng.randn(70, 33).astype(np.float32) for _ in range(70)]  # two foreach chunks
    ema_j = jema.ema_init([jnp.asarray(p) for p in params])
    ema_t = tema.ema_init([torch.from_numpy(p) for p in params])
    for step in range(4):
        params = [p + 0.1 * rng.randn(*p.shape).astype(np.float32) for p in params]
        ema_j = jema.ema_update(ema_j, [jnp.asarray(p) for p in params], decay=0.9)
        tema.ema_update(ema_t, [torch.from_numpy(p) for p in params], decay=0.9)
    for a, b in zip(ema_j, ema_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# -- the trainers: resume, LRM handoff, refusals ----------------------------------


def _resume_cache(root, n=2):
    """A labelled t2v cache whose samples each hold a short and a long
    caption, so every sample draws from the dataset's random.Random; two
    samples, so the 2 + 1 steps of the resume test cross an epoch."""
    rng = np.random.RandomState(31)
    null = root / "null" / "wanx"
    null.mkdir(parents=True)
    for name in ("null", "uncond"):
        np.save(null / f"{name}.npy", rng.randn(1, 3, 64).astype(np.float32))
    lines = []
    for i in range(n):
        meta = {"vae_latent_path": str(root / f"lat{i}.npy"),
                "textshort_path": str(root / f"short{i}.npy"), "short_caption": f"s{i}",
                "textlong_path": str(root / f"long{i}.npy"), "long_caption": f"l{i}",
                "motion_quality": ["good", "poor"][i % 2]}
        np.save(meta["vae_latent_path"], rng.randn(1, 16, 3, 8, 8).astype(np.float32))
        np.save(meta["textshort_path"], rng.randn(1, 6, 64).astype(np.float32))
        np.save(meta["textlong_path"], rng.randn(1, 9, 64).astype(np.float32))
        (root / f"m{i}.json").write_text(json.dumps(meta))
        lines.append(str(root / f"m{i}.json"))
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return str(root / "list.txt"), str(root / "null")


def _cli_config(name, root, out, **sections):
    from hyvideo_prfl_torch.configs import load_config

    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    meta, null = _resume_cache(root) if not (root / "list.txt").exists() else (
        str(root / "list.txt"), str(root / "null"))
    cfg.dataset.meta_file_list = [meta]
    cfg.dataset.val_meta_file_list = []
    cfg.dataset.null_dir = null
    cfg.save.output_dir = str(out)
    cfg.train.save_interval = 2
    cfg.train.save_optimizer_state = True
    for key, value in sections.items():
        section, leaf = key.split("__")
        cfg[section][leaf] = AttrDict.wrap(value)
    return cfg


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.params, b.params))


def test_pavrm_cli_refuses_what_is_not_ported(tmp_path):
    # an unknown FSDP strategy raises; dataset.sp_size > 1 (sp clamps to
    # one process's 1) and optimizer-state offload build and step
    # (tests/test_torch_parallel_train.py runs them on gloo)
    cli = _load_script("train_pavrm_torch")
    with pytest.raises(ValueError, match="zero3"):
        cli.build_trainer(_cli_config("smoke_pavrm", tmp_path, tmp_path / "o", model__fsdp={
            "fsdp_sharding_startegy": "zero3"}), "cpu")
    trainer = cli.build_trainer(_cli_config("smoke_pavrm", tmp_path, tmp_path / "o",
                                            dataset__sp_size=2, train__offload_opt_state=True),
                                "cpu")
    assert trainer.mesh.sp == 1
    (m,) = cli.run(trainer, 1)
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0


def test_pavrm_handoff_through_the_clis(tmp_path):
    # PAVRM trains and exports; the eval CLI scores the export as the
    # trained model does; the PRFL trainer loads it and trains
    pav = _load_script("train_pavrm_torch")
    cfg = _cli_config("smoke_pavrm", tmp_path, tmp_path / "o")
    cfg.dataset.val_meta_file_list = list(cfg.dataset.meta_file_list)
    trainer = pav.build_trainer(cfg, "cpu")
    hist = pav.run(trainer, 2)
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    out = tmp_path / "o" / "smoke_pavrm"
    # the TensorBoard tags of the JAX trainer: its step metrics and step_time
    # under train/, the classification metrics under val_t<t>/ (train_pavrm.py)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (events,) = glob.glob(str(out / "logs" / "events.out.tfevents.*"))
    acc = EventAccumulator(events)
    acc.Reload()
    val_keys = jpavrm.classification_metrics(np.array([0.2, 0.8]), np.array([0.0, 1.0]))
    assert set(acc.Tags()["scalars"]) == (
        {f"train/{k}" for k in ("loss", "grad_norm", "acc", "step_time")}
        | {f"val_t{t}/{k}" for t in cfg.eval.timestep for k in val_keys})
    lrm = {"model__lrm_transformer_path": str(out / "transformer" / "checkpoint-2"),
           "model__lrm_mlp_path": str(out / "mlp" / "mlp_step_2.ckpt"),
           "model__lrm_query_attention_path": str(out / "mlp" / "query_attention_step_2.ckpt")}
    infer = _load_script("inference_pavrm_torch")
    ecfg = _cli_config("smoke_pavrm", tmp_path, tmp_path / "e", **lrm)
    # the CLI's own main on a --config_path, written as chip_smoke's 12d
    # writes it and read back by the port's YAML reader
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    (tmp_path / "eval.yaml").write_text(smoke.yaml_text(ecfg) + "\n")
    res = infer.main(["--config_path", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    want = tpavrm.evaluate(trainer.eval_fn, trainer.val_dataset, ecfg.eval.timestep,
                           int(ecfg.eval.seed), "cpu")
    for key, val in want.items():
        assert res[key]["mean_reward"] == pytest.approx(val["mean_reward"], rel=1e-6)
        assert res[key]["accuracy"] == val["accuracy"]
    loaded = infer.load_lrm(ecfg, torch.device("cpu"))
    x, t, ctx, _ = _score_inputs("t2v")
    x, t, ctx = (torch.from_numpy(a) for a in (x, t, ctx))
    with torch.no_grad():
        np.testing.assert_allclose(loaded.score(x, t, ctx).numpy(),
                                   trainer.model.score(x, t, ctx).numpy(), rtol=1e-6, atol=1e-7)
    prfl = _load_script("train_prfl_torch")
    pcfg = _cli_config("smoke_prfl", tmp_path, tmp_path / "p", **lrm)
    ptrainer = prfl.build_trainer(pcfg, "cpu")
    assert torch.equal(ptrainer.model.lrm.mlp.Dense_1.weight, trainer.model.mlp.Dense_1.weight)
    (m,) = prfl.run(ptrainer, 1)
    assert np.isfinite(m["reward"]) and m["grad_norm"] > 0


def _count_launches(monkeypatch):
    """Count the plain-version calls by the kernel the card would launch."""
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
            lambda q, k, v: "K3" if k.shape[2] in (16, 512, 257, 514) else "K1")
    counted(tfa, "flash_attention_bwd_plain", lambda *a: "K4")
    return counts


@pytest.mark.parametrize("kind,loss", [("t2v", "ce"), ("i2v", "bt")])
def test_pavrm_launch_derivation(monkeypatch, kind, loss):
    # chip_smoke.py holds phase 12's launch counts to this derivation
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counts = _count_launches(monkeypatch)
    s = _Setup(kind, loss)
    model = s.port()
    tx = tcommon.make_optimizer(learning_rate=LR)
    state = tcommon.init_train_state(model, tx)
    tpavrm.make_train_step(model, tx, tfm.train_schedule(1000))(state, _tbatch(s.batch()))
    assert counts == smoke.expected_pavrm_launches(2, loss, i2v=kind != "t2v")


@pytest.mark.parametrize("num_queries", [1, 3])
def test_query_attention_scores_alike_with_and_without_grad(num_queries):
    # The trained tower's pool (weights that require grad) and the same
    # weights loaded for scoring must give the same bits: chip_smoke's 12d
    # holds the exported LRM to the trained tower's scores exactly.
    from hyvideo_prfl_torch.models import reward as trw

    g = torch.Generator().manual_seed(num_queries)
    pool = trw.QueryAttention(256, num_queries, 8, "query").init_params(g)
    with torch.no_grad():
        for p in pool.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    for _ in range(5):
        x = torch.randn(2, 300, 256, generator=g)
        with torch.no_grad():
            trained = pool.requires_grad_(True)(x)
            loaded = pool.requires_grad_(False)(x)
        assert torch.equal(trained, loaded)


def test_port_imports_no_jax_nor_safetensors(tmp_path):
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|hyvideo_prfl_tpu|safetensors|yaml)\b", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "hyvideo_prfl_torch"))
             for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, "scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
              if f.endswith("_torch.py")] + [os.path.join(REPO, "chip_smoke.py")]
    # the card's machine has none of these: the port imports them only
    # inside the functions that need them
    top_level = re.compile(r"^(import|from)\s+(PIL|cv2|imageio|transformers)\b", re.M)
    # the preprocess path reads video through OpenCV alone: no imageio anywhere
    no_imageio = re.compile(r"^\s*(import|from)\s+imageio\b", re.M)
    preprocess = {os.path.join(REPO, *p) for p in (
        ("hyvideo_prfl_torch", "models", "xlm_roberta.py"),
        ("hyvideo_prfl_torch", "data", "native_loader.py"),
        ("hyvideo_prfl_torch", "data", "utils.py"),
        ("scripts", "gen_latents_torch.py"), ("scripts", "encode_captions_torch.py"))}
    assert preprocess <= set(files)
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not pattern.search(text) and not top_level.search(text), path
        assert path not in preprocess or not no_imageio.search(text), path
    code = (
        "import sys, importlib.util, torch\n"
        "for m in ('jax', 'flax', 'chex', 'optax', 'yaml', 'safetensors', 'hyvideo_prfl_tpu',\n"
        "          'PIL', 'cv2', 'imageio', 'transformers'):\n"
        "    sys.modules[m] = None\n"
        "from hyvideo_prfl_torch.models import clip, t5, vae, wan_dit\n"
        "from hyvideo_prfl_torch.utils import encoders, tokenizers, video_io\n"
        "from hyvideo_prfl_torch.training import ema, pavrm\n"
        "from hyvideo_prfl_torch.utils import checkpoint as ck\n"
        "from hyvideo_prfl_torch.configs import load_config\n"
        "pcfg = load_config('configs/train_pavrm_t2v_480.yaml')\n"
        "assert pcfg.lrm.timestep == [400, 500, 600, 700]\n"
        "assert pcfg.optimizer.learning_rate == 1e-5\n"
        "from hyvideo_prfl_torch.models import xlm_roberta\n"
        "from hyvideo_prfl_torch.data import dataset, loader, native_loader, utils\n"
        "from hyvideo_prfl_torch.parallel import sharding\n"
        "from hyvideo_prfl_torch.ops import attention\n"
        "from hyvideo_prfl_torch.training import cli, common, prfl\n"
        "from hyvideo_prfl_torch.ops import ring_attention\n"
        "from hyvideo_prfl_torch.parallel import teacher_student\n"
        "from hyvideo_prfl_torch.training import distill, lora\n"
        "assert sharding.build_mesh(4, 'cpu').world == 1 and attention.ulysses_chunks(40, 4) == 1\n"
        "assert sharding.build_mesh(1, 'cpu', ring_size=2).ring == 1\n"
        "for name in ('train_pavrm_torch', 'inference_pavrm_torch', 'train_prfl_torch',\n"
        "             'inference_torch', 'decode_latents_torch', 'encode_captions_torch',\n"
        "             'gen_latents_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[name] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        "cfg = wan_dit.tiny_test()\n"
        "state = ck.from_jax_params(ck.seeded_jax_tree(cfg, 0), cfg)\n"
        f"path = ck.save_reference_dir(state, cfg, {str(tmp_path)!r}, step=1)\n"
        "back = ck.load_reference_dir(path, cfg)\n"
        "assert all(torch.equal(back[k], state[k]) for k in state)\n"
        "frames = torch.zeros(2, 4, 6, 3)\n"
        f"out = video_io.cache_video(frames, {str(tmp_path / 'v.mp4')!r})\n"
        "assert out.endswith('v_frames.npy')\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
