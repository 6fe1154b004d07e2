"""The port's i2v and flf2v conditioning against the JAX package, on the CPU.

Both packages get one seeded JAX-layout tree (utils/checkpoint.seeded_jax_tree,
whose i2v/flf2v trees carry the image branch: the CLIP projector
``img_emb`` with a non-zero flf2v ``emb_pos``, and each block's
k_img/v_img/norm_k_img) and the same seeded numpy inputs. The models are
``tiny_test`` at head_dim 128 with the 36-channel input, the released
CLIP feature shape [257, 1280] and the 512-token text context (the
cross-attention splits the context at ``len - 512``, so a shorter text
cannot run). The JAX side runs its Pallas kernels in interpret mode, as its
own tests do; the port's ops run their plain versions (the Hopper kernels
are held to them on the card by chip_smoke.py).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.configs import dit_config_for_task as jax_config_for_task
from hyvideo_prfl_tpu.data import dataset as jds
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import attention as jattn
from hyvideo_prfl_tpu.ops import flash_attention as jfa
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_tpu.training import common as jcommon
from hyvideo_prfl_tpu.training import prfl as jprfl
from hyvideo_prfl_tpu.training.pavrm import PavrmConfig as JPavrmConfig
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_torch.configs import dit_config_for_task
from hyvideo_prfl_torch.data import dataset as tds
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.ops import qknorm_rope as tqr
from hyvideo_prfl_torch.ops import stream as tstream
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.training import common as tcommon
from hyvideo_prfl_torch.training import prfl as tprfl
from hyvideo_prfl_torch.training.pavrm import PavrmConfig
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("i2v", "flf2v")
TEXT_LEN = 512
SHAPE = (1, 3, 8, 8, 16)  # 48 tokens
INT8 = dict(quant_dense="int8", quant_attn="int8")


def _tiny(kind, **kw):
    return {**dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2, model_type=kind,
                   in_dim=36), **kw}


def _tcfg(kind, compute_dtype=torch.float32, **kw):
    return tdit.tiny_test(**_tiny(kind, **kw), compute_dtype=compute_dtype)


def _jcfg(kind, compute_dtype=jnp.float32, **kw):
    return jdit.tiny_test(**_tiny(kind, **kw), compute_dtype=compute_dtype)


def _tree(kind, seed):
    return tck.seeded_jax_tree(_tcfg(kind), seed)


def _port(kind, tree, compute_dtype=torch.float32, **kw):
    cfg = _tcfg(kind, compute_dtype, **kw)
    model = tdit.WanModel(cfg, param_dtype=torch.float32)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    return model


def _frames(kind):
    return 2 if kind == "flf2v" else 1


def _inputs(kind, seed, b=2, shape=SHAPE):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, *shape[1:]).astype(np.float32)
    y = rng.randn(b, *shape[1:4], 20).astype(np.float32)
    clip = rng.randn(b * _frames(kind), 257, 1280).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    ctx = rng.randn(b, TEXT_LEN, 64).astype(np.float32)
    return x, y, clip, t, ctx


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the conditioning helpers ------------------------------------------------


@pytest.mark.parametrize("lat_f,last_frame", [(1, False), (6, False), (6, True), (21, True)])
def test_i2v_mask_matches_jax(lat_f, last_frame):
    got = tpipe.i2v_mask(lat_f, 3, 5, last_frame=last_frame).numpy()
    want = np.asarray(jpipe.i2v_mask(lat_f, 3, 5, last_frame=last_frame))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flf2v", [False, True])
def test_i2v_condition_matches_jax(flf2v):
    cond = np.random.RandomState(1).randn(2, 5, 3, 4, 16).astype(np.float32)
    got = tcommon.i2v_condition(torch.from_numpy(cond), flf2v).numpy()
    want = np.asarray(jcommon.i2v_condition(jnp.asarray(cond), flf2v))
    np.testing.assert_array_equal(got, want)
    # not 16 channels, or no cond: passed through
    y = torch.from_numpy(got)
    assert tcommon.i2v_condition(y, flf2v) is y and tcommon.i2v_condition(None) is None
    # the two flf2v masks differ, as in the JAX package: the pipeline's sets
    # only channel 3 of the last latent frame, the trainer's all four
    pipe = tpipe.i2v_mask(5, 3, 4, last_frame=flf2v).numpy()
    train = got[0, ..., :4]
    np.testing.assert_array_equal(pipe[:4], train[:4])
    if flf2v:
        assert pipe[4, 0, 0].tolist() == [0, 0, 0, 1] and train[4, 0, 0].tolist() == [1, 1, 1, 1]
    else:
        np.testing.assert_array_equal(pipe, train)


@pytest.mark.parametrize("kind", ["t2v", *KINDS])
def test_prepare_conditioning_matches_jax(kind):
    rng = np.random.RandomState(2)
    frames = _frames(kind)
    batch = {"cond": rng.randn(2, 4, 3, 5, 16).astype(np.float32),
             "clip_fea": rng.randn(2, frames * 257, 8).astype(np.float32)}
    is_i2v, flf = kind != "t2v", kind == "flf2v"
    y, clip = tcommon.prepare_conditioning({k: torch.from_numpy(v) for k, v in batch.items()},
                                           is_i2v, flf)
    jy, jclip = jcommon.prepare_conditioning({k: jnp.asarray(v) for k, v in batch.items()},
                                             is_i2v, flf)
    if not is_i2v:
        assert y is clip is jy is jclip is None
        return
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(clip.numpy(), np.asarray(jclip))
    assert clip.shape == (2 * frames, 257, 8)
    np.testing.assert_array_equal(tcommon.reshape_clip(torch.from_numpy(batch["clip_fea"])),
                                  np.asarray(jcommon.reshape_clip(jnp.asarray(batch["clip_fea"]))))


# -- configs and weights -----------------------------------------------------


@pytest.mark.parametrize("name", ["i2v_14b", "i2v_1_3b", "flf2v_14b"])
def test_config_presets_match_jax(name):
    a, b = getattr(tdit, name)(), getattr(jdit, name)()
    for f in dataclasses.fields(a):
        if f.name != "compute_dtype":
            assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
    assert tdit.T5_CONTEXT_TOKEN_NUMBER == jdit.T5_CONTEXT_TOKEN_NUMBER
    assert (tdit.FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER
            == jdit.FIRST_LAST_FRAME_CONTEXT_TOKEN_NUMBER)


@pytest.mark.parametrize("task", ["t2v-1.3B", "t2v-14b", "t2i-14B", "i2v-14B", "i2v-14b-480p",
                                  "i2v-14b-720p", "i2v-1.3b", "flf2v-14B"])
def test_task_names_map_as_jax(task):
    a, b = dit_config_for_task(task), jax_config_for_task(task)
    for f in dataclasses.fields(a):
        if f.name != "compute_dtype":
            assert getattr(a, f.name) == getattr(b, f.name), (task, f.name)


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_tree_has_the_jax_init_structure(kind):
    shapes = jax.eval_shape(lambda: jdit.init_params(_jcfg(kind), jax.random.PRNGKey(0),
                                                     text_len=TEXT_LEN))
    assert (jax.tree.map(lambda a: a.shape, shapes)
            == jax.tree.map(lambda a: a.shape, _tree(kind, 0)))
    # the image leaves are drawn after every t2v draw: the t2v part of the
    # tree is the t2v tree of the same seed
    t2v = tck.seeded_jax_tree(tdit.tiny_test(**{**_tiny("t2v"), "in_dim": 36}), 0)
    tree = _tree(kind, 0)
    flat_t2v = jax.tree_util.tree_flatten_with_path(t2v)[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, leaf in flat_t2v:
        np.testing.assert_array_equal(flat[path], leaf)


@pytest.mark.parametrize("kind", KINDS)
def test_from_jax_params_equals_from_reference_state(kind):
    tree = _tree(kind, 1)
    cfg = _tcfg(kind)
    a = tck.from_jax_params(tree, cfg)
    b = tck.from_reference_state(jck.flax_to_torch_state(tree, _jcfg(kind)), cfg)
    assert a.keys() == b.keys() == tdit.WanModel(cfg).state_dict().keys()
    assert any(".k_img." in k for k in a) and "img_emb.fc1.weight" in a
    assert ("img_emb.emb_pos" in a) == (kind == "flf2v")
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


class _Recorder(dict):
    """A state dict that remembers which keys were read."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_port_reads_every_released_i2v_key():
    # the released i2v-14B key set, at a tiny width and the released depth:
    # the JAX exporter writes exactly those keys, and the port's reader
    # consumes every one of them
    with open(os.path.join(REPO, "tests", "fixtures", "wan_i2v_14b_state_keys.json")) as f:
        released = set(json.load(f))
    cfg = _tcfg("i2v", num_layers=40)
    state = _Recorder(jck.flax_to_torch_state(tck.seeded_jax_tree(cfg, 2),
                                              _jcfg("i2v", num_layers=40)))
    assert set(state) == released
    out = tck.from_reference_state(state, cfg)
    assert state.read == released
    model = tdit.WanModel(cfg)
    model.load_state_dict(out)  # strict: every tensor of the model, no other


# -- the model -------------------------------------------------------------


def _jax_forward(kind, tree, x, y, clip, t, ctx, dtype=jnp.float32, grid=None):
    return np.asarray(jdit.WanModel(_jcfg(kind, dtype)).apply(
        tree, *_j(x, t, ctx), y=jnp.asarray(y), clip_fea=jnp.asarray(clip), grid=grid))


@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_jax_bf16(kind):
    tree = _tree(kind, 4)
    x, y, clip, t, ctx = _inputs(kind, 4)
    want = _jax_forward(kind, tree, x, y, clip, t, ctx, jnp.bfloat16)
    model = _port(kind, tree, torch.bfloat16).eval()
    with torch.inference_mode():
        got = model(*_t(x)[:1], *_t(t, ctx), y=_t(y)[0], clip_fea=_t(clip)[0]).numpy()
    # the bound of test_wan_model_matches_jax_bf16: a few bf16 ulps of the
    # largest output, 3e-2 of max|out|
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_image_branch_reaches_the_output(kind):
    # another image (clip_fea) or another first frame (y) changes the output
    tree = _tree(kind, 5)
    x, y, clip, t, ctx = _inputs(kind, 5, b=1)
    model = _port(kind, tree).eval()
    with torch.inference_mode():
        base = model(*_t(x, t, ctx), y=_t(y)[0], clip_fea=_t(clip)[0])
        other_clip = model(*_t(x, t, ctx), y=_t(y)[0], clip_fea=_t(clip[::-1].copy())[0]
                           if kind == "flf2v" else _t(clip)[0] * 0.5)
        other_y = model(*_t(x, t, ctx), y=_t(y)[0] * 0.5, clip_fea=_t(clip)[0])
    assert not torch.allclose(base, other_clip) and not torch.allclose(base, other_y)


# flf2v: its gradients reach every leaf of the i2v model and emb_pos too
# -- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_sample_matches_jax(kind):
    tree = _tree(kind, 8)
    rng = np.random.RandomState(9)
    ctx = rng.randn(1, TEXT_LEN, 64).astype(np.float32)
    ctx_null = rng.randn(1, TEXT_LEN, 64).astype(np.float32) * 0.1
    clip = rng.randn(_frames(kind), 257, 1280).astype(np.float32)
    cond = rng.randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(10)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))  # JAX's draw
    jcls, tcls = {"i2v": (jpipe.WanI2V, tpipe.WanI2V),
                  "flf2v": (jpipe.WanFLF2V, tpipe.WanFLF2V)}[kind]
    jgen = jpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=3.0)
    want = np.asarray(jcls(_jcfg(kind), tree).generate(key, *_j(ctx, ctx_null, clip, cond),
                                                       jgen))
    gen = tpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=3.0)
    got = tcls(_port(kind, tree).eval()).generate(
        None, *_t(ctx, ctx_null, clip, cond), gen, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == SHAPE and np.isfinite(got).all()
    assert np.abs(want - noise).max() > 0.1  # the DiT moved the latent
    # fp32 end to end, three CFG steps of a DiT held to 1e-5 per forward:
    # the t2v sampling test's bound
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# -- the int8 model ----------------------------------------------------------


@pytest.fixture
def streaming(monkeypatch):
    """Interpret-mode Pallas and the flash backend on the JAX side, with
    FULL_K_MAX and DEFAULT_BLOCK_K shrunk in both packages so the
    192-token self-attention streams and takes the int8 kernel, as
    tests/test_torch_quant.py does."""
    monkeypatch.setenv("PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "FULL_K_MAX", 128)
    monkeypatch.setattr(jfa, "DEFAULT_BLOCK_K", 128)
    monkeypatch.setattr(tfa, "FULL_K_MAX", 128)
    jattn.set_default_backend("flash")
    yield
    jattn.set_default_backend("auto")


# -- the PRFL steps ----------------------------------------------------------

STEPS, MID, LR = 4, 1, 1e-3
PAV = dict(feature_layer=(2,), trainable_blocks=(0, 1))


def _batch(kind, seed):
    rng = np.random.RandomState(seed)
    return {"latents": rng.randn(*SHAPE).astype(np.float32),
            "text": rng.randn(1, TEXT_LEN, 64).astype(np.float32),
            "cond": rng.randn(*SHAPE).astype(np.float32),
            "clip_fea": rng.randn(1, _frames(kind) * 257, 1280).astype(np.float32)}


def _prfl_cfgs(kind):
    flags = dict(is_i2v=True, is_flf2v=kind == "flf2v")
    return (jprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID, **flags),
            tprfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID, **flags))


def _models(kind, seed):
    policy, lrm_dit = _tree(kind, seed), _tree(kind, seed + 1)
    jpc, tpc = _prfl_cfgs(kind)
    jmodel = jprfl.PrflModel(_jcfg(kind), JPavrmConfig(**PAV), jpc)
    qp, mp = jmodel.lrm.init_head_params(jax.random.PRNGKey(3))
    tcfg = _tcfg(kind, remat_policy="attn")
    tmodel = tprfl.PrflModel(tcfg, PavrmConfig(**PAV), tpc)
    tmodel.dit.load_state_dict(tck.from_jax_params(policy, tcfg))
    tmodel.lrm.load_state_dict(tck.lrm_from_jax(lrm_dit, jax.tree.map(np.asarray, qp),
                                                jax.tree.map(np.asarray, mp),
                                                tmodel.lrm.dit_cfg))
    return policy, {"dit": lrm_dit, "q": qp, "m": mp}, jmodel, tmodel


def _assert_params(tstate, jparams, tcfg):
    want = tck.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    assert set(want) == set(tstate.names)
    for n, p in zip(tstate.names, tstate.params):
        got, ref = p.detach().numpy(), want[n].numpy()
        # AdamW's first step moves each weight by lr g / (|g| + eps); where
        # |g| is near eps that size rests on the last bits of g: as
        # tests/test_torch_training.py, 0.1 lr on a few weights, 1e-4 of the
        # weight on all others
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.1 * LR, err_msg=n)
        off = np.abs(got - ref) > 1e-4 * np.abs(ref) + 1e-6
        assert off.mean() < 1e-3, (n, off.sum())


# one kind per step keeps the file's time down: the refl step on i2v (y in
# token cells through rollout, policy and LRM), the SFT step on flf2v (y in
# video layout, the two-frame CLIP features reshaped)
class _Identity:
    """p += g: the step's raw gradients land in the parameters."""

    def init(self, params, names=None):
        return {}

    def update(self, params, grads, opt_state, step):
        for p, g in zip(params, grads):
            p.add_(g)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_launches(monkeypatch, image_lks):
    """Count the plain-version calls by the kernel the card would launch
    for each (on the CPU the same Functions call the plain versions)."""
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
    # the text (512) and image (257, 514) keys fit one block (K3); the 48
    # self-attention keys would too, so they are told apart by length
    counted(tfa, "flash_attention_plain",
            lambda q, k, v: "K3" if k.shape[2] in (TEXT_LEN, *image_lks) else "K1")
    counted(tfa, "flash_attention_bwd_plain", lambda *a: "K4")
    return counts


@pytest.mark.parametrize("kind", KINDS)
def test_launch_derivation_counts_a_forward_and_backward(monkeypatch, kind):
    counts = _count_launches(monkeypatch, (257 * _frames(kind),))
    x, y, clip, t, ctx = _inputs(kind, 16, b=1)
    model = _port(kind, _tree(kind, 16), remat_policy="attn")
    with torch.no_grad():
        model(*_t(x, t, ctx), y=_t(y)[0], clip_fea=_t(clip)[0])
    smoke = _smoke()
    assert counts == smoke.dit_launches(2, False, i2v=True)
    counts.clear()
    model(*_t(x, t, ctx), y=_t(y)[0], clip_fea=_t(clip)[0]).square().mean().backward()
    assert counts == smoke.dit_launches(2, True, i2v=True)
    assert counts["K3"] == 4 and counts["K6"] == 2 * 5 + 2 * 5 and counts["K7"] == 2 * 5


def test_launch_derivation_counts_an_outer_step(monkeypatch):
    # the policy's image context needs a gradient (img_emb, k_img), the
    # frozen LRM's does not
    counts = _count_launches(monkeypatch, (257,))
    _, _, _, tmodel = _models("i2v", 17)
    batch = {k: torch.from_numpy(v) for k, v in _batch("i2v", 18).items()}
    tx = tcommon.make_optimizer(learning_rate=LR)
    state = tcommon.init_train_state(tmodel.dit, tx)
    state, _ = tprfl.make_refl_step(tmodel, tx)(state, batch)
    tprfl.make_sft_step(tmodel, tx, tfm.train_schedule(1000))(
        state, batch, generator=torch.Generator().manual_seed(0))
    assert counts == _smoke().expected_train_launches(2, 2, MID, i2v=True)


# -- the dataset -------------------------------------------------------------


def _write_cache(root, frames):
    rng = np.random.RandomState(19)
    null = root / "null" / "wanx"
    null.mkdir(parents=True)
    for name, n in (("null", 1), ("uncond", 7), ("uncond_flf2v", 9)):
        np.save(null / f"{name}.npy", rng.randn(1, n, 64).astype(np.float32))
    lines = []
    for i in range(3):
        meta = {"vae_latent_path": str(root / f"lat{i}.npy"),
                "textshort_path": str(root / f"s{i}.npy"),
                "textlong_path": str(root / f"l{i}.npy"),
                "f1_black_path" if i != 1 else "latents_condition_path": str(root / f"c{i}.npy"),
                "imgclip_path": str(root / f"clip{i}.npy"), "short_caption": f"s{i}",
                "long_caption": f"l{i}"}
        np.save(meta["vae_latent_path"], rng.randn(1, 16, 3, 4, 6).astype(np.float32))
        np.save(meta["textshort_path"], rng.randn(1, 5, 64).astype(np.float32))
        np.save(meta["textlong_path"], rng.randn(1, 9, 64).astype(np.float32))
        np.save(root / f"c{i}.npy", rng.randn(1, 16, 3, 4, 6).astype(np.float32))
        np.save(meta["imgclip_path"], rng.randn(1, frames * 257, 1280).astype(np.float32))
        path = root / f"meta{i}.json"
        path.write_text(json.dumps(meta))
        lines.append(str(path))
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return str(root / "list.txt"), str(root / "null")


@pytest.mark.parametrize("kind", ["t2v", *KINDS])
def test_dataset_i2v_fields_match_jax(tmp_path, kind):
    meta, null = _write_cache(tmp_path, _frames(kind))
    flags = dict(is_i2v=kind != "t2v", is_flf2v=kind == "flf2v")
    common = dict(uncond_prob=(0.3, 0.0), text_len=16, null_dir=null, seed=4, **flags)
    jset = jds.LatentCacheDataset(dataset_type="refl", meta_file_list=[meta], **common)
    tset = tds.LatentCacheDataset(meta_file_list=[meta], **common)
    for idx in (0, 1, 2, 1):
        want, got = jset[idx], tset[idx]
        assert got.keys() == want.keys()
        assert ("cond" in got) == ("clip_fea" in got) == (kind != "t2v")
        for key in got:
            if isinstance(got[key], str):
                assert got[key] == want[key], key
            else:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- the CLIs ------------------------------------------------------------------


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task,size", [("i2v-14B", "832*480"), ("i2v-14B", "480*832"),
                                       ("i2v-14B", "1280*720"), ("flf2v-14B", "832*480"),
                                       ("flf2v-14B", "720*1280"), ("t2v-1.3B", "832*480")])
def test_serving_cli_defaults_follow_the_jax_rules(task, size):
    cli = _load_script("inference_torch")
    jcli = _load_script("inference")
    got = cli.args_init(["--task", task, "--size", size])
    want = jcli.args_init(["--task", task, "--size", size])
    assert (got.sample_steps, got.sample_shift) == (want.sample_steps, want.sample_shift)
    assert got.device == "cuda"
    assert cli.pipeline_class(task) is {"t2v": tpipe.WanT2V, "i2v": tpipe.WanI2V,
                                        "flf2v": tpipe.WanFLF2V}[task.split("-")[0]]
    # the zero CLIP default: [1, 257, 1280] for i2v as in the JAX CLI; the
    # two frames flf2v's pipeline takes (the JAX CLI's one frame cannot run)
    assert cli.clip_shape(task) == ((2 if "flf2v" in task else 1), 257, 1280)


@pytest.mark.parametrize("kind", KINDS)
def test_serving_cli_answers_an_image_request(monkeypatch, tmp_path, kind):
    # the CLI path on the CPU at a tiny width: cached .npy inputs in the JAX
    # CLI's layouts, the pipeline of the task, latents of the request's grid
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "dit_config_for_task",
                        lambda task, **kw: _tcfg(kind, torch.bfloat16, **kw))
    monkeypatch.setattr(cli, "latent_grid", lambda size, frames, sp_size=1: (2, 4, 4))
    rng = np.random.RandomState(20)
    np.save(tmp_path / "clip.npy", rng.randn(_frames(kind), 257, 1280).astype(np.float32))
    np.save(tmp_path / "cond.npy", rng.randn(2, 4, 4, 16).astype(np.float32))
    task = f"{kind}-14B"
    out = tmp_path / "out.mp4"
    assert cli.main(["--task", task, "--device", "cpu", "--sample_steps", "2",
                     "--clip_embeds", str(tmp_path / "clip.npy"),
                     "--cond_latent", str(tmp_path / "cond.npy"),
                     "--save_file", str(out)]) == 0
    lat = np.load(tmp_path / "out_latents.npy")
    assert lat.shape == (1, 2, 4, 4, 16) and np.isfinite(lat).all()
    with pytest.raises(SystemExit):
        cli.args_init(["--task", "v2v-14B"])  # no such task


