"""The port's text and image towers (hyvideo_prfl_torch/models/{t5,clip}.py),
their weight converters, the serving CLI's text encoder and image
conditioner, against the JAX package on the CPU.

Weights are the port's seeded ``init_params``, mapped to the JAX trees by
``convert_encoders.{t5,clip,vae}_torch_to_flax``; inputs are seeded numpy
arrays. Bounds: fp32 towers within 1e-4 of max|JAX|; T5 in its bf16
compute within 3e-2 of max|JAX| (a bf16 residual stream through 2
blocks: a few bf16 steps of 2^-8 at the output's scale); the torch
bicubic resize within 1e-3 of OpenCV's INTER_CUBIC (both a = -0.75 on
half-pixel centres; OpenCV rounds its weights to fp32 in another order).
The tokenizer is a stub (no tokenizer files exist here), patched into
``transformers.AutoTokenizer`` for both CLIs alike.
"""

import argparse
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import clip as jclip
from hyvideo_prfl_tpu.models import t5 as jt5
from hyvideo_prfl_tpu.models import vae as jvae
from hyvideo_prfl_tpu.utils import checkpoint as jck
from hyvideo_prfl_tpu.utils import convert_encoders as ce
from hyvideo_prfl_torch.models import clip as tclip
from hyvideo_prfl_torch.models import t5 as tt5
from hyvideo_prfl_torch.models import vae as tvae
from hyvideo_prfl_torch.utils import encoders

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = 1e-4
BF16 = 3e-2


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rel):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _fp32_state(module):
    return {k: v.float().numpy() for k, v in module.state_dict().items()}


def _t5_pair(cfg_kw=None, seed=0):
    """(port T5 in fp32 weights, its reference state, the JAX params)."""
    cfg = tt5.tiny_t5(compute_dtype=torch.float32, **(cfg_kw or {}))
    t5 = tt5.init_params(tt5.T5Encoder(cfg), torch.Generator().manual_seed(seed))
    state = _fp32_state(t5)
    jcfg = jt5.tiny_t5(**(cfg_kw or {}))
    return state, jcfg, ce.t5_torch_to_flax(state, jcfg)


def _ids(b=2, l=24, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 15:] = 0
    ids[1, 15:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_t5_matches_encode_text_with_a_padded_mask(dtype):
    state, jcfg, params = _t5_pair()
    ids, mask = _ids()
    cd = torch.bfloat16 if dtype == "bf16" else torch.float32
    jcfg = jt5.tiny_t5(compute_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = np.asarray(jt5.encode_text(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    t5 = tt5.T5Encoder(tt5.tiny_t5(compute_dtype=cd))
    t5.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if dtype == "bf16":  # dense weights and the token embedding in bf16, as JAX casts them
        assert t5.blocks[0].attn.q.weight.dtype == torch.bfloat16
        assert t5.blocks[0].norm1.weight.dtype == torch.float32
    got = t5(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, want, BF16 if dtype == "bf16" else FP32)


@pytest.mark.parametrize("lq,buckets", [(1, 32), (37, 32), (512, 32), (200, 16)])
def test_relative_buckets_equal_the_jax_ones(lq, buckets):
    got = tt5.relative_buckets(lq, lq, buckets)
    assert np.array_equal(got, jt5._relative_buckets_np(lq, lq, buckets))


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_tower_matches_jax(use_31_block):
    cfg = tclip.tiny_clip()
    tower = tclip.init_params(tclip.CLIPVisionTower(cfg), torch.Generator().manual_seed(2))
    state = {"visual." + k: v for k, v in _fp32_state(tower).items()}
    jcfg = jclip.tiny_clip()
    params = ce.clip_torch_to_flax(state, jcfg)
    x = np.random.default_rng(3).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jclip.CLIPVisionTower(jcfg).apply(params, jnp.asarray(x), use_31_block=use_31_block)
    got = tower(torch.from_numpy(x), use_31_block=use_31_block)
    assert got.shape == (2, 5, 64)
    _close(got, want, FP32)


@pytest.mark.parametrize("hw", [(60, 104), (480, 832), (224, 224), (17, 300)])
def test_preprocess_frames_matches_the_opencv_resize(hw):
    frames = np.random.default_rng(4).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = jclip.preprocess_frames(frames, 224)
    got = tclip.preprocess_frames(torch.from_numpy(frames), 224)
    assert got.shape == (2, 224, 224, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-3


def test_converters_equal_the_jax_ones():
    state, jcfg, params = _t5_pair(seed=5)
    tree = jax.tree.map(np.asarray, params)
    got, want = encoders.t5_from_jax(tree, tt5.tiny_t5()), ce.t5_flax_to_torch(params, jcfg)
    assert set(got) == set(want) == set(state)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    cfg = tclip.tiny_clip()
    tower = tclip.init_params(tclip.CLIPVisionTower(cfg), torch.Generator().manual_seed(6))
    state = {"visual." + k: v for k, v in _fp32_state(tower).items()}
    params = ce.clip_torch_to_flax(state, jclip.tiny_clip())
    got = encoders.clip_from_jax(jax.tree.map(np.asarray, params), cfg)
    want = ce.clip_flax_to_torch(params, jclip.tiny_clip())
    assert set(got) == set(want) == set(state)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


def test_reference_files_load_with_their_configs(tmp_path):
    cfg = tt5.tiny_t5(num_layers=3, num_buckets=16)
    t5 = tt5.init_params(tt5.T5Encoder(cfg), torch.Generator().manual_seed(7))
    # the released encoder file is bf16 throughout
    encoders.save_reference(_fp32_state(t5), str(tmp_path / "t5.pth"), dtype=torch.bfloat16)
    back = encoders.load_reference_t5(str(tmp_path / "t5.pth"))
    assert back.cfg == cfg
    ccfg = tclip.tiny_clip(num_heads=16)
    tower = tclip.init_params(tclip.CLIPVisionTower(ccfg), torch.Generator().manual_seed(8))
    whole = {"visual." + k: v for k, v in _fp32_state(tower).items()}
    # the whole-CLIP file's other keys: the text tower's, the dead post-norm and head
    whole.update({"textual.token_embedding.weight": np.zeros((4, 4), np.float32),
                  "visual.post_norm.weight": np.ones(64, np.float32),
                  "visual.head": np.zeros((64, 8), np.float32),
                  "log_scale": np.zeros((), np.float32)})
    encoders.save_reference(whole, str(tmp_path / "clip.pth"))
    back = encoders.load_reference_clip_visual(str(tmp_path / "clip.pth"))
    assert back.cfg == ccfg
    for k, v in tower.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _image_pair(tmp_path, clip_kw):
    """A seeded VAE (z 16) and CLIP tower as reference files, and the JAX
    params of both."""
    vae = tvae.init_params(tvae.WanVAE(tvae.tiny_vae(z_dim=16)), torch.Generator().manual_seed(9))
    vstate = _fp32_state(vae)
    encoders.save_reference(vstate, str(tmp_path / "vae.pth"))
    ccfg = tclip.tiny_clip(**clip_kw)
    tower = tclip.init_params(tclip.CLIPVisionTower(ccfg), torch.Generator().manual_seed(10))
    cstate = {"visual." + k: v for k, v in _fp32_state(tower).items()}
    encoders.save_reference(cstate, str(tmp_path / "clip.pth"))
    jv, jc = jvae.tiny_vae(z_dim=16), jclip.tiny_clip(**clip_kw)
    return (jv, ce.vae_torch_to_flax(vstate, jv)), (jc, ce.clip_torch_to_flax(cstate, jc))


@pytest.mark.parametrize("n_frames", [1, 2])
def test_conditioner_matches_the_jax_modules(tmp_path, n_frames):
    (jv, vparams), (jc, cparams) = _image_pair(tmp_path, dict(num_heads=16))
    cli = _load_script("inference_torch")
    cond = cli.Conditioner(encoders.load_reference_clip_visual(str(tmp_path / "clip.pth")),
                           encoders.load_reference_vae(str(tmp_path / "vae.pth")))
    lat_f, lat_h, lat_w = 3, 4, 6
    f_pix, h, w = cond.pixels(lat_f, lat_h, lat_w)
    assert (f_pix, h, w) == (5, 8, 12)
    frames = np.random.default_rng(11).uniform(-1, 1, (n_frames, h, w, 3)).astype(np.float32)
    clip_fea, cond_latent = cond.condition(torch.from_numpy(frames), lat_f)
    # the JAX CLI's conditioner (scripts/inference.py _ImageConditioner) on
    # the same frames: CLIP on the preprocessed frames, then the streaming
    # encode of [first, zeros..., (last)]
    want_clip = jclip.CLIPVisionTower(jc).apply(
        cparams, jnp.asarray(jclip.preprocess_frames(frames, jc.image_size)))
    vid = np.zeros((1, f_pix, h, w, 3), np.float32)
    vid[0, 0] = frames[0]
    if n_frames == 2:
        vid[0, -1] = frames[1]
    want_lat = jvae.encode_streaming(vparams, jv, jnp.asarray(vid))
    _close(clip_fea, want_clip, 1e-3)  # the resize's 1e-3 through the tower
    _close(cond_latent, want_lat, FP32)
    assert cond_latent.shape == (1, lat_f, lat_h, lat_w, 16)


def test_load_image_matches_the_jax_cli(tmp_path):
    from PIL import Image

    jcli = _load_script("inference")
    cli = _load_script("inference_torch")
    img = (np.random.default_rng(12).uniform(0, 255, (37, 53, 3))).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    got = cli.load_image(str(tmp_path / "img.png"), 16, 24)
    want = jcli._ImageConditioner._load_image(None, str(tmp_path / "img.png"), 16, 24)
    assert got.shape == (16, 24, 3) and np.array_equal(got, want)


class _StubTokenizer:
    """Words -> ids by a fixed hash, an end token 1, padding 0."""

    vocab_size = 1000

    def __call__(self, texts, return_tensors=None, add_special_tokens=True, padding=None,
                 truncation=None, max_length=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [2 + sum(map(ord, w)) * 7 % 997 for w in t.split()][:max_length - 1] + [1]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture
def stub_tokenizer(monkeypatch):
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda name, **kw: _StubTokenizer())


def test_prompt_through_both_clis(tmp_path, monkeypatch, stub_tokenizer):
    state, jcfg, params = _t5_pair(seed=13)
    jck.save_orbax(str(tmp_path / "t5_orbax"), params)
    encoders.save_reference(state, str(tmp_path / "t5.pth"), dtype=torch.bfloat16)
    prompt = "a  red fox   runs through snow"
    # the JAX CLI's text embedder, its umT5-XXL config swapped for the tiny one
    monkeypatch.setattr(jt5, "umt5_xxl", lambda **kw: jt5.tiny_t5())
    jcli = _load_script("inference")
    jargs = argparse.Namespace(prompt=prompt, prompt_file=None, smoke_tiny=False,
                               t5_params=str(tmp_path / "t5_orbax"), tokenizer="stub")
    want = np.asarray(jcli._make_text_embedder(jargs, None)(prompt))
    cli = _load_script("inference_torch")
    args = cli.args_init(["--prompt", prompt, "--t5_path", str(tmp_path / "t5.pth"),
                          "--tokenizer", "stub", "--device", "cpu"])
    got = cli.make_text_encoder(args, torch.device("cpu"))([prompt, "another one"])
    assert got.shape == (2, 512, 64) and want.shape == (1, 512, 64)
    n = 7  # six words and the end token
    # the port trims each context to its tokens and zero-pads it, as the
    # reference DiT does; the JAX CLI keeps the encoder's pad positions
    _close(got[0, :n], want[0, :n], BF16)
    assert not got[0, n:].any() and not got[1, 3:].any() and got[1, :3].abs().min() > 0
    with pytest.raises(SystemExit):
        cli.args_init(["--prompt", prompt])  # no --t5_path


def _tiny_i2v(monkeypatch, cli, model_type="t2v"):
    from hyvideo_prfl_torch.models import wan_dit as tdit

    def cfg(task, **kw):
        return tdit.tiny_test(dim=256, num_heads=2, ffn_dim=512, num_layers=2,
                              model_type=model_type, in_dim=16 if model_type == "t2v" else 36,
                              compute_dtype=torch.float32, **kw)

    monkeypatch.setattr(cli, "dit_config_for_task", cfg)
    monkeypatch.setattr(cli, "latent_grid", lambda size, frames, sp_size=1: (3, 4, 4))


def test_serving_cli_from_prompt_and_image_to_frames(tmp_path, monkeypatch, stub_tokenizer):
    from PIL import Image

    from hyvideo_prfl_torch.utils import video_io

    _image_pair(tmp_path, dict(dim=1280, num_heads=16, num_layers=2))
    state, _, _ = _t5_pair(seed=14)
    encoders.save_reference(state, str(tmp_path / "t5.pth"), dtype=torch.bfloat16)
    Image.fromarray(np.random.default_rng(15).uniform(0, 255, (20, 30, 3)).astype(np.uint8)
                    ).save(tmp_path / "img.png")
    monkeypatch.setattr(video_io, "_write_mp4", lambda frames, path, fps: False)
    cli = _load_script("inference_torch")
    _tiny_i2v(monkeypatch, cli, "i2v")
    seen = {}
    run_request = cli.run_request

    def spy(pipe, req, size):
        seen.update(clip=req.clip_fea, cond=req.cond_latent, ctx=req.context)
        return run_request(pipe, req, size)

    monkeypatch.setattr(cli, "run_request", spy)
    out = tmp_path / "out.mp4"
    assert cli.main(["--task", "i2v-14B", "--device", "cpu", "--sample_steps", "2",
                     "--prompt", "a cat", "--t5_path", str(tmp_path / "t5.pth"),
                     "--tokenizer", "stub", "--image", str(tmp_path / "img.png"),
                     "--clip_path", str(tmp_path / "clip.pth"),
                     "--vae_path", str(tmp_path / "vae.pth"), "--save_file", str(out)]) == 0
    frames = np.load(tmp_path / "out_frames.npy")
    assert frames.dtype == np.uint8 and frames.shape == (5, 8, 8, 3)
    # one block's CLIP tokens (use_31_block of 2), the conditioning latent
    # of the grid, the 3-token prompt padded to 512
    assert seen["clip"].shape == (1, 5, 1280) and seen["cond"].shape == (1, 3, 4, 4, 16)
    assert seen["ctx"].shape == (1, 512, 64) and not seen["ctx"][0, 3:].any()
    with pytest.raises(SystemExit):
        cli.args_init(["--task", "i2v-14B", "--image", "x.png"])  # no --vae_path/--clip_path


@pytest.mark.parametrize("argv", [
    ["--task", "flf2v-14B", "--image", "a.png"],  # flf2v without --last_image
    ["--task", "i2v-14B", "--image", "a.png", "--last_image", "b.png"],  # i2v with it
    ["--task", "flf2v-14B", "--last_image", "b.png"],  # --last_image without --image
])
def test_cli_refuses_inconsistent_image_flags(argv, capsys):
    cli = _load_script("inference_torch")
    with pytest.raises(SystemExit):
        cli.args_init(argv + ["--vae_path", "v.pth", "--clip_path", "c.pth"])
    assert "error" in capsys.readouterr().err
