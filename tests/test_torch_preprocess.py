"""The port's preprocess path (hyvideo_prfl_torch/utils/video_io.py readers,
scripts/gen_latents_torch.py, scripts/encode_captions_torch.py) against the
JAX package's (utils/video_io.py, scripts/gen_latents.py,
scripts/encode_captions.py) on the CPU, on mp4s that OpenCV writes here.

Both readers decode through OpenCV here (the JAX reader's pyav plugin is
absent), so frames, sizing, resize and range agree bit for bit. The towers
are tiny (a z 16 VAE of dim 16, a 2-block CLIP at 224 pixels with ViT-H's
16 heads, tiny umT5) with the port's seeded weights written as reference
``.pth`` files, which both CLIs read: the JAX CLI with its published
configs patched to the tiny ones. Bounds: the fp32 VAE and CLIP within
1e-4 of max|JAX|; umT5's bf16 compute within 3e-2 of max|JAX|. The
tokenizer is a stub patched into ``transformers.AutoTokenizer``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.configs import load_config as jload_config
from hyvideo_prfl_tpu.data.dataset import LatentCacheDataset as JDataset
from hyvideo_prfl_tpu.models import clip as jclip
from hyvideo_prfl_tpu.models import t5 as jt5
from hyvideo_prfl_tpu.models import vae as jvae
from hyvideo_prfl_tpu.utils import convert_encoders as ce
from hyvideo_prfl_tpu.utils import video_io as jvio
from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.data.dataset import LatentCacheDataset
from hyvideo_prfl_torch.models import clip as tclip
from hyvideo_prfl_torch.models import t5 as tt5
from hyvideo_prfl_torch.models import vae as tvae
from hyvideo_prfl_torch.utils import encoders
from hyvideo_prfl_torch.utils import video_io as tvio

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FP32 = 1e-4
BF16 = 3e-2
CLIP_KW = dict(image_size=224, dim=64, num_heads=16, num_layers=2)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def write_mp4(path, n, h, w, fps, seed=0):
    """A textured, moving clip through OpenCV's mp4v writer."""
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, 2 * w, 3), dtype=np.uint8)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert vw.isOpened()
    for i in range(n):
        vw.write(np.ascontiguousarray(base[:, 2 * i:2 * i + w]))
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def clip_mp4(tmp_path_factory):
    return write_mp4(tmp_path_factory.mktemp("mp4") / "clip.mp4", 30, 64, 96, 24)


@pytest.mark.parametrize("kw", [{}, dict(target_fps=16), dict(target_fps=16, start_frame=3),
                                dict(target_fps=10, num_frames=7), dict(start_frame=4)])
def test_read_video_equals_the_jax_reader(clip_mp4, kw):
    got, fps = tvio.read_video(clip_mp4, **kw)
    want, jfps = jvio.read_video(clip_mp4, **kw)
    assert fps == jfps and got.dtype == np.uint8 and (len(got) - 1) % 4 == 0
    assert np.array_equal(got, want)
    if kw == dict(target_fps=16):  # 30 frames at 24 fps: 20 at 16, aligned to 17
        assert got.shape == (17, 64, 96, 3)


@pytest.mark.parametrize("args", [(720, 1280, 704, 1.81), (1280, 720, 704, 1.81),
                                  (512, 512, 480, 1.73), (480, 4000, 480, 1.73),
                                  (720, 1280, 480, 1.73), (64, 96, 32, 1.81)])
def test_target_size_for_equals_the_jax_one(args):
    assert tvio.target_size_for(*args) == jvio.target_size_for(*args)
    if args == (720, 1280, 480, 1.73):
        assert tvio.target_size_for(*args) == (480, 832)


@pytest.mark.parametrize("hw", [(480, 832), (32, 64), (50, 30)])
def test_resize_center_crop_and_range_equal_the_jax_ones(hw):
    frames = np.random.default_rng(1).integers(0, 256, (3, 45, 77, 3), dtype=np.uint8)
    got = tvio.resize_center_crop(frames, *hw)
    assert got.shape == (3, *hw, 3) and np.array_equal(got, jvio.resize_center_crop(frames, *hw))
    assert np.array_equal(tvio.to_model_range(got), jvio.to_model_range(got))


@pytest.mark.parametrize("name", ["pre_480.yaml", "pre_720.yaml", "nested"])
def test_resolve_config_equals_the_jax_one(name, tmp_path):
    from scripts.gen_latents import resolve_config as jresolve

    gen = _load_script("gen_latents_torch")
    path = os.path.join(REPO, "configs", name)
    if name == "nested":
        path = str(tmp_path / "pre.yaml")
        with open(path, "w") as f:
            f.write("input_json: data.json\nheight: 480\nwidth: 832\nnum_frames: 17\nfps: 8\n"
                    "extra_model:\n  vae:\n    params_path: w/vae\n"
                    "  image_encoder:\n    params_path: w/clip\n"
                    "  text_encoder:\n    params_path: w/t5\n    tokenizer: tok\n"
                    "    t5_text_len: 256\n")
    got = gen.resolve_config(load_config(path))
    assert got == jresolve(jload_config(path))
    if name == "pre_480.yaml":
        assert (got["resolution"], got["aspect_ratio"], got["fps"], got["num_frames"]) == (
            480, 1.73, 16, 81)


def _fp32_state(module):
    return {k: v.float().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """The tiny VAE, CLIP and umT5 as reference files, and their JAX params."""
    d = tmp_path_factory.mktemp("weights")
    vae = tvae.init_params(tvae.WanVAE(tvae.tiny_vae(z_dim=16)), torch.Generator().manual_seed(1))
    vstate = _fp32_state(vae)
    encoders.save_reference(vstate, str(d / "vae.pth"))
    clip = tclip.init_params(tclip.CLIPVisionTower(tclip.tiny_clip(**CLIP_KW)),
                             torch.Generator().manual_seed(2))
    cstate = {"visual." + k: v for k, v in _fp32_state(clip).items()}
    encoders.save_reference(cstate, str(d / "clip.pth"))
    t5 = tt5.init_params(tt5.T5Encoder(tt5.tiny_t5(compute_dtype=torch.float32)),
                         torch.Generator().manual_seed(3))
    encoders.save_reference(_fp32_state(t5), str(d / "t5.pth"))
    jv, jc = jvae.tiny_vae(z_dim=16), jclip.tiny_clip(**CLIP_KW)
    return dict(dir=d, vae=str(d / "vae.pth"), clip=str(d / "clip.pth"), t5=str(d / "t5.pth"),
                jv=jv, jvp=ce.vae_torch_to_flax(vstate, jv), jc=jc,
                jcp=ce.clip_torch_to_flax(cstate, jc))


@pytest.mark.parametrize("frames,stream_over", [(5, 33), (9, 5)])
def test_encode_clip_data_equals_the_jax_one(towers, frames, stream_over):
    from scripts.gen_latents import encode_clip_data as jencode

    gen = _load_script("gen_latents_torch")
    video = np.random.default_rng(4).uniform(-1, 1, (frames, 32, 48, 3)).astype(np.float32)
    keep = video.copy()
    vae = encoders.load_reference_vae(towers["vae"])
    clip = encoders.load_reference_clip_visual(towers["clip"])
    times = {}
    got = gen.encode_clip_data(vae, clip, video, stream_over_frames=stream_over, times=times)
    assert np.array_equal(video, keep) and set(times) == {"encode_s", "f1_black_s", "clip_s"}
    want = jencode(jvae.WanVAE(towers["jv"]), towers["jvp"], jclip.CLIPVisionTower(towers["jc"]),
                   towers["jcp"], video, stream_over_frames=stream_over)
    t = (frames - 1) // 2 + 1
    assert got[0].shape == got[1].shape == (1, 16, t, 16, 24)
    # the JAX CLI writes the CLIP features with a leading unit axis; the
    # port writes the reference's [1, 257, dim], which both datasets read
    assert got[2].shape == (1, 257, 64) and want[2].shape == (1, 1, 257, 64)
    for g, w in zip(got, (want[0], want[1], want[2][0])):
        _close(g, w, FP32)


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


CLIPS = [dict(source_id="a", short_caption="a red fox", long_caption="a red fox runs in snow"),
         dict(source_id="broken", short_caption="x"),
         dict(source_id="b", short_caption="a paper boat on a rainy street")]


@pytest.fixture(scope="module")
def caches(towers, tmp_path_factory):
    """Both gen_latents CLIs, then both encode_captions CLIs, on the same
    mp4s and tiny towers; returns the roots and what each run said."""
    import transformers

    from scripts import encode_captions as jcap
    from scripts import gen_latents as jgen

    mp = pytest.MonkeyPatch()
    mp.setattr(transformers.AutoTokenizer, "from_pretrained", lambda name, **kw: _StubTokenizer())
    vae_config = jvae.VAEConfig  # the JAX CLI builds VAEConfig(); tiny_vae passes its kw
    mp.setattr(jvae, "VAEConfig", lambda **kw: vae_config(**(kw or dict(
        dim=16, z_dim=16, dim_mult=(1, 2), num_res_blocks=1, temporal_downsample=(True,)))))
    mp.setattr(jclip, "vit_h_14", lambda **kw: jclip.tiny_clip(**CLIP_KW))
    mp.setattr(jt5, "umt5_xxl", lambda **kw: jt5.tiny_t5())
    root = tmp_path_factory.mktemp("caches")
    videos = {"a": write_mp4(root / "a.mp4", 30, 64, 96, 24, seed=5),
              "b": write_mp4(root / "b.mp4", 26, 80, 60, 30, seed=6),
              "broken": str(root / "broken.mp4")}
    with open(videos["broken"], "wb") as f:
        f.write(b"not a video")
    data = [dict(c, video_path=videos[c["source_id"]]) for c in CLIPS]
    with open(root / "clips.json", "w") as f:
        json.dump(data, f)
    out = {}
    gen = _load_script("gen_latents_torch")
    for pkg in ("jax", "torch", "jax_no_t5", "torch_no_t5"):
        cfg = root / f"{pkg}.yaml"
        t5 = "" if pkg.endswith("no_t5") else f"text_encoder_path: {towers['t5']}\n"
        cfg.write_text(f"json_path: {root / 'clips.json'}\nsave_dir: {root / pkg}\n"
                       f"vae_path: {towers['vae']}\nimage_encoder_path: {towers['clip']}\n"
                       f"{t5}tokenizer_path: stub\nresolution: [32]\naspect_ratio: 1.81\n"
                       "sample_n_frames: 9\nextract_fps: 16\nstart_idx: 2\n")
        runs = []
        for _ in range(2):  # the second run finds every clip processed
            stats = []
            if pkg.startswith("jax"):
                rc = jgen.main(jload_config(str(cfg)))
            else:
                rc = gen.main(load_config(str(cfg)), "cpu", stats=stats)
            runs.append((rc, stats))
        out[pkg] = dict(root=root / pkg, runs=runs)
    cap = _load_script("encode_captions_torch")
    for pkg in ("jax_no_t5", "torch_no_t5"):
        argv = ["--meta_dir", str(root / pkg / "meta_v1"), "--t5_params", towers["t5"],
                "--tokenizer", "stub", "--null_dir", str(root / pkg / "null"),
                "--negative_prompt", "blurry, static"]
        for _ in range(2):
            if pkg.startswith("jax"):
                mp.setattr(sys, "argv", ["encode_captions.py", *argv])
                assert jcap.main() == 0
            else:
                assert cap.main([*argv, "--device", "cpu"]) == 0
    mp.undo()
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _meta(root, base):
    with open(os.path.join(root, "meta_v1", f"{base}_meta_v1.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("t5", [True, False])
def test_gen_latents_writes_what_the_jax_cli_writes(caches, t5):
    j, t = (caches[k + ("" if t5 else "_no_t5")] for k in ("jax", "torch"))
    files = _files(t["root"])
    names = ["latents/a.npy", "latents/a_f1_black.npy", "latents/a_img_clip.npy",
             "latents/b.npy", "latents/b_f1_black.npy", "latents/b_img_clip.npy",
             "meta_v1/a_meta_v1.json", "meta_v1/b_meta_v1.json"]
    names += ["latents/a_textlong.npy", "latents/a_textshort.npy", "latents/b_textlong.npy",
              "latents/b_textshort.npy"]
    if not t5:  # encode_captions filled them in, and wrote the null embeddings
        names += ["null/wanx/null.npy", "null/wanx/uncond.npy"]
    assert files == _files(j["root"]) == sorted(names)
    for base in ("a", "b"):
        jm, tm = _meta(j["root"], base), _meta(t["root"], base)
        assert sorted(jm) == sorted(tm)
        for k, v in tm.items():
            if k.endswith("_path") and k != "video_path":
                assert os.path.relpath(v, t["root"]) == os.path.relpath(jm[k], j["root"])
            else:
                assert v == jm[k], k
        # source 64 x 96 (a) and 80 x 60 (b), the short side to 32: 32 x 64
        # and 64 x 32 pixels; 9 frames at stride 2 in time, 2 in space
        assert tm["latent_shape"] == ([1, 16, 5, 16, 32] if base == "a" else [1, 16, 5, 32, 16])
        for key, rel in (("vae_latent_path", FP32), ("f1_black_path", FP32),
                         ("imgclip_path", FP32), ("textshort_path", BF16),
                         ("textlong_path", BF16)):
            got, want = np.load(tm[key]), np.load(jm[key])
            if key == "imgclip_path":  # the JAX CLI's extra leading axis
                assert got.shape == (1, 257, 64) and want.shape == (1, *got.shape)
                want = want[0]
            if key == "vae_latent_path":
                assert list(got.shape) == tm["latent_shape"]
            _close(got, want, rel)
        assert np.load(tm["textlong_path"]).shape[1] == len(CLIPS[2 * (base == "b")].get(
            "long_caption", CLIPS[2 * (base == "b")]["short_caption"]).split()) + 1
    if not t5:
        for name in ("null", "uncond"):
            got = np.load(os.path.join(t["root"], "null", "wanx", f"{name}.npy"))
            want = np.load(os.path.join(j["root"], "null", "wanx", f"{name}.npy"))
            assert got.shape == (1, 1 if name == "null" else 3, 64)
            _close(got, want, BF16)


def test_gen_latents_skips_processed_clips_and_passes_over_a_broken_one(caches):
    (rc1, first), (rc2, second) = caches["torch"]["runs"]
    assert rc1 == rc2 == 0
    assert [s["source_id"] for s in first] == ["a", "b"] and second == []
    assert set(first[0]) == {"source_id", "read_resize_s", "encode_s", "f1_black_s", "clip_s",
                             "t5_s", "total_s"}
    assert [rc for rc, _ in caches["jax"]["runs"]] == [0, 0]
    assert not os.path.exists(os.path.join(caches["torch"]["root"], "meta_v1",
                                           "broken_meta_v1.json"))


def test_the_clis_refuse_an_orbax_directory_and_run_without_vae(tmp_path):
    gen = _load_script("gen_latents_torch")
    cap = _load_script("encode_captions_torch")
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        gen.load_vae(str(tmp_path / "orbax"), "cpu")
    with pytest.raises(SystemExit, match="orbax"):
        cap.make_t5_embedder(str(tmp_path / "orbax"), "stub", 512, "cpu")
    assert cap.make_t5_embedder("", "stub") is None
    cfg = tmp_path / "pre.yaml"
    cfg.write_text(f"json_path: x.json\nsave_dir: {tmp_path / 'out'}\n"
                   f"vae_path: {tmp_path / 'missing.pth'}\n")
    assert gen.main(load_config(str(cfg)), "cpu") == 1


@pytest.mark.parametrize("uncond", [0.0, 0.5])
def test_the_port_dataset_reads_the_port_cache_as_the_jax_dataset_does(caches, tmp_path,
                                                                      uncond):
    root = caches["torch_no_t5"]["root"]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(os.path.join(root, "meta_v1", f"{b}_meta_v1.json\n")
                           for b in ("a", "b")))
    kw = dict(meta_file_list=[str(lst)], uncond_prob=[uncond, 0.0], text_len=16,
              null_dir=str(root / "null"), is_i2v=True, seed=7)
    got, want = LatentCacheDataset(**kw), JDataset(**kw)
    for idx in (0, 1, 1, 0, 1, 0, 0, 1):
        g, w = got[idx], want[idx]
        assert sorted(g) == sorted(w)
        for k in g:
            if k == "prompt":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["latents"].shape == g["cond"].shape == ((5, 32, 16, 16) if idx else
                                                        (5, 16, 32, 16))
        assert g["clip_fea"].shape == (257, 64) and g["text"].shape == (16, 64)
    assert got.rng.random() == want.rng.random()
