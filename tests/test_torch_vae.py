"""The port's Wan VAE (hyvideo_prfl_torch/models/vae.py) against the JAX
package's, on the CPU.

Both get one set of seeded weights: the port's ``init_params`` fills a
``WanVAE`` (every weight non-zero, the attention's projection too), whose
state dict is the reference layout; the JAX tree comes from it through
``convert_encoders.vae_torch_to_flax``. Inputs are seeded numpy arrays.
Bounds: fp32 within 1e-4 of max|JAX| (the two run the same fp32
convolutions in another order); the bf16 stream within 0.1 of the fp32
frames (clamped to [-1, 1]) and within 0.1 of the JAX bf16 stream.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import vae as jvae
from hyvideo_prfl_tpu.utils import convert_encoders as ce
from hyvideo_prfl_torch.models import vae as tvae
from hyvideo_prfl_torch.utils import encoders, video_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {  # name -> (port config, JAX config)
    "tiny": (tvae.tiny_vae(), jvae.tiny_vae()),
    "tiny_z16": (tvae.tiny_vae(z_dim=16), jvae.tiny_vae(z_dim=16)),
    "wan_dim32": (tvae.VAEConfig(dim=32), jvae.VAEConfig(dim=32)),
}
FP32 = 1e-4


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _pair(name, seed=0):
    """(port VAE, JAX config, JAX params) with the same seeded weights."""
    tcfg, jcfg = CONFIGS[name]
    vae = tvae.init_params(tvae.WanVAE(tcfg), torch.Generator().manual_seed(seed))
    state = {k: v.numpy() for k, v in vae.state_dict().items()}
    return vae.eval(), jcfg, ce.vae_torch_to_flax(state, jcfg)


def _close(got, want, rel=FP32):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _video(t, hw, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (1, t, hw, hw, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def test_bf16_stream_within_bound(tiny):
    vae, jcfg, params = tiny
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 5, 8, 8, 4))
                         .astype(np.float32))
    ref = vae.decode(z)
    got = tvae.decode_streaming(vae, z, 2, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and float(got.abs().max()) <= 1.0
    assert float((got - ref).abs().max()) <= 0.1
    jbf = np.asarray(jvae.decode_streaming(params, jcfg, jnp.asarray(z.numpy()), 2,
                                           dtype=jnp.bfloat16))
    assert np.abs(got.numpy() - jbf).max() <= 0.1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_vae_from_jax_equals_the_jax_converter(name):
    vae, jcfg, params = _pair(name, seed=8)
    tree = {"params": {k: v for k, v in params["params"].items()}}
    want = ce.vae_flax_to_torch(params, jcfg)
    got = encoders.vae_from_jax(tree, CONFIGS[name][0])
    assert set(got) == set(want) == set(vae.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kw", [dict(), dict(dim=32), dict(dim=16, dim_mult=(1, 2, 3),
                                                           num_res_blocks=1,
                                                           temporal_downsample=(True, False))])
def test_infer_config_from_a_reference_state(kw):
    cfg = tvae.VAEConfig(**kw)
    state = tvae.WanVAE(cfg, device="meta").state_dict()
    assert tvae.infer_config(state) == cfg
    jcfg = jvae.VAEConfig(**kw)
    params = ce.vae_torch_to_flax({k: np.zeros(v.shape, np.float32) for k, v in state.items()},
                                  jcfg)
    j = jvae.infer_config(params)
    assert (j.dim, j.z_dim, j.dim_mult, j.num_res_blocks, j.temporal_downsample) == (
        cfg.dim, cfg.z_dim, cfg.dim_mult, cfg.num_res_blocks, cfg.temporal_downsample)


def test_load_reference_vae_round_trip(tmp_path, tiny):
    vae = tiny[0]
    path = encoders.save_reference({k: v.numpy() for k, v in vae.state_dict().items()},
                                   str(tmp_path / "vae.pth"))
    back = encoders.load_reference_vae(path)
    assert back.cfg == vae.cfg
    for k, v in vae.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _no_mp4(monkeypatch):
    monkeypatch.setattr(video_io, "_write_mp4", lambda frames, path, fps: False)


def test_decode_latents_cli_matches_jax_decode_streaming(tmp_path, monkeypatch, tiny):
    vae, jcfg, params = tiny
    encoders.save_reference({k: v.numpy() for k, v in vae.state_dict().items()},
                            str(tmp_path / "vae.pth"))
    z = np.random.default_rng(9).standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    # the reference's [B, z, F, H, W] layout is read too
    np.save(tmp_path / "lat.npy", np.transpose(z, (0, 4, 1, 2, 3)))
    _no_mp4(monkeypatch)
    cli = _load_script("decode_latents_torch")
    assert cli.main(["--latents", str(tmp_path / "lat.npy"), "--vae_path",
                     str(tmp_path / "vae.pth"), "--save_file", str(tmp_path / "out.mp4"),
                     "--decode_chunk", "1", "--dtype", "float32", "--device", "cpu"]) == 0
    frames = np.load(tmp_path / "out_frames.npy")
    ref = np.asarray(jvae.decode_streaming(params, jcfg, jnp.asarray(z), 1))[0]
    assert frames.dtype == np.uint8 and frames.shape == ref.shape == (5, 8, 12, 3)
    want = ((np.clip(ref, -1, 1) + 1.0) * 127.5).astype(np.int32)
    # one level of 255 apart at most: the fp32 frames agree to 1e-4
    assert np.abs(frames.astype(np.int32) - want).max() <= 1
    assert cli.stream_dtype(tvae.VAEConfig(), (1, 21, 90, 160), "auto") == torch.bfloat16
    assert cli.stream_dtype(tvae.VAEConfig(), (1, 21, 60, 104), "auto") == torch.float32


def test_cache_video_writes_frames_without_a_writer(tmp_path, monkeypatch):
    video = np.linspace(-1.2, 1.2, 2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    _no_mp4(monkeypatch)
    out = video_io.cache_video(torch.from_numpy(video), str(tmp_path / "a" / "v.mp4"))
    assert out.endswith("v_frames.npy")
    frames = np.load(out)
    assert frames.dtype == np.uint8 and frames.shape == (2, 4, 6, 3)
    assert frames.min() == 0 and frames.max() == 255


def _tiny_dit_cli(monkeypatch, cli):
    from hyvideo_prfl_torch.models import wan_dit as tdit

    def cfg(task, **kw):
        return tdit.tiny_test(dim=256, num_heads=2, ffn_dim=512, num_layers=2,
                              compute_dtype=torch.float32, **kw)

    monkeypatch.setattr(cli, "dit_config_for_task", cfg)
    monkeypatch.setattr(cli, "latent_grid", lambda size, frames, sp_size=1: (3, 4, 4))


def test_serving_cli_writes_decoded_frames(tmp_path, monkeypatch):
    cli = _load_script("inference_torch")
    _tiny_dit_cli(monkeypatch, cli)
    _no_mp4(monkeypatch)
    vae = tvae.init_params(tvae.WanVAE(tvae.tiny_vae(z_dim=16)), torch.Generator().manual_seed(0))
    encoders.save_reference({k: v.numpy() for k, v in vae.state_dict().items()},
                            str(tmp_path / "vae.pth"))
    out = tmp_path / "out.mp4"
    assert cli.main(["--task", "t2v-1.3B", "--device", "cpu", "--sample_steps", "2",
                     "--vae_path", str(tmp_path / "vae.pth"), "--save_file", str(out)]) == 0
    frames = np.load(tmp_path / "out_frames.npy")
    # 3 latent frames at the tiny VAE's stride (2, 2, 2)
    assert frames.dtype == np.uint8 and frames.shape == (5, 8, 8, 3)
    assert not (tmp_path / "out_latents.npy").exists()


def test_trainer_sanity_decode_writes_frames(tmp_path, monkeypatch):
    from hyvideo_prfl_torch.configs.config import load_config

    cli = _load_script("train_prfl_torch")
    vae = tvae.init_params(tvae.WanVAE(tvae.tiny_vae(z_dim=16)), torch.Generator().manual_seed(1))
    encoders.save_reference({k: v.numpy() for k, v in vae.state_dict().items()},
                            str(tmp_path / "vae.pth"))
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(tmp_path)
    cfg.model.ema.use_ema = False
    cfg.extra_model.vae.params_path = str(tmp_path / "vae.pth")
    cfg.train.sanity_check_interval = 1
    _no_mp4(monkeypatch)
    trainer = cli.build_trainer(cfg, "cpu")
    assert trainer.vae is not None and trainer.vae.cfg == tvae.tiny_vae(z_dim=16)
    (m,) = cli.run(trainer, 1)
    assert np.isfinite(m["refl_loss"])
    sanity = tmp_path / "smoke_prfl" / "sanity_check"
    for name in ("pred_x0", "latent_next"):
        frames = np.load(sanity / f"step0_{name}_frames.npy")
        # the smoke cache's [1, 3, 8, 8, 16] latents through the (2, 2, 2) stride
        assert frames.dtype == np.uint8 and frames.shape == (5, 16, 16, 3)
        assert not (sanity / f"step0_{name}.npy").exists()
