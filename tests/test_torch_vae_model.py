"""The port's Wan VAE against the JAX package's, on the CPU: encode and
decode, the published configuration and the streaming paths, at fp32
within 1e-4 of max|JAX|. The weights and helpers are
tests/test_torch_vae.py's; these cases live in a file of their own so
that pytest-xdist's ``--dist loadfile`` runs them beside the longest file
of the suite rather than before it.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import vae as jvae
from hyvideo_prfl_tpu.utils import convert_encoders as ce
from hyvideo_prfl_torch.models import vae as tvae

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_vae import (  # noqa: E402
    _close,
    _pair,
    _video,
)


@pytest.mark.parametrize("name,t,hw", [("tiny", 9, 16), ("tiny_z16", 5, 16),
                                       ("wan_dim32", 9, 32)])
def test_encode_decode_match_jax(name, t, hw):
    vae, jcfg, params = _pair(name)
    model = jvae.WanVAE(jcfg)
    x = _video(t, hw)
    z_ref = np.asarray(model.apply(params, jnp.asarray(x), method=model.encode))
    z = vae.encode(torch.from_numpy(x))
    _close(z, z_ref)
    lat = np.random.default_rng(2).standard_normal(z_ref.shape).astype(np.float32)
    x_ref = np.asarray(model.apply(params, jnp.asarray(lat), method=model.decode))
    got = vae.decode(torch.from_numpy(lat))
    _close(got, x_ref)
    assert float(got.abs().max()) <= 1.0


def test_full_config_matches_jax():
    # the published VAEConfig() (dim 96) at a few 32x32 frames
    vae = tvae.init_params(tvae.WanVAE(tvae.VAEConfig()), torch.Generator().manual_seed(3))
    jcfg = jvae.VAEConfig()
    params = ce.vae_torch_to_flax({k: v.numpy() for k, v in vae.state_dict().items()}, jcfg)
    model = jvae.WanVAE(jcfg)
    x = _video(5, 32)
    z_ref = np.asarray(model.apply(params, jnp.asarray(x), method=model.encode))
    assert z_ref.shape == (1, 2, 4, 4, 16)
    _close(vae.encode(torch.from_numpy(x)), z_ref)
    x_ref = np.asarray(model.apply(params, jnp.asarray(z_ref), method=model.decode))
    _close(vae.decode(torch.from_numpy(z_ref)), x_ref)


@pytest.mark.parametrize("name", ["tiny", "wan_dim32"])
def test_streaming_matches_whole_clip_and_jax(name):
    vae, jcfg, params = _pair(name, seed=4)
    x = torch.from_numpy(_video(9, 16 if name == "tiny" else 32, seed=5))
    whole = vae.encode(x)
    stream = tvae.encode_streaming(vae, x, frames_per_chunk=4)
    _close(stream, whole)
    _close(stream, jvae.encode_streaming(params, jcfg, jnp.asarray(x.numpy()), 4))
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(tuple(whole.shape))
                         .astype(np.float32))
    ref = vae.decode(z)
    for chunk in (1, 2):
        got = tvae.decode_streaming(vae, z, frames_per_chunk=chunk)
        _close(got, ref)
        _close(got, jvae.decode_streaming(params, jcfg, jnp.asarray(z.numpy()), chunk))
    # the CLIs' decode: chunk 0 and -1 (at most 5 latent frames) the whole
    # clip, n the stream of n; frames on the CPU
    assert torch.equal(tvae.decode(vae, z, chunk=0), ref)
    assert torch.equal(tvae.decode(vae, z, chunk=-1), ref)
    assert torch.equal(tvae.decode(vae, z, chunk=2),
                       tvae.decode_streaming(vae, z, frames_per_chunk=2))
    assert tvae.decode(vae, z, chunk=1).device.type == "cpu"
    with pytest.raises(ValueError, match="temporal stride"):
        tvae.encode_streaming(vae, x, frames_per_chunk=3)
