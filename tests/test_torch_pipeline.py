"""The port's serving slice against the JAX package: latent sizing, the
batched-CFG UniPC sampling chain end to end on a tiny DiT, and the CLI's
import surface (the port must import with JAX unavailable)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)


@pytest.mark.parametrize("area,aspect,frames", [
    (832 * 480, 480 / 832, 81), (832 * 480, 480 / 832, 21), (832 * 480, 832 / 480, 9),
    (1280 * 720, 720 / 1280, 81)])
def test_latent_size_matches_jax(area, aspect, frames):
    got = tpipe.latent_size_for(area, aspect, num_frames=frames)
    assert got == jpipe.latent_size_for(area, aspect, num_frames=frames)


def test_slice_latent_grids():
    # the serving slice's shapes: 832*480 at 21 and 81 frames
    assert tpipe.latent_size_for(832 * 480, 480 / 832, num_frames=21) == (6, 60, 104)
    assert tpipe.latent_size_for(832 * 480, 480 / 832, num_frames=81) == (21, 60, 104)


def test_t2v_sample_matches_jax():
    tree = tck.seeded_jax_tree(tdit.tiny_test(**TINY), seed=3)
    rng = np.random.RandomState(4)
    ctx = rng.randn(1, 16, 64).astype(np.float32)
    ctx_null = rng.randn(1, 16, 64).astype(np.float32) * 0.1
    shape = (1, 3, 8, 8, 16)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))  # JAX's draw

    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    jgen = jpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    want = np.asarray(jpipe.WanT2V(jcfg, tree).sample(key, shape, jnp.asarray(ctx),
                                                      jnp.asarray(ctx_null), jgen))

    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    gen = tpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0)
    got = tpipe.WanT2V(model.eval()).generate(
        None, torch.from_numpy(ctx), torch.from_numpy(ctx_null), 3, 8, 8, gen,
        noise=torch.from_numpy(noise))
    assert got.shape == shape and np.isfinite(got.numpy()).all()
    assert np.abs(want - noise).max() > 0.1  # the DiT moved the latent
    # fp32 end to end: three CFG steps of the fp32 DiT, where the model
    # tests hold each forward to 1e-4 of its scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_port_and_cli_import_without_jax():
    code = (
        "import sys, importlib.util\n"
        "for m in ('jax', 'flax', 'chex', 'optax', 'hyvideo_prfl_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import hyvideo_prfl_torch\n"
        "from hyvideo_prfl_torch.configs import dit_config_for_task\n"
        "from hyvideo_prfl_torch.pipelines import pipeline\n"
        "from hyvideo_prfl_torch.utils import checkpoint\n"
        "from hyvideo_prfl_torch.ops import _build, attention\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'inference_torch', 'scripts/inference_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['inference_torch'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "args = mod.args_init(['--size', '832*480', '--frame_num', '21'])\n"
        "assert args.device == 'cuda' and args.sample_steps == 50\n"
        "assert mod.latent_grid(args.size, args.frame_num) == (6, 60, 104)\n"
        "assert dit_config_for_task(args.task).num_layers == 30\n"
        "assert not _build.LAUNCHES\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import inference_torch
    finally:
        sys.path.pop(0)
    args = inference_torch.args_init(["--task", "t2v-1.3B"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        inference_torch.build_pipeline(args)
