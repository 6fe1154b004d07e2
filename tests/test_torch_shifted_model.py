"""The shifted route and the un-normed DiT through whole models against
the JAX package, on the CPU: the bounded switch read from the
environment, a training CLI run on the shifted route, and the DiT without
qk-norm (forward and gradients). The helpers are
tests/test_torch_shifted.py's; these cases live in a file of their own so
that pytest-xdist's ``--dist loadfile`` runs them beside the longest file
of the suite rather than before it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_torch.ops import flash_attention as tfa
from hyvideo_prfl_torch.utils import checkpoint as tck

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_shifted import (  # noqa: E402
    _dit_inputs,
    _load_script,
    _spy,
    _unnormed,
    REPO,
    TINY,
    UNNORMED,
    _pallas_kernel_path,  # an autouse fixture
)


@pytest.mark.parametrize("value", ["0", "1"])
def test_bounded_switch_reads_the_environment_as_jax_does(value):
    code = ("from hyvideo_prfl_tpu.ops import flash_attention as jfa\n"
            "from hyvideo_prfl_torch.ops import flash_attention as tfa\n"
            "print(jfa.FLASH_BOUNDED, tfa.FLASH_BOUNDED)\n")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "HYV_FLASH_BOUNDED": value, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(value == "1")] * 2


def test_cli_trains_on_the_shifted_route(tmp_path, monkeypatch):
    # the training CLI under HYV_FLASH_BOUNDED=0: no flag of its own, every
    # attention of the rollout, the policy and the LRM takes the shifted form
    from hyvideo_prfl_torch.configs.config import load_config

    shifted = _spy(monkeypatch, "flash_attention_shifted_plain")
    bounded = _spy(monkeypatch, "flash_attention_plain")
    monkeypatch.setattr(tfa, "FLASH_BOUNDED", False)
    cli = _load_script("train_prfl_torch")
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(tmp_path)
    cfg.model.ema.use_ema = False  # the smoke config asks for EMA; not needed here
    trainer = cli.build_trainer(cfg, "cpu")
    before = trainer.model.dit.head.head.weight.detach().clone()
    (m,) = cli.run(trainer, 1)
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        assert np.isfinite(m[key]), (key, m)
    assert m["grad_norm"] > 0 and not torch.equal(trainer.model.dit.head.head.weight, before)
    assert shifted and not bounded


@pytest.mark.parametrize("kind", list(UNNORMED))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unnormed_dit_matches_jax(kind, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    model, tree = _unnormed(kind, compute_dtype=td)
    x, t, ctx = _dit_inputs(22)
    jcfg = jdit.tiny_test(**TINY, **UNNORMED[kind], compute_dtype=jd)
    want = np.asarray(jdit.WanModel(jcfg).apply(tree, *map(jnp.asarray, (x, t, ctx))))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, (x, t, ctx))).numpy()
    assert np.abs(want).max() > 0.1
    if dtype == "float32":
        # fp32 throughout, both shifted softmaxes: matmul sums in another
        # order, 1e-4 of the output scale over two blocks
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    else:
        # bf16 activations round at a dozen points per block in both
        # frameworks, in other orders: 3e-2 of max|out|, the qk-normed
        # DiT's bf16 tolerance (tests/test_torch_wan_dit.py)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("kind", list(UNNORMED))
def test_unnormed_dit_grads_match_jax(kind):
    model, tree = _unnormed(kind, param_dtype=torch.float32, remat_policy="attn")
    x, t, ctx = _dit_inputs(23, b=1)
    r = np.random.RandomState(24).randn(1, 3, 8, 8, 16).astype(np.float32)
    jcfg = jdit.tiny_test(**TINY, **UNNORMED[kind], compute_dtype=jnp.float32)
    jmodel = jdit.WanModel(jcfg)

    def loss(params, x_):
        return (jmodel.apply(params, x_, jnp.asarray(t), jnp.asarray(ctx)) * r).sum()

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    want = tck.from_jax_params(jax.tree.map(np.asarray, jg), model.cfg)
    tx = torch.from_numpy(x).requires_grad_()
    (model(tx, torch.from_numpy(t), torch.from_numpy(ctx)) * torch.from_numpy(r)).sum().backward()
    grads = {"input": (tx.grad, torch.from_numpy(np.asarray(jgx)))}
    grads.update({name: (p.grad, want[name]) for name, p in model.named_parameters()})
    assert len(grads) == len(want) + 1
    for name, (got, ref) in grads.items():
        # fp32 both sides; sums in other orders: 1e-4 of each gradient's
        # largest entry. The cross-attention k bias shifts every logit of a
        # row alike, which the softmax ignores: its gradient is 0 up to
        # rounding, held to the k weight's scale instead.
        scale = np.abs(ref.numpy()).max()
        if name.endswith("cross_attn.k.bias"):
            scale = np.abs(want[name[:-len("bias")] + "weight"].numpy()).max()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
