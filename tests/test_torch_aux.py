"""The port's smaller modules against the JAX package, on the CPU: the
reward pool's ``layer_norm``/``product_text`` options and its reference
layout with ``text_proj``, the distillation helpers (Euler sub-solver,
phase endpoints, the discriminator heads with their flax weights carried
across) and the trainers' metric logger (TensorBoard scalars, or the text
fallback). The teacher-student collectives ride the world-4 gloo spawn of
tests/test_torch_parallel.py."""

import ast
import builtins
import glob
import importlib.util
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import reward as jrw
from hyvideo_prfl_tpu.training import distill as jdistill
from hyvideo_prfl_tpu.utils import convert_encoders as jconv
from hyvideo_prfl_torch.configs import config_from_dict
from hyvideo_prfl_torch.models import reward as trw
from hyvideo_prfl_torch.training import cli as tcli
from hyvideo_prfl_torch.training import distill as tdistill
from hyvideo_prfl_torch.utils import checkpoint as tck
from scripts import _common as jcommon

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

D, TEXT = 64, 32


@pytest.mark.parametrize("layer_norm,product_text", [(True, False), (False, True),
                                                     (True, True)])
def test_query_attention_options_match_jax(layer_norm, product_text):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 10, D) * 3 + 1).astype(np.float32)
    text = rng.randn(2, TEXT).astype(np.float32)
    jq = jrw.QueryAttention(feature_dim=D, num_queries=2, num_heads=4, layer_norm=layer_norm,
                            return_type="query", product_text=product_text, text_dim=TEXT)
    params = jq.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(text))
    want = np.asarray(jq.apply(params, jnp.asarray(x), jnp.asarray(text)))
    tq = trw.QueryAttention(D, 2, 4, return_type="query", layer_norm=layer_norm,
                            product_text=product_text, text_dim=TEXT)
    state = tck.reward_heads_from_jax(jax.tree.map(np.asarray, params), {"params": {}})
    tq.load_state_dict({k[len("q_attn."):]: v for k, v in state.items()})
    got = tq(torch.from_numpy(x), torch.from_numpy(text)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the reference layout both ways carries text_proj, as the JAX converters do
    ref = tck.query_attention_to_reference(tq.state_dict())
    jref = jconv.query_attention_flax_to_torch(jax.tree.map(np.asarray, params))
    assert set(ref) == set(jref) and ("text_proj.weight" in ref) == product_text
    for k, v in jref.items():
        np.testing.assert_array_equal(ref[k].numpy(), v, err_msg=k)
    back = tck.query_attention_from_reference(ref)
    assert set(back) == set(tq.state_dict())
    for k, v in tq.state_dict().items():
        assert torch.equal(back[k], v), k


def test_distill_helpers_match_jax():
    assert ([tdistill.get_phase_endpoint(i, 32, 8) for i in range(32)]
            == [jdistill.get_phase_endpoint(i, 32, 8) for i in range(32)])
    a = np.linspace(0, 1, 10, dtype=np.float32)
    got = tdistill.extract_into_tensor(a, [2, 7], (2, 3, 4))
    want = jdistill.extract_into_tensor(a, jnp.asarray([2, 7]), (2, 3, 4))
    assert tuple(got.shape) == want.shape == (2, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sig = np.linspace(1, 0, 1001)
    js = jdistill.EulerSolver.make(sig, timesteps=1000, euler_timesteps=10)
    ts = tdistill.EulerSolver.make(sig, timesteps=1000, euler_timesteps=10)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    rng = np.random.RandomState(0)
    x, v = rng.randn(2, 4).astype(np.float32), rng.randn(2, 4).astype(np.float32)
    for i in range(10):
        np.testing.assert_array_equal(
            ts.euler_step(torch.from_numpy(x), torch.from_numpy(v), i).numpy(),
            np.asarray(js.euler_step(jnp.asarray(x), jnp.asarray(v), jnp.int32(i))))
        j = (i * 7) % 10
        np.testing.assert_array_equal(
            ts.euler_step_to_target(torch.from_numpy(x), torch.from_numpy(v), i, j).numpy(),
            np.asarray(js.euler_step_to_target(jnp.asarray(x), jnp.asarray(v), jnp.int32(i),
                                               jnp.int32(j))))


def test_discriminator_matches_jax():
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 8, 48).astype(np.float32) for _ in range(2)]
    jd = jdistill.Discriminator(num_heads=2, inner_dim=64)
    params = jd.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    want = jd.apply(params, [jnp.asarray(f) for f in feats])
    td = tdistill.Discriminator(48, num_heads=2, inner_dim=64)
    td.load_state_dict(tdistill.discriminator_from_flax(jax.tree.map(np.asarray, params)))
    got = td([torch.from_numpy(f) for f in feats])
    assert len(got) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 8, 1)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(rng.randn(2, 8, 64).astype(np.float32))
    np.testing.assert_allclose(tdistill._group_norm(x, 32).numpy(),
                               np.asarray(jdistill._group_norm(jnp.asarray(x.numpy()), 32)),
                               rtol=1e-5, atol=1e-5)


def _config(tmp_path):
    return config_from_dict({"save": {"log_dir": str(tmp_path / "logs")}})


def _scalars(log_dir):
    """{(tag, step, value)} of the one event file in log_dir."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (events,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    acc = EventAccumulator(events)
    acc.Reload()
    return {(tag, e.step, e.value) for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}


def _jax_log_keys(script):
    """The keys of the dict literal each ``logger.log(step, {...})`` call of
    a JAX trainer writes."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    return [[k.value for k in call.args[1].keys if isinstance(k, ast.Constant)]
            for call in ast.walk(tree)
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "log" and getattr(call.func.value, "id", None) == "logger"
            and len(call.args) > 1 and isinstance(call.args[1], ast.Dict)]


def test_metric_logger_writes_scalars(tmp_path):
    # the PRFL trainer's scalars are the JAX trainer's (train_prfl.py's
    # logger.log), and both loggers write the same records as the same
    # TensorBoard scalars
    spec = importlib.util.spec_from_file_location(
        "train_prfl_torch", os.path.join(REPO, "scripts", "train_prfl_torch.py"))
    trainer = importlib.util.module_from_spec(spec)
    sys.modules["train_prfl_torch"] = trainer
    spec.loader.exec_module(trainer)
    assert _jax_log_keys("train_prfl.py") == [list(trainer.TB_KEYS)]
    assert ["step_time"] in _jax_log_keys("train_pavrm.py")
    rng = np.random.RandomState(0)
    records = [(step, {k: float(rng.randn()) for k in trainer.TB_KEYS}, "train")
               for step in range(3)]
    records.append((2, {"accuracy": 0.75, "f1": 0.5}, "val_t400"))
    root = logging.getLogger()
    level = root.level
    jlog = jcommon.MetricLogger(str(tmp_path / "jax"))
    try:
        for step, scalars, prefix in records:
            jlog.log(step, scalars, prefix=prefix)
    finally:
        jlog.writer.close()
        for h in [h for h in root.handlers if getattr(h, "_hyv_metric_logger", False)]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)
        jcommon.MetricLogger._live = None
    log = tcli.MetricLogger(_config(tmp_path), str(tmp_path))
    for step, scalars, prefix in records:
        log.log({"step": step, **scalars}, step, scalars, prefix=prefix)
    log.close()
    lines = (tmp_path / "logs" / "log.txt").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1, 2, 2]
    got, want = _scalars(str(tmp_path / "logs")), _scalars(str(tmp_path / "jax"))
    assert len(want) == 3 * len(trainer.TB_KEYS) + 2
    assert got == want


def test_metric_logger_falls_back_to_text(tmp_path, monkeypatch, caplog):
    real = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with caplog.at_level("INFO"):
        log = tcli.MetricLogger(_config(tmp_path), str(tmp_path))
    assert log.writer is None and "text only" in caplog.text
    log.log({"step": 0, "loss": 1.5}, 0, {"loss": 1.5})
    assert json.loads((tmp_path / "logs" / "log.txt").read_text()) == {"step": 0, "loss": 1.5}
    assert not glob.glob(str(tmp_path / "logs" / "events.out.tfevents.*"))
    # other ranks write nothing
    other = tcli.MetricLogger(_config(tmp_path / "r1"), str(tmp_path / "r1"), main=False)
    other.log({"step": 0}, 0, {"loss": 1.0})
    assert not os.path.exists(tmp_path / "r1")
