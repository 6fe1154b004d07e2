"""The port's dpm++ and euler solvers and TeaCache against the JAX
package's: the schedule tables, a rollout with a stand-in velocity, each
solver's sampling chain and TeaCache's on a tiny DiT given the same noise,
the TeaCache gate's skip pattern, the forward's skip/residual path, and
the serving CLI's solver and TeaCache flags."""

import importlib.util
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import teacache as jtc
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_tpu.schedulers import dpm as jdpm
from hyvideo_prfl_tpu.schedulers import flow_match as jfm
from hyvideo_prfl_tpu.schedulers import unipc as junipc
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import teacache as ttc
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.schedulers import dpm as tdpm
from hyvideo_prfl_torch.schedulers import flow_match as tfm
from hyvideo_prfl_torch.schedulers import unipc as tunipc
from hyvideo_prfl_torch.utils import checkpoint as tck

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)
SHAPE = (1, 3, 8, 8, 16)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# -- the schedules -----------------------------------------------------------


@pytest.mark.parametrize("steps,shift", [(4, 5.0), (10, 3.0), (50, 5.0), (1, 5.0), (2, 5.0)])
def test_dpm_schedule_tables_equal_jax(steps, shift):
    # exact: the same float64 precompute rounded once to fp32
    t, j = tdpm.dpm_schedule(steps, shift=shift), jdpm.dpm_schedule(steps, shift=shift)
    for name in ("sigmas", "timesteps", "sigma_tab", "a_tab", "b_tab", "c_tab"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.num_steps == j.num_steps == steps
    if steps >= 3:  # order 2 in the middle, lower order at the warm-up and the end
        assert t.c_tab[0] == 0 and t.c_tab[-1] == 0 and (t.c_tab[1:-1] != 0).all()


@pytest.mark.parametrize("steps,shift", [(3, 5.0), (4, 5.0), (10, 3.0), (12, 5.0), (30, 7.0),
                                         (40, 5.0), (50, 1.0), (50, 3.0)])
def test_inference_schedule_equals_jax(steps, shift):
    # exact: jnp.linspace's fp32 arithmetic, then the warp in fp32
    t, j = tfm.inference_schedule(steps, shift=shift), jfm.inference_schedule(steps, shift=shift)
    np.testing.assert_array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))


def _stand_in(x0_shape, seed=0):
    a = np.random.RandomState(seed).randn(*x0_shape).astype(np.float32) * 0.1
    return (lambda x, t: 0.7 * x + a * (t / 1000.0),
            lambda x, t: 0.7 * x + torch.from_numpy(a) * (t / 1000.0))


@pytest.mark.parametrize("steps,stop", [(3, None), (8, None), (8, 5)])
def test_dpm_rollout_matches_jax(steps, stop):
    x0 = np.random.RandomState(1).randn(2, 12, 4, 16).astype(np.float32)
    jvel, tvel = _stand_in(x0.shape)
    want, jstate = jdpm.rollout(jdpm.dpm_schedule(steps), jvel, jnp.asarray(x0),
                                stop_index=stop)
    got, tstate = tdpm.rollout(tdpm.dpm_schedule(steps), tvel, torch.from_numpy(x0),
                               num_steps=stop)
    assert tstate.step_index == int(jstate.step_index) == (stop or steps)
    # fp32 multiply-adds with the same coefficients; XLA may fuse them into
    # fused multiply-adds that round once where PyTorch rounds twice
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tstate.m_prev.numpy(), np.asarray(jstate.m_prev), rtol=1e-5,
                               atol=1e-5)


def test_euler_steps_match_jax():
    x = np.random.RandomState(2).randn(1, 6, 4, 16).astype(np.float32)
    jvel, tvel = _stand_in(x.shape, seed=3)
    js, ts = jfm.inference_schedule(6, shift=5.0), tfm.inference_schedule(6, shift=5.0)
    want, got = jnp.asarray(x), torch.from_numpy(x)
    for i in range(6):
        want = jfm.euler_step(js, jvel(want, js.timesteps[i]), want, i)
        got = tfm.euler_step(ts, tvel(got, float(ts.timesteps[i])), got, i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unipc_rollout_threads_a_carry():
    # the carry changes nothing of the chain; it sees every step in order
    sched = tunipc.unipc_schedule(5)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 6, 4, 16).astype(np.float32))

    def vel(x, t):
        return -0.5 * x + t / 1000.0

    plain, pstate = tunipc.rollout(sched, vel, x)
    got, state, seen = tunipc.rollout(sched, lambda x, t, i, e: (vel(x, t), e + [(i, t)]), x,
                                      extra_init=[])
    assert torch.equal(got, plain) and state.step_index == pstate.step_index == 5
    assert seen == [(i, float(sched.timesteps[i])) for i in range(5)]


# -- the DiT and the sampling chains on a tiny model -------------------------


@pytest.fixture(scope="module")
def tiny():
    tree = tck.seeded_jax_tree(tdit.tiny_test(**TINY), seed=3)
    rng = np.random.RandomState(4)
    ctx = rng.randn(1, 16, 64).astype(np.float32)
    ctx_null = rng.randn(1, 16, 64).astype(np.float32) * 0.1
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    return dict(tree=tree, ctx=ctx, ctx_null=ctx_null, model=model.eval(), jcfg=jcfg)


def test_time_embed_only_matches_jax(tiny):
    t = np.float32([999.0, 500.0, 3.5])
    want = np.asarray(jdit.time_embed_only(tiny["tree"], tiny["jcfg"], jnp.asarray(t)))
    got = tdit.time_embed_only(tiny["model"], torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("skip", [False, True])
def test_forward_residual_path_matches_jax(tiny, skip):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 8, 8, 16).astype(np.float32)
    t = np.float32([800.0, 800.0])
    ctx = np.concatenate([tiny["ctx"], tiny["ctx_null"]])
    res = rng.randn(2, 48, TINY["dim"]).astype(np.float32)
    model = jdit.WanModel(tiny["jcfg"])
    jout, je, jres = model.apply(tiny["tree"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                 skip_blocks=jnp.asarray(skip), residual_in=jnp.asarray(res),
                                 output_residual=True)
    with torch.no_grad():
        out, e, r = tiny["model"](torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(ctx), skip_blocks=skip,
                                  residual_in=torch.from_numpy(res), output_residual=True)
        plain = tiny["model"](torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    # fp32 end to end: the model tests' 1e-4 of the scale
    for a, b in ((out, jout), (e, je), (r, jres)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    if skip:  # the stack replaced by the cached residual
        torch.testing.assert_close(r, torch.from_numpy(res), rtol=1e-6, atol=1e-5)
    else:  # the same forward as without the residual path
        assert torch.equal(out, plain)


def _jax_sample(tiny, solver, steps=3):
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    jgen = jpipe.GenerateConfig(sampling_steps=steps, guide_scale=5.0, shift=5.0,
                                sample_solver=solver)
    want = np.asarray(jpipe.WanT2V(tiny["jcfg"], tiny["tree"]).sample(
        key, SHAPE, jnp.asarray(tiny["ctx"]), jnp.asarray(tiny["ctx_null"]), jgen))
    return noise, want


@pytest.mark.parametrize("solver", ["dpm++", "euler", "dpm"])
def test_sample_matches_jax(tiny, solver):
    noise, want = _jax_sample(tiny, solver)
    gen = tpipe.GenerateConfig(sampling_steps=3, guide_scale=5.0, shift=5.0,
                               sample_solver=solver)
    got = tpipe.WanT2V(tiny["model"]).generate(
        None, torch.from_numpy(tiny["ctx"]), torch.from_numpy(tiny["ctx_null"]), 3, 8, 8, gen,
        noise=torch.from_numpy(noise))
    assert got.shape == SHAPE and np.isfinite(got.numpy()).all()
    assert np.abs(want - noise).max() > 0.1  # the DiT moved the latent
    # fp32 end to end: three CFG steps of the fp32 DiT, where the model tests
    # hold each forward to 1e-4 of its scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_solvers_give_different_chains(tiny):
    gens = {s: tpipe.GenerateConfig(sampling_steps=3, sample_solver=s)
            for s in ("unipc", "dpm++", "euler")}
    noise = torch.from_numpy(np.random.RandomState(6).randn(*SHAPE).astype(np.float32))
    pipe = tpipe.WanT2V(tiny["model"])
    outs = {s: pipe.generate(None, torch.from_numpy(tiny["ctx"]),
                             torch.from_numpy(tiny["ctx_null"]), 3, 8, 8, g, noise=noise)
            for s, g in gens.items()}
    assert not torch.equal(outs["unipc"], outs["dpm++"])
    assert not torch.equal(outs["dpm++"], outs["euler"])
    with pytest.raises(ValueError, match="unknown solver"):
        pipe.generate(None, torch.from_numpy(tiny["ctx"]), torch.from_numpy(tiny["ctx_null"]),
                      3, 8, 8, tpipe.GenerateConfig(sampling_steps=2, sample_solver="ddim"),
                      noise=noise)


# -- TeaCache ------------------------------------------------------------------


def _jax_gate(tiny, steps, thresh, key):
    """The JAX gate over a UniPC schedule's timesteps -> skip per step."""
    sched = junipc.unipc_schedule(steps, shift=5.0)
    state = jtc.init_state(1, TINY["dim"], 1)
    skips = []
    for i in range(steps):
        e = jdit.time_embed_only(tiny["tree"], tiny["jcfg"], jnp.full((1,), sched.timesteps[i]))
        skip, state = jtc.should_skip(state, e, jnp.int32(i), steps, thresh,
                                      jtc.COEFFICIENTS[key])
        skips.append(bool(skip))
    return skips


def _port_gate(tiny, steps, thresh, key):
    sched = tunipc.unipc_schedule(steps, shift=5.0)
    state, skips = ttc.init_state(), []
    for i in range(steps):
        with torch.no_grad():
            e = tdit.time_embed_only(tiny["model"], torch.full((1,), float(sched.timesteps[i])))
        skip, state = ttc.should_skip(state, e, i, steps, thresh, ttc.COEFFICIENTS[key])
        skips.append(skip)
    return skips


# The tiny seeded model's time MLP changes its e by a relative 0.86-1.21
# between the 12 steps, so the fitted polynomials give 635-3,130 a step
# (t2v-1.3b) and negative values (t2v-14b). Thresholds 1,000 and 2,000 mix
# skipped and computed interior steps, every sum at least 1% from them;
# t2v-14b at 0 skips every interior step.
GATES = [("t2v-1.3b", 1000.0), ("t2v-14b", 0.0), ("t2v-1.3b", 2000.0)]


@pytest.mark.parametrize("key,thresh", GATES)
def test_teacache_skip_pattern_equals_jax(tiny, key, thresh):
    want = _jax_gate(tiny, 12, thresh, key)
    got = _port_gate(tiny, 12, thresh, key)
    assert got == want
    assert any(want[1:-1]) and not want[0] and not want[-1]
    assert all(want[1:-1]) == (key == "t2v-14b")  # else a computed step resets the sum


def test_teacache_gate_state():
    e0, e1 = torch.ones(1, 4), torch.full((1, 4), 1.01)
    coeffs = (1.0, 0.0)  # poly(x) = x (highest degree first): the relative changes
    skip, st = ttc.should_skip(ttc.init_state(), e0, 0, 5, 1.0, coeffs)
    assert not skip and float(st.accum) == 0 and torch.equal(st.prev_mod_input, e0)
    skip, st = ttc.should_skip(st, e1, 1, 5, 1.0, coeffs)
    assert skip and abs(float(st.accum) - 0.01) < 1e-6
    skip, st = ttc.should_skip(st, e1, 2, 5, 0.005, coeffs)  # over: compute, reset
    assert not skip and float(st.accum) == 0
    skip, _ = ttc.should_skip(st, e1, 4, 5, 1.0, coeffs)  # the last step computes
    assert not skip


@pytest.mark.parametrize("key,thresh", GATES[:2])
def test_sample_teacache_matches_jax(tiny, key, thresh):
    steps = 12
    rng = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(rng, SHAPE, jnp.float32))
    jgen = jpipe.GenerateConfig(sampling_steps=steps, guide_scale=5.0, shift=5.0)
    want = np.asarray(jpipe.WanT2V(tiny["jcfg"], tiny["tree"]).sample_teacache(
        rng, SHAPE, jnp.asarray(tiny["ctx"]), jnp.asarray(tiny["ctx_null"]), jgen,
        thresh=thresh, coeffs_key=key))
    pipe = tpipe.WanT2V(tiny["model"])
    gen = tpipe.GenerateConfig(sampling_steps=steps, guide_scale=5.0, shift=5.0,
                               sample_solver="euler")  # TeaCache samples with UniPC anyway
    got = pipe.sample_teacache(None, SHAPE, torch.from_numpy(tiny["ctx"]),
                               torch.from_numpy(tiny["ctx_null"]), gen, thresh=thresh,
                               coeffs_key=key, noise=torch.from_numpy(noise))
    assert pipe.teacache_skips == _jax_gate(tiny, steps, thresh, key)
    assert any(pipe.teacache_skips)
    # fp32 end to end over 12 CFG steps, the skipped ones adding the cached
    # residual: the sampling test's 1e-4 of the scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # without a skip (threshold 0) it is the UniPC chain
    plain = pipe.generate(None, torch.from_numpy(tiny["ctx"]), torch.from_numpy(tiny["ctx_null"]),
                          3, 8, 8, tpipe.GenerateConfig(sampling_steps=steps),
                          noise=torch.from_numpy(noise))
    none = pipe.sample_teacache(None, SHAPE, torch.from_numpy(tiny["ctx"]),
                                torch.from_numpy(tiny["ctx_null"]), gen, thresh=-1e30,
                                coeffs_key=key, noise=torch.from_numpy(noise))
    assert not any(pipe.teacache_skips)
    torch.testing.assert_close(none, plain, rtol=1e-5, atol=1e-5)


# -- the serving CLI -------------------------------------------------------------


def _tiny_cli(monkeypatch):
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "dit_config_for_task",
                        lambda task, **kw: tdit.tiny_test(**TINY, compute_dtype=torch.float32,
                                                          **kw))
    monkeypatch.setattr(cli, "latent_grid", lambda size, frames, sp_size=1: (frames // 4 + 1, 4, 4))
    return cli


@pytest.mark.parametrize("flags,solver,thresh", [
    ([], "unipc", None), (["--sample_solver", "dpm++"], "dpm++", None),
    (["--sample_solver", "euler"], "euler", None),
    (["--teacache_thresh", "0.5"], "unipc", 0.5)])
def test_cli_passes_the_solver_and_teacache(monkeypatch, tmp_path, flags, solver, thresh):
    cli = _tiny_cli(monkeypatch)
    seen = []
    generate, teacache = tpipe.WanT2V.generate, tpipe.WanT2V.sample_teacache
    monkeypatch.setattr(tpipe.WanT2V, "generate",
                        lambda self, *a, **kw: seen.append(("generate", a[6].sample_solver))
                        or generate(self, *a, **kw))
    monkeypatch.setattr(tpipe.WanT2V, "sample_teacache",
                        lambda self, *a, **kw: seen.append(("teacache", kw["thresh"],
                                                            kw["coeffs_key"]))
                        or teacache(self, *a, **kw))
    out = tmp_path / "o.mp4"
    assert cli.main(["--task", "t2v-1.3B", "--device", "cpu", "--frame_num", "5",
                     "--sample_steps", "3", "--save_file", str(out), *flags]) == 0
    lat = np.load(tmp_path / "o_latents.npy")
    assert lat.shape == (1, 2, 4, 4, 16) and np.isfinite(lat).all()
    want = ("teacache", thresh, "t2v-1.3b") if thresh is not None else ("generate", solver)
    assert seen == [want]
    with pytest.raises(SystemExit):
        cli.args_init(["--sample_solver", "ddim"])


def test_cli_ignores_teacache_for_i2v(caplog):
    cli = _load_script("inference_torch")
    with caplog.at_level(logging.WARNING):
        args = cli.args_init(["--task", "i2v-14B", "--teacache_thresh", "0.2"])
    assert args.teacache_thresh is None and "ignored" in caplog.text
    assert cli.args_init(["--task", "t2i-14B", "--teacache_thresh", "0.2"]).teacache_thresh == 0.2
    assert cli.teacache_key("t2v-1.3B") == "t2v-1.3b"
    assert cli.teacache_key("t2v-14B") == cli.teacache_key("t2i-14B") == "t2v-14b"
