"""The port's tracer (hyvideo_prfl_torch/utils/tracing.py) on the CPU: the
switch, the spans' nesting, self times and device pairs, the counters, and
the spans the training CLI, the serving path and the loader leave.

No JAX: the tracer and the CLIs' paths run on the port alone.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.data.loader import DataParallelLoader
from hyvideo_prfl_torch.models import wan_dit
from hyvideo_prfl_torch.ops import _build
from hyvideo_prfl_torch.pipelines import pipeline
from hyvideo_prfl_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every span the training CLI's outer step holds (scripts/train_prfl_torch.py,
# training/prfl.py, training/common.py, schedulers/unipc.py)
TRAIN_SPANS = ("train.step", "train.batch", "train.log", "prfl.rollout", "prfl.forward",
               "prfl.lrm", "prfl.backward", "prfl.optimizer", "sft.forward", "sft.backward",
               "sft.optimizer", "optimizer.finite_guard", "optimizer.clip", "solver.step",
               "solver.model")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Tracing off, with no spans kept, around each test."""
    monkeypatch.setattr(tracing, "ENV", False)
    tracing.reset()
    tracing.drain()
    yield
    tracing.reset()


def _load_script(name):
    key = f"{name}_traced"  # the dataclasses need the module registered
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(REPO, "scripts",
                                                                         name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


class Clock:
    """The host clock and the device's, moved by hand."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class FakeEvent:
    """A timing event stamped with the clock; ``done`` stands for its
    completion on the device. Waiting on it fails the test."""

    def __init__(self, clock, done=True):
        self.ms, self.done = clock.now * 1e3, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "a pair resolved before it completed"
        return end.ms - self.ms

    def synchronize(self):
        raise AssertionError("the tracer waited on an event")

    wait = synchronize


def test_off_by_default_counts_but_keeps_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing off made a CUDA event or a profiler range")

    monkeypatch.setattr(tracing, "_event", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not tracing.enabled()
    before = tracing.COUNTERS["test.off"]
    with tracing.span("off.outer", 1):
        with tracing.span("off.inner"):
            tracing.count("test.off")
            tracing.count("test.off", 2)
    assert tracing.totals()["spans"] == {} and tracing.drain()["spans"] == {}
    assert tracing.COUNTERS["test.off"] == before + 3


def test_hyv_trace_is_read_at_import():
    code = ("from hyvideo_prfl_torch.utils import tracing; "
            "print(tracing.ENV, tracing.enabled())")
    for value, want in (("1", "True True"), ("0", "False False")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=REPO, env={**os.environ, "HYV_TRACE": value}, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == want


@pytest.mark.parametrize("switch", ["profiler", "HYV_TRACE"])
def test_spans_nest_and_land_in_the_profilers_timeline(monkeypatch, switch):
    def run():
        with tracing.span("t.outer", 5):
            with tracing.span("t.inner"):
                torch.ones(64).mul(3.0)
            with tracing.span("t.inner"):
                pass

    if switch == "HYV_TRACE":
        monkeypatch.setattr(tracing, "ENV", True)
        run()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert tracing.enabled()
            run()
        # the ranges are the profiler's own events, around the ops they ran
        spans = {}
        for e in prof.profiler.kineto_results.events():
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
        (o0, o1), = spans["t.outer"]
        (i0, i1), (j0, j1) = sorted(spans["t.inner"])
        (m0, m1), = spans["aten::mul"]
        assert o0 <= i0 <= m0 <= m1 <= i1 <= j0 <= j1 <= o1
        assert not tracing.enabled()  # off again once the profiler stops
    got = tracing.totals()["spans"]
    assert set(got) == {"t.outer", "t.inner"}
    assert got["t.outer"]["parent"] is None and got["t.inner"]["parent"] == "t.outer"
    assert got["t.outer"]["calls"] == 1 and got["t.inner"]["calls"] == 2
    assert got["t.outer"]["id"] == got["t.inner"]["id"] == 5
    assert "device_s" not in got["t.inner"]  # no CUDA in this process


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tracing, "ENV", True)
    monkeypatch.setattr(tracing, "time", clock)
    monkeypatch.setattr(tracing, "_event", lambda: FakeEvent(clock))
    with tracing.span("s.parent"):
        clock.now += 1.0
        with tracing.span("s.child"):
            clock.now += 2.0
            with tracing.span("s.grandchild"):
                clock.now += 0.5
        clock.now += 3.0
        with tracing.span("s.child"):
            clock.now += 4.0
    got = tracing.totals()["spans"]
    parent, child, grand = got["s.parent"], got["s.child"], got["s.grandchild"]
    for side in ("host", "device"):
        assert parent[f"{side}_s"] == pytest.approx(10.5)
        assert parent[f"self_{side}_s"] == pytest.approx(10.5 - 6.5)
        assert child[f"{side}_s"] == pytest.approx(6.5)
        assert child[f"self_{side}_s"] == pytest.approx(6.0)
        assert grand[f"self_{side}_s"] == pytest.approx(0.5)
    # drain gives the same in milliseconds, once
    drained = tracing.drain()["spans"]
    assert drained["s.child"]["self_device_ms"] == pytest.approx(6000.0)
    assert drained["s.child"]["calls"] == 2 and tracing.drain()["spans"] == {}
    assert tracing.totals()["spans"]["s.child"]["calls"] == 2


def test_an_unfinished_pair_is_left_pending_not_waited_on(monkeypatch):
    clock = Clock()
    made = []

    def event():
        made.append(FakeEvent(clock, done=False))
        return made[-1]

    def refuse(*a, **k):
        raise AssertionError("the tracer synchronised the device")

    monkeypatch.setattr(tracing, "ENV", True)
    monkeypatch.setattr(tracing, "time", clock)
    monkeypatch.setattr(tracing, "_event", event)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with tracing.span("p.first"):
        clock.now += 2.0
    with tracing.span("p.second"):
        clock.now += 1.0
    # neither end event has completed: nothing resolved, nothing waited on
    assert tracing.totals()["spans"] == {} and tracing.drain()["spans"] == {}
    made[0].done = made[1].done = True  # the first pair completes, the second's not
    got = tracing.totals()["spans"]
    assert set(got) == {"p.first"} and got["p.first"]["device_s"] == pytest.approx(2.0)
    for e in made:
        e.done = True
    got = tracing.drain()["spans"]
    assert set(got) == {"p.first", "p.second"}
    assert got["p.second"]["device_ms"] == pytest.approx(1000.0)


def test_a_span_left_by_an_exception_closes(monkeypatch):
    class WindowClosed(Exception):
        pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(WindowClosed):
            with tracing.span("x.request", 9):
                with tracing.span("x.forward"):
                    raise WindowClosed
        with tracing.span("x.after"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert {"x.request", "x.forward", "x.after"} <= set(names)
    assert tracing._stack() == []
    got = tracing.totals()["spans"]
    assert got["x.forward"]["parent"] == "x.request" and got["x.after"]["parent"] is None
    assert got["x.forward"]["id"] == 9 and got["x.request"]["calls"] == 1


class SlowDataset:
    """Eight samples, each made in ``delay`` seconds."""

    def __init__(self, delay):
        self.delay = delay

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        time.sleep(self.delay)
        return {"latents": np.full((2, 2), idx, np.float32)}


def test_loader_counts_its_gets_and_waits():
    before = {k: tracing.COUNTERS[k] for k in ("loader.get", "loader.empty", "loader.wait_ns")}
    it = iter(DataParallelLoader(SlowDataset(0.05), prefetch=2))
    first = next(it)  # the read-ahead thread has only started: a wait
    time.sleep(0.5)   # the queue fills
    rest = [next(it), next(it)]
    assert [int(b["latents"][0, 0, 0]) for b in [first] + rest] == [0, 1, 2]
    got = {k: tracing.COUNTERS[k] - v for k, v in before.items()}
    assert got["loader.get"] == 3
    assert 1 <= got["loader.empty"] < 3
    assert got["loader.wait_ns"] > 0


def test_launches_are_the_tracers_counters():
    _build.reset_launches()
    tracing.count("loader.get")
    kept = tracing.COUNTERS["loader.get"]
    _build.check(0, "K8")
    _build.check(0, "K8")
    _build.check(0, "K1")
    assert dict(_build.LAUNCHES) == {"K8": 2, "K1": 1}
    assert _build.LAUNCHES["K4"] == 0 and "K4" not in _build.LAUNCHES and "K8" in _build.LAUNCHES
    assert tracing.COUNTERS["launch.K8"] == 2
    assert tracing.drain()["counters"]["launch.K8"] == 2
    _build.reset_launches()
    assert not _build.LAUNCHES and tracing.COUNTERS["loader.get"] == kept


def test_training_cli_records_carry_every_span(monkeypatch, tmp_path):
    monkeypatch.setattr(tracing, "ENV", True)
    cli = _load_script("train_prfl_torch")
    cfg = load_config(os.path.join(REPO, "configs", "smoke_prfl.yaml"))
    cfg.dataset.meta_file_list = [os.path.join(REPO, p) for p in cfg.dataset.meta_file_list]
    cfg.dataset.null_dir = os.path.join(REPO, cfg.dataset.null_dir)
    cfg.save.output_dir = str(tmp_path)
    cfg.train.fixed_mid = 2
    cfg.train.sanity_check_interval = 0
    trainer = cli.build_trainer(cfg, "cpu")
    history = cli.run(trainer, 2)
    logged = [json.loads(x) for x in
              (tmp_path / "smoke_prfl" / "logs" / "log.txt").read_text().splitlines()]
    assert [h["step"] for h in logged] == [0, 1]
    for record, line in zip(history, logged):
        spans = record["trace"]["spans"]
        assert set(TRAIN_SPANS) <= set(spans), sorted(set(TRAIN_SPANS) - set(spans))
        assert spans["solver.model"]["calls"] == spans["solver.step"]["calls"] == record["mid"]
        assert spans["train.step"]["calls"] == 1 and spans["train.step"]["id"] == record["step"]
        assert spans["optimizer.clip"]["calls"] == 2  # the refl and the SFT update
        assert spans["optimizer.finite_guard"]["parent"] == "sft.optimizer"
        assert spans["prfl.rollout"]["parent"] == "train.step"
        assert spans["train.step"]["host_ms"] >= spans["prfl.backward"]["host_ms"] > 0
        assert line["trace"]["spans"].keys() == spans.keys()
    assert history[0]["trace"]["counters"]["loader.get"] == 1


def test_serving_request_has_one_dit_forward_a_step(monkeypatch):
    monkeypatch.setattr(tracing, "ENV", True)
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "latent_grid", lambda size, frame_num, sp_size=1: (3, 8, 8))
    cfg = wan_dit.tiny_test(dim=256, num_heads=2, ffn_dim=512, num_layers=2,
                            compute_dtype=torch.float32)
    model = wan_dit.init_params(wan_dit.WanModel(cfg), torch.Generator().manual_seed(0))
    ctx = torch.from_numpy(np.random.RandomState(6).randn(1, 16, 64).astype(np.float32))
    req = cli.Request(seed=7, context=ctx, context_null=torch.zeros_like(ctx), frame_num=9,
                      sample_steps=3)
    lat = cli.run_request(pipeline.WanT2V(model.eval()), req, "832*480")
    assert lat.shape == (1, 3, 8, 8, 16)
    spans = tracing.drain()["spans"]
    assert spans["serve.request"]["calls"] == 1 and spans["serve.request"]["id"] == 7
    assert spans["dit.forward"]["calls"] == spans["solver.step"]["calls"] == 3
    assert spans["dit.forward"]["parent"] == "solver.model"
    assert spans["solver.step"]["parent"] == "serve.request"
    assert spans["serve.request"]["host_ms"] >= spans["dit.forward"]["host_ms"] > 0
