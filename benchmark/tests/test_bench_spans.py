"""The readers of the program's spans (benchmark/metrics/<name>.py, source
``program_span``): None without the tracer, without totals or without a
span they read, and their arithmetic on fixed totals."""

import sys

import pytest

from harness import common

# each reader and the spans it reads
READS = {"prfl.rollout_s": ("prfl.rollout",),
         "prfl.forward_s": ("prfl.forward", "prfl.lrm", "sft.forward"),
         "prfl.backward_s": ("prfl.backward", "sft.backward"),
         "prfl.optimizer_ms": ("prfl.optimizer", "sft.optimizer"),
         "loader_wait_ms.train": ("train.batch",),
         "pipeline_ms.sample": ("serve.request", "dit.forward")}
READERS = tuple(READS)
# device and host seconds over 2 traced steps
TOTALS = {"prfl.rollout": 18.0, "prfl.forward": 1.0, "prfl.lrm": 0.5, "sft.forward": 0.7,
          "prfl.backward": 6.0, "sft.backward": 2.0, "prfl.optimizer": 0.1,
          "sft.optimizer": 0.06, "train.batch": 0.008, "serve.request": 1.9,
          "dit.forward": 1.8}
WANT = {"prfl.rollout_s": 9.0, "prfl.forward_s": 1.1, "prfl.backward_s": 4.0,
        "prfl.optimizer_ms": 80.0, "loader_wait_ms.train": 4.0, "pipeline_ms.sample": 50.0}


def _readings():
    return common.Readings(steps=2, trace=None, work=None, history=[])


def _totals(spans):
    return {"spans": {n: {"calls": 1, "host_s": s, "self_host_s": s, "device_s": s,
                          "self_device_s": s} for n, s in spans.items()},
            "counters": {}}


@pytest.mark.parametrize("name", READERS)
def test_span_reader_arithmetic(monkeypatch, name):
    from hyvideo_prfl_torch.utils import tracing

    monkeypatch.setattr(tracing, "totals", lambda: _totals(TOTALS))
    assert common.metric_reader(name)(_readings()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_span_reader_gives_none_without_what_it_reads(monkeypatch, name):
    from hyvideo_prfl_torch.utils import tracing

    read = common.metric_reader(name)
    monkeypatch.setattr(tracing, "totals", lambda: _totals({}))
    assert read(_readings()) is None
    # each span it reads missing in turn, or without device times (a CPU run)
    for gone in TOTALS:
        monkeypatch.setattr(tracing, "totals",
                            lambda: _totals({n: s for n, s in TOTALS.items() if n != gone}))
        value = read(_readings())
        if gone in READS[name]:
            assert value is None, gone
        else:
            assert value == pytest.approx(WANT[name])
    host_only = _totals(TOTALS)
    for row in host_only["spans"].values():
        del row["device_s"], row["self_device_s"]
    monkeypatch.setattr(tracing, "totals", lambda: host_only)
    assert (read(_readings()) is None) == (name != "loader_wait_ms.train")
    # a program without the tracer (the parent of the commit that added it)
    monkeypatch.delattr(sys.modules["hyvideo_prfl_torch.utils"], "tracing")
    monkeypatch.setitem(sys.modules, "hyvideo_prfl_torch.utils.tracing", None)
    assert read(_readings()) is None
