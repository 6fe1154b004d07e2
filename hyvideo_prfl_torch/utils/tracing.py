"""The port's spans and counters: one registry, on the profiler's clock.

    from hyvideo_prfl_torch.utils import tracing

    with tracing.span("train.step", step):  # a root span, with its step
        with tracing.span("prfl.rollout"):
            ...
    tracing.count("loader.empty")

A span records its name, its parent (the span open on this thread when it
began), the outer step or request it belongs to (given to a root span,
inherited by its children), its host duration and, on CUDA, its device
interval: a pair of timing events recorded on the current stream at entry
and exit. Its self time, on the host and on the device, is its duration
less the parts its child spans cover.

Counters always count: an increment of a Counter. Spans record only while
tracing is on, that is while a torch.profiler records or under
``HYV_TRACE=1`` (read at import into ``ENV``). Off, a span costs that one
check: no CUDA event and no profiler range. On, each span also opens a
profiler range of its name (``_RecordFunctionFast``: an op's scope, not a
user annotation, so the profiler mirrors no range onto the device's
timeline), which lies in the profiler's timeline on the clock of the CUDA
kernels and names the device's idle gaps inside it.

The tracer never synchronises. An event pair is resolved
(``elapsed_time``) once its end event has completed (``query()``), in the
order the spans ended; a pair not yet complete waits for a later span's
exit, ``totals()`` or ``drain()``. Only running totals per span name are
kept (calls, host, device and self seconds), so memory stays bounded
however long a run is: ``totals()`` holds them since tracing came on in
this process, ``drain()`` what was added since the last drain, in
milliseconds, with the counters' increments (the CLIs log it).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from collections.abc import Mapping
from typing import Dict

import torch

ENV = os.environ.get("HYV_TRACE", "") == "1"
COUNTERS: collections.Counter = collections.Counter()

_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()
_pending: collections.deque = collections.deque()  # ended spans, device pair unresolved
_totals: Dict[str, dict] = {}
_drained: Dict[str, dict] = {}
_counted = collections.Counter()  # COUNTERS at the last drain


def enabled() -> bool:
    return ENV or _profiling()


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


class Counts(Mapping):
    """The counters whose names start with ``prefix``, keyed by the rest of
    the name; a missing one reads 0, and ``clear()`` drops them."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def _names(self):
        return [k for k in COUNTERS if k.startswith(self.prefix)]

    def __getitem__(self, key):
        return COUNTERS.get(self.prefix + key, 0)

    def __contains__(self, key):
        return self.prefix + key in COUNTERS

    def __iter__(self):
        return iter([k[len(self.prefix):] for k in self._names()])

    def __len__(self):
        return len(self._names())

    def clear(self) -> None:
        for k in self._names():
            del COUNTERS[k]


def _event():
    """A timing event recorded on the current CUDA stream; None where this
    process has not initialised CUDA."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "ident", "parent", "host", "device", "child_host", "child_device",
                 "_t0", "_events", "_range")

    def __init__(self, name: str, ident):
        self.name, self.ident, self.device = name, ident, None
        self.child_host = self.child_device = 0.0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.ident is None and self.parent is not None:
            self.ident = self.parent.ident
        stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._events = (_event(),)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host = time.perf_counter() - self._t0
        self._events += (_event(),)
        self._range.__exit__(*exc)
        stack = _stack()
        stack.remove(self)
        if self.parent is not None:
            self.parent.child_host += self.host
        _pending.append(self)
        _resolve()
        return False


def span(name: str, ident=None):
    """A context manager timing ``name``; ``ident`` the outer step or
    request of a root span (a child inherits its parent's)."""
    if not (ENV or _profiling()):
        return _OFF
    return _Span(name, ident)


def _resolve() -> None:
    """Fold the ended spans into the totals, in the order they ended, up to
    the first whose end event has not completed."""
    while _pending:
        s = _pending[0]
        start, end = s._events
        if start is not None and end is not None:
            if not (end.query() and start.query()):
                return
            s.device = start.elapsed_time(end) * 1e-3
            if s.parent is not None:
                s.parent.child_device += s.device
        _pending.popleft()
        s._events = None
        for table in (_totals, _drained):
            row = table.setdefault(s.name, {"calls": 0, "host_s": 0.0, "self_host_s": 0.0})
            row["calls"] += 1
            row["host_s"] += s.host
            row["self_host_s"] += s.host - s.child_host
            if s.device is not None:
                row["device_s"] = row.get("device_s", 0.0) + s.device
                row["self_device_s"] = row.get("self_device_s", 0.0) + s.device - s.child_device
            row["parent"] = s.parent.name if s.parent is not None else None
            row["id"] = s.ident


def totals() -> dict:
    """{"spans": {name: {calls, host_s, self_host_s[, device_s, self_device_s],
    parent, id}}, "counters": {name: n}}: the spans resolved since tracing
    came on in this process (``id``: the latest call's step or request),
    and every counter."""
    _resolve()
    return {"spans": {n: dict(row) for n, row in _totals.items()},
            "counters": dict(COUNTERS)}


def drain() -> dict:
    """What was added since the last drain: the spans resolved, their times
    in milliseconds (``host_ms``, ``self_host_ms``, ``device_ms``,
    ``self_device_ms``), and the counters' increments."""
    global _drained, _counted
    _resolve()
    spans = {}
    for n, row in _drained.items():
        spans[n] = {k: v for k, v in row.items() if not k.endswith("_s")}
        spans[n].update((k[:-2] + "_ms", v * 1e3) for k, v in row.items() if k.endswith("_s"))
    counters = {k: v - _counted.get(k, 0) for k, v in COUNTERS.items()
                if v != _counted.get(k, 0)}
    _drained, _counted = {}, collections.Counter(COUNTERS)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget the spans' totals and the pairs pending; counters stay."""
    global _drained
    _pending.clear()
    _totals.clear()
    _drained = {}
