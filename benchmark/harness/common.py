"""What every cell of the benchmark shares: the cell's files found by name,
the seeds of its draws, the device's description, the card's clocks, the
check that no JAX module was loaded, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its
configuration is the file its ``configs`` entry names; its traffic mix is
``benchmark/traffic/<traffic>.json``, which names the kind of run (a
module of this folder: ``train_prfl``, ``serve``), its
shapes, its recipe and its limits; each per-layer metric is read by
``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
from typing import Any, Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "hyvideo_prfl_tpu")
GIB = 1024 ** 3


class Failure(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


# ---------------------------------------------------------------- the files

def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict       # the configuration file
    traffic_name: str
    traffic: dict      # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files, and the metrics
    it reports (an end-to-end or per-layer metric with a ``workloads`` list
    that leaves it out is not its)."""
    spec = spec or benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise Failure(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(os.path.join(ROOT, conf["file"])),
                traffic_name=w["traffic"],
                traffic=load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json")),
                end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read`` of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_script(name: str):
    """A CLI of the program (scripts/<name>.py) as a module."""
    path = os.path.join(ROOT, "scripts", name + ".py")
    if not os.path.isfile(path):
        raise Failure(f"the program's {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


WIDTHS = ("dim", "ffn_dim", "num_heads", "num_layers", "freq_dim", "text_dim", "in_dim",
          "out_dim")


def same_widths(program_cfg, config: dict, layers: Optional[int] = None) -> None:
    """The program's model is the configuration's (``layers``: a tower's
    depth in place of the configuration's)."""
    want = {k: config[k] for k in WIDTHS}
    if layers is not None:
        want["num_layers"] = layers
    got = {k: getattr(program_cfg, k) for k in WIDTHS}
    if got != want or list(program_cfg.patch_size) != list(config["patch_size"]):
        raise Failure(f"the program builds {got}, the configuration says {want}")


# ---------------------------------------------------------------- seeds

def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of one run."""
    text = "/".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


# ---------------------------------------------------------------- the device

def check_devices(chips: int, device: str) -> None:
    import torch

    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is false: this benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise Failure(f"the cell needs {chips} cards; {torch.cuda.device_count()} are visible")


def nvidia_smi(fields: str) -> Optional[List[str]]:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--id=0",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    return [f.strip() for f in r.stdout.strip().splitlines()[0].split(",")]


def device_info(device: str, chips: int, peak_bytes: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    row = nvidia_smi("power.limit")
    if row:
        try:
            out["power_limit_w"] = float(row[0])
        except ValueError:
            pass
    return out


class ClockSampler:
    """The card's SM clock, power draw and utilization, read by nvidia-smi
    about once a second on a thread between start() and stop() (the
    program's scripts/gpu_clocks_torch.py, at a lower rate, so that its
    processes take little from the run)."""

    FIELDS = "clocks.sm,power.draw,utilization.gpu"

    def __init__(self, period: float = 1.0):
        self.period, self.reads = period, []
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        while not self._stop.wait(self.period):
            row = nvidia_smi(self.FIELDS)
            if row is not None:
                self.reads.append(row)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        busy = []
        for row in self.reads:
            try:
                clock, power, util = map(float, row[:3])
            except ValueError:
                continue
            if util >= 50:
                busy.append((clock, power))
        out = {"reads": len(self.reads), "busy_reads": len(busy)}
        if busy:
            out.update(sm_clock_mhz_median=statistics.median(c for c, _ in busy),
                       sm_clock_mhz_min=min(c for c, _ in busy),
                       power_w_median=statistics.median(p for _, p in busy))
        return out


# ---------------------------------------------------------------- guards

def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------- checks

@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = sorted(set(limits) - set(values))
    if missing:
        raise Failure(f"no reading for the checks {missing}")
    return [Check(n, float(values[n]), float(limits[n])) for n in limits]


def worst_leaf_gap(got: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> float:
    """max over the leaves of |got - ref| / max(ref's norm of the leaf, the
    median leaf's ref norm): the gap between the program's norm of a leaf
    and the reference's, relative to the larger of the two norms of the
    reference."""
    names = leaves if leaves is not None else sorted(ref)
    med = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def moved_leaves(grad_ref: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under AdamW by round-off alone."""
    med = statistics.median(grad_ref.values())
    return sorted(n for n, g in grad_ref.items() if g >= 1e-3 * med)


# ---------------------------------------------------------------- the result

def emit(result: dict, checks: List[Check], clocks: Optional[dict] = None,
         phases: Optional[dict] = None) -> None:
    """The clocks' and phases' line, the checks on stderr's last lines, and
    the result as stdout's last line, its ``checks`` key last."""
    if clocks is not None or phases is not None:
        print(json.dumps({"clocks": clocks, "phases_s": phases}), flush=True)
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print(json.dumps(result), flush=True)


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads: the traced window (``trace``;
    None untraced), the steps in it, the work one step needs (work.Work)
    and the program's history of those steps."""

    steps: int
    trace: Any
    work: Any
    history: List[dict]
