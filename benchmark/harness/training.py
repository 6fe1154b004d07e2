"""The training side of the cells: the trainer's recipe (a frozen copy of
a published YAML with the traffic's changes), the seeded draws handed to
both sides, the program's numbers that the reference is held to (the
first gradient as the optimizer got it, the parameters' change), the
comparison, and, for every cell, the timed window over the program's own
loop and the metrics read from it.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from . import common, devtrace as tr, reference as R
from .common import sub_seed


def recipe(traffic: dict, changes: dict):
    """benchmark/recipes/<recipe> read by the program's config reader, with
    the traffic's changes and ``changes`` ({"section.key": value}) on top."""
    from hyvideo_prfl_torch.configs import load_config

    config = load_config(os.path.join(common.BENCH, "recipes", traffic["recipe"]))
    for path, value in {**traffic["changes"], **changes}.items():
        *parents, leaf = path.split(".")
        node = config
        for part in parents:
            node = node.setdefault(part, type(config)())
        node[leaf] = value
    return config


class Draws:
    """The random inputs of each step, from the run's seed: the benchmark
    makes them and hands the same to the program and the reference."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, torch.device(device)

    def gen(self, *tags, host=False) -> torch.Generator:
        dev = "cpu" if host else self.device
        return torch.Generator(device=dev).manual_seed(sub_seed(self.seed, *tags))

    def normal(self, shape, *tags) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen(*tags), device=self.device)

    def flow_match(self, k: int, shape, n_train: int = 1000):
        """An SFT step's (t [1], sigma [1], noise): a uniform training
        timestep and a normal draw."""
        idx = int(torch.randint(0, n_train, (1,), generator=self.gen("t", k, host=True)))
        sig = R.train_sigmas(n_train)
        t = torch.tensor([sig[idx] * n_train], dtype=torch.float32)
        return t, torch.tensor([float(sig[idx])]), self.normal(shape, "noise", k)


def leaf_norms(tensors: List[torch.Tensor], names: List[str], scale=1.0) -> Dict[str, float]:
    norms = torch.stack([t.detach().float().norm() for t in tensors]).cpu().tolist()
    return {n: v * scale for n, v in zip(names, norms)}


def first_grad(state, b1: float) -> Dict[str, float]:
    """The first gradient as the optimizer got it, from its state after one
    update: the first moment is (1 - b1) g."""
    return leaf_norms(state.opt_state["mu"], state.names, 1.0 / (1.0 - b1))


@torch.no_grad()
def change(state, P0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each trained leaf's distance from its first value."""
    out = {}
    for n, p in zip(state.names, state.params):
        out[n] = float((p.detach().float() - P0[n]).norm())
    return out


@dataclasses.dataclass
class Window:
    steps: int
    start: float  # perf_counter at the window's start
    wall_s: float
    history: List[dict]
    peak_bytes: int
    trace: Optional[tr.Trace] = None


def window(run: Callable[[int], List[dict]], steps: int, device: str, traced: bool) -> Window:
    """``steps`` steps through the CLI's own loop, timed from the call to the
    end of its device work; the peak memory of the window alone."""
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else (lambda: None)
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace = None
    if traced:
        history, trace = tr.traced(lambda: run(steps), sync)
    else:
        history = run(steps)
        sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return Window(steps, t0, wall, history, peak, trace)


def free(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def steps_for(seconds: float, step_s: float) -> int:
    """Whole steps that last about ``seconds``."""
    return max(1, int(round(seconds / max(step_s, 1e-9))))


def compare(prog: dict, ref: dict, first: int) -> Dict[str, float]:
    """The training numbers: the largest relative gap of the first ``first``
    losses (the followed steps log them in order), and
    the worst leaf's gap of the first gradient and of the change over the
    followed steps (leaves whose reference gradient rounds to nought in any
    step left out of the change)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    loss = max(gaps[:first])
    kept = set(ref["grads"][0])
    for g in ref["grads"]:
        kept &= set(common.moved_leaves(g))
    diag = {f"diag.loss{i}": [p, r, g]
            for i, (p, r, g) in enumerate(zip(prog["losses"], ref["losses"], gaps))}
    diag["diag.kept"] = [len(kept), len(ref["change"])]
    for key, got, want in (("grad", prog["grad"], ref["grads"][0]),
                           ("change", prog["change"], ref["change"])):
        med = sorted(want.values())[len(want) // 2]
        gaps = sorted(((abs(got[n] - want[n]) / max(want[n], med, 1e-30), n) for n in want),
                      reverse=True)[:4]
        diag[f"diag.worst_{key}"] = [[n, g, got[n], want[n]] for g, n in gaps] + [["median", med]]
    return {"loss": loss,
            "grad": common.worst_leaf_gap(prog["grad"], ref["grads"][0]),
            "change": common.worst_leaf_gap(prog["change"], ref["change"], sorted(kept)), **diag}


def metrics_of(cell: common.Cell, win: Window, setup_s: float, per_step: float,
               readers_ctx) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer ones (traced)."""
    if win.trace is None:
        out = {}
        for m in cell.end_to_end:
            # every s/step metric is the window's wall over its steps
            value = {"setup_s": setup_s, "peak_mem_gib": win.peak_bytes / common.GIB}.get(
                m["name"], per_step if m["unit"] == "s/step" else None)
            if value is None:
                raise common.Failure(f"no reading for the end-to-end metric {m['name']}")
            out[m["name"]] = common.metric(value, m["unit"])
        return out
    out = {}
    for m in cell.per_layer:
        value = common.metric_reader(m["name"])(readers_ctx)
        if value is not None:
            out[m["name"]] = common.metric(value, m["unit"])
    return out
