"""The benchmark's CPU tests: the harness at a tiny size on the CPU, with
the program's plain paths in place of its kernels."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

# widths of a model that runs in seconds on the CPU, with the 8 blocks the
# reward tower reads
TINY = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=8, freq_dim=32, text_dim=32)
# limits at TINY widths: the cells' own are set from readings at the
# published widths, where bf16 lies closer to fp32 than at width 64 (the
# first gradient's worst leaf reads 0.05-0.08 here, 0.002-0.03 there)
TINY_LIMITS = {"grad": 0.15, "change": 0.35, "rollout_v": 0.02}


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at TINY widths and a few tokens."""
    from harness import common

    c = common.cell(name)
    c.config = {**c.config, **TINY}
    t = copy.deepcopy(c.traffic)
    t["caption_tokens"], t["null_tokens"] = [3, 5, 7, 9], 4
    if t["kind"] == "serve":
        # the serving CLI takes its named sizes: one frame of 832*480
        t["video"] = {"frames": 1, "height": 480, "width": 832}
        t["steps"] = 6
    else:
        t["video"] = {"frames": 5, "height": 32, "width": 48}
        t["changes"]["model.override"] = dict(TINY)
    t["limits"] = {k: TINY_LIMITS.get(k, v) for k, v in t["limits"].items()}
    c.traffic = t
    return c


@pytest.fixture
def tiny(monkeypatch):
    """tiny(name) -> the tiny cell; the serving CLI builds TINY models."""
    import torch

    from harness import common

    torch.set_num_threads(min(4, torch.get_num_threads()))
    load = common.load_script

    def load_tiny(name):
        mod = load(name)
        if hasattr(mod, "dit_config_for_task"):
            orig = mod.dit_config_for_task
            mod.dit_config_for_task = lambda task, **kw: orig(task, **{**TINY, **kw})
        return mod

    monkeypatch.setattr(common, "load_script", load_tiny)
    return tiny_cell


def measure(cell, seed=3000000001, seconds=2.0, trace=0, control=False, fault=None):
    """One run of ``cell`` on the CPU -> run.measure's result."""
    import run

    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + (["--control"] if control else []) + (
        ["--fault", fault] if fault else [])
    return run.measure(run.parse(argv), device="cpu", cell=cell)
