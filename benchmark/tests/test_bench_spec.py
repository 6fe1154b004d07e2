"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import os
import re

import pytest

from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = common.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, [w["name"] for w in SPEC["workloads"]],
                  [c["name"] for c in SPEC["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_metric_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        # each listed cell reports the metric it moves
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or m["unit"] == "%":
            assert m["unit"] == "%"
    for w in cells:  # setup_s, another end-to-end metric and a per-layer one
        assert sum(w in m.get("workloads", cells) for m in SPEC["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(name):
    cell = common.cell(name)
    assert cell.traffic["kind"] in ("train_prfl", "serve")
    assert os.path.isfile(os.path.join(common.BENCH, "harness", cell.traffic["kind"] + ".py"))
    for m in cell.per_layer:
        assert callable(common.metric_reader(m["name"]))
    assert cell.traffic["limits"] and all(v >= 0 for v in cell.traffic["limits"].values())
    if "recipe" in cell.traffic:
        assert os.path.isfile(os.path.join(common.BENCH, "recipes", cell.traffic["recipe"]))
    conf = next(c for c in SPEC["configs"] if c["name"] == cell.config_name)
    assert conf["file"].startswith("benchmark/") and cell.config["source"] == conf["source"]
    assert cell.config["reduced"] == conf["reduced"]
