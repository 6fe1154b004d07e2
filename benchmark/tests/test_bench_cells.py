"""Each cell's whole run on the CPU at a tiny size, the look for a card
skipped: correct with the program as it is, and not correct with the
timed path broken underneath (a step that leaves its state unchanged,
half of the CFG batch left out, an answer altered where it is made) or
with the cell's control in the program's place."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, measure

PRFL, SERVE = "prfl_t2v1.3b_480p81", "serve_t2v1.3b_480p81"


def _failed(result):
    return sorted(c.name for c in result["checks"] if not c.ok)


@pytest.mark.parametrize("name", [PRFL, SERVE])
def test_cell_is_correct(tiny, name):
    result = measure(tiny(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in tiny(name).end_to_end}


@pytest.mark.parametrize("name, fault, caught", [
    (PRFL, "state", "change"), (PRFL, "answer", "chain_x"), (SERVE, "answer", "chain_x"),
    (SERVE, "half", "model_v")])
def test_fault_is_caught(tiny, name, fault, caught):
    result = measure(tiny(name), fault=fault)
    assert not result["correct"] and caught in _failed(result), result["checks"]


@pytest.mark.parametrize("name, caught", [(PRFL, "rollout_v"), (SERVE, "model_v")])
def test_control_is_not_correct(tiny, name, caught):
    """The control, the reference in fp8 in the program's place, at TINY
    widths: it fails the forward's number, and the program's own reading
    in the same run passes it."""
    result = measure(tiny(name), seconds=0, control=True)
    assert not result["correct"] and _failed(result) == [caught], result["checks"]
    limit = next(c.limit for c in result["checks"] if c.name == caught)
    assert result["values"]["sound." + caught] <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("name", [PRFL, SERVE])
def test_control_is_not_correct_on_the_card(name):
    """The control at the cells' published sizes, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the published sizes")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
                          "--seed", "0", "--seconds", "0", "--control",
                          "--calibrate", "2147483811,2147483812,2147483813"],
                         capture_output=True, text=True, cwd=ROOT, timeout=2400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith('{"calibrate"')]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)


def test_no_jax_module_is_loaded():
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest, run; "
            "from harness import common, train_prfl, serve, reference, devtrace; "
            "import hyvideo_prfl_torch.training.prfl, hyvideo_prfl_torch.pipelines.pipeline; "
            "common.load_script('train_prfl_torch'); common.load_script('inference_torch'); "
            "print(common.forbidden_loaded())" % (os.path.join(BENCH, "tests"), BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", SERVE,
                          "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.gpu
@pytest.mark.parametrize("name", [PRFL, SERVE])
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their published sizes")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
                          "--seed", "2147483801", "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
