"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the
cards the cell asks for. The cell, its configuration, its traffic mix and
its metrics are found by name from ``BENCHMARK.json``; the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number compared with its limit,
which also close standard error. The line before it holds the card's
clocks and power over the run.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when the program is missing, or when a module of JAX or
of the JAX package was loaded.

Three options serve the calibration of the limits and are not part of a
measured run: ``--control`` runs the cell's control (the reference in
fp8 in the program's place at the forwards the run checks; only those
numbers are compared), ``--fault`` plants a fault in the program
(harness/faults.py), and ``--calibrate a,b,...`` reads the compared
numbers for each seed in one process, without a measured window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# build and kernel caches of the program at fixed paths in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path[:0] = [ROOT, BENCH]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, choices=("state", "answer", "half"))
    p.add_argument("--calibrate", default=None)
    return p.parse_args(argv)


def measure(args, device: str = "cuda", cell=None) -> dict:
    """One run of the cell -> the result line's object (``checks`` holds
    the Check list)."""
    import importlib

    from harness import common

    cell = cell or common.cell(args.workload)
    common.check_devices(cell.chips, device)
    kind = importlib.import_module("harness." + cell.traffic["kind"])
    clocks = common.ClockSampler().start() if device == "cuda" else None
    restore = None
    if args.fault:
        from harness import faults

        restore = faults.plant(args.fault, cell.traffic["kind"])
    try:
        out = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, args.control)
    finally:
        clock_summary = clocks.stop() if clocks is not None else None
        if restore is not None:
            restore()
    limits = cell.traffic["limits"]
    if args.control:
        limits = {k: v for k, v in limits.items() if k in out["values"]}
    checks = common.checks_from(out["values"], limits)
    win = out["window"]
    total = time.perf_counter() - T0
    phases = {"total": total}
    if win is not None:
        phases.update(setup=win.start - T0, window=win.wall_s,
                      after_window=total - (win.start - T0) - win.wall_s)
    result = {"correct": all(c.ok for c in checks), "clocks": clock_summary,
              "phases": phases, "checks": checks, "values": out["values"]}
    if win is None:
        return result
    history = win.history
    failed = out.get("failed", sum(1 for h in history
                                   if any(v != v for v in h.values() if isinstance(v, float))))
    setup_s = win.start - T0
    from harness import training

    readings = common.Readings(win.steps, win.trace, out["work"], history)
    metrics = training.metrics_of(cell, win, setup_s, win.wall_s / max(win.steps, 1), readings)
    result.update(attempted=win.steps, failed=int(failed), metrics=metrics,
                  device=common.device_info(device, cell.chips, win.peak_bytes))
    if win.trace is not None:
        result["device"].update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
        result["breakdown"] = win.trace.breakdown()
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from harness import common
    except ImportError:
        traceback.print_exc()
        return 2
    try:
        if args.calibrate:
            return calibrate(args)
        result = measure(args)
    except common.Failure as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 3
    except Exception:  # noqa: BLE001 -- any failure of a run ends it with no result
        traceback.print_exc()
        return 1
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"benchmark: modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr, flush=True)
        return 4
    checks, clocks, phases = result.pop("checks"), result.pop("clocks"), result.pop("phases")
    print(json.dumps({"values": result.pop("values")}), file=sys.stderr, flush=True)
    common.emit({k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                        "breakdown") if k in result}, checks, clocks, phases)
    return 0


def calibrate(args) -> int:
    """The compared numbers of several seeds, one JSON line each."""
    from harness import common

    for seed in [int(s) for s in args.calibrate.split(",")]:
        t0 = time.perf_counter()
        one = argparse.Namespace(**{**vars(args), "seed": seed, "seconds": 0, "trace": 0})
        result = measure(one)
        print(json.dumps({"calibrate": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "seconds": time.perf_counter() - t0,
                          "values": result["values"],
                          "correct": result["correct"]}), flush=True)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
