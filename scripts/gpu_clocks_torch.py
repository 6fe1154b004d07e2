"""The card's SM clock, power draw and clock-event reasons while a command runs.

    python3 scripts/gpu_clocks_torch.py [--label NAME] -- <command> [arguments]

Reads ``nvidia-smi`` over and over (about every 50-100 ms; each read is one
``nvidia-smi`` process) while the command runs, then prints one JSON line:
the label, the command's exit code and wall seconds, and, over the reads at
which the card was busy (utilization >= 50%), the SM clock's median,
minimum and maximum (MHz), the median power draw (W), and each clock-event
reason seen (a software power cap, a thermal slowdown, ...) with the number
of busy reads that showed it. Exits with the command's exit code.
``ClockSampler`` does the same around a stretch of code in one process.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

FIELDS = "clocks.sm,power.draw,utilization.gpu"
# the reasons' field, by its current name and by the one older drivers use
REASON_FIELDS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting", 0x4: "sw_power_cap",
           0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal_slowdown",
           0x40: "hw_thermal_slowdown", 0x80: "hw_power_brake_slowdown",
           0x100: "display_clock_setting"}


def _query(fields: str) -> list[str] | None:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--id=0",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True)
    if r.returncode != 0 or not r.stdout.strip():
        return None
    return [f.strip() for f in r.stdout.strip().splitlines()[0].split(",")]


class ClockSampler:
    """Reads the card's clock, power, utilization and clock-event reasons in a
    thread between start() and stop(); summary() condenses the reads."""

    def __init__(self):
        self.fields = next((FIELDS + "," + rf for rf in REASON_FIELDS
                            if _query(FIELDS + "," + rf) is not None), FIELDS)
        self.reads: list[list[str]] = []
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        while not self._stop.is_set():
            row = _query(self.fields)
            if row is not None:
                self.reads.append(row)

    def start(self) -> "ClockSampler":
        self.reads = []
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        return self.summary()

    def summary(self) -> dict:
        busy = []
        for row in self.reads:
            try:
                clock, power, util = float(row[0]), float(row[1]), float(row[2])
            except ValueError:
                continue
            if util >= 50:
                reasons = int(row[3], 16) if len(row) > 3 and row[3].startswith("0x") else None
                busy.append((clock, power, reasons))
        out = {"reads": len(self.reads), "busy_reads": len(busy)}
        if busy:
            clocks = [c for c, _, _ in busy]
            out.update(sm_clock_mhz_median=statistics.median(clocks),
                       sm_clock_mhz_min=min(clocks), sm_clock_mhz_max=max(clocks),
                       power_w_median=statistics.median(p for _, p, _ in busy))
            if all(r is not None for _, _, r in busy):
                out["reasons_busy_reads"] = {
                    name: sum(1 for _, _, r in busy if r & bit)
                    for bit, name in REASONS.items() if any(r & bit for _, _, r in busy)}
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        p.error("no command given")
    sampler = ClockSampler().start()
    t0 = time.perf_counter()
    rc = subprocess.run(cmd).returncode
    wall = time.perf_counter() - t0
    summary = sampler.stop()
    print(json.dumps({"clocks": args.label, "rc": rc, "wall_s": wall, **summary}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
