"""The device trace of a window: torch.profiler over the CPU and the card,
reduced to device time by kernel group, the union of the device's busy
intervals, and the idle gaps named by what the host was doing in them.

The groups are a frozen copy of the program's table
(scripts/profile_torch_step.py ``GROUPS``): a kernel-name fragment to the
kernel it belongs to, the first match winning.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Tuple

GROUPS = (("flash_fwd_kernel<false, true>", "K1"),
          ("flash_fwd_kernel<false, false>", "K3"),
          ("flash_fwd_kernel<true, true>", "K2"),
          ("flash_fwd_kernel<true, false>", "K3s"),
          ("::rope_kernel<", "R"),
          ("flash_fwd_qk8_kernel", "K10"),
          ("flash_bwd_merged_kernel", "K4"),
          ("flash_bwd_prologue_kernel<true>", "K5"),
          ("flash_bwd_prologue_kernel", "K4"),
          ("flash_bwd_dkv_kernel", "K5"),
          ("flash_bwd_dq_kernel", "K5"),
          ("rmsnorm_rope_kernel", "K6"),
          ("rmsnorm_rope_bwd_kernel", "K7"),
          ("ln_scale_shift_kernel", "K8"),
          ("ln_scale_shift_bwd_kernel", "K9"),
          ("gemm", "GEMM"), ("sm90_xmma", "GEMM"), ("cutlass", "GEMM"),
          ("nvjet", "GEMM"))
ATTN_FWD = ("K1", "K2", "K3", "K3s", "K10")
ATTN_BWD = ("K4", "K5")


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag.lower() in low), "other")


@dataclasses.dataclass
class Trace:
    window_s: float                  # the traced window's length
    busy_s: float                    # union of the device's intervals in it
    group_s: Dict[str, float]        # summed kernel time by group
    kernels: int
    idle_gaps: List[Tuple[str, float]]  # summed gap seconds by the host op open

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s) if self.window_s > 0 else 0.0

    def group_sum(self, groups) -> float:
        return sum(self.group_s.get(g, 0.0) for g in groups)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.group_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:top]]}


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event recorded."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == cuda, e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in raw]
    except AttributeError:
        out = []
        for e in prof.events():
            dev = e.device_type == cuda
            out.append((e.name, dev, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
        return out


def traced(fn: Callable[[], object], sync: Callable[[], None]):
    """Run ``fn`` under torch.profiler (CPU and CUDA activity) -> (its
    result, Trace of the window from its start to the end of its device
    work)."""
    import time

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window = time.perf_counter() - t0
    return result, reduce(_events(prof), window)


def reduce(events, window_s: float) -> Trace:
    dev = sorted((s, e, n) for n, is_dev, s, e in events if is_dev and e > s)
    host = [(s, e, n) for n, is_dev, s, e in events if not is_dev and e > s]
    groups: Dict[str, float] = {}
    kernels = 0
    for s, e, n in dev:
        if n.startswith(("Memcpy", "Memset")):
            continue
        kernels += 1
        g = group_of(n)
        groups[g] = groups.get(g, 0.0) + (e - s) * 1e-9
    # the window on the trace's clock: from the first host event to the last
    # device or host event
    starts = [s for s, _, _ in host] + [s for s, _, _ in dev]
    ends = [e for _, e, _ in host] + [e for _, e, _ in dev]
    lo = min(starts) if starts else 0
    hi = max(ends) if ends else 0
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
    named: Dict[str, float] = {}
    host.sort()
    # each gap is named by the innermost host event open at its middle: the
    # latest-starting one that has not ended (a sweep over the events)
    active: list = []
    j = 0
    for gs, ge in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (gs + ge) // 2
        while j < len(host) and host[j][0] <= mid:
            s, e, n = host[j]
            heapq.heappush(active, (-s, e, n))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "host: no op"
        named[name] = named.get(name, 0.0) + (ge - gs) * 1e-9
    trace_window = max(window_s, (hi - lo) * 1e-9) if hi > lo else window_s
    return Trace(window_s=trace_window, busy_s=busy * 1e-9, group_s=groups, kernels=kernels,
                 idle_gaps=sorted(named.items(), key=lambda kv: -kv[1]))
