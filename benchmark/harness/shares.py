"""The per-layer shares that several metrics read, each in its cells
(``benchmark/metrics/<name>.py`` names the one it reads). Each returns
None where the run has nothing to read, never 0. Percent.

- ``roofline``: a kernel group's share of its roofline: the least time the
  card could take for the calls of that kind the traced steps need
  (harness/work.py: attention 4 B H Lq Lk D operations a forward call, 10
  a backward call; 2 M K N a product at the peak of its type, bf16 or
  fp32; or the call's bytes at 3.35 TB/s; each forward and backward once,
  no recomputation) over the group's device time in the trace.
- ``idle``: the share of the traced window in which no kernel or copy ran
  on the card, 1 - (union of the device's intervals) / (window).
- ``mfu``: the whole step's share of the card's peak: the operations the
  traced steps need over the traced window times 989 TFLOP/s (bf16, dense).
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import work


def roofline(r, groups: Sequence[str], need: str) -> Optional[float]:
    """``need``: the Work field of the group's least time (``attn_fwd_s``,
    ``attn_bwd_s``, ``gemm_s``)."""
    if r.trace is None:
        return None
    spent = r.trace.group_sum(tuple(groups))
    if spent <= 0:
        return None
    return 100.0 * getattr(r.work, need) * r.steps / spent


def idle(r) -> Optional[float]:
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * r.trace.idle_share


def mfu(r) -> Optional[float]:
    if r.trace is None or r.trace.window_s <= 0 or r.steps <= 0:
        return None
    return 100.0 * r.work.flops * r.steps / (r.trace.window_s * work.PEAK["bf16"])
