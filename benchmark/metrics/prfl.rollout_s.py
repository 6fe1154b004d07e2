"""prfl.rollout_s: the no-grad rollout's device time a step: the program's
``prfl.rollout`` span (hyvideo_prfl_torch/utils/tracing.py) over the
traced outer steps; None without the tracer or the span."""


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    row = tracing.totals()["spans"].get("prfl.rollout", {})
    return row["device_s"] / r.steps if "device_s" in row and r.steps else None
