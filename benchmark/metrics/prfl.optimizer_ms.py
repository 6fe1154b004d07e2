"""prfl.optimizer_ms: the two optimizer calls' device time a step (the
finite guard, the clip and AdamW): the program's ``prfl.optimizer`` and
``sft.optimizer`` spans (hyvideo_prfl_torch/utils/tracing.py) over the
traced outer steps, in milliseconds; None without the tracer or either
span."""

SPANS = ("prfl.optimizer", "sft.optimizer")


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.totals()["spans"]
    parts = [spans.get(n, {}).get("device_s") for n in SPANS]
    return 1e3 * sum(parts) / r.steps if None not in parts and r.steps else None
