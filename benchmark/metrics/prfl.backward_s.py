"""prfl.backward_s: the backwards' device time a step: the program's
``prfl.backward`` and ``sft.backward`` spans
(hyvideo_prfl_torch/utils/tracing.py) over the traced outer steps; None
without the tracer or either span."""

SPANS = ("prfl.backward", "sft.backward")


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.totals()["spans"]
    parts = [spans.get(n, {}).get("device_s") for n in SPANS]
    return sum(parts) / r.steps if None not in parts and r.steps else None
