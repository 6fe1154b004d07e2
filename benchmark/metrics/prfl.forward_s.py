"""prfl.forward_s: the gradient-carrying forwards' device time a step: the
program's ``prfl.forward`` (the policy and the solver step), ``prfl.lrm``
(score, sigmoid, hinge) and ``sft.forward`` spans
(hyvideo_prfl_torch/utils/tracing.py) over the traced outer steps; None
without the tracer or any of the spans."""

SPANS = ("prfl.forward", "prfl.lrm", "sft.forward")


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.totals()["spans"]
    parts = [spans.get(n, {}).get("device_s") for n in SPANS]
    return sum(parts) / r.steps if None not in parts and r.steps else None
