"""pipeline_ms.sample: the serving pipeline's own device time a step: the
program's ``serve.request`` spans less their ``dit.forward`` spans
(hyvideo_prfl_torch/utils/tracing.py), over the traced steps, in
milliseconds; None without the tracer or either span."""


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.totals()["spans"]
    req, dit = (spans.get(n, {}).get("device_s") for n in ("serve.request", "dit.forward"))
    return 1e3 * (req - dit) / r.steps if None not in (req, dit) and r.steps else None
