"""loader_wait_ms.train: the training loop's wait for its batch a step: the
host time of the program's ``train.batch`` span (the loader's next batch
and its copy to the device; hyvideo_prfl_torch/utils/tracing.py) over the
traced outer steps, in milliseconds; None without the tracer or the
span."""


def read(r):
    try:
        from hyvideo_prfl_torch.utils import tracing
    except ImportError:
        return None
    row = tracing.totals()["spans"].get("train.batch")
    return 1e3 * row["host_s"] / r.steps if row and r.steps else None
