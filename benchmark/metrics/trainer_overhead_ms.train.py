"""trainer_overhead_ms.train: the training loop's own time a step (the
loader, the host's per-step work, the logger): the traced window per step
less the step functions' own synchronised time (``t_refl`` + ``t_sft``),
in milliseconds."""


def read(r):
    if r.trace is None or not r.history:
        return None
    own = [h.get("t_refl", 0.0) + h.get("t_sft", 0.0) for h in r.history]
    return 1e3 * (r.trace.window_s / len(r.history) - sum(own) / len(own))
