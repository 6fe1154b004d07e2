"""prfl.refl_s: the refl step's own time, the mean of the training CLI's
``t_refl`` (wall seconds to the step's synchronize) over the traced
steps."""


def read(r):
    times = [h["t_refl"] for h in r.history if "t_refl" in h]
    return sum(times) / len(times) if times else None
