"""prfl.sft_s: the SFT step's own time, the mean of the training CLI's
``t_sft`` over the traced steps."""


def read(r):
    times = [h["t_sft"] for h in r.history if "t_sft" in h]
    return sum(times) / len(times) if times else None
