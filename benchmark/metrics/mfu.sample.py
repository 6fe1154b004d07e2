"""mfu.sample: the whole step's share of the card's bf16 peak
(harness/shares.py)."""

from harness import shares


def read(r):
    return shares.mfu(r)
