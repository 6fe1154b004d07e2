"""idle_share.train: the share of the traced window in which the card was
idle (harness/shares.py)."""

from harness import shares


def read(r):
    return shares.idle(r)
