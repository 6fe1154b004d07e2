"""attn_bwd_roofline.train: the attention backward kernels' share of their
roofline, over the device time of K4 and K5 and their prologues
(harness/shares.py)."""

from harness import devtrace, shares


def read(r):
    return shares.roofline(r, devtrace.ATTN_BWD, "attn_bwd_s")
