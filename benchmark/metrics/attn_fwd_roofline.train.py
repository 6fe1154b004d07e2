"""attn_fwd_roofline.train: the attention forward kernels' share of their
roofline, over the device time of K1, K2, K3, K3s and K10
(harness/shares.py)."""

from harness import devtrace, shares


def read(r):
    return shares.roofline(r, devtrace.ATTN_FWD, "attn_fwd_s")
