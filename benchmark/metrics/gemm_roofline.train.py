"""gemm_roofline.train: the dense products' share of their roofline, over
the device time of the GEMM group (harness/shares.py)."""

from harness import shares


def read(r):
    return shares.roofline(r, ("GEMM",), "gemm_s")
