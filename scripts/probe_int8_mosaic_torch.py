"""Int8 inside a hand-written kernel against bf16, on one GPU: the port's
counterpart of scripts/probe_int8_mosaic.py (kernel P2).

    python3 scripts/probe_int8_mosaic_torch.py [--steps 64 ...]

P2 (hyvideo_prfl_torch/csrc/int8_probe.cu) chains 64 products of one
[512, 512] . [512, 512] pair in one kernel, as the TPU probe does, with
int8 operands (wgmma m64n128k32 s8 x s8 -> s32) and bf16 ones (m64n128k16
-> fp32) on the same ternary values, the 64 products split over the blocks
of a thread-block cluster. It prints one JSON line: whether each
result equals the exact plain version, ms and TOPS, and the library's rate
for one product (torch._int_mm for int8, torch.matmul for bf16; the TPU
probe's XLA reference). ``--steps`` runs it at other chain lengths too,
one line each: the time against the length splits a call into its fixed
cost and its cost per product.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.ops import int8_probe  # noqa: E402

M = N = K_DIM = 512
STEPS = 64


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, nargs="+", default=[STEPS])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_int8_mosaic_torch: no CUDA device is available")
    results = []
    for steps in args.steps:
        g = torch.Generator(device="cuda").manual_seed(1)
        res = int8_probe.measure("chain", (M, K_DIM, N, 1, steps),
                                 lambda a, bt, steps=steps: int8_probe.probe_chain(a, bt, steps),
                                 g)
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
