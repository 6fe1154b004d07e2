"""Int8 against bf16 tensor-core rate at flash-attention tile shapes, on one
GPU: the port's counterpart of scripts/probe_int8_rate.py (kernel P1).

    python3 scripts/probe_int8_rate_torch.py

P1 (hyvideo_prfl_torch/csrc/int8_probe.cu) runs the TPU probe's grid
(reps, nblocks) of ``o += a @ b_nb`` at its two shapes:

  - big-K: a [512, 1024] x b [1024, 2048], 16 b-blocks, 512 reps (dense-like)
  - qk:    a [512, 128] x b [128, 2048], 16 b-blocks, 4,096 reps (the flash
           score tile: K = head_dim)

each with int8 operands (wgmma m64n128k32 s32.s8.s8, the instruction of
K10's score) and bf16 ones (m64n128k16, K1's), on the same ternary values. For each it
prints one JSON line: whether the result equals the exact plain version,
ms and TOPS, and the library's rate for the product of one rep
(torch._int_mm for int8, torch.matmul for bf16).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.ops import int8_probe  # noqa: E402

SHAPES = {  # tag -> (m, k, n_cols, nblocks, reps)
    "bigK": (512, 1024, 2048, 16, 512),
    "qk": (512, 128, 2048, 16, 4096),
}


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("probe_int8_rate_torch: no CUDA device is available")
    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for tag, shape in SHAPES.items():
        nblocks, reps = shape[3], shape[4]
        res = int8_probe.measure(
            tag, shape, lambda a, bt: int8_probe.probe_rate(a, bt, nblocks, reps), g)
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
