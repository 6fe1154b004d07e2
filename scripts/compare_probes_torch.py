"""The probes P1 and P2 of this checkout against another checkout's (for
example the parent commit's), on one card.

    python3 scripts/compare_probes_torch.py --other path/to/other/checkout

Builds both kernel libraries (each from its own ``hyvideo_prfl_torch/csrc``
into its own ``build/``) and calls each library's C entry points on the same
ternary operands at P2's shape (64 chained [512, 512]^2) and P1's qk shape
([512, 128] x [128, 2048] x 16 blocks x 4,096 reps), int8 and bf16. A
library whose entry points take a split count (atomics into a zeroed
output) gets the one its wrapper picked, and the zeroing is part of its
call; this checkout's write every output once. Each result must equal the
exact plain version. Both are timed in turns (other, this, this, other) as
``ops.int8_probe`` times the probe scripts: calls queued behind a device
sleep, so the host's launch cost stays out. Prints the card, then one JSON
line per probe and type. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hyvideo_prfl_torch.ops import int8_probe  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "scripts"))
from compare_norm_kernels_torch import load_build  # noqa: E402

SHAPES = {"P2": (512, 512, 512, 1, 64), "P1 qk": (512, 128, 2048, 16, 4096)}


def caller(lib, a, bt, m, n_cols, nblocks, reps, stream):
    """(the library's call of P1 (nblocks > 1) or P2 on a and bt, the
    output it writes)"""
    int8 = int(a.dtype == torch.int8)
    k_bytes = a.shape[1] * a.element_size()
    out = torch.empty((m, n_cols), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    ptrs = (a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, k_bytes, n_cols)
    if hasattr(lib, "hyv_probe_cluster"):  # every element written once
        if nblocks > 1:
            return lambda: lib.hyv_probe_rate(*ptrs, nblocks, reps, int8, stream), out
        return lambda: lib.hyv_probe_chain(*ptrs, reps, int8, stream), out
    # the split design: the split count its wrapper picked, atomics into zeros
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(reps, sms // ((m // 256) * (n_cols // 128))))

    def fn():
        out.zero_()
        if nblocks > 1:
            return lib.hyv_probe_rate(*ptrs, nblocks, reps, splits, int8, stream)
        return lib.hyv_probe_chain(*ptrs, reps, splits, int8, stream)
    return fn, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True, help="root of the other checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_probes_torch: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = {label: load_build(root).lib()
            for label, root in (("other", args.other), ("this", REPO))}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ok = True
    for tag, (m, k, n_cols, nblocks, reps) in SHAPES.items():
        a8, a16 = int8_probe.ternary((m, k), g, dev)
        b8, b16 = int8_probe.ternary((nblocks * n_cols, k), g, dev)
        ref = int8_probe.probe_plain(a8, b8, nblocks, reps)
        ops = 2.0 * m * k * n_cols * nblocks * reps
        for kind, a, bt in (("int8", a8, b8), ("bf16", a16, b16)):
            fns = {}
            for label, lib in libs.items():
                fn, out = caller(lib, a, bt, m, n_cols, nblocks, reps, stream)
                err = fn()
                torch.cuda.synchronize()
                exact = err == 0 and torch.equal(out.double(), ref.double())
                ok &= exact
                if not exact:
                    print(f"{tag} {kind} {label}: launch {err}, not exact")
                fns[label] = fn
            times = {label: [] for label in fns}
            for turn in range(4):
                for label in (("other", "this") if turn % 2 == 0 else ("this", "other")):
                    times[label].append(int8_probe._ms(fns[label], reps=1))
            med = {label: statistics.median(v) for label, v in times.items()}
            print(json.dumps({"probe": tag, "type": kind, "other_ms": med["other"],
                              "this_ms": med["this"],
                              "other_tops": ops / (med["other"] * 1e9),
                              "this_tops": ops / (med["this"] * 1e9),
                              "this_over_other": med["this"] / med["other"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
