"""The norm kernels K6-K9 of this checkout against the same kernels of another
checkout of the port (for example the parent commit's), in turns on one card.

    python3 scripts/compare_norm_kernels_torch.py --other path/to/other/checkout

Builds both kernel libraries, each from its own ``hyvideo_prfl_torch/csrc``
into its own ``build/`` directory, and calls both through their C entry
points (whose signatures K6-K9 share across checkouts) on the same inputs:
K6 (rope) and K8 (bf16 out) at [2, 32,760, 1536], as the 81-frame CFG-2
forward calls them, and K7 (rope) and K9 (bf16 cotangent) at [1, 32,760,
1536], as the training backward does. Each pair is checked to agree: the
per-tile partials of K7 and K9 summed as the wrappers sum them, and every
output within 1e-5 of its max (fp32) or one bf16 ulp of it (bf16), since
two builds may sum in another order. Then each pair is timed in turns
(other, this, this, other, ...) with CUDA events over 20 calls a turn.
Prints each library's ptxas register and spill lines for the instances it
launches, then one JSON line per kernel: the median ms of each library, the
minimum and maximum over its turns, and this/other. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_build(checkout: str):
    """The checkout's ops/_build.py as a module of its own (it imports only
    the standard library), so its CSRC and BUILD_DIR are the checkout's."""
    path = os.path.join(checkout, "hyvideo_prfl_torch", "ops", "_build.py")
    name = f"_build_{abs(hash(os.path.abspath(checkout)))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def register_lines(build, fragments):
    """ptxas's register and spill lines of the kernels whose mangled names
    hold one of the fragments, each after the kernel's name and template
    arguments."""
    out, current = [], None
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            current = None
            for frag in fragments:
                m = re.search(frag + r"(I\w*?E)E", line)
                if m:
                    current = frag + m.group(1)
                    break
        elif current and ("registers" in line or "spill" in line):
            out.append(f"{current}: {line.split(':', 1)[-1].strip()}")
    return out


def timed_turns(fns, reps=7, calls=20):
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns.items())
    for i in range(reps):
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(calls):
                fn()
            ev1.record()
            torch.cuda.synchronize()
            times[name].append(ev0.elapsed_time(ev1) / calls)
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True, help="root of the other checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_norm_kernels_torch: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    libs = {}
    for label, root in (("other", args.other), ("this", REPO)):
        build = load_build(root)
        libs[label] = build.lib()
        print(f"{label} ({root}): built in {build.build_seconds:.2f} s")
        for line in register_lines(build, ("rmsnorm_rope_kernel", "rmsnorm_rope_bwd_kernel",
                                           "ln_scale_shift_kernel",
                                           "ln_scale_shift_bwd_kernel")):
            print(f"  ptxas {line}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    n, d, lq = 12, 128, 32760
    dim = n * d
    stream = torch.cuda.current_stream(dev).cuda_stream
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_tab = torch.randn(lq, d, device=dev, generator=g)
    s_tab = torch.randn(lq, d, device=dev, generator=g)
    x2 = torch.randn(2, lq, dim, device=dev, generator=g).bfloat16()
    x1 = torch.randn(1, lq, dim, device=dev, generator=g).bfloat16()
    gh = torch.randn(1, n, lq, d, device=dev, generator=g).bfloat16()
    xf2 = torch.randn(2, lq, dim, device=dev, generator=g)
    xf1 = torch.randn(1, lq, dim, device=dev, generator=g)
    s2 = 1.0 + 0.1 * torch.randn(2, dim, device=dev, generator=g)
    t2 = 0.1 * torch.randn(2, dim, device=dev, generator=g)
    s1 = s2[:1].contiguous()
    gb = torch.randn(1, lq, dim, device=dev, generator=g).bfloat16()
    n_tiles = (lq + 31) // 32

    def outputs(label):
        """Fresh outputs per library, and each kernel's call on them."""
        o6 = torch.empty(2, n, lq, d, dtype=torch.bfloat16, device=dev)
        o8 = torch.empty(2, lq, dim, dtype=torch.bfloat16, device=dev)
        dx7 = torch.empty_like(x1)
        dw7 = torch.empty(1, n_tiles, dim, device=dev)
        dx9 = torch.empty_like(xf1)
        ds9 = torch.empty(1, n_tiles, dim, device=dev)
        dt9 = torch.empty_like(ds9)
        lib = libs[label]

        def check(err):
            if err != 0:
                raise RuntimeError(f"{label} launch failed: cudaError {err}")

        calls = {
            "K6": lambda: check(lib.hyv_rmsnorm_rope(
                x2.data_ptr(), w.data_ptr(), c_tab.data_ptr(), s_tab.data_ptr(),
                o6.data_ptr(), 2, lq, n, d, 1e-6, 1, stream)),
            "K7": lambda: check(lib.hyv_rmsnorm_rope_bwd(
                x1.data_ptr(), w.data_ptr(), c_tab.data_ptr(), s_tab.data_ptr(), gh.data_ptr(),
                dx7.data_ptr(), dw7.data_ptr(), 1, lq, n, d, 1e-6, 1, stream)),
            "K8": lambda: check(lib.hyv_ln_scale_shift(
                xf2.data_ptr(), s2.data_ptr(), t2.data_ptr(), o8.data_ptr(), 2, lq, dim, 1e-6,
                1, stream)),
            "K9": lambda: check(lib.hyv_ln_scale_shift_bwd(
                xf1.data_ptr(), s1.data_ptr(), gb.data_ptr(), dx9.data_ptr(), ds9.data_ptr(),
                dt9.data_ptr(), 1, lq, dim, 1e-6, 1, stream)),
        }
        results = {"K6": (o6,), "K7": (dx7, dw7), "K8": (o8,), "K9": (dx9, ds9, dt9)}
        return calls, results

    runs = {label: outputs(label) for label in libs}
    ok = True
    for name in ("K6", "K7", "K8", "K9"):
        for label in libs:
            runs[label][0][name]()
        torch.cuda.synchronize()
        for a, b in zip(runs["this"][1][name], runs["other"][1][name]):
            if a.dtype == torch.float32 and a.dim() == 3 and a.shape[1] == n_tiles:
                a, b = a.sum(dim=1), b.sum(dim=1)  # per-tile partials, summed as the wrappers do
            rel = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-5
            err = (a.float() - b.float()).abs().max().item()
            agree = err <= rel * b.float().abs().max().item()
            ok &= agree
            if not agree:
                print(f"{name}: the two libraries disagree")
        t = timed_turns({"other": runs["other"][0][name], "this": runs["this"][0][name]})
        med = {label: statistics.median(v) for label, v in t.items()}
        print(json.dumps({"kernel": name, "other_ms": med["other"], "this_ms": med["this"],
                          "other_turns_ms": [min(t["other"]), max(t["other"])],
                          "this_turns_ms": [min(t["this"]), max(t["this"])],
                          "this_over_other": med["this"] / med["other"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
