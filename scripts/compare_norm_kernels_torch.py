"""The norm kernels K6-K9 of this checkout against the same kernels of another
checkout of the port (for example the parent commit's), in turns on one card.

    python3 scripts/compare_norm_kernels_torch.py --other path/to/other/checkout

Builds both kernel libraries, each from its own ``hyvideo_prfl_torch/csrc``
into its own ``build/`` directory. K6-K8 are called through their C entry
points (whose signatures they share across checkouts) on the same inputs:
K6 (rope) and K8 (bf16 out) at [2, 32,760, 1536], as the 81-frame CFG-2
forward calls them, and K7 (rope) at [1, 32,760, 1536], as the training
backward does; K7 also at the 14B width, [1, 32,760, 5120] (the PAVRM step)
and [1, 75,600, 5120] with 40 heads, and at bench.py's [1, 3,120, 1280]
with 10 heads (tags K7_d5120, K7_d5120_l75600, K7_d1280). K9 (bf16
cotangent) is called through each checkout's own wrapper, ``ops/stream.py``
``bwd_kernel`` (the other package imported under another name, so that it
launches its own build), since the two forms of its ds/dt partials differ:
per 32-row tile summed by two torch reductions, or per (block, batch
element) summed inside the kernel. So K9's time is everything autograd
pays; it runs at [1, 32,760, 1536] (tag K9), [1, 3,120, 1280] (K9_d1280)
and [1, 32,760, 5120] (K9_d5120). Each pair is checked to agree: K7's dw
partials summed as the wrapper sums them (per 32-row tile or, where the
library has hyv_rmsnorm_rope_bwd_parts, per block), and every output
within 1e-5 of its max (fp32) or one bf16 ulp of it (bf16; K7's dx two),
since two builds may sum in another order. Then each pair is timed in
turns (other, this, this, other, ...) with CUDA events over 20 calls a
turn, queued behind a device sleep, so the events time the device alone.
Prints each library's ptxas register and spill lines for the instances it
launches, then one JSON line per kernel: the median ms of each library, the
minimum and maximum over its turns, and this/other. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
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


def load_stream_module(checkout: str, alias: str):
    """The checkout's ops/stream.py, its package imported as ``alias``, so
    its wrappers launch the kernels of its own build."""
    pkg = os.path.join(checkout, "hyvideo_prfl_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.stream")


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
            torch.cuda._sleep(10_000_000)  # the turn's calls queue behind it
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
    libs, streams = {}, {}
    for label, root in (("other", args.other), ("this", REPO)):
        streams[label] = load_stream_module(root, f"_hyv_{label}")
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
    s2 = 1.0 + 0.1 * torch.randn(2, dim, device=dev, generator=g)
    t2 = 0.1 * torch.randn(2, dim, device=dev, generator=g)
    # K9 at [1, rows, dim] with the blocks' bf16 cotangent: tag -> (rows, dim)
    k9_shapes = {"K9": (lq, dim), "K9_d1280": (3120, 1280), "K9_d5120": (lq, 5120)}
    k9_in = {tag: (torch.randn(1, rows, w_, device=dev, generator=g),
                   1.0 + 0.1 * torch.randn(1, w_, device=dev, generator=g),
                   torch.randn(1, rows, w_, device=dev, generator=g).bfloat16())
             for tag, (rows, w_) in k9_shapes.items()}
    # K7 at the other widths: tag -> (rows, heads), batch 1, with rope
    k7_wide = {"K7_d5120": (32760, 40), "K7_d5120_l75600": (75600, 40), "K7_d1280": (3120, 10)}
    wide_in = {}
    for tag, (rows, heads) in k7_wide.items():
        wide_in[tag] = (
            torch.randn(1, rows, heads * d, device=dev, generator=g).bfloat16(),
            1.0 + 0.1 * torch.randn(heads * d, device=dev, generator=g),
            torch.randn(rows, d, device=dev, generator=g),
            torch.randn(rows, d, device=dev, generator=g),
            torch.randn(1, heads, rows, d, device=dev, generator=g).bfloat16())

    def k7_parts(lib, rows, heads):
        """K7's dw partials: one per block where the library says so, else
        one per 32-row tile"""
        try:
            return lib.hyv_rmsnorm_rope_bwd_parts(1, rows, heads, 1)
        except AttributeError:
            return (rows + 31) // 32

    def outputs(label):
        """Fresh outputs per library, and each kernel's call on them."""
        lib = libs[label]
        o6 = torch.empty(2, n, lq, d, dtype=torch.bfloat16, device=dev)
        o8 = torch.empty(2, lq, dim, dtype=torch.bfloat16, device=dev)
        dx7 = torch.empty_like(x1)
        dw7 = torch.empty(k7_parts(lib, lq, n), dim, device=dev)

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
        }
        results = {"K6": (o6,), "K7": (dx7, dw7), "K8": (o8,)}
        # K9 through the checkout's wrapper: its outputs are new each call
        for tag, (x9, s9, g9) in k9_in.items():
            k9 = (lambda x9=x9, s9=s9, g9=g9, mod=streams[label]:
                  mod.bwd_kernel(x9, s9, g9, 1e-6))
            calls[tag] = k9
            results[tag] = k9
        for tag, (rows, heads) in k7_wide.items():
            xw, ww, cw, sw, gw = wide_in[tag]
            dxw = torch.empty_like(xw)
            dww = torch.empty(k7_parts(lib, rows, heads), heads * d, device=dev)
            calls[tag] = (lambda xw=xw, ww=ww, cw=cw, sw=sw, gw=gw, dxw=dxw, dww=dww,
                          rows=rows, heads=heads: check(lib.hyv_rmsnorm_rope_bwd(
                              xw.data_ptr(), ww.data_ptr(), cw.data_ptr(), sw.data_ptr(),
                              gw.data_ptr(), dxw.data_ptr(), dww.data_ptr(), 1, rows, heads, d,
                              1e-6, 1, stream)))
            results[tag] = (dxw, dww)
        return calls, results

    runs = {label: outputs(label) for label in libs}
    ok = True
    for name in ("K6", "K7", "K8", *k7_wide, *k9_shapes):
        if name.startswith("K9"):
            outs = {label: runs[label][1][name]() for label in libs}
        else:
            for label in libs:
                runs[label][0][name]()
            outs = {label: runs[label][1][name] for label in libs}
        torch.cuda.synchronize()
        if name.startswith("K7"):  # the partials, summed as the wrapper sums them
            outs = {label: (o[0], o[1].sum(dim=0)) for label, o in outs.items()}
        for a, b in zip(outs["this"], outs["other"]):
            rel = 1e-5 if a.dtype == torch.float32 else 2.0 ** -7
            if name.startswith("K7"):
                rel = 2.0 ** -6 if a.dtype == torch.bfloat16 else 2.0 ** -7
            err = (a.float() - b.float()).abs().max().item()
            agree = err <= rel * b.float().abs().max().item()
            ok &= agree
            if not agree:
                print(f"{name}: the two libraries disagree ({err:.3e})")
        t = timed_turns({"other": runs["other"][0][name], "this": runs["this"][0][name]})
        med = {label: statistics.median(v) for label, v in t.items()}
        print(json.dumps({"kernel": name, "other_ms": med["other"], "this_ms": med["this"],
                          "other_turns_ms": [min(t["other"]), max(t["other"])],
                          "this_turns_ms": [min(t["this"]), max(t["this"])],
                          "this_over_other": med["this"] / med["other"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
