"""What each design element of K3/K3s buys, on one GPU.

    python3 scripts/ablate_flash_single_torch.py [--reps 7] [--calls 20]

K3 and K3s (hyvideo_prfl_torch/csrc/flash_fwd_single.cu) are built as they
are and with one design element taken out at a time, each variant from a
patched copy of csrc/ in a temporary directory (one nvcc per source, all
at once), loaded through ctypes beside the package's own library:

  - no_turns:  the two consumer warpgroups issue their products whenever
               they are ready, without taking turns on the named barriers;
  - divide:    the epilogue divides every output by l instead of
               multiplying by 1/l;
  - serial_pv: each key tile's p v is waited for right after it is issued,
               instead of staying in flight behind the next q'k^T.

Each variant is first held to the plain versions at small and ragged shapes
(o within two bf16 ulps of max|o|, lse within 1e-5 of max|lse|), then all of
them are timed at the 81-frame CFG-2 text cross-attention (B 2, N 12,
lq 32,760, lk 512), in turns with SDPA's flash forward and the mma.sync
streaming form at the same lk. One JSON line per variant and form: ms (the
median turn, calls per turn between two CUDA events), TFLOP/s, the share
of the 0.2084 ms bf16 bound, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.ops import _build  # noqa: E402
from hyvideo_prfl_torch.ops import flash_attention as fa  # noqa: E402

# variant -> (source text, replacement) pairs applied to flash_fwd_single.cu
VARIANTS = {
    "as_built": [],
    "no_turns": [
        ("  auto turn_begin = [&]() { named_bar_sync(3 + cw, 256); };",
         "  auto turn_begin = [&]() {};"),
        ("  auto turn_end = [&]() { named_bar_arrive(4 - cw, 256); };",
         "  auto turn_end = [&]() {};"),
        ("  if (cw == 0) named_bar_arrive(3, 256);\n", ""),
    ],
    "divide": [
        ("      const float l_inv = 1.f / (l <= 0.f ? 1.f : l);",
         "      const float l_safe = l <= 0.f ? 1.f : l;"),
        ("acc[4 * jd + 2 * half] * l_inv", "acc[4 * jd + 2 * half] / l_safe"),
        ("acc[4 * jd + 2 * half + 1] * l_inv", "acc[4 * jd + 2 * half + 1] / l_safe"),
    ],
    "serial_pv": [
        ("      wgmma_commit();\n      if (j == t.nk - 1) turn_end();",
         "      wgmma_commit();\n      if (j == t.nk - 1) turn_end();\n      wgmma_wait<0>();"),
    ],
}
CASES = [(1, 1, 1, 1, None), (1, 2, 129, 127, None), (2, 3, 300, 512, None),
         (1, 2, 4680, 769, None), (1, 1, 200, 3584, None), (2, 3, 300, 769, [1, 128])]


def build_variants(names, workdir):
    """name -> loaded ctypes library of csrc/ with that variant's patches."""
    nvcc = _build._nvcc()
    jobs = {}
    for name in names:
        d = os.path.join(workdir, name)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "flash_fwd_single.cu")
        text = open(path).read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        srcs = sorted(f for f in os.listdir(d) if f.endswith(".cu"))
        jobs[name] = (d, [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", d, "-c", "-o", os.path.join(d, f[:-3] + ".o"),
             os.path.join(d, f)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f in srcs])
    libs = {}
    for name, (d, procs) in jobs.items():
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        objs = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".o"))
        so = os.path.join(d, "lib.so")
        subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", so,
                        *objs], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hyv_error_string.argtypes = [ctypes.c_int]
        lib.hyv_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def check(lib, dev):
    """Largest error of the variant against the plain versions, over CASES and
    both forms, as a fraction of its bound (<= 1 passes)."""
    _build._lib = lib
    worst = 0.0
    for b, n, lq, lk, valid in CASES:
        g = torch.Generator(device=dev).manual_seed(lq + lk)
        q = torch.randn(b, n, lq, 128, device=dev, generator=g).bfloat16()
        k = torch.randn(b, n, lk, 128, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, 128, device=dev, generator=g).bfloat16()
        kv = None
        if valid is not None:
            kv = torch.tensor(valid, device=dev, dtype=torch.int32).repeat_interleave(n)
        for shifted in (False, True) if valid is None else (True,):
            o, lse = fa.flash_fwd_kernel(q, k, v, True, shifted, kv)
            po, plse = (fa.flash_attention_shifted_plain(q, k, v, kv) if shifted
                        else fa.flash_attention_plain(q, k, v))
            eo = (o.float() - po.float()).abs().nan_to_num(1e30).max().item()
            el = (lse - plse).abs().nan_to_num(1e30).max().item()
            worst = max(worst, eo / (2.0 ** -6 * po.float().abs().max().item()),
                        el / (1e-5 * plse.abs().max().item()))
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=7, help="turns per function")
    p.add_argument("--calls", type=int, default=20, help="calls between two CUDA events")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_flash_single_torch: no CUDA device is available")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as work:
        libs = build_variants(list(VARIANTS), work)
        errs = {name: check(lib, dev) for name, lib in libs.items()}

        b, n, lq, lk, d = 2, 12, 32760, 512, 128
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, n, lq, d, device=dev, generator=g).bfloat16()
        k = torch.randn(b, n, lk, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, d, device=dev, generator=g).bfloat16()
        vt = v.movedim(1, 2).contiguous()

        def kernel(lib, shifted, single=True):
            def call():
                _build._lib = lib
                return fa.flash_fwd_kernel(q, k, v, single, shifted)
            return call

        def sdpa():
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(q, k, vt)

        fns = {"sdpa_flash": sdpa, "mma_sync": kernel(libs["as_built"], False, single=False)}
        for name, lib in libs.items():
            fns[f"{name} K3"] = kernel(lib, False)
            fns[f"{name} K3s"] = kernel(lib, True)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {name: [] for name in fns}
        order = list(fns.items())
        for i in range(args.reps):
            for name, fn in order if i % 2 == 0 else order[::-1]:
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ev0.record()
                for _ in range(args.calls):
                    fn()
                ev1.record()
                torch.cuda.synchronize()
                times[name].append(ev0.elapsed_time(ev1) / args.calls)
    flop = 4 * b * n * lq * lk * d
    bound_ms = 1e3 * flop / 989e12
    for name, ts in times.items():
        ms = statistics.median(ts)
        variant = name.split(" ")[0]
        print(json.dumps({"fn": name, "ms": ms, "tflops": flop / ms / 1e9,
                          "of_bound": bound_ms / ms,
                          "err_over_bound": errs.get(variant), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
