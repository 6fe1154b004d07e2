"""What each design element of K9, the LayerNorm+modulate backward, buys, on one GPU.

    python3 scripts/ablate_ln_bwd_torch.py [--shapes 3120x1280 32760x1536 ...] \
        [--variants ...] [--reps 5] [--calls 10]

K9 (hyvideo_prfl_torch/csrc/ln_scale_shift_bwd.cu) is built as it is and
with one design element changed at a time, each source variant from a
patched copy of its source (one nvcc per variant, all at once), loaded
through ctypes, and each geometry variant as the built kernel called with
another partition than ops/stream.py k9_geometry's:

  - stages3, stages4, stages_max: a ring of 3, 4 or as many stages as
                shared memory holds (up to 8), instead of the 48 KB target
                (two stages at the model widths);
  - warps_per_row: S doubled (up to 8), the tile half as tall: fewer
                rows at once, each on more warps with fewer groups a lane;
  - div_sqrt:   rstd = 1 / sqrtf(.), an IEEE division, instead of rsqrtf;
  - spin_wait:  every mbarrier wait spins on test_wait instead of try_wait;
  - warps16:    16 consumer warps (at most 6 groups a lane: ptxas then
                has 96 registers a thread) instead of 8;
  - no_sum:     timing only, ds/dt wrong: the grid's ticket but no
                cross-block sum;
  - no_ticket_sum: timing only, ds/dt wrong: neither the ticket nor the
                sum, so as_built's excess over it is what the cross-block
                sum costs.

Shapes are [1, L, D] with the blocks' bf16 cotangent (a trailing ``f``, as
in 8190x8192f, takes the head's fp32 one). Each variant is first held to
the plain version (every output within 1e-5 of its max; the timing-only
ones dx alone) and to itself on a second call (bitwise), then the variants
of a shape are timed in turns with F.layer_norm's autograd backward, each
turn's calls queued behind a device sleep (the device's time alone). Prints
the card's name and power limit, each build's ptxas register and spill
lines, then one JSON line per shape and variant: median ms, its share of
the byte bound, and the checks. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hyvideo_prfl_torch.ops import _build, stream  # noqa: E402

SRC = os.path.join(REPO, "hyvideo_prfl_torch", "csrc", "ln_scale_shift_bwd.cu")

_TICKET = "  // ---- the grid's ticket: every block's partials are written ----\n"
_SUM = "  for (int it = blockIdx.x * (kThreads / 32) + warp; it < items; it += n_warps) {"
_SPIN = '''__device__ __forceinline__ void spin_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\\n.reg .pred p;\\nSPIN:\\n"
               "mbarrier.test_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
               "@!p bra SPIN;\\n}\\n" ::"r"(bar), "r"(parity) : "memory");
}

template <typename GT>
__global__'''
# source variant -> text replacements; geometry variants use as_built's build
SOURCES = {
    "as_built": [],
    "div_sqrt": [("rsqrtf(acc.x * inv_d + eps)", "1.0f / sqrtf(acc.x * inv_d + eps)")],
    "spin_wait": [("template <typename GT>\n__global__", _SPIN),
                  ("mbar_wait(base + kBarEmpty", "spin_wait(base + kBarEmpty"),
                  ("mbar_wait(base + kBarFull", "spin_wait(base + kBarFull")],
    "warps16": [("constexpr int kWarps = 8; ", "constexpr int kWarps = 16; "),
                ("constexpr int kMaxGroups = 8; ", "constexpr int kMaxGroups = 6; ")],
    "no_sum": [(_SUM, "  for (int it = items; it < items; it += n_warps) {")],
    "no_ticket_sum": [(_TICKET, "  return;\n")],
}
GEOMETRY = ("stages3", "stages4", "stages_max", "warps_per_row")
TIMING_ONLY = ("no_sum", "no_ticket_sum")


def build(variants, tmp):
    """{variant: the library's hyv_ln_scale_shift_bwd}, one nvcc each."""
    nvcc, text0, procs = _build._nvcc(), open(SRC).read(), {}
    for name in variants:
        d = os.path.join(tmp, name)
        shutil.copytree(os.path.dirname(SRC), d)
        text = text0
        for a, b in SOURCES[name]:
            if a not in text:
                raise SystemExit(f"{name}: the source no longer holds {a!r}")
            text = text.replace(a, b)
        path = os.path.join(d, os.path.basename(SRC))
        open(path, "w").write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", d, "-o", os.path.join(d, "k9.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.split(':', 1)[-1].strip()}")
        fn = ctypes.CDLL(os.path.join(tmp, name, "k9.so")).hyv_ln_scale_shift_bwd
        fn.argtypes = _build._SIGNATURES["hyv_ln_scale_shift_bwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def geometry(name, l, d, g_bytes, sms):
    """The partition a variant runs with, or None where it does not apply."""
    geo = stream.k9_geometry(1, l, d, g_bytes, sms)
    groups, S = d // 128, geo.S
    if name == "warps_per_row":
        S *= 2
        if S > stream.K9_WARPS:
            return None
    elif name == "warps16":
        S = 1
        while -(-groups // S) > 6:
            S *= 2
    T = min((16 if name == "warps16" else stream.K9_WARPS) // S, l)
    if S == geo.S and T == geo.T and not name.startswith("stages"):
        return geo
    ring = stream.K9_HEADER + 4 * d + (8 * d if T > 1 else 0)
    stage = T * d * (4 + g_bytes)
    fit = min(stream.K9_MAX_STAGES, (stream.K9_SMEM_MAX - ring) // stage)
    stages = {"stages3": 3, "stages4": 4, "stages_max": fit}.get(name, geo.stages)
    if stages > fit or (name.startswith("stages") and stages == geo.stages):
        return None
    if name not in ("stages3", "stages4", "stages_max"):
        stages = min(fit, max(2, -(-stream.K9_IN_FLIGHT // stage)))
    tiles = -(-l // T)
    return dataclasses.replace(geo, S=S, T=T, stages=stages, stage_bytes=stage, ring=ring,
                               smem=ring + stages * stage, tiles_per_b=tiles, tiles=tiles,
                               grid=min(tiles, sms))


def timed_turns(fns, reps, calls):
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
    return {name: statistics.median(t) for name, t in times.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", nargs="+",
                   default=["3120x1280", "32760x1536", "32760x5120", "75600x5120",
                            "8190x8192f"])
    p.add_argument("--variants", nargs="+", default=list(SOURCES) + list(GEOMETRY))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--calls", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_ln_bwd_torch: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    variants = ["as_built"] + [v for v in args.variants if v != "as_built"]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    try:
        libs = build([v for v in variants if v in SOURCES], tmp)
        dev = torch.device("cuda")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sync = torch.zeros(1, dtype=torch.int32, device=dev)
        strm = torch.cuda.current_stream(dev).cuda_stream
        g = torch.Generator(device=dev).manual_seed(11)
        ok = True
        for shape in args.shapes:
            fp32_g = shape.endswith("f")
            l, d = (int(v) for v in shape.rstrip("f").split("x"))
            gb = 4 if fp32_g else 2
            x = torch.randn(1, l, d, device=dev, generator=g) * 0.5 + 0.3
            s = 1 + 0.1 * torch.randn(1, d, device=dev, generator=g)
            t = 0.1 * torch.randn(1, d, device=dev, generator=g)
            gy = torch.randn(1, l, d, device=dev, generator=g).to(
                torch.float32 if fp32_g else torch.bfloat16)
            ref = stream.ln_scale_shift_bwd_plain(x, s, gy)
            fns, checks = {}, {}
            for name in variants:
                geo = geometry(name, l, d, gb, sms)
                if geo is None:
                    continue
                outs = (torch.empty_like(x), torch.empty(1, d, device=dev),
                        torch.empty(1, d, device=dev))
                part = torch.empty(geo.slots, 2, d, device=dev)
                fn = libs[name if name in libs else "as_built"]

                def call(fn=fn, geo=geo, outs=outs, part=part):
                    err = fn(x.data_ptr(), s.data_ptr(), gy.data_ptr(), outs[0].data_ptr(),
                             part.data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                             sync.data_ptr(), 1, l, d, 1e-6, int(not fp32_g), geo.S, geo.T,
                             geo.stages, geo.ring, geo.grid, strm)
                    if err != 0:
                        raise RuntimeError(f"{name} at {shape}: cudaError {err}")
                call()
                first = tuple(o.clone() for o in outs)
                call()
                torch.cuda.synchronize()
                n_out = 1 if name in TIMING_ONLY else 3
                agree = all((a - r).abs().max().item() <= 1e-5 * r.abs().max().item()
                            for a, r in list(zip(outs, ref))[:n_out])
                same = all(torch.equal(a, b) for a, b in zip(first, outs))
                ok &= agree and (same or name in TIMING_ONLY)
                fns[name] = call
                checks[name] = (geo, agree, same)
            xr = x.clone().requires_grad_()
            sr, tr = s[0].clone().requires_grad_(), t[0].clone().requires_grad_()
            yr = F.layer_norm(xr, (d,), sr, tr, 1e-6)
            gf = gy.float()
            fns["library"] = lambda: torch.autograd.grad(yr, (xr, sr, tr), gf, retain_graph=True)
            ms = timed_turns(fns, args.reps, args.calls)
            bound = l * d * (8 + gb) / 3.35e12 * 1e3
            for name, t_ms in ms.items():
                row = {"shape": [1, l, d], "g": "fp32" if fp32_g else "bf16", "variant": name,
                       "ms": t_ms, "share_of_bound": bound / t_ms, "bound_ms": bound}
                if name in checks:
                    geo, agree, same = checks[name]
                    row.update({"S": geo.S, "T": geo.T, "stages": geo.stages,
                                "smem": geo.smem, "agrees": agree, "bitwise": same})
                print(json.dumps(row))
            del x, gy, ref, fns, xr, yr, gf
            torch.cuda.empty_cache()
        print(f"ablate_ln_bwd_torch: {'all variants agree' if ok else 'a variant disagrees'}; "
              f"{card}")
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
