"""The streaming flash-attention forward K1/K2 of this checkout against the same
kernels of another checkout of the port (for example the parent commit's), in
turns on one card.

    python3 scripts/compare_flash_fwd_torch.py --other path/to/other/checkout \
        [--other_single_streaming]

Builds both kernel libraries, each from its own ``hyvideo_prfl_torch/csrc``
into its own ``build/`` directory, and calls K1 (bounded) and K2 (shifted)
of both through the C entry point ``hyv_flash_fwd``, whose signature the
checkouts share, at the 81-frame self-attention of t2v-1.3B: B 2 (the CFG
batch of serving) and B 1 (the training step), 12 heads, lq = lk = 32,760,
head_dim 128, q/k head-major, v [B, L, N, D]. ``--other_single_streaming``
applies only to an other checkout that still holds the separate
single-block kernel ``csrc/flash_fwd_single.cu`` (the port before K1/K2
became instances of its template): it also builds that checkout's kernels
with the host check that holds the single-block forward to lk <= 3,584
removed, and times that kernel at the same shapes, which is how its design
was first measured over a 256-tile key loop.

Each pair is checked to agree: o within four bf16 ulps of max|o| (each
kernel lies within two of the plain version), lse within 2e-5 of max|lse|.
Then every function is timed in turns (other, this, [other single], SDPA;
then the reverse order, ...) with CUDA events, beside SDPA's flash forward
on the same q/k/v. Prints each library's ptxas lines for the flash forward
instances, then one JSON line per kernel and shape: the median ms of each
function, the minimum and maximum over its turns, TFLOP/s, the bf16 bound
and the card's name and power limit.

Last, what each library's K1 does to the work after it: at B 2, a DiT
block's pattern, one K1 and then four FFN GEMMs ([65,520, 1536] x [1536,
8960], bf16, as the block's first FFN layer), is run for about a second
per library, in turns (other, this, this, other), with the GEMMs timed by
CUDA events and the card's SM clock, power and clock-event reasons read
throughout (``gpu_clocks_torch.ClockSampler``). One JSON line per turn.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from compare_norm_kernels_torch import load_build, register_lines, timed_turns  # noqa: E402
from gpu_clocks_torch import ClockSampler  # noqa: E402

from hyvideo_prfl_torch.ops import flash_attention as fa  # noqa: E402

# the host check of the single-block forward's key range, as an older
# checkout's flash_fwd_single.cu holds it
SINGLE_CHECK = ("  if (Lk <= 0 || Lk > kFullKMax) return (int)cudaErrorInvalidValue;\n",
                "  if (Lk <= 0) return (int)cudaErrorInvalidValue;\n")
FRAGMENTS = ("flash_fwd_kernel", "flash_fwd_single_kernel")
BF16_ULP = 2.0 ** -7


def lifted_copy(checkout: str, work: str) -> str:
    """A copy of an older checkout's package sources with the single-block
    key range check removed; returns the copy's root."""
    path = os.path.join(checkout, "hyvideo_prfl_torch", "csrc", "flash_fwd_single.cu")
    if not os.path.exists(path):
        raise SystemExit(f"--other_single_streaming: {path} does not exist (the checkout's "
                         "single-block forward is an instance of flash_fwd_kernel)")
    pkg = os.path.join(work, "hyvideo_prfl_torch")
    os.makedirs(os.path.join(pkg, "ops"))
    shutil.copy(os.path.join(checkout, "hyvideo_prfl_torch", "ops", "_build.py"),
                os.path.join(pkg, "ops"))
    shutil.copytree(os.path.join(checkout, "hyvideo_prfl_torch", "csrc"),
                    os.path.join(pkg, "csrc"))
    path = os.path.join(pkg, "csrc", "flash_fwd_single.cu")
    text = open(path).read()
    if SINGLE_CHECK[0] not in text:
        raise SystemExit(f"{path} no longer holds the key range check")
    open(path, "w").write(text.replace(*SINGLE_CHECK))
    return work


def neighbour_turns(k1s, gemm, card, rounds=40, gemms=4):
    """Per library and turn: rounds x (its K1, then `gemms` GEMMs), the
    GEMMs timed by CUDA events, with the card's clocks read throughout."""
    for k1 in k1s.values():
        k1()
    gemm()
    torch.cuda.synchronize()
    order = list(k1s)
    for turn, label in enumerate(order + order[::-1]):
        k1 = k1s[label]
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(rounds)]
        sampler = ClockSampler().start()
        for ev0, ev1 in evs:
            k1()
            ev0.record()
            for _ in range(gemms):
                gemm()
            ev1.record()
        torch.cuda.synchronize()
        clocks = sampler.stop()
        ms = [ev0.elapsed_time(ev1) / gemms for ev0, ev1 in evs]
        print(json.dumps({"gemm_after_k1": label, "turn": turn, "gemm_ms": statistics.median(ms),
                          "gemm_turn_ms": [min(ms), max(ms)], "card": card, **clocks}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--other_single_streaming", action="store_true",
                   help="also time the other checkout's single-block kernel at 32,760 keys "
                        "(only for a checkout that holds csrc/flash_fwd_single.cu)")
    p.add_argument("--reps", type=int, default=5, help="turns per function")
    p.add_argument("--calls", type=int, default=3, help="calls between two CUDA events")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash_fwd_torch: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    work = tempfile.mkdtemp()
    roots = {"other": args.other, "this": REPO}
    if args.other_single_streaming:
        roots["other_single"] = lifted_copy(args.other, work)
    libs = {}
    for label, root in roots.items():
        build = load_build(root)
        libs[label] = build.lib()
        print(f"{label} ({root}): built in {build.build_seconds:.2f} s")
        for line in register_lines(build, FRAGMENTS):
            print(f"  ptxas {line}")

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, d, l = 12, 128, 32760
    qscale = fa._qscale(d)
    ok = True
    for b in (2, 1):
        g = torch.Generator(device=dev).manual_seed(b)
        q = torch.randn(b, n, l, d, device=dev, generator=g).bfloat16()
        k = torch.randn(b, n, l, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, l, n, d, device=dev, generator=g).bfloat16()
        vt = v.movedim(1, 2).contiguous()  # SDPA's [B, N, L, D]
        qs, ks, vs = q.stride(), k.stride(), v.stride()
        outs = {label: (torch.empty(b, l, n, d, dtype=torch.bfloat16, device=dev),
                        torch.empty(b * n, l, device=dev)) for label in libs}

        def call(label, shifted):
            o, lse = outs[label]
            single = int(label == "other_single")
            lib = libs[label]

            def run():
                err = lib.hyv_flash_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), None,
                    b, n, l, l, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[2], vs[1],
                    o.stride(0), o.stride(2), o.stride(1), qscale, single, shifted, stream)
                if err != 0:
                    raise RuntimeError(f"{label} launch failed: cudaError {err}")
            return run

        def sdpa():
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(q, k, vt)

        flop = 4 * b * n * l * l * d
        bound_ms = 1e3 * flop / 989e12
        for name, shifted in (("K1", 0), ("K2", 1)):
            fns = {label: call(label, shifted) for label in libs}
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            ref_o, ref_lse = outs["other"]
            for label in libs:
                if label == "other":
                    continue
                o, lse = outs[label]
                eo = (o.float() - ref_o.float()).abs().max().item()
                el = (lse - ref_lse).abs().max().item()
                bo = 4 * BF16_ULP * ref_o.float().abs().max().item()
                bl = 2e-5 * ref_lse.abs().max().item()
                agree = bool(torch.isfinite(o.float()).all()) and eo <= bo and el <= bl
                print(f"{name} B {b}: {label} against other: o {eo:.3e} (bound {bo:.3e}), "
                      f"lse {el:.3e} (bound {bl:.3e})" + ("" if agree else ": DISAGREE"))
                ok &= agree
            fns["sdpa_flash"] = sdpa
            t = timed_turns(fns, reps=args.reps, calls=args.calls)
            med = {label: statistics.median(ts) for label, ts in t.items()}
            print(json.dumps({
                "kernel": name, "shape": [b, n, l, l, d], "card": card,
                **{f"{label}_ms": ms for label, ms in med.items()},
                **{f"{label}_turns_ms": [min(ts), max(ts)] for label, ts in t.items()},
                "tflops": {label: flop / ms / 1e9 for label, ms in med.items()},
                "bound_ms": bound_ms, "this_of_bound": bound_ms / med["this"],
                "this_over_other": med["this"] / med["other"],
                "this_over_sdpa": med["this"] / med["sdpa_flash"]}))
        if b == 2:
            x = torch.randn(b * l, 1536, device=dev, generator=g).bfloat16()
            w = torch.randn(8960, 1536, device=dev, generator=g).bfloat16().mul_(0.02)
            neighbour_turns({label: call(label, 0) for label in roots if label != "other_single"},
                            lambda: torch.nn.functional.linear(x, w), card)
            del x, w
        del q, k, v, vt, outs
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
