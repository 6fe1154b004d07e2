"""The streaming flash-attention forward K1/K2, the int8-score forward K10 and
the split backward K5 of this checkout against the same kernels of another
checkout of the port (for example the parent commit's), in turns on one card.

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

K10 (B 2, on q and k quantized per head as the port quantizes them) and K5
(B 1, at the self-attention shape and at lq 1,024 over the same 32,760
keys, the shape that reaches K5 by default) are called through each
checkout's own Python wrappers, ``flash_qk8_kernel`` and ``bwd_kernel(...,
merged=False)``, the other checkout's package imported under another name
so that it builds and loads its own library. They are checked to agree as
above (K5: dq, dk and dv within four bf16 ulps of each gradient's max) and
timed in turns, K10 beside this checkout's K1 and K5 beside this
checkout's K4 and SDPA's flash backward; one JSON line each.

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
import importlib
import importlib.util
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


def load_flash_module(checkout: str, alias: str):
    """The checkout's ops/flash_attention.py, its package imported as
    ``alias``, so its wrappers launch the kernels of its own build."""
    pkg = os.path.join(checkout, "hyvideo_prfl_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.flash_attention")


def check_agree(name, got, ref, ulps=4):
    """Each output within `ulps` bf16 ulps of its reference's max."""
    ok = True
    for label, a, r in zip(("o", "lse") if len(got) == 2 else ("dq", "dk", "dv"), got, ref):
        err = (a.float() - r.float()).abs().max().item()
        bnd = (2e-5 if label == "lse" else ulps * BF16_ULP) * r.float().abs().max().item()
        good = bool(torch.isfinite(a.float()).all()) and err <= bnd
        print(f"{name}: {label} {err:.3e} (bound {bnd:.3e})" + ("" if good else ": DISAGREE"))
        ok &= good
    return ok


def report_turns(name, shape, fns, flop, bound_ms, card, args):
    t = timed_turns(fns, reps=args.reps, calls=args.calls)
    med = {label: statistics.median(ts) for label, ts in t.items()}
    print(json.dumps({
        "kernel": name, "shape": shape, "card": card,
        **{f"{label}_ms": ms for label, ms in med.items()},
        **{f"{label}_turns_ms": [min(ts), max(ts)] for label, ts in t.items()},
        "tflops": {label: flop / ms / 1e9 for label, ms in med.items()},
        "bound_ms": bound_ms, "this_of_bound": bound_ms / med["this"],
        "this_over_other": med["this"] / med["other"]}))


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

    other_fa = load_flash_module(args.other, "hyvideo_prfl_torch_other")
    wrappers = {"other": other_fa, "this": fa}

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
            # K10 on the same q and k, quantized per (batch, head)
            q8, sq = fa.quantize_bn(q)
            k8, sk = fa.quantize_bn(k)
            c = fa.qk8_scale(sq, sk, d)
            outs10 = {label: w.flash_qk8_kernel(q8, k8, v, c) for label, w in wrappers.items()}
            ok &= check_agree(f"K10 B {b}: this against other", outs10["this"], outs10["other"])
            del outs10
            ops = 2 * b * n * l * l * d  # of each product
            report_turns("K10", [b, n, l, l, d],
                         {label: (lambda w=w: w.flash_qk8_kernel(q8, k8, v, c))
                          for label, w in wrappers.items()} | {"K1": call("this", 0)},
                         2 * ops, 1e3 * (ops / 1979e12 + ops / 989e12), card, args)
            del q8, k8
        else:
            # K5 at the self-attention shape and at lq 1,024 over its keys;
            # o and lse from this checkout's K1
            for lq in (l, 1024):
                qq = q[:, :, :lq]
                o, lse = fa.flash_fwd_kernel(qq, k, v, False)
                do = torch.randn(o.shape, device=dev, generator=g).bfloat16()
                grads = {label: w.bwd_kernel(qq, k, v, o, lse, do, False)
                         for label, w in wrappers.items()}
                ok &= check_agree(f"K5 lq {lq}: this against other", grads["this"], grads["other"])
                del grads
                qs_ = qq.clone().requires_grad_()
                ks_ = k.clone().requires_grad_()
                vs_ = vt.clone().requires_grad_()
                with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.FLASH_ATTENTION):
                    out = torch.nn.functional.scaled_dot_product_attention(qs_, ks_, vs_)
                dot = do.movedim(1, 2).contiguous()
                fns = {label: (lambda w=w: w.bwd_kernel(qq, k, v, o, lse, do, False))
                       for label, w in wrappers.items()}
                fns["K4"] = lambda: fa.bwd_kernel(qq, k, v, o, lse, do, True)
                fns["sdpa_flash_bwd"] = lambda: torch.autograd.grad(
                    out, (qs_, ks_, vs_), dot, retain_graph=True)
                bflop = 10 * b * n * lq * l * d
                report_turns("K5", [b, n, lq, l, d], fns, bflop, 1e3 * bflop / 989e12, card, args)
                del o, lse, do, qs_, ks_, vs_, out, dot, fns
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
