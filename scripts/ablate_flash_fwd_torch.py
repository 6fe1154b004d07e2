"""What each design element of the flash-attention forwards buys, on one GPU.

    python3 scripts/ablate_flash_fwd_torch.py [--shape self cross] [--reps 5] [--calls 3] \
        [--variants ...] [--clocks]

The forward kernel (hyvideo_prfl_torch/csrc/flash_fwd.cu: K1/K2 streaming,
K3/K3s single-block) and the int8-score forward K10 (flash_fwd_qk8.cu) are
built as they are and with one design element changed at a time, each
variant from a patched copy of its source (one nvcc per variant, all at
once, beside one build of every source), loaded through ctypes beside the
package's own library. Variants of flash_fwd.cu:

  - rs_qk:      q'k^T reads its A operand into registers (ldmatrix) before
                each key tile instead of through a shared-memory
                descriptor;
  - three_stages: one q buffer and three k/v stages (224 KB), the buffer
                handed back once the o store has read it, instead of two
                q buffers and two stages (192 KB), the buffer handed back
                at the next tile's start;
  - exp2f:      the softmax calls exp2f, which rescues denormal results,
                instead of the bare multi-function-unit exp2;
  - one_chain:  each row's max and sum run as one dependent chain per row
                instead of four and two independent ones;
  - skip_rescale: the shifted forms skip the accumulator rescale where
                every factor of the warp is 1 (no row raised its max; a
                warp vote), instead of rescaling on every key tile;
  - turns:      the two consumer warpgroups take turns issuing their
                products (named barriers 3 and 4, warpgroup 0 first;
                FlashAttention-3's ping-pong) instead of issuing whenever
                they are ready;
  - serial_pv:  the softmax of key tile j waits for the p v of tile j - 1,
                issued in the same turn after q'k^T, instead of running
                while it is in flight;
  - divide:     the epilogue divides every output by l instead of
                multiplying by 1/l;
  - no_exp2:    timing only, its output is wrong: p = s (or s - m) with no
                exp2 at all, so as_built's excess over it is the time the
                exp2 adds where the other warpgroup's products do not hide
                it.

Variants of flash_fwd_qk8.cu (K10):

  - qk8_magic:  float(s32) by an integer add and a float subtract of
                1.5 * 2^23 (exact for |s32| < 2^22) instead of the I2F
                conversion (__int2float_rn);
  - qk8_three_stages: three k8/v stages (208 KB) instead of two (160 KB);
  - qk8_no_exp2: timing only, as no_exp2;
  - qk8_no_score: timing only, no score product (p from stale registers):
                what the softmax and p v take alone;
  - qk8_bf16_score: timing only, the score's four k-steps on the bf16
                wgmma over the same bytes: no switch between the int8 and
                the bf16 tensor-core paths within a key tile.

Each variant but no_exp2 is first held to the plain versions at small and
ragged shapes, in the single-block and the streaming forms (o within two
bf16 ulps of max|o|, lse within 1e-5 of max|lse|). Then the variants that
touch a shape are timed there, in turns with SDPA's flash forward:
"self" is the 81-frame CFG-2 self-attention (B 2, N 12, lq = lk = 32,760:
K1, K2, and K10 on q and k quantized per head), "cross" the text
cross-attention (lk 512: K3, K3s, and the streaming forms at the same lk).
One JSON line per variant and form: ms (the median turn, calls per turn
between two CUDA events), TFLOP/s (K10: ops of both products, TOPS), the
share of its bound (bf16 peak; K10 int8 and bf16 peaks), the largest error
over its bound, and the card's name and power limit. ``--clocks`` then runs
each timed function alone for about two seconds with the card's SM clock,
power and clock-event reasons read throughout (gpu_clocks_torch's
ClockSampler), one JSON line each.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gpu_clocks_torch import ClockSampler  # noqa: E402

from hyvideo_prfl_torch.ops import _build  # noqa: E402
from hyvideo_prfl_torch.ops import flash_attention as fa  # noqa: E402

EX2 = "exp2_mufu("  # the bare exp2 (csrc/sm90.cuh), called by name in flash_fwd.cu
QK8 = "flash_fwd_qk8.cu"
SCORE8 = "wgmma_m64n128k32_s8_ss(s,"  # K10's score product, one k32 step
# variant -> ((source text, replacement) pairs applied to its source, the
# shapes it changes[, the source: flash_fwd.cu unless named])
VARIANTS = {
    "as_built": ([], ("self", "cross")),
    "rs_qk": ([("""      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_ss(
            s, desc_sw128(sq + (kk >> 2) * kHalf + cw * 64 * 128 + (kk & 3) * 32, 1, 64),
            desc_sw128(sk + (kk >> 2) * kHalf + (kk & 3) * 32, 1, 64), kk > 0);""",
                """      uint32_t qf[kD / 16][4];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hyv::ldsm_x4(q_frag(sq, kk), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_rs<0>(s, qf[kk], desc_sw128(sk + (kk >> 2) * kHalf + (kk & 3) * 32,
                                                     1, 64), kk > 0);""")], ("self", "cross")),
    "three_stages": ([("constexpr int kQBufs = 2;", "constexpr int kQBufs = 1;"),
                      ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                      ("    if (it > 0 && wt == 0) {\n      bulk_wait_read();\n"
                       "      mbar_arrive(bar + kQEmpty + 8 * (qb ^ 1));\n    }\n", ""),
                      ("      bulk_commit();\n    }\n",
                       "      bulk_commit();\n      bulk_wait_read();\n"
                       "      mbar_arrive(bar + kQEmpty);\n    }\n")], ("self",)),
    "exp2f": ([(EX2, "exp2f(")], ("self", "cross")),
    "one_chain": ([("ls[(i >> 1) & 1][(i >> 2) & 1] += p;", "ls[(i >> 1) & 1][0] += p;"),
                   ("mx4[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx4[(i >> 1) & 1][(i >> 2) & 3],",
                    "mx4[(i >> 1) & 1][0] = fmaxf(mx4[(i >> 1) & 1][0],")], ("self",)),
    "skip_rescale": ([("      if constexpr (kShifted) {\n#pragma unroll\n"
                       "        for (int i = 0; i < 64; ++i) acc[i] *= corr",
                       "      if (kShifted && __any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {\n"
                       "#pragma unroll\n        for (int i = 0; i < 64; ++i) acc[i] *= corr")],
                     ("self",)),
    "turns": ([("  const float neg_inf = __int_as_float(0xff800000);\n",
                "  if (cw == 0) named_bar_arrive(3, 256);\n"
                "  const float neg_inf = __int_as_float(0xff800000);\n"),
               ("      wgmma_fence();\n#pragma unroll\n",
                "      named_bar_sync(3 + cw, 256);\n      wgmma_fence();\n#pragma unroll\n"),
               ("      if (j > 0) issue_pv(prev);\n",
                "      if (j > 0) issue_pv(prev);\n      named_bar_arrive(4 - cw, 256);\n"),
               ("      wgmma_fence();\n      issue_pv(prev);\n",
                "      named_bar_sync(3 + cw, 256);\n      wgmma_fence();\n      issue_pv(prev);\n"
                "      named_bar_arrive(4 - cw, 256);\n")], ("self", "cross")),
    "serial_pv": ([("      if (j > 0)\n        wgmma_wait<1>();\n      else\n        wgmma_wait<0>();",
                    "      wgmma_wait<0>();")], ("self", "cross")),
    "divide": ([("      const float l_inv = 1.f / (l <= 0.f ? 1.f : l);",
                 "      const float l_safe = l <= 0.f ? 1.f : l;"),
                ("acc[4 * jd + 2 * half] * l_inv", "acc[4 * jd + 2 * half] / l_safe"),
                ("acc[4 * jd + 2 * half + 1] * l_inv", "acc[4 * jd + 2 * half + 1] / l_safe")],
               ("cross",)),
    "no_exp2": ([(EX2, "(")], ("self", "cross")),
    "qk8_magic": ([("return __int2float_rn((int)s);",
                    "return __fsub_rn(__uint_as_float(s + 0x4B400000u), 12582912.f);")],
                  ("self",), QK8),
    "qk8_three_stages": ([("constexpr int kStages = 2;  // k8/v stages",
                           "constexpr int kStages = 3;  // k8/v stages")], ("self",), QK8),
    "qk8_no_exp2": ([(EX2, "(")], ("self",), QK8),
    "qk8_no_score": ([(SCORE8, "if (false) " + SCORE8)], ("self",), QK8),
    "qk8_bf16_score": ([(SCORE8, "wgmma_m64n128k16_ss(reinterpret_cast<float(&)[64]>(s),")],
                       ("self",), QK8),
}
UNCHECKED = ("no_exp2", "qk8_no_exp2", "qk8_no_score", "qk8_bf16_score")
INSTANCES = {"flash_fwd_kernelILb0ELb1E": "K1", "flash_fwd_kernelILb1ELb1E": "K2",
             "flash_fwd_kernelILb0ELb0E": "K3", "flash_fwd_kernelILb1ELb0E": "K3s"}
# (B, N, lq, lk, key counts per batch or None); the streaming forms take
# every case, the single-block forms those with lk <= FULL_K_MAX
CASES = [(1, 1, 1, 1, None), (1, 2, 129, 127, None), (2, 3, 300, 512, None),
         (1, 2, 4680, 769, None), (1, 1, 200, 3584, None), (2, 3, 300, 769, [1, 128]),
         (1, 2, 300, 4000, None), (2, 1, 777, 8191, [8191, 3001])]


def source_of(name):
    return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else "flash_fwd.cu"


def build_variants(names, workdir):
    """name -> loaded ctypes library: every source built once, and each
    variant's patched source in place of its own."""
    nvcc = _build._nvcc()
    src_dir = os.path.join(workdir, "csrc")
    shutil.copytree(_build.CSRC, src_dir)

    def compile_(src, obj, inc):
        return subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", inc, "-c", "-o", obj, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {}
    for f in sorted(os.listdir(src_dir)):
        if f.endswith(".cu"):
            procs[f] = compile_(os.path.join(src_dir, f), os.path.join(workdir, f[:-3] + ".o"),
                                src_dir)
    for name in names:
        text = open(os.path.join(src_dir, source_of(name))).read()
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"variant_{name}.cu")
        open(path, "w").write(text)
        procs[name] = compile_(path, path[:-3] + ".o", src_dir)
    logs = {key: p.communicate()[0] for key, p in procs.items()}
    bad = [key for key, p in procs.items() if p.returncode]
    if bad:
        raise RuntimeError("nvcc failed: " + "\n".join(f"{k}\n{logs[k]}" for k in bad))
    objs = sorted(f for f in os.listdir(workdir) if f.endswith(".o") and not f.startswith("variant_"))
    libs = {}
    for name in names:
        so = os.path.join(workdir, f"lib_{name}.so")
        own = source_of(name)[:-3] + ".o"
        common = [os.path.join(workdir, f) for f in objs if f != own]
        subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", so,
                        os.path.join(workdir, f"variant_{name}.o"), *common],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hyv_error_string.argtypes = [ctypes.c_int]
        lib.hyv_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        form = None
        for line in logs[name].splitlines():
            if "Compiling entry function" in line:
                form = next((f for frag, f in INSTANCES.items() if frag in line), None)
                form = "K10" if "flash_fwd_qk8_kernel" in line else form
            elif form and ("registers" in line or "spill" in line or "arning" in line):
                print(f"{name} {form}: {line.split(':', 1)[-1].strip()}")
    return libs


def check(lib, dev, qk8=False):
    """Largest error of the variant against the plain versions, over CASES and
    the forms each takes (``qk8``: K10 over the cases without a key mask),
    as a fraction of its bound (<= 1 passes)."""
    _build._lib = lib
    worst = 0.0
    for b, n, lq, lk, valid in CASES:
        if qk8:
            if valid is not None:
                continue
            g = torch.Generator(device=dev).manual_seed(lq + lk)
            q8, sq = fa.quantize_bn(torch.randn(b, n, lq, 128, device=dev, generator=g))
            k8, sk = fa.quantize_bn(torch.randn(b, n, lk, 128, device=dev, generator=g))
            v = torch.randn(b, lk, n, 128, device=dev, generator=g).bfloat16()
            c = fa.qk8_scale(sq, sk, 128)
            o, lse = fa.flash_qk8_kernel(q8, k8, v, c)
            po, plse = fa.flash_attention_qk8_plain(q8, k8, v, c)
            eo = (o.float() - po.float()).abs().nan_to_num(1e30).max().item()
            el = (lse - plse).abs().nan_to_num(1e30).max().item()
            worst = max(worst, eo / (2.0 ** -6 * po.float().abs().max().item()),
                        el / (1e-5 * plse.abs().max().item()))
            continue
        g = torch.Generator(device=dev).manual_seed(lq + lk)
        q = torch.randn(b, n, lq, 128, device=dev, generator=g).bfloat16()
        k = torch.randn(b, n, lk, 128, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, 128, device=dev, generator=g).bfloat16()
        kv = None
        if valid is not None:
            kv = torch.tensor(valid, device=dev, dtype=torch.int32).repeat_interleave(n)
        for single in (True, False) if lk <= fa.FULL_K_MAX else (False,):
            for shifted in (False, True) if valid is None else (True,):
                o, lse = fa.flash_fwd_kernel(q, k, v, single, shifted, kv)
                po, plse = (fa.flash_attention_shifted_plain(q, k, v, kv) if shifted
                            else fa.flash_attention_plain(q, k, v))
                eo = (o.float() - po.float()).abs().nan_to_num(1e30).max().item()
                el = (lse - plse).abs().nan_to_num(1e30).max().item()
                worst = max(worst, eo / (2.0 ** -6 * po.float().abs().max().item()),
                            el / (1e-5 * plse.abs().max().item()))
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", nargs="+", default=["self", "cross"], choices=["self", "cross"])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument("--reps", type=int, default=5, help="turns per function")
    p.add_argument("--calls", type=int, default=3, help="calls between two CUDA events")
    p.add_argument("--clocks", action="store_true",
                   help="then run each timed self-attention function alone for ~2 s with the "
                        "card's clocks read")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_flash_fwd_torch: no CUDA device is available")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    names = ["as_built"] + [v for v in args.variants if v != "as_built"]
    with tempfile.TemporaryDirectory() as work:
        libs = build_variants(names, work)
        errs = {name: check(lib, dev, source_of(name) == QK8) for name, lib in libs.items()
                if name not in UNCHECKED}
        errs["as_built K10"] = check(libs["as_built"], dev, True)
        for name, e in errs.items():
            print(f"{name}: largest error {e:.3f} of its bound")
        bad = [name for name, e in errs.items() if not e <= 1.0]
        for shape in args.shape:
            b, n, lq, d = 2, 12, 32760, 128
            lk = lq if shape == "self" else 512
            g = torch.Generator(device=dev).manual_seed(0)
            q = torch.randn(b, n, lq, d, device=dev, generator=g).bfloat16()
            k = torch.randn(b, n, lk, d, device=dev, generator=g).bfloat16()
            v = torch.randn(b, lk, n, d, device=dev, generator=g).bfloat16()
            vt = v.movedim(1, 2).contiguous()

            q8, sq = fa.quantize_bn(q)
            k8, sk = fa.quantize_bn(k)
            c = fa.qk8_scale(sq, sk, d)

            def kernel(lib, shifted, single):
                def call():
                    _build._lib = lib
                    if shifted is None:
                        return fa.flash_qk8_kernel(q8, k8, v, c)
                    return fa.flash_fwd_kernel(q, k, v, single, shifted)
                return call

            def sdpa():
                from torch.nn.attention import SDPBackend, sdpa_kernel

                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return torch.nn.functional.scaled_dot_product_attention(q, k, vt)

            fns = {"sdpa_flash": sdpa}
            forms = {"K1": (False, False), "K2": (True, False)} if shape == "self" else {
                "K3": (False, True), "K3s": (True, True), "K1": (False, False),
                "K2": (True, False)}
            for name in names:
                if shape not in VARIANTS[name][1] or name in bad:
                    continue
                for form, (shifted, single) in forms.items():
                    if shape == "cross" and not single and name != "as_built":
                        continue  # the streaming forms at lk 512: as built only
                    if source_of(name) == "flash_fwd.cu":
                        fns[f"{name} {form}"] = kernel(libs[name], shifted, single)
                if shape == "self" and (name == "as_built" or source_of(name) == QK8):
                    fns[f"{name} K10"] = kernel(libs[name], None, False)
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            calls = args.calls if shape == "self" else 20 * args.calls
            times = {name: [] for name in fns}
            order = list(fns.items())
            for i in range(args.reps):
                for name, fn in order if i % 2 == 0 else order[::-1]:
                    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    ev0.record()
                    for _ in range(calls):
                        fn()
                    ev1.record()
                    torch.cuda.synchronize()
                    times[name].append(ev0.elapsed_time(ev1) / calls)
            flop = 4 * b * n * lq * lk * d
            for name, ts in times.items():
                ms = statistics.median(ts)
                variant = name.split(" ")[0]
                qk8 = name.endswith("K10")
                # K10: half the flop are int8 ops at twice the bf16 peak
                bound_ms = 1e3 * flop * (0.5 / 1979e12 + 0.5 / 989e12 if qk8 else 1 / 989e12)
                err = errs.get("as_built K10" if qk8 and variant == "as_built" else variant)
                print(json.dumps({"shape": shape, "fn": name, "ms": ms,
                                  "turns_ms": [min(ts), max(ts)], "tflops": flop / ms / 1e9,
                                  "of_bound": bound_ms / ms, "err_over_bound": err,
                                  "card": card}))
            if args.clocks and shape == "self":
                for name, fn in fns.items():
                    fn()
                    torch.cuda.synchronize()
                    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    sampler = ClockSampler().start()
                    ev0.record()
                    for _ in range(max(1, int(2000 / statistics.median(times[name])))):
                        fn()
                    ev1.record()
                    torch.cuda.synchronize()
                    print(json.dumps({"shape": shape, "fn": name, "clock_run_s":
                                      ev0.elapsed_time(ev1) / 1e3, "card": card,
                                      **sampler.stop()}))
            del q, k, v, vt, q8, k8
            torch.cuda.empty_cache()
    if bad:
        print(f"variants over their bound: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
