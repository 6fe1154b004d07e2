#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hyvideo_prfl_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Print the card's name and power limit; build the Hopper kernels from
   hyvideo_prfl_torch/csrc and print the build time.
2. Hold each kernel (K8 ln_scale_shift, K6 qk-norm+rope, K1 streaming and
   K3 single-block flash forward) against its plain PyTorch version at the
   t2v-1.3B 832*480 81-frame shapes, with a stated bound, and time both
   with CUDA events, in turns.
3. Whole-model check: WanModel at t2v-1.3B width with 2 blocks on the
   9-frame grid (4,680 tokens), seeded weights with a non-zero head, loaded
   through utils/checkpoint.from_jax_params, on the card against the same
   module on the CPU (which runs the plain versions).
4. Serve through the CLI path (scripts/inference_torch.py) at t2v-1.3B
   full width and depth, 832*480, CFG 5.0, pipeline built once: two
   21-frame requests with 4 UniPC steps, one 81-frame request with 2 steps.
   Latents must be finite and of the expected shape, and every kernel's
   launch count must match the number of DiT forwards.

The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE = "832*480"
GRID_81 = (21, 30, 52)   # latent grid of an 81-frame 832*480 request
GRID_9 = (3, 30, 52)
TEXT_LEN = 512
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "K8": ("hyvideo_prfl_torch/csrc/ln_scale_shift.cu",
           "hyvideo_prfl_tpu/ops/stream.py:75"),
    "K6": ("hyvideo_prfl_torch/csrc/qknorm_rope.cu",
           "hyvideo_prfl_tpu/ops/qknorm_rope.py:85"),
    "K1": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:250"),
    "K3": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:331"),
}


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_err(got, ref):
    import torch

    d = (got.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item(), bool(torch.isfinite(got.float()).all())


def timed_pair(kernel_fn, plain_fn, reps=5, calls=10):
    """Median ms per call of kernel and plain version, in turns (plain,
    kernel, kernel, plain, ...) after a warm-up. Each turn times `calls`
    back-to-back calls between two CUDA events, so the queue stays full and
    the host's launch cost is hidden behind the device's work."""
    import torch

    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for i in range(reps):
        order = (("plain", plain_fn), ("kernel", kernel_fn))
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(calls):
                fn()
            ev1.record()
            torch.cuda.synchronize()
            times[name].append(ev0.elapsed_time(ev1) / calls)
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def report(name, err, ref_max, finite, bound, ms, plain_ms, results):
    print(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e}, max|ref| {ref_max:.3e}),"
          f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    expect(finite, f"{name}: non-finite output")
    expect(err <= bound, f"{name}: error {err} over bound {bound}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(results):
    """Phase 2: each kernel against its plain version at the 81-frame shapes."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    b, n, d = 2, 12, 128
    dim = n * d
    lq = math.prod(GRID_81)

    # K8: the block sites write bf16, the head writes fp32.
    # Bound: the two differ only in fp32 summation order, which can move a
    # value across a rounding boundary: one bf16 ulp of the largest |out|
    # (2^-7 max|ref|) for bf16, 1e-5 max|ref| for fp32.
    x = torch.randn(b, lq, dim, device=dev, generator=g)
    s = 1.0 + 0.1 * torch.randn(b, dim, device=dev, generator=g)
    t = 0.1 * torch.randn(b, dim, device=dev, generator=g)
    ref32 = stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.float32)
    e32, m32, f32 = max_err(stream._kernel(x, s, t, 1e-6, torch.float32), ref32)
    print(f"  K8 fp32-out: max_abs_err {e32:.3e} (bound {1e-5 * m32:.3e})")
    expect(f32 and e32 <= 1e-5 * m32, "K8 fp32-out disagrees with its plain version")
    ref = stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.bfloat16)
    err, rmax, fin = max_err(stream._kernel(x, s, t, 1e-6, torch.bfloat16), ref)
    ms, pms = timed_pair(lambda: stream._kernel(x, s, t, 1e-6, torch.bfloat16),
                         lambda: stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.bfloat16))
    report("K8", err, rmax, fin, 2.0 ** -7 * rmax, ms, pms, results)
    del x, ref, ref32

    # K6 with rope (self-attention q/k at 32,760 tokens) and without (cross
    # q at 32,760, cross k at the 512 text tokens).
    # Bound: r differs in its last fp32 bits, so bf16(x r) may round the
    # other way, and the rope sum mixes two such values: two bf16 ulps of
    # the largest |out| (2^-6 max|ref|).
    xq = torch.randn(b, lq, dim, device=dev, generator=g).bfloat16()
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    for name, xx, rope in (("norm-only q", xq, False),
                           ("norm-only k", xq[:, :TEXT_LEN].contiguous(), False)):
        e_, m_, f_ = max_err(qr._kernel(xx, w, None, None, n, 1e-6, rope),
                             qr.rmsnorm_rope_plain(xx, w, None, None, n, 1e-6, rope))
        print(f"  K6 {name}: max_abs_err {e_:.3e} (bound {2.0 ** -6 * m_:.3e})")
        expect(f_ and e_ <= 2.0 ** -6 * m_, f"K6 {name} disagrees with its plain version")
    ref = qr.rmsnorm_rope_plain(xq, w, c_tab, s_tab, n, 1e-6, True)
    err, rmax, fin = max_err(qr._kernel(xq, w, c_tab, s_tab, n, 1e-6, True), ref)
    ms, pms = timed_pair(lambda: qr._kernel(xq, w, c_tab, s_tab, n, 1e-6, True),
                         lambda: qr.rmsnorm_rope_plain(xq, w, c_tab, s_tab, n, 1e-6, True))
    report("K6", err, rmax, fin, 2.0 ** -6 * rmax, ms, pms, results)
    del xq, ref

    # K1 (self-attention, 32,760 keys: a 56-key ragged last tile) and K3
    # (text cross-attention, 512 keys). Unit-variance q/k stand in for the
    # qk-normed activations. The plain version runs in chunks of q rows.
    # Bound: exp2 on the card is within 2 ulp of torch.exp2, so bf16(p) can
    # round the other way for a few keys, and o is rounded to bf16: two bf16
    # ulps of the largest |o| (2^-6 max|ref|); lse 1e-5 max|lse| (fp32 sums
    # in another order).
    q = torch.randn(b, n, lq, d, device=dev, generator=g).bfloat16()
    for name, lk in (("K1", lq), ("K3", TEXT_LEN)):
        k = torch.randn(b, n, lk, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, d, device=dev, generator=g).bfloat16()
        single = name == "K3"
        expect(fa.uses_single_block(lk) == single, f"{name}: wrong route for lk={lk}")
        o, lse = fa.flash_fwd_kernel(q, k, v, single)
        po, plse = fa.flash_attention_plain(q, k, v)
        el, ml, fl = max_err(lse, plse)
        print(f"  {name} lse: max_abs_err {el:.3e} (bound {1e-5 * ml:.3e})")
        expect(fl and el <= 1e-5 * ml, f"{name} lse disagrees with its plain version")
        err, rmax, fin = max_err(o, po)
        del o, lse, po, plse
        ms, pms = timed_pair(lambda: fa.flash_fwd_kernel(q, k, v, single),
                             lambda: fa.flash_attention_plain(q, k, v), reps=3, calls=2)
        tflops = 4 * b * n * lq * lk * d / (ms * 1e9)
        print(f"  {name}: {tflops:.1f} TFLOP/s (kernel), "
              f"{4 * b * n * lq * lk * d / (pms * 1e9):.1f} TFLOP/s (plain)")
        report(name, err, rmax, fin, 2.0 ** -6 * rmax, ms, pms, results)
        del k, v
    del q
    torch.cuda.empty_cache()


def phase_model():
    """Phase 3: 2-block full-width WanModel, card against CPU."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = wan_dit.t2v_1_3b(num_layers=2)
    state = from_jax_params(seeded_jax_tree(cfg, seed=7), cfg)
    rng = np.random.default_rng(8)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = torch.from_numpy(rng.standard_normal((2, f, hh, ww, 16), dtype=np.float32))
    t = torch.tensor([900.0, 300.0])
    ctx = torch.from_numpy(rng.standard_normal((2, TEXT_LEN, cfg.text_dim), dtype=np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = wan_dit.WanModel(cfg, device=torch.device(dev))
        model.load_state_dict(state)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[dev] = model(x.to(dev), t.to(dev), ctx.to(dev)).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"  forward on {dev}: {time.perf_counter() - t0:.2f} s")
        del model
    err, rmax, fin = max_err(outs["cuda"], outs["cpu"])
    # Bound: bf16 matmuls accumulate in another order on the card than on
    # the CPU and activations round to bf16 at a dozen points per block, so
    # after two blocks a few bf16 ulps of the largest value remain:
    # 3e-2 max|cpu|, the CPU tests' bf16 tolerance against JAX.
    bound = 3e-2 * rmax
    print(f"  whole model [2, 3, 60, 104, 16] (4,680 tokens, K1 with a 8-key "
          f"ragged tile): max_abs_err {err:.3e} (bound {bound:.3e}, max|cpu| {rmax:.3e})")
    expect(tuple(outs["cuda"].shape) == (2, f, hh, ww, 16), "whole model: wrong shape")
    expect(fin and bool(torch.isfinite(outs["cpu"]).all()), "whole model: non-finite output")
    expect(rmax > 0, "whole model: output is all zeros")
    expect(err <= bound, f"whole model: error {err} over bound {bound}")
    torch.cuda.empty_cache()


def load_cli():
    path = os.path.join(REPO, "scripts", "inference_torch.py")
    spec = importlib.util.spec_from_file_location("inference_torch", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_serve():
    """Phase 4: three requests through the CLI path; returns launch counts."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_cli()
    args = cli.args_init(["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21",
                          "--sample_steps", "4", "--sample_guide_scale", "5.0",
                          "--device", "cuda"])
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    cfg = pipe.cfg
    dev = torch.device("cuda")
    # the JAX initialisers zero the head, which would make every latent
    # independent of the blocks: give it seeded weights
    with torch.no_grad():
        pipe.model.head.head.weight.normal_(
            0.0, cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    print(f"  pipeline built once in {time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in pipe.model.parameters()) / 1e9:.3f} B params)")

    def embeds(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)

    null = cli.load_or_zeros(None, (1, cfg.text_len, cfg.text_dim), dev)
    requests = [
        cli.Request(seed=42, context=embeds(101), context_null=null, frame_num=21,
                    sample_steps=4, guide_scale=args.sample_guide_scale),
        cli.Request(seed=43, context=embeds(102), context_null=null, frame_num=21,
                    sample_steps=4, guide_scale=args.sample_guide_scale),
        cli.Request(seed=44, context=embeds(103), context_null=null, frame_num=81,
                    sample_steps=2, guide_scale=args.sample_guide_scale),
    ]
    per_forward = {"K8": 3 * cfg.num_layers + 1, "K6": 4 * cfg.num_layers,
                   "K1": cfg.num_layers, "K3": cfg.num_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    totals = {k: 0 for k in per_forward}
    latents = []
    for req in requests:
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = cli.run_request(pipe, req, SIZE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = (1, *cli.latent_grid(SIZE, req.frame_num), 16)
        print(f"  request seed {req.seed}, {req.frame_num} frames, {req.sample_steps} steps: "
              f"{dt:.3f} s, {dt / req.sample_steps:.3f} s/step, latents {tuple(lat.shape)}")
        expect(tuple(lat.shape) == want, f"latents {tuple(lat.shape)}, expected {want}")
        expect(bool(torch.isfinite(lat).all()), "non-finite latents")
        for name, per in per_forward.items():
            got = _build.LAUNCHES[name] - before.get(name, 0)
            expect(got == per * req.sample_steps,
                   f"{name} launched {got} times, expected {per * req.sample_steps}")
            totals[name] += per * req.sample_steps
        latents.append(lat)
    launches = {k: _build.LAUNCHES[k] for k in per_forward}
    expect(launches == totals, f"launch counts {launches}, expected {totals}")
    expect(not torch.equal(latents[0], latents[1]), "two distinct requests gave one result")
    print(f"  launches {launches} (per DiT forward {per_forward})")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def print_ptxas(log: str) -> None:
    """Registers and spills of the kernel instances the slice launches."""
    wanted = {"flash_fwd_bounded_kernelILb0": "K1",
              "flash_fwd_bounded_kernelILb1": "K3",
              "ln_scale_shift_kernelILi12E13__nv_bfloat16": "K8 D=1536 bf16-out",
              "ln_scale_shift_kernelILi12Ef": "K8 D=1536 fp32-out",
              "rmsnorm_rope_kernelILi6ELb1": "K6 12x128 rope",
              "rmsnorm_rope_kernelILi6ELb0": "K6 12x128 norm-only"}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in wanted.items() if k in line), None)
        elif current and ("registers" in line or "spill" in line):
            print(f"  ptxas {current}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "hyvideo_prfl_torch")):
        print("chip_smoke: hyvideo_prfl_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hyvideo_prfl_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t0 = time.perf_counter()
    _build.lib()
    print(f"  kernels built in {_build.build_seconds:.2f} s "
          f"(loaded in {time.perf_counter() - t0:.2f} s)")
    print_ptxas(_build.build_log)

    results = {}
    print("phase 2: kernels against their plain versions at the 81-frame shapes")
    phase_kernels(results)
    print("phase 3: whole-model check, card against CPU")
    phase_model()
    print("phase 4: serving through the CLI path")
    launches = phase_serve()

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
