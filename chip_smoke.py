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
5. Hold each backward kernel (K4 merged and K5 split flash backward, K7
   qk-norm+rope backward, K9 LayerNorm+modulate backward) against its
   plain PyTorch version at the training shapes (81 frames, batch 1), with
   a stated bound, and time both with CUDA events, in turns.
6. Whole-model gradient check: the 2-block full-width WanModel (fp32
   masters, remat "attn") on the 9-frame grid, loss = sum(out * r), every
   parameter's and the input's gradient on the card against the CPU's
   (a CPU run at fp32 compute measures each gradient's bf16 noise), with
   each backward kernel's launch count equal to its derivation.
7. Train through the CLI path (scripts/train_prfl_torch.py) on a seeded
   latent cache: the train_prfl_t2v_480.yaml config at t2v-1.3B (8 PRFL
   steps, fixed_mid 3, no accumulation, remat "attn"), two outer steps at
   21 frames and one at 81. Metrics finite, grad norm above 0, the
   policy's blocks moved, launch counts per outer step equal to the
   derivation (expected_train_launches); prints seconds per refl and SFT
   step and the peak device memory.

The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
    "K4": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:453"),
    "K5": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:371"),
    "K7": ("hyvideo_prfl_torch/csrc/qknorm_rope_bwd.cu",
           "hyvideo_prfl_tpu/ops/qknorm_rope.py:106"),
    "K9": ("hyvideo_prfl_torch/csrc/ln_scale_shift_bwd.cu",
           "hyvideo_prfl_tpu/ops/stream.py:84"),
}


def _add(total, counts, times=1):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n * times
    return total


FWD_BLOCK = {"K8": 3, "K6": 4, "K1": 1, "K3": 1}


def dit_launches(n_layers, backward, ctx_grad=1, head=True, remat_policy="attn"):
    """Kernel launches of one DiT forward, and of its backward.

    A forward launches, per block, three K8 (two adaLN norms and norm3),
    four K6 (self q and k with rope, cross q and k without), one K1
    (self-attention) and one K3 (text cross-attention), plus one K8 at the
    head. The backward launches, per block, three K9, one K4 per attention
    call (every call at the slice's lengths takes the merged route) and one
    K7 per qk-norm whose input needs a gradient: four, or three when the
    text context needs none (the frozen LRM's cross k); plus one K9 at the
    head. Remat re-runs forward work inside the backward: under "attn" each
    block's checkpointed segments re-run up to their last op that saved a
    tensor, which is every K8 and every K6 whose output is differentiated,
    and never K1/K3; under "full" the whole block forward re-runs."""
    total = _add({"K8": 1} if head else {}, FWD_BLOCK, n_layers)
    if backward:
        recompute = {"attn": {"K8": 3, "K6": 3 + ctx_grad}, "full": FWD_BLOCK,
                     "off": {}}[remat_policy]
        total = _add(total, _add({"K9": 3, "K7": 3 + ctx_grad, "K4": 2}, recompute), n_layers)
        if head:
            total = _add(total, {"K9": 1})
    return total


def expected_train_launches(n_policy, n_lrm, mid, remat_policy="attn"):
    """Kernel launches of one outer PRFL step: the refl step (mid no-grad
    rollout forwards, one policy forward and backward, one forward and
    backward of the head-less LRM, whose text context needs no gradient)
    and the SFT step (one policy forward and backward)."""
    policy = dit_launches(n_policy, True, remat_policy=remat_policy)
    lrm = dit_launches(n_lrm, True, ctx_grad=0, head=False, remat_policy=remat_policy)
    return _add(_add(_add({}, dit_launches(n_policy, False), mid), lrm), policy, 2)


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


def phase_serve():
    """Phase 4: three requests through the CLI path; returns launch counts."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_script("inference_torch")
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


def report_many(name, label, checks, results=None, timing=None):
    """Check each (output name, got, ref, bound relative to max|ref|)."""
    worst = 0.0
    for out_name, got, ref, bound_rel in checks:
        err, rmax, fin = max_err(got, ref)
        bound = bound_rel * rmax
        print(f"  {name} {label} {out_name}: max_abs_err {err:.3e} (bound {bound:.3e}, "
              f"max|ref| {rmax:.3e})")
        expect(fin, f"{name} {label} {out_name}: non-finite output")
        expect(err <= bound, f"{name} {label} {out_name}: error {err} over bound {bound}")
        worst = max(worst, err)
    if timing is not None:
        ms, pms = timing
        print(f"  {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": pms}


def phase_bwd_kernels(results):
    """Phase 5: each backward kernel against its plain version at the
    training shapes of the 81-frame slice (batch 1: training has no CFG)."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    n, d = 12, 128
    dim = n * d
    lq = math.prod(GRID_81)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    # Flash backward. Unit-variance q/k stand in for the qk-normed
    # activations, o and lse come from K1/K3, dO is a seeded cotangent.
    # Bound: bf16(p) and bf16(ds) may round the other way where exp2 or an
    # fp32 sum differs in its last bits, and every output rounds to bf16
    # (K4's dq also adds its atomics in a run-dependent order): two bf16
    # ulps of the largest gradient (2^-6 max|ref|) per output.
    cases = (("K4", lq, lq, "self-attention, 32,760 keys (56 valid in the last 64-key tile)"),
             ("K4", lq, TEXT_LEN, "cross-attention, 512 keys"),
             ("K5", 1024, lq, "lq 1,024 (the split route)"),
             ("K5", lq, lq, "self-attention shape, called directly for timing"))
    for name, lq_, lk_, label in cases:
        merged = name == "K4"
        if "directly" not in label:
            expect(fa.uses_merged_bwd(lq_, lk_) == merged, f"{name}: wrong route for {label}")
        q, k = randn(1, n, lq_, d), randn(1, n, lk_, d)
        v = randn(1, lk_, n, d)
        o, lse = fa.flash_fwd_kernel(q, k, v, fa.uses_single_block(lk_))
        do = randn(*o.shape)
        got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        timed = (name == "K4" and lk_ == lq) or "directly" in label
        timing = None
        if timed:
            del got, ref
            timing = timed_pair(lambda: fa.bwd_kernel(q, k, v, o, lse, do, merged),
                                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                                reps=3, calls=1)
            got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
            flop = 10 * n * lq_ * lk_ * d  # five products of 2 flop per multiply-add
            print(f"  {name} {label}: {flop / (timing[0] * 1e9):.1f} TFLOP/s (kernel), "
                  f"{flop / (timing[1] * 1e9):.1f} TFLOP/s (plain), counting the five "
                  f"products of the algorithm{' (K5 runs seven)' if name == 'K5' else ''}")
        report_many(name, label, [(o_, a, b, 2.0 ** -6)
                                  for o_, a, b in zip(("dq", "dk", "dv"), got, ref)],
                    results, timing)
        del q, k, v, o, lse, do, got, ref
        torch.cuda.empty_cache()

    # K7 at the self-attention q/k (rope), cross q (norm only, 32,760 rows)
    # and cross k (norm only, the 512 text rows). Bound: dx rounds to bf16
    # and r differs in its last fp32 bits, so two bf16 ulps of max|dx|; dw
    # sums 32,760 rows in another order and bf16(x r) may round the other
    # way on a few: one bf16 ulp of max|dw| (2^-7).
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    for label, l, rope in (("rope, 32,760 rows", lq, True), ("norm-only, 32,760 rows", lq, False),
                           ("norm-only, 512 rows", TEXT_LEN, False)):
        x = randn(1, l, dim)
        gg = randn(1, n, l, d)
        c, s_ = (c_tab, s_tab) if rope else (None, None)
        got = qr.bwd_kernel(x, w, c, s_, gg, n, 1e-6, rope)
        ref = qr.rmsnorm_rope_bwd_plain(x, w, c, s_, gg, n, 1e-6, rope)
        timing = (timed_pair(lambda: qr.bwd_kernel(x, w, c, s_, gg, n, 1e-6, rope),
                             lambda: qr.rmsnorm_rope_bwd_plain(x, w, c, s_, gg, n, 1e-6, rope))
                  if rope else None)
        report_many("K7", label, [("dx", got[0], ref[0], 2.0 ** -6),
                                  ("dw", got[1], ref[1], 2.0 ** -7)], results, timing)
        del x, gg, got, ref

    # K9 with the blocks' bf16 cotangent and the head's fp32 one. Bound:
    # fp32 throughout; the row sums and the 32,760-row ds/dt sums run in
    # another order: 1e-5 of each output's max.
    x = randn(1, lq, dim, dtype=torch.float32)
    s = 1.0 + 0.1 * torch.randn(1, dim, device=dev, generator=g)
    for label, gdt in (("fp32 g (head)", torch.float32), ("bf16 g (blocks)", torch.bfloat16)):
        gg = randn(1, lq, dim, dtype=gdt)
        got = stream.bwd_kernel(x, s, gg, 1e-6)
        ref = stream.ln_scale_shift_bwd_plain(x, s, gg, 1e-6)
        timing = (timed_pair(lambda: stream.bwd_kernel(x, s, gg, 1e-6),
                             lambda: stream.ln_scale_shift_bwd_plain(x, s, gg, 1e-6))
                  if gdt == torch.bfloat16 else None)
        report_many("K9", label, [(o_, a, b, 1e-5)
                                  for o_, a, b in zip(("dx", "ds", "dt"), got, ref)],
                    results, timing)
        del gg, got, ref
    del x
    torch.cuda.empty_cache()


def phase_grad_model():
    """Phase 6: gradients of the 2-block full-width model, card against CPU."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = wan_dit.t2v_1_3b(num_layers=2, remat_policy="attn")
    state = from_jax_params(seeded_jax_tree(cfg, seed=17), cfg)
    rng = np.random.default_rng(18)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    ctx = rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32)
    r = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    grads, launches = {}, {}
    # the card and the CPU at bf16 compute, and the CPU at fp32 compute,
    # which measures how far bf16 rounding alone moves each gradient
    for key, dev, cd in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                         ("cpu fp32", "cpu", torch.float32)):
        model = wan_dit.WanModel(dataclasses.replace(cfg, compute_dtype=cd),
                                 device=torch.device(dev), param_dtype=torch.float32)
        model.load_state_dict(state)
        xi = torch.from_numpy(x).to(dev).requires_grad_()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model(xi, torch.tensor([700.0], device=dev), torch.from_numpy(ctx).to(dev))
        (out * torch.from_numpy(r).to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        print(f"  forward + backward, {key}: {time.perf_counter() - t0:.2f} s")
        grads[key] = {"input latent": xi.grad.cpu(),
                      **{name: p.grad.cpu() for name, p in model.named_parameters()}}
        del model, out, xi

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Bound: bf16 matmuls and activations round at other points on the card
    # (and K4's dq adds in a run-dependent order), so a gradient may differ
    # from the CPU's bf16 run by a few bf16 ulps of its norm: 2e-2 (about
    # five ulps of 2^-8). The attention k biases are held to the CPU's fp32
    # run instead: their gradient is a sum over keys that nearly cancels
    # (softmax ignores a shift shared by all keys; only the RMSNorm breaks
    # it), so bf16 rounding alone moves it by a large part of its small
    # norm, on the CPU as on the card. The card rounds at as many points as
    # the CPU, so its distance from fp32 may be at most 1.5x the CPU bf16
    # run's; a K4 or K7 fault in that sum moves it further.
    worst = []
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        expect(bool(torch.isfinite(got).all()), f"gradient of {name}: non-finite")
        expect(ref.norm().item() > 0, f"gradient of {name} is zero on the CPU")
        if name.endswith(".k.bias"):
            exact = grads["cpu fp32"][name]
            noise, err = rel(ref, exact), rel(got, exact)
            print(f"  {name}: card against CPU fp32 {err:.3e} (bound 1.5 x {noise:.3e}, "
                  f"the CPU bf16 run against fp32); card against CPU bf16 {rel(got, ref):.3e}")
            expect(err <= 1.5 * noise, f"gradient of {name}: card against CPU fp32 {err:.3e} "
                                       f"over 1.5 x {noise:.3e}")
            continue
        err = rel(got, ref)
        worst.append((err, name))
        expect(err <= 2e-2, f"gradient of {name}: relative error {err:.3e} over 2e-2")
    worst.sort(reverse=True)
    print(f"  the other {len(worst)} gradients (every parameter and the input latent) within "
          f"2e-2 of the CPU bf16 run's, relative to their norms; the largest:")
    for err, name in worst[:5]:
        print(f"    {name}: {err:.3e}")
    want = dit_launches(cfg.num_layers, True)
    print(f"  launches {launches}, derived {want}")
    expect(launches == want, f"launches {launches}, expected {want}")
    torch.cuda.empty_cache()


TRAIN_CONFIG = {  # configs/train_prfl_t2v_480.yaml, with the smoke's changes marked
    "train_id": "prfl_t2v_480",
    "task": "t2v-1.3b",                      # changed from t2v-14b
    "prfl_inference_steps": 8,               # added: 8 steps
    "model": {
        "base_path": None,                    # no weights in the repository
        "patch_size": [1, 2, 2],
        "lora": {"use_lora": False, "lora_rank": 128,
                 "target_modules": ["q", "k", "v", "o"]},
        "ema": {"use_ema": False, "ema_decay": 0.99},
        "fsdp": {"fsdp_sharding_startegy": "full", "use_cpu_offload": False},
        "gradient_checkpointing": True,
        "remat_policy": "attn",
        "selective_checkpointing": 1.0,
    },
    "extra_model": {"scheduler": {"flow_shift": 5.0, "num_train_timesteps": 1000,
                                  "weighting_scheme": "uniform", "logit_mean": 0,
                                  "logit_std": 1, "mode_scale": 1.29}},
    "dataset": {"uncond_prob": [0.1, 0.0], "sp_size": 1, "batch_size": 1},
    "optimizer": {"learning_rate": 5e-6, "adam_beta1": 0.9, "adam_beta2": 0.999,
                  "weight_decay": 0.01, "lr_scheduler": "constant", "lr_warmup_steps": 0,
                  "max_train_steps": 1000000},
    "train": {"seed": 110221, "precision": "bf16", "save_interval": 100,
              "sanity_check_interval": 100,
              "gradient_accumulation_steps": 1,  # changed from 5
              "fixed_mid": 3},                   # added
    "lrm": {"query_attention": {"num_queries": 1, "num_heads": 8, "dropout": 0.0,
                                "return_type": "query"},
            "feature_layer": [8], "pool": "q_attn", "mlp_dim": 5120,
            "task": "motion_quality", "trainable_blocks": [0, 1, 2, 3, 4, 5, 6, 7]},
}


def write_latent_cache(root, frame_counts):
    """A seeded latent cache in the reference's layout (temp_data_smoke/) at
    the slice's shapes: latents [1, 16, F, 60, 104], text [1, n, 4096].
    Returns {frames: meta list path}."""
    rng = np.random.default_rng(21)
    null_dir = os.path.join(root, "null", "wanx")
    os.makedirs(null_dir)
    os.makedirs(os.path.join(root, "latents"))
    np.save(os.path.join(null_dir, "null.npy"), rng.standard_normal((1, 1, 4096), np.float32))
    np.save(os.path.join(null_dir, "uncond.npy"),
            rng.standard_normal((1, 20, 4096), np.float32))
    lists = {}
    for frames in frame_counts:
        lat_f = (frames - 1) // 4 + 1
        stem = os.path.join(root, "latents", f"clip{frames}")
        meta = {"vae_latent_path": stem + ".npy", "textshort_path": stem + "_short.npy",
                "textlong_path": stem + "_long.npy", "short_caption": f"clip {frames}",
                "long_caption": f"a longer caption for clip {frames}"}
        np.save(meta["vae_latent_path"],
                rng.standard_normal((1, 16, lat_f, 60, 104), np.float32))
        np.save(meta["textshort_path"], rng.standard_normal((1, 12, 4096), np.float32))
        np.save(meta["textlong_path"], rng.standard_normal((1, 48, 4096), np.float32))
        meta_path = stem + "_meta.json"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        lists[frames] = stem + ".list"
        with open(lists[frames], "w") as f:
            f.write(meta_path + "\n")
    return lists, os.path.join(root, "null")


def load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_train(root):
    """Phase 7: PRFL training through the CLI path; returns launch counts."""
    import torch

    from hyvideo_prfl_torch.configs import config_from_dict
    from hyvideo_prfl_torch.data.dataset import LatentCacheDataset
    from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler
    from hyvideo_prfl_torch.ops import _build

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(root, (21, 81))
    raw = json.loads(json.dumps(TRAIN_CONFIG))
    raw["dataset"].update(meta_file_list=[lists[21]], null_dir=null_dir)
    raw["save"] = {"output_dir": os.path.join(root, "out")}
    config = config_from_dict(raw)
    t0 = time.perf_counter()
    trainer = cli.build_trainer(config, "cuda")
    model = trainer.model
    cfg = model.dit_cfg
    dev = torch.device("cuda")
    # the JAX initialisers zero the head, which would give every block a
    # zero gradient in the first refl step: give it seeded weights
    with torch.no_grad():
        model.dit.head.head.weight.normal_(
            0.0, cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    n_lrm = model.lrm.dit_cfg.num_layers
    print(f"  trainer built in {time.perf_counter() - t0:.2f} s: policy "
          f"{sum(p.numel() for p in model.dit.parameters()) / 1e9:.3f} B fp32 master params, "
          f"{cfg.num_layers} blocks; LRM {n_lrm} blocks, frozen")
    watched = {name: p.detach().clone() for name, p in model.dit.named_parameters()
               if name in ("blocks.0.ffn_0.weight", "blocks.29.self_attn.q.weight",
                           "blocks.15.modulation", "blocks.0.self_attn.norm_q")}
    lrm_before = model.lrm.mlp.Dense_0.weight.detach().clone()
    per_step = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                       cfg.remat_policy)

    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hist = cli.run(trainer, 2)
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    want = _add({}, per_step, 2)
    for m in hist:
        print(f"  21 frames (9,360 tokens), step {m['step']}: refl_loss {m['refl_loss']:.6f}, "
              f"reward {m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss "
              f"{m['sft_loss']:.6f}, t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s")
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            expect(math.isfinite(m[key]), f"{key} is not finite: {m}")
        expect(m["grad_norm"] > 0, f"grad norm {m['grad_norm']} is not above 0")
    for name, before in watched.items():
        p = dict(model.dit.named_parameters())[name]
        moved = (p.detach() != before).float().mean().item()
        print(f"  {name}: {moved:.1%} of its entries moved")
        expect(moved > 0, f"policy weight {name} did not move")
    expect(torch.equal(model.lrm.mlp.Dense_0.weight, lrm_before), "the frozen LRM moved")
    print(f"  launches over 2 outer steps {got}, derived {want} (per step {per_step})")
    expect(got == want, f"launches {got}, expected {want}")
    print(f"  peak device memory at 21 frames {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ds81 = LatentCacheDataset([lists[81]], uncond_prob=[0.1, 0.0], text_len=512,
                              null_dir=null_dir, seed=1)
    trainer.loader = iter(BatchIterator(ds81, BlockDistributedSampler(len(ds81))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (m,) = cli.run(trainer, 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = dict(_build.LAUNCHES)
    want = _add({}, per_step, 3)
    print(f"  81 frames (32,760 tokens): refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s")
    print(f"  peak device memory at 81 frames {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite at 81 frames: {m}")
    expect(peak < 80e9, f"peak memory {peak} does not fit 80 GB")
    expect(got == want, f"launches over 3 outer steps {got}, expected {want}")
    del trainer, model
    torch.cuda.empty_cache()
    return got


def print_ptxas(log: str) -> None:
    """Registers and spills of the kernel instances the slice launches."""
    wanted = {"flash_fwd_bounded_kernelILb0": "K1",
              "flash_fwd_bounded_kernelILb1": "K3",
              "flash_bwd_dkv_kernelILb1": "K4",
              "flash_bwd_dkv_kernelILb0": "K5 dk/dv",
              "flash_bwd_dq_kernel": "K5 dq",
              "rmsnorm_rope_bwd_kernelILi6ELb1": "K7 12x128 rope",
              "rmsnorm_rope_bwd_kernelILi6ELb0": "K7 12x128 norm-only",
              "ln_scale_shift_bwd_kernelILi12E13__nv_bfloat16": "K9 D=1536 bf16-g",
              "ln_scale_shift_bwd_kernelILi12Ef": "K9 D=1536 fp32-g",
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
    serve_launches = phase_serve()
    print("phase 5: backward kernels against their plain versions at the training shapes")
    phase_bwd_kernels(results)
    print("phase 6: whole-model gradients, card against CPU")
    phase_grad_model()
    print("phase 7: PRFL training through the CLI path")
    with tempfile.TemporaryDirectory() as root:
        train_launches = phase_train(root)
    # every kernel of the training path ran there; K5 is not on it (the JAX
    # rule routes every full-width call to K4) and is held and timed in phase 5
    expect(all(train_launches.get(k, 0) > 0 for k in KERNELS if k != "K5"),
           f"a kernel of the training path never launched: {train_launches}")
    print(f"  serving launches {serve_launches}; training launches {train_launches}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train_launches.get(name, 0), **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
