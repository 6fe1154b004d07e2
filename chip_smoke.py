#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hyvideo_prfl_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Print the card's name and power limit; build the Hopper kernels from
   hyvideo_prfl_torch/csrc (one nvcc per source, all at once) and print the
   build time, each slice kernel's registers and spills (K1-K5, K3s, K10
   and the norm kernels' wide instances must have none), the shared memory
   of the forward, K4 (and K5's dk/dv pass), K5's dq pass and K10, and the
   warpgroup MMA and TMA load instructions in the disassembly of K1, K2,
   K3, K3s, K4, both K5 passes (HGMMA, UTMALDG) and K10 (IGMMA for the
   int8 score, HGMMA for p v, UTMALDG): all must be there.
2. Hold each forward kernel (K8 ln_scale_shift, K6 qk-norm+rope, K1
   streaming and K3 single-block flash forward, K10 int8-score flash
   forward) against its plain PyTorch version at the t2v-1.3B 832*480
   81-frame CFG-2 shapes, with a stated bound, K10 also against K1, and
   time each with CUDA events, in turns with its plain version and, where
   one PyTorch call computes the same function, that call (K10 in turns
   with K1). K1 and K3
   (both TMA/wgmma instances of flash_fwd.cu) print TFLOP/s and their
   share of the bound; K3 is timed over 20 calls a turn, in turns also
   with the streaming form at the same 512 keys (streaming_ms).
   2b. The same for the shifted forward K2 (also against K1, with a user
   key mask, and at logits near 300, where K1 overflows), its single-block
   form K3s at the cross-attention shape (timed as K3, in turns with K3,
   SDPA and the shifted streaming form), and the rope R forward and
   backward (bit for bit).
3. Whole-model check: WanModel at t2v-1.3B width with 2 blocks on the
   9-frame grid (4,680 tokens), seeded weights with a non-zero head, loaded
   through utils/checkpoint.from_jax_params, on the card against the same
   module on the CPU (which runs the plain versions); then the same for
   the int8 model (W8A8 block matmuls and the int8 self-attention, K10).
4. Serve through the CLI path (scripts/inference_torch.py) at t2v-1.3B
   full width and depth, 832*480, CFG 5.0: two 21-frame requests with 4
   UniPC steps and one 81-frame request with 2 steps in bf16, the 81-frame
   one again on the shifted route (HYV_FLASH_BOUNDED=0: K2 and K3s, no
   K1/K3), then the first and the last again under --quant int8
   --quant_attn int8. Latents must be finite and of the expected shape,
   every kernel's launch count must match the number of DiT forwards, and
   the shifted and int8 latents must lie near the bf16 ones of the same
   seed.
5. Hold each backward kernel (K4 merged and K5 split flash backward, K7
   qk-norm+rope backward, K9 LayerNorm+modulate backward) against its
   plain PyTorch version at the training shapes (81 frames, batch 1), with
   a stated bound, and time each with its plain version and, for K4/K5,
   the flash backward of PyTorch's scaled_dot_product_attention; K4 at
   the self-attention and at the text cross-attention (lk 512: cross_*);
   K5 at the self-attention (in turns with K4 too, as k4_ms) and at lq
   1,024 (short_q_*: the split route through the autograd op, the dq
   pass's key range split as the wrapper picks it, and unsplit as
   short_q_unsplit_ms).
   5b. K4 and K5 with a key mask: within their bound, masked keys'
   gradients exactly 0.
6. Whole-model gradient check: the 2-block full-width WanModel (fp32
   masters, remat "attn") on the 9-frame grid, loss = sum(out * r), the
   output (phase 3's bound) and every parameter's and the input's
   gradient on the card against the CPU's
   (a CPU run at fp32 compute measures each gradient's bf16 noise), with
   each backward kernel's launch count equal to its derivation.
7. Train through the CLI path (scripts/train_prfl_torch.py) on a seeded
   latent cache: the train_prfl_t2v_480.yaml config at t2v-1.3B (8 PRFL
   steps, fixed_mid 3, no accumulation, remat "attn"), two outer steps at
   21 frames and one at 81; then, from the same weights and draws, one at
   21 and one at 81 with train.rollout_quant int8, one at 21 on the
   shifted route, and one at 21 with every backward on K5
   (HYV_FLASH_MERGED_BWD=0). Metrics finite, grad norm above 0, the
   policy's blocks moved, launch counts per outer step equal to the
   derivation (expected_train_launches), the int8 run's first reward
   within 0.05, the shifted and the split-backward runs' within 0.01 of
   the bf16 run's; prints seconds per refl and SFT step and the peak device
   memory.
8. The int8 probes P1 and P2 through their scripts
   (scripts/probe_int8_{rate,mosaic}_torch.py): exact against their plain
   versions, int8 and bf16 TOPS beside torch._int_mm's and torch.matmul's.
9. The un-normed DiT (qk_norm off, the shifted route by nature, R for its
   rope): 2 blocks (and no norm3) card against CPU, output and every
   gradient, as phases 3 and 6; then 30 blocks at 81 frames, one
   batched-CFG forward through the pipeline, latents finite and the R,
   K2 and K3s launches as derived.
10. The 14B width: K6-K9 against their plain versions at [1, 75,600, 5120]
   with 40 heads (t2v-14B at 720*1280, 81 frames; the norm kernels' wide
   row layout) and at [1, 3,120, 1280] with 10 heads (bench.py's shape),
   timed beside their byte bounds; K1 and K2 against their plain versions
   at the 14B self-attention's sequence-parallel shards (40 heads x 18,900
   tokens; 10 and 5 heads x 75,600), timed beside SDPA's flash forward; a 2-block t2v-14B model, output and
   every gradient card against CPU at one latent frame of 832*480 (1,560
   tokens), as phases 3 and 6; the same blocks forward and backward at
   720*1280 and 81 frames on the card, gradients finite and launches as
   derived, with seconds and peak memory.

The line before the last is a JSON object of per-kernel results (launches
counted on the main paths: serving and training for the forward and
backward kernels, the split-route gradient call and the split-backward
training step for K5, the probe scripts for P1/P2, the un-normed pipeline
for R); the last is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the package is missing.
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
    "K2": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:198"),
    "K3s": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
            "hyvideo_prfl_tpu/ops/flash_attention.py:351"),
    "K4": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:453"),
    "K5": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:371"),
    "K7": ("hyvideo_prfl_torch/csrc/qknorm_rope_bwd.cu",
           "hyvideo_prfl_tpu/ops/qknorm_rope.py:106"),
    "K9": ("hyvideo_prfl_torch/csrc/ln_scale_shift_bwd.cu",
           "hyvideo_prfl_tpu/ops/stream.py:84"),
    "K10": ("hyvideo_prfl_torch/csrc/flash_fwd_qk8.cu",
            "hyvideo_prfl_tpu/ops/flash_attention.py:290"),
    "P1": ("hyvideo_prfl_torch/csrc/int8_probe.cu", "scripts/probe_int8_rate.py:25"),
    "P2": ("hyvideo_prfl_torch/csrc/int8_probe.cu", "scripts/probe_int8_mosaic.py:29"),
    "R": ("hyvideo_prfl_torch/csrc/rope.cu", "hyvideo_prfl_tpu/ops/rope_pallas.py:32"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s, ops/s by type
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _add(total, counts, times=1):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n * times
    return total


def dit_launches(n_layers, backward, ctx_grad=1, head=True, remat_policy="attn", qk8=False,
                 shifted=False, qk_norm=True, cross_attn_norm=True, self_single=False,
                 merged_bwd=True):
    """Kernel launches of one DiT forward, and of its backward.

    A forward launches, per block, three K8 (two adaLN norms and norm3; two
    without cross_attn_norm), four K6 (self q and k with rope, cross q and
    k without; none without qk_norm, where two R rotate the self q and k
    instead), one self-attention forward and one text cross-attention
    forward, plus one K8 at the head. The attention forwards are K1 and K3,
    or K10 and K3 under quant_attn "int8" (qk8, at the slice's streaming
    lengths), or K2 and K3s on the shifted route (HYV_FLASH_BOUNDED=0,
    shifted, or no qk_norm). With ``self_single`` (a token count whose keys
    fit one block, uses_single_block) the self-attention takes the
    single-block form too: K3, or K3s on the shifted route; the int8
    forward only takes streaming keys. The int8 forward has no backward. The backward
    launches, per block, one K9 per K8, one K4 per attention call (every
    call at the slice's lengths takes the merged route; K5 in its place
    under HYV_FLASH_MERGED_BWD=0, ``merged_bwd`` False) and one K7 per
    qk-norm whose input needs a gradient: four, or three when the text
    context needs none (the frozen LRM's cross k), or two R (the rotations'
    backward) without qk_norm; plus one K9 at the head. Remat re-runs
    forward work inside the backward: under "attn" each block's
    checkpointed segments re-run up to their last op that saved a tensor,
    which is every K8, every K6 whose output is differentiated and every
    R, never the attention forward; under "full" the whole block forward
    re-runs."""
    k8 = 2 + int(cross_attn_norm)
    norms = {"K6": 4} if qk_norm else {"R": 2}
    if qk8 and qk_norm and not shifted:
        attn = {"K10": 1, "K3": 1}
    elif shifted or not qk_norm:
        attn = {"K2": 1, "K3s": 1}
    else:
        attn = {"K1": 1, "K3": 1}
    if self_single:
        attn = {"K3s": 2} if shifted or not qk_norm else {"K3": 2}
    fwd_block = {"K8": k8, **norms, **attn}
    total = _add({"K8": 1} if head else {}, fwd_block, n_layers)
    if backward:
        norm_recompute = {"K6": 3 + ctx_grad} if qk_norm else {"R": 2}
        recompute = {"attn": {"K8": k8, **norm_recompute}, "full": fwd_block,
                     "off": {}}[remat_policy]
        norm_bwd = {"K7": 3 + ctx_grad} if qk_norm else {"R": 2}
        attn_bwd = {"K4" if merged_bwd else "K5": 2}
        total = _add(total, _add({"K9": k8, **norm_bwd, **attn_bwd}, recompute), n_layers)
        if head:
            total = _add(total, {"K9": 1})
    return total


def expected_train_launches(n_policy, n_lrm, mid, remat_policy="attn", rollout_quant=None,
                            shifted=False, merged_bwd=True):
    """Kernel launches of one outer PRFL step: the refl step (mid no-grad
    rollout forwards, through the int8 model under rollout_quant "int8",
    one policy forward and backward, one forward and backward of the
    head-less LRM, whose text context needs no gradient) and the SFT step
    (one policy forward and backward); ``shifted`` for HYV_FLASH_BOUNDED=0,
    ``merged_bwd`` False for HYV_FLASH_MERGED_BWD=0."""
    policy = dit_launches(n_policy, True, remat_policy=remat_policy, shifted=shifted,
                          merged_bwd=merged_bwd)
    lrm = dit_launches(n_lrm, True, ctx_grad=0, head=False, remat_policy=remat_policy,
                       shifted=shifted, merged_bwd=merged_bwd)
    rollout = dit_launches(n_policy, False, qk8=rollout_quant == "int8", shifted=shifted)
    return _add(_add(_add({}, rollout, mid), lrm), policy, 2)


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_err(got, ref):
    import torch

    d = (got.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item(), bool(torch.isfinite(got.float()).all())


def timed_turns(fns, reps=5, calls=10):
    """Median ms per call of each named function, in turns (forward order,
    then reversed, ...) after a warm-up. Each turn times `calls`
    back-to-back calls between two CUDA events, so the queue stays full and
    the host's launch cost is hidden behind the device's work."""
    import torch

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
    return {name: statistics.median(t) for name, t in times.items()}


def timed_pair(kernel_fn, plain_fn, reps=5, calls=10):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain, ..."""
    t = timed_turns({"plain": plain_fn, "kernel": kernel_fn}, reps, calls)
    return t["kernel"], t["plain"]


def bound(nbytes, **ops):
    """The least time the card could take for the work: the bytes it must
    move (each input read once, each output written once) over the memory
    rate, or the operations over each type's peak, whichever is larger."""
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa_flash(q, k, v):
    """PyTorch's own flash attention on [B, N, L, D] q/k/v: the library call
    timed beside K1/K3 and, through its backward, K4/K5 (library_ms). The
    port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def report(name, err, ref_max, finite, bound_, ms, plain_ms, results, **extra):
    print(f"  {name}: max_abs_err {err:.3e} (bound {bound_:.3e}, max|ref| {ref_max:.3e}),"
          f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + "".join(f", {k} {v:.4f}" for k, v in extra.items() if isinstance(v, float)))
    expect(finite, f"{name}: non-finite output")
    expect(err <= bound_, f"{name}: error {err} over bound {bound_}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra}


def phase_kernels(results):
    """Phase 2: each forward kernel against its plain version at the
    81-frame shapes."""
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
    rows = b * lq * dim

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
    # no single PyTorch call: layer_norm has no per-batch modulation and
    # writes its input's type, not bf16 from fp32
    report("K8", err, rmax, fin, 2.0 ** -7 * rmax, ms, pms, results,
           **bound(rows * (4 + 2), fp32=8 * rows), library_ms=None)
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
    # no single PyTorch call: rms_norm over the 1,536 features of all heads
    # fused with the rope and the head-major relayout
    report("K6", err, rmax, fin, 2.0 ** -6 * rmax, ms, pms, results,
           **bound(rows * (2 + 2) + 2 * lq * d * 4, fp32=7 * rows), library_ms=None)
    del xq, ref

    # K1 (self-attention, 32,760 keys: a 56-key ragged last tile) and K3
    # (text cross-attention, 512 keys). Unit-variance q/k stand in for the
    # qk-normed activations. The plain version runs in chunks of q rows.
    # Bound: exp2 on the card is within 2 ulp of torch.exp2, so bf16(p) can
    # round the other way for a few keys, and o is rounded to bf16: two bf16
    # ulps of the largest |o| (2^-6 max|ref|); lse 1e-5 max|lse| (fp32 sums
    # in another order).
    q = torch.randn(b, n, lq, d, device=dev, generator=g).bfloat16()
    keep = {}
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
        if name == "K1":
            keep = {"k": k, "v": v, "o": o, "po": po}
        del o, lse, po, plse
        vt = v.movedim(1, 2).contiguous()  # SDPA's [B, N, L, D]
        fns = {"plain": lambda: fa.flash_attention_plain(q, k, v),
               "kernel": lambda: fa.flash_fwd_kernel(q, k, v, single),
               "library": lambda: sdpa_flash(q, k, vt)}
        if single:
            # the streaming form at the same lk: K1's instance over 4 tiles
            fns["streaming"] = lambda: fa.flash_fwd_kernel(q, k, v, False)
        # K3 runs in well under a millisecond: 20 calls a turn keep the
        # wrapper's host time out of the events
        t = timed_turns(fns, reps=5, calls=20) if single else timed_turns(fns, reps=3, calls=2)
        flop = 4 * b * n * lq * lk * d
        bnd = bound(2 * b * n * (lq + lk) * d * 2, bf16=flop)
        extra = {"streaming_ms": t["streaming"]} if single else {}
        print(f"  {name}: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
              f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), "
              f"{flop / (t['plain'] * 1e9):.1f} (plain), "
              f"{flop / (t['library'] * 1e9):.1f} (SDPA flash)"
              + (f", {flop / (t['streaming'] * 1e9):.1f} (streaming form)" if single else ""))
        report(name, err, rmax, fin, 2.0 ** -6 * rmax, t["kernel"], t["plain"], results,
               **bnd, library_ms=t["library"], **extra)
        del vt
        if name == "K3":
            del k, v

    # K10 at the self-attention shape, on K1's inputs: q and k quantized per
    # (batch, head) as the port quantizes them before the launch.
    # Bound against its plain version (same q8, k8, c): the int32 scores are
    # exact on both; exp2 within 2 ulp flips bf16(p) on a few keys and o
    # rounds to bf16: two bf16 ulps of max|o|, lse 1e-5 max|lse|, as K1.
    k, v = keep["k"], keep["v"]
    q8, sq = fa.quantize_bn(q)
    k8, sk = fa.quantize_bn(k)
    c = fa.qk8_scale(sq, sk, d)
    o10, lse10 = fa.flash_qk8_kernel(q8, k8, v, c)
    po10, plse10 = fa.flash_attention_qk8_plain(q8, k8, v, c)
    el, ml, fl = max_err(lse10, plse10)
    print(f"  K10 lse: max_abs_err {el:.3e} (bound {1e-5 * ml:.3e})")
    expect(fl and el <= 1e-5 * ml, "K10 lse disagrees with its plain version")
    err, rmax, fin = max_err(o10, po10)
    # Against K1 on the same bf16 q/k/v: the plain versions differ only by
    # the quantization of q and k (their max distance is that effect), and
    # each kernel lies within two bf16 ulps of max|o| of its plain version,
    # so |K10 - K1| <= max|plain10 - plain1| + 4 ulps. First-order, the
    # per-head rounding (a uniform error of s/2 on 256 terms, s = max|x|/127)
    # moves each logit by ~0.017 here, and o, an average over ~32k keys,
    # by ~1e-4; the check prints what the card shows.
    quant, _, _ = max_err(po10, keep["po"])
    e1, m1, _ = max_err(o10, keep["o"])
    b1 = quant + 4 * 2.0 ** -7 * m1
    print(f"  K10 against K1: max_abs_err {e1:.3e} (bound {b1:.3e}: quantization effect "
          f"{quant:.3e} between the plain versions, max|o| {m1:.3e})")
    expect(e1 <= b1, f"K10 against K1: {e1} over {b1}")
    del o10, lse10, po10, plse10, keep
    t = timed_turns({"plain": lambda: fa.flash_attention_qk8_plain(q8, k8, v, c),
                     "kernel": lambda: fa.flash_qk8_kernel(q8, k8, v, c),
                     "K1": lambda: fa.flash_fwd_kernel(q, k, v, False)}, reps=3, calls=2)
    tq = timed_turns({"quantize": lambda: (fa.quantize_bn(q), fa.quantize_bn(k))},
                     reps=3, calls=2)["quantize"]
    ops = 2 * b * n * lq * lq * d  # of each product
    print(f"  K10: {2 * ops / (t['kernel'] * 1e9):.1f} TOPS (int8 score + bf16 p v), K1 "
          f"{2 * ops / (t['K1'] * 1e9):.1f} TFLOP/s in the same turns; per-head "
          f"quantization of q and k outside the kernel {tq:.4f} ms")
    # no single PyTorch call computes the int8 score softmax: library_ms null
    report("K10", err, rmax, fin, 2.0 ** -6 * rmax, t["kernel"], t["plain"], results,
           **bound(2 * b * n * lq * d + 2 * b * n * lq * d * 2 + b * n * 4, int8=ops, bf16=ops),
           library_ms=None, k1_ms=t["K1"])
    del q, k, v, q8, k8
    torch.cuda.empty_cache()


def phase_shifted_kernels(results):
    """Phase 2b: the shifted forward (K2, K3s) and the rope R against their
    plain versions at the 81-frame CFG-2 shapes."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import rope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    b, n, d = 2, 12, 128
    lq = math.prod(GRID_81)
    ulp2 = 2.0 ** -6  # two bf16 ulps of the largest |o|

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=g)).bfloat16()

    def check_fwd(label, o, lse, ref, bound_rel=ulp2):
        # Bound: as K1's, two bf16 ulps of max|o|: K2 rounds bf16(p) at the
        # running max rather than the row max, so any p may round the other
        # way (the errors average over the keys), and o rounds to bf16; lse
        # 1e-5 max|lse| (fp32 sums in another order)
        el, ml, fl = max_err(lse, ref[1])
        err, rmax, fin = max_err(o, ref[0])
        print(f"  {label}: max_abs_err {err:.3e} (bound {bound_rel * rmax:.3e}, max|ref| "
              f"{rmax:.3e}); lse {el:.3e} (bound {1e-5 * ml:.3e})")
        expect(fl and el <= 1e-5 * ml, f"{label}: lse disagrees with its plain version")
        expect(fin, f"{label}: non-finite output")
        expect(err <= bound_rel * rmax, f"{label}: error {err} over {bound_rel * rmax}")
        return err, rmax

    # K2 at the self-attention shape (32,760 keys: a 56-key ragged last
    # tile), on unit-variance q/k standing in for qk-normed activations
    q, k = randn(b, n, lq, d), randn(b, n, lq, d)
    v = randn(b, lq, n, d)
    o2, lse2 = fa.flash_fwd_kernel(q, k, v, False, True)
    ref2 = fa.flash_attention_shifted_plain(q, k, v)
    err2, rmax2 = check_fwd("K2 against its plain version", o2, lse2, ref2)
    # against K1 on the same inputs: the two plain versions differ only in
    # where bf16 rounds p, and each kernel lies within two ulps of its own,
    # so |K2 - K1| <= max|plain2 - plain1| + 4 ulps of max|o|
    o1, _ = fa.flash_fwd_kernel(q, k, v, False, False)
    po1, _ = fa.flash_attention_plain(q, k, v)
    forms, _, _ = max_err(ref2[0], po1)
    e21, m21, _ = max_err(o2, o1)
    b21 = forms + 2 * ulp2 * m21
    print(f"  K2 against K1: max_abs_err {e21:.3e} (bound {b21:.3e}: the plain forms differ "
          f"by {forms:.3e}, max|o| {m21:.3e})")
    expect(e21 <= b21, f"K2 against K1: {e21} over {b21}")
    del o1, po1, o2, lse2, ref2
    # the user mask: batch 0 keeps all 32,760 keys, batch 1 the first 20,001
    kvalid = torch.tensor([lq, 20001], device=dev, dtype=torch.int32).repeat_interleave(n)
    om, lsem = fa.flash_fwd_kernel(q, k, v, False, True, kvalid)
    check_fwd("K2 with k_valid_len [32760, 20001]", om, lsem,
              fa.flash_attention_shifted_plain(q, k, v, kvalid))
    del om, lsem
    vt = v.movedim(1, 2).contiguous()  # SDPA's [B, N, L, D]
    t = timed_turns({"plain": lambda: fa.flash_attention_shifted_plain(q, k, v),
                     "kernel": lambda: fa.flash_fwd_kernel(q, k, v, False, True),
                     "K1": lambda: fa.flash_fwd_kernel(q, k, v, False, False),
                     "library": lambda: sdpa_flash(q, k, vt)}, reps=3, calls=2)
    flop = 4 * b * n * lq * lq * d
    bnd = bound(2 * b * n * 2 * lq * d * 2, bf16=flop)
    print(f"  K2: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), K1 "
          f"{flop / (t['K1'] * 1e9):.1f} in the same turns ({t['kernel'] / t['K1']:.3f}x its "
          f"time), {flop / (t['plain'] * 1e9):.1f} (plain), "
          f"{flop / (t['library'] * 1e9):.1f} (SDPA flash)")
    report("K2", err2, rmax2, True, ulp2 * rmax2, t["kernel"], t["plain"], results,
           **bnd, library_ms=t["library"], k1_ms=t["K1"])
    del q, k, v, vt

    # logits near 300: q and k of standard deviation 6.7 give logits of
    # standard deviation ~45, the largest of the 2.6e10 near 300. exp of
    # anything past ~88 overflows fp32: K1 returns inf / inf there.
    q, k = randn(b, n, lq, d, scale=6.7), randn(b, n, lq, d, scale=6.7)
    v = randn(b, lq, n, d)
    s0 = (q[:, :, :512].float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    top = s0.abs().max().item()
    del s0
    o1, _ = fa.flash_fwd_kernel(q, k, v, False, False)
    k1_finite = bool(torch.isfinite(o1.float()).all())
    del o1
    oh, lseh = fa.flash_fwd_kernel(q, k, v, False, True)
    print(f"  large logits (largest |logit| of the first 512 q rows {top:.1f}; max lse "
          f"{lseh.max().item():.1f}): K1 output finite: {k1_finite}")
    expect(top > 150, f"the large-logit inputs reach only {top}")
    expect(not k1_finite, "K1 stayed finite: the inputs do not leave the bounded range")
    check_fwd("K2 at large logits", oh, lseh, fa.flash_attention_shifted_plain(q, k, v))
    del q, k, v, oh, lseh

    # K3s at the text cross-attention shape (lq 32,760 x lk 512)
    q = randn(b, n, lq, d)
    k, v = randn(b, n, TEXT_LEN, d), randn(b, TEXT_LEN, n, d)
    o3, lse3 = fa.flash_fwd_kernel(q, k, v, True, True)
    err3, rmax3 = check_fwd("K3s against its plain version", o3, lse3,
                            fa.flash_attention_shifted_plain(q, k, v))
    vt = v.movedim(1, 2).contiguous()
    # 20 calls a turn, as K3's, in turns with the shifted streaming form
    # (K2's instance) at the same lk
    t = timed_turns({"plain": lambda: fa.flash_attention_shifted_plain(q, k, v),
                     "kernel": lambda: fa.flash_fwd_kernel(q, k, v, True, True),
                     "K3": lambda: fa.flash_fwd_kernel(q, k, v, True, False),
                     "streaming": lambda: fa.flash_fwd_kernel(q, k, v, False, True),
                     "library": lambda: sdpa_flash(q, k, vt)}, reps=5, calls=20)
    flop = 4 * b * n * lq * TEXT_LEN * d
    bnd = bound(2 * b * n * (lq + TEXT_LEN) * d * 2, bf16=flop)
    print(f"  K3s: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), K3 "
          f"{flop / (t['K3'] * 1e9):.1f} in the same turns, {flop / (t['plain'] * 1e9):.1f} "
          f"(plain), {flop / (t['library'] * 1e9):.1f} (SDPA flash), "
          f"{flop / (t['streaming'] * 1e9):.1f} (streaming form)")
    report("K3s", err3, rmax3, True, ulp2 * rmax3, t["kernel"], t["plain"], results,
           **bnd, library_ms=t["library"], k3_ms=t["K3"], streaming_ms=t["streaming"])
    del q, k, v, vt, o3, lse3

    # R forward and backward at the self-attention q/k, [2, 32,760, 12, 128]
    # bf16. Bound: 0. The kernel and the plain version form the same fp32
    # products and sum, each rounded once, then one rounding to bf16.
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    s_bwd = torch.roll(s_tab, d // 2, dims=-1).contiguous()
    x, gy = randn(b, lq, n, d), randn(b, lq, n, d)
    worst, rmax_r = 0.0, 0.0
    for label, inp, tab in (("forward", x, s_tab), ("backward (S rolled)", gy, s_bwd)):
        err, rmax, fin = max_err(rope.rope_kernel(inp, c_tab, tab),
                                 rope.rope_rotate_plain(inp, c_tab, tab))
        print(f"  R {label}: max_abs_err {err:.3e} (bound 0: bit for bit; max|ref| {rmax:.3e})")
        expect(fin and err == 0.0, f"R {label} differs from its plain version by {err}")
        worst, rmax_r = max(worst, err), max(rmax_r, rmax)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(rope.rope_rotate(xg, c_tab, s_tab), xg, gy)
    expect(torch.equal(dx, rope.rope_rotate_plain(gy, c_tab, s_bwd)),
           "R's autograd backward differs from the rotation by the rolled table")
    del xg, dx
    ms, pms = timed_pair(lambda: rope.rope_kernel(x, c_tab, s_tab),
                         lambda: rope.rope_rotate_plain(x, c_tab, s_tab), reps=5, calls=10)
    # x read and out written (bf16), the two [L, 128] fp32 tables read once;
    # three fp32 operations per element. No single PyTorch call rotates.
    report("R", worst, rmax_r, True, 0.0, ms, pms, results,
           **bound(2 * x.numel() * 2 + 2 * lq * d * 4, fp32=3 * x.numel()), library_ms=None)
    del x, gy
    torch.cuda.empty_cache()


def phase_model():
    """Phase 3: 2-block full-width WanModel, card against CPU, in bf16 and
    as the int8 model."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.utils.checkpoint import (
        from_jax_params, quantize_state, seeded_jax_tree)

    cfg = wan_dit.t2v_1_3b(num_layers=2)
    state = from_jax_params(seeded_jax_tree(cfg, seed=7), cfg)
    rng = np.random.default_rng(8)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = torch.from_numpy(rng.standard_normal((2, f, hh, ww, 16), dtype=np.float32))
    t = torch.tensor([900.0, 300.0])
    ctx = torch.from_numpy(rng.standard_normal((2, TEXT_LEN, cfg.text_dim), dtype=np.float32))
    qcfg = dataclasses.replace(cfg, quant_dense="int8", quant_attn="int8")
    for label, mcfg, mstate, attn in (("bf16", cfg, state, "K1"),
                                      ("int8", qcfg, quantize_state(state, qcfg), "K10")):
        outs = {}
        for dev in ("cuda", "cpu"):
            model = wan_dit.WanModel(mcfg, device=torch.device(dev))
            model.load_state_dict(mstate)
            _build.reset_launches()
            t0 = time.perf_counter()
            with torch.inference_mode():
                outs[dev] = model(x.to(dev), t.to(dev), ctx.to(dev)).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
            print(f"  {label} forward on {dev}: {time.perf_counter() - t0:.2f} s")
            del model
        err, rmax, fin = max_err(outs["cuda"], outs["cpu"])
        # Bound: bf16 matmuls accumulate in another order on the card than on
        # the CPU and activations round to bf16 at a dozen points per block,
        # so after two blocks a few bf16 ulps of the largest value remain:
        # 3e-2 max|cpu|, the CPU tests' bf16 tolerance against JAX. The int8
        # model quantizes those activations, so a value that rounds apart
        # may land on the neighbouring int8 step: one step is 1/127 of a
        # token's largest value, inside the same bound.
        bound_ = 3e-2 * rmax
        print(f"  {label} whole model [2, 3, 60, 104, 16] (4,680 tokens, {attn} with an "
              f"8-key ragged tile): max_abs_err {err:.3e} (bound {bound_:.3e}, "
              f"max|cpu| {rmax:.3e}); launches {launches}")
        expect(tuple(outs["cuda"].shape) == (2, f, hh, ww, 16), f"{label} model: wrong shape")
        expect(fin and bool(torch.isfinite(outs["cpu"]).all()),
               f"{label} model: non-finite output")
        expect(rmax > 0, f"{label} model: output is all zeros")
        expect(err <= bound_, f"{label} model: error {err} over bound {bound_}")
        want = dit_launches(cfg.num_layers, False, qk8=label == "int8")
        expect(launches == want, f"{label} model: launches {launches}, expected {want}")
    torch.cuda.empty_cache()


def _serve(cli, pipe, requests, per_forward, label):
    """Answer each request through the CLI path with the launch counters set
    to 0 just before and read just after -> (latents, launches)."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    totals, latents = {}, []
    for req in requests:
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = cli.run_request(pipe, req, SIZE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = (1, *cli.latent_grid(SIZE, req.frame_num), 16)
        print(f"  {label} request seed {req.seed}, {req.frame_num} frames, {req.sample_steps} "
              f"steps: {dt:.3f} s, {dt / req.sample_steps:.3f} s/step, latents {tuple(lat.shape)}")
        expect(tuple(lat.shape) == want, f"latents {tuple(lat.shape)}, expected {want}")
        expect(bool(torch.isfinite(lat).all()), f"{label}: non-finite latents")
        for name, per in per_forward.items():
            got = _build.LAUNCHES[name] - before.get(name, 0)
            expect(got == per * req.sample_steps,
                   f"{label}: {name} launched {got} times, expected {per * req.sample_steps}")
        _add(totals, per_forward, req.sample_steps)
        latents.append(lat)
    launches = dict(_build.LAUNCHES)
    expect(launches == totals, f"{label}: launch counts {launches}, expected {totals}")
    print(f"  {label} launches {launches} (per DiT forward {per_forward}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return latents, launches


def phase_serve():
    """Phase 4: three bf16 requests, the 81-frame one again on the shifted
    route, and two int8 requests through the CLI path; returns the launch
    counts of all."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    cli = load_script("inference_torch")
    dev = torch.device("cuda")

    def build(flags):
        args = cli.args_init(["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21",
                              "--sample_steps", "4", "--sample_guide_scale", "5.0",
                              "--device", "cuda", *flags])
        t0 = time.perf_counter()
        pipe = cli.build_pipeline(args)
        # the JAX initialisers zero the head, which would make every latent
        # independent of the blocks: give it seeded weights (the head is not
        # quantized, so both pipelines get the same one)
        with torch.no_grad():
            pipe.model.head.head.weight.normal_(
                0.0, pipe.cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        n_weights = sum(p.numel() for p in pipe.model.state_dict().values())
        print(f"  pipeline {flags or '(bf16)'} built once in {time.perf_counter() - t0:.2f} s "
              f"({n_weights / 1e9:.3f} B weights)")
        return pipe, args

    pipe, args = build([])
    cfg = pipe.cfg

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
    bf16, launches = _serve(cli, pipe, requests, dit_launches(cfg.num_layers, False), "bf16")
    expect(not torch.equal(bf16[0], bf16[1]), "two distinct requests gave one result")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # The shifted route (HYV_FLASH_BOUNDED=0; the module switch is read at
    # call time): the 81-frame request again, through K2 and K3s only.
    # Bound: the two routes differ only in where bf16 rounds p, far less
    # than int8 against bf16 moves the latents (~0.01 relative L2, checked
    # below): 0.05, a tenth of the distance between two unrelated samples.
    fa.FLASH_BOUNDED = False
    try:
        shifted, launches_s = _serve(cli, pipe, [requests[2]],
                                     dit_launches(cfg.num_layers, False, shifted=True), "shifted")
    finally:
        fa.FLASH_BOUNDED = True
    expect(launches_s.get("K1", 0) == 0 and launches_s.get("K3", 0) == 0,
           f"the shifted route launched K1 or K3: {launches_s}")
    d = rel(shifted[0], bf16[2])
    print(f"  shifted against bounded route, seed {requests[2].seed}, 81 frames: relative L2 "
          f"distance {d:.4f} (bound 0.05); K1 and K3 launched 0 times")
    expect(d <= 0.05, f"the shifted route's latents lie {d} from the bounded route's")
    del pipe
    torch.cuda.empty_cache()

    pipe, _ = build(["--quant", "int8", "--quant_attn", "int8"])
    int8, launches8 = _serve(cli, pipe, [requests[0], requests[2]],
                             dit_launches(cfg.num_layers, False, qk8=True), "int8")
    del pipe
    torch.cuda.empty_cache()

    # Bound: the int8 sample of a seed must stay near the bf16 sample of the
    # same seed. Two unrelated samples lie ~sqrt(2) of a norm apart (seeds 42
    # and 43 below); W8A8 noise of ~1% per matmul, over 30 blocks and a
    # guidance of 5 on the cond - uncond difference, may move the latents
    # by a few tenths of that: bound 0.3 relative, a fifth of the distance
    # between two unrelated samples.
    apart = rel(bf16[1], bf16[0])
    for lat8, lat, req in ((int8[0], bf16[0], requests[0]), (int8[1], bf16[2], requests[2])):
        d = rel(lat8, lat)
        print(f"  int8 against bf16, seed {req.seed}, {req.frame_num} frames: relative L2 "
              f"distance {d:.4f} (bound 0.3; seeds 42 and 43 in bf16 lie {apart:.4f} apart)")
        expect(d <= 0.3, f"int8 latents of seed {req.seed} lie {d} from the bf16 ones")
    return _add(_add(dict(launches), launches8), launches_s)


def report_many(name, label, checks, results=None, timing=None, **extra):
    """Check each (output name, got, ref, bound relative to max|ref|); with
    a timing (kernel ms, plain ms), record it and `extra` in results."""
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
        print(f"  {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms"
              + "".join(f", {k} {v:.4f}" for k, v in extra.items() if isinstance(v, float)))
        results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": pms, **extra}


def phase_bwd_kernels(results):
    """Phase 5: each backward kernel against its plain version at the
    training shapes of the 81-frame slice (batch 1: training has no CFG);
    returns the launches of the split-route gradient call (K5's path)."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import _build
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
    # The split route runs through the op as training would reach it: a
    # gradient of flash_attention at lq 1,024, where the JAX rule picks K5.
    # Its numbers land beside the self-attention call's as short_q_*, the
    # cross-attention's beside K4's as cross_*.
    cases = (("K4", lq, lq, "self-attention, 32,760 keys (56 valid in the last 64-key tile)"),
             ("K4", lq, TEXT_LEN, "cross-attention, 512 keys"),
             ("K5", lq, lq, "self-attention shape, called directly"),
             ("K5", 1024, lq, "lq 1,024 (the split route, through the autograd op)"))
    route_launches = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, lq_, lk_, label in cases:
        merged = name == "K4"
        if "directly" not in label:
            expect(fa.uses_merged_bwd(lq_, lk_) == merged, f"{name}: wrong route for {label}")
        q, k = randn(1, n, lq_, d), randn(1, n, lk_, d)
        v = randn(1, lk_, n, d)
        if "autograd" in label:
            qkv = [x.requires_grad_() for x in (q, k, v)]
            o, lse = fa.flash_attention(*qkv, return_lse=True, qk_layout="bnld",
                                        bounded_logits=True)
            do = randn(*o.shape)
            torch.cuda.synchronize()
            _build.reset_launches()
            got = torch.autograd.grad(o, qkv, do)
            torch.cuda.synchronize()
            route_launches = dict(_build.LAUNCHES)
            expect(route_launches == {"K5": 1}, f"the split route launched {route_launches}")
            q, k, v, o = q.detach(), k.detach(), v.detach(), o.detach()
        else:
            o, lse = fa.flash_fwd_kernel(q, k, v, fa.uses_single_block(lk_))
            do = randn(*o.shape)
            got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        cross, short_q = lk_ != lq, lq_ != lq
        del got, ref
        # the library yardstick: SDPA's flash backward on the same tensors
        # in its [B, N, L, D] layout, one op per call; K5 at the
        # self-attention in turns with K4 too, and at lq 1,024 also with its
        # dq pass unsplit (dq_splits 1), the measurement behind the split
        qs, ks = q.clone().requires_grad_(), k.clone().requires_grad_()
        vs = v.movedim(1, 2).contiguous().requires_grad_()
        out = sdpa_flash(qs, ks, vs)
        dot = do.movedim(1, 2).contiguous()
        fns = {"plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
               "kernel": lambda: fa.bwd_kernel(q, k, v, o, lse, do, merged),
               "library": lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                      retain_graph=True)}
        if name == "K5" and not short_q:
            fns["k4"] = lambda: fa.bwd_kernel(q, k, v, o, lse, do, True)
        if short_q:
            fns["unsplit"] = lambda: fa.bwd_kernel(q, k, v, o, lse, do, False, dq_splits=1)
        # the cross and the lq 1,024 calls are short: 20 calls a turn
        t = timed_turns(fns, reps=5 if cross or short_q else 3,
                        calls=20 if cross or short_q else 1)
        del qs, ks, vs, out, dot
        timing = (t["kernel"], t["plain"])
        got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        flop = 10 * n * lq_ * lk_ * d  # five products of 2 flop per multiply-add
        print(f"  {name} {label}: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel), "
              f"{flop / (t['plain'] * 1e9):.1f} (plain), {flop / (t['library'] * 1e9):.1f} "
              f"(SDPA flash backward)"
              + (f", {flop / (t['k4'] * 1e9):.1f} (K4, {t['k4']:.4f} ms)" if "k4" in t else "")
              + (f", {flop / (t['unsplit'] * 1e9):.1f} (dq pass unsplit, "
                 f"{t['unsplit']:.4f} ms)" if "unsplit" in t else "")
              + f", counting the five products of the algorithm"
              f"{' (K5 runs seven)' if name == 'K5' else ''}")
        # q, k, v, dO in; dq, dk, dv out (bf16); lse and delta fp32
        extra = {**bound(n * d * 2 * (3 * lq_ + 4 * lk_) + 8 * n * lq_, bf16=flop),
                 "library_ms": t["library"]}
        for key in ("k4", "unsplit"):
            if key in t:
                extra[f"{key}_ms"] = t[key]
        splits = (fa.q_splits(n * -(-lk_ // 128), -(-lq_ // 64), sms),
                  fa.q_splits(n * -(-lq_ // 128), -(-lk_ // 64), sms))
        print(f"  {name} {label}: {extra['bound_ms'] / t['kernel']:.3f} of the bound; dk/dv "
              f"q sweep split over {splits[0]} block(s) per key tile"
              + (f", dq key range over {splits[1]} block(s) per q tile" if name == "K5" else ""))
        checks = [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)]
        if cross or short_q:
            # recorded beside the self-attention call's numbers
            part = {}
            report_many(name, label, checks, part, timing, **extra)
            prefix = "cross" if cross else "short_q"
            results[name].update({f"{prefix}_{key}": val for key, val in part[name].items()})
        else:
            report_many(name, label, checks, results, timing, **extra)
        if name == "K5" and not short_q:
            # dq written once per q tile: the same bits on a second call
            again = fa.bwd_kernel(q, k, v, o, lse, do, False)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  K5 {label}: dq, dk, dv bitwise equal on a second call: {same}")
            expect(same, "K5 is not deterministic")
            del again
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
        # x and g in, dx out (bf16), the rope tables; no single PyTorch call
        # computes the fused norm-and-rope backward
        report_many("K7", label, [("dx", got[0], ref[0], 2.0 ** -6),
                                  ("dw", got[1], ref[1], 2.0 ** -7)], results, timing,
                    **bound(3 * l * dim * 2 + 2 * l * d * 4, fp32=12 * l * dim),
                    library_ms=None)
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
        # x (fp32) and g in, dx (fp32) out; no single PyTorch call computes
        # the LayerNorm-with-modulation backward
        report_many("K9", label, [(o_, a, b, 1e-5)
                                  for o_, a, b in zip(("dx", "ds", "dt"), got, ref)],
                    results, timing,
                    **bound(lq * dim * (4 + gg.element_size() + 4), fp32=12 * lq * dim),
                    library_ms=None)
        del gg, got, ref
    del x
    torch.cuda.empty_cache()
    return route_launches


def phase_masked_bwd():
    """Phase 5b: K4 and K5 with the key mask against the plain backward at
    the training shapes (batch 1). The gradients of masked keys must be
    exactly 0."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8642)
    n, d = 12, 128
    lq = math.prod(GRID_81)
    valid = 20001
    kvalid = torch.full((n,), valid, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    # o and lse from K2 under the same mask; dO a seeded cotangent. Bound:
    # as the unmasked backward, two bf16 ulps of each gradient's largest
    # entry (2^-6 max|ref|)
    for name, lq_ in (("K4", lq), ("K5", 1024)):
        merged = name == "K4"
        expect(fa.uses_merged_bwd(lq_, lq) == merged, f"{name}: wrong route at lq {lq_}")
        q, k, v = randn(1, n, lq_, d), randn(1, n, lq, d), randn(1, lq, n, d)
        o, lse = fa.flash_fwd_kernel(q, k, v, False, True, kvalid)
        do = randn(*o.shape)
        got = fa.bwd_kernel(q, k, v, o, lse, do, merged, kvalid)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, kvalid)
        report_many(name, f"key mask ({valid:,} of {lq:,} keys, lq {lq_:,})",
                    [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)])
        dk, dv = got[1], got[2]
        zero = not dk[:, :, valid:].any() and not dv[:, valid:].any()
        print(f"  {name} masked keys: dk and dv exactly 0 past key {valid:,}: {zero}")
        expect(zero, f"{name}: masked keys got non-zero gradients")
        expect(dk[:, :, :valid].abs().sum().item() > 0, f"{name}: dk of the kept keys is 0")
        del q, k, v, o, lse, do, got, ref
        torch.cuda.empty_cache()


def phase_grad_model(cfg=None, grid=GRID_9, seed=17, label=""):
    """Phase 6: the output (at phase 3's bound) and the gradients of the
    2-block full-width model (t2v-1.3B unless ``cfg`` says otherwise) on a
    token grid, card against CPU. Returns the seeded state."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = cfg or wan_dit.t2v_1_3b(num_layers=2, remat_policy="attn")
    state = from_jax_params(seeded_jax_tree(cfg, seed=seed), cfg)
    rng = np.random.default_rng(seed + 1)
    f, hh, ww = grid[0], grid[1] * 2, grid[2] * 2
    x = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    ctx = rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32)
    r = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    outs, grads, launches = {}, {}, {}
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
        print(f"  {label}forward + backward, {key}: {time.perf_counter() - t0:.2f} s")
        outs[key] = out.detach().cpu()
        grads[key] = {"input latent": xi.grad.cpu(),
                      **{name: p.grad.cpu() for name, p in model.named_parameters()}}
        del model, out, xi

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # phase 3's bound: 3e-2 max|cpu| (bf16 roundings in another order)
    err, rmax, fin = max_err(outs["card"], outs["cpu"])
    print(f"  {label}2-block output: max_abs_err {err:.3e} (bound {3e-2 * rmax:.3e}, "
          f"max|cpu| {rmax:.3e})")
    expect(fin and rmax > 0 and err <= 3e-2 * rmax, f"{label}output: error {err}")

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
    want = dit_launches(cfg.num_layers, True,
                        self_single=fa.uses_single_block(math.prod(grid)))
    print(f"  {label}launches {launches}, derived {want}")
    expect(launches == want, f"{label}launches {launches}, expected {want}")
    torch.cuda.empty_cache()
    return state


GRID_14B_81 = (21, 45, 80)  # token grid of an 81-frame 720*1280 request (75,600)
GRID_14B_1 = (1, 30, 52)    # one latent frame at 832*480 (1,560 tokens)
GRID_BENCH = (8, 15, 26)    # bench.py's token grid (3,120)


def phase_wide(results):
    """Phase 10: the 14B width. K6-K9 against their plain versions at
    [1, 75,600, 5120] with 40 heads (t2v-14B at 720*1280, 81 frames) and
    at [1, 3,120, 1280] with 10 heads (bench.py's shape), timed beside
    their byte bounds; K1 and K2 against theirs at 40 heads x 18,900 and
    10 and 5 heads x 75,600; a 2-block t2v-14B model's output and gradients,
    card against CPU, at one latent frame of 832*480; the same blocks
    forward and backward at 720*1280 and 81 frames on the card, gradients
    finite and launches as derived."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9876)
    # Bounds, as at width 1536 (phases 2 and 5): K8 one bf16 ulp of max|out|;
    # K9 1e-5 of each output's max; K6 and K7's dx two bf16 ulps, K7's dw
    # one. Byte bounds: each input read once, each output written once.
    for tag, n, grid in (("d5120", 40, GRID_14B_81), ("d1280", 10, GRID_BENCH)):
        l, dim = math.prod(grid), n * 128
        x32 = torch.randn(1, l, dim, device=dev, generator=g)
        s_ = 1.0 + 0.1 * torch.randn(1, dim, device=dev, generator=g)
        t_ = 0.1 * torch.randn(1, dim, device=dev, generator=g)
        g32 = torch.randn(1, l, dim, device=dev, generator=g).bfloat16()
        xb = torch.randn(1, l, dim, device=dev, generator=g).bfloat16()
        w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
        c_tab, s_tab = (torch.from_numpy(a).to(dev) for a in rope_tables_rolled_np(grid, 128))
        gh = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
        tables = 2 * l * 128 * 4
        cases = {
            "K8": (lambda: stream._kernel(x32, s_, t_, 1e-6, torch.bfloat16),
                   lambda: stream.ln_scale_shift_plain(x32, s_, t_, 1e-6, torch.bfloat16),
                   (("out", 2.0 ** -7),), l * dim * (4 + 2)),
            "K9": (lambda: stream.bwd_kernel(x32, s_, g32, 1e-6),
                   lambda: stream.ln_scale_shift_bwd_plain(x32, s_, g32, 1e-6),
                   (("dx", 1e-5), ("ds", 1e-5), ("dt", 1e-5)), l * dim * (4 + 2 + 4)),
            "K6": (lambda: qr._kernel(xb, w, c_tab, s_tab, n, 1e-6, True),
                   lambda: qr.rmsnorm_rope_plain(xb, w, c_tab, s_tab, n, 1e-6, True),
                   (("out", 2.0 ** -6),), l * dim * (2 + 2) + tables),
            "K7": (lambda: qr.bwd_kernel(xb, w, c_tab, s_tab, gh, n, 1e-6, True),
                   lambda: qr.rmsnorm_rope_bwd_plain(xb, w, c_tab, s_tab, gh, n, 1e-6, True),
                   (("dx", 2.0 ** -6), ("dw", 2.0 ** -7)), l * dim * 3 * 2 + tables),
        }
        for name, (kern, plain, outs, nbytes) in cases.items():
            got, ref = kern(), plain()
            got, ref = ((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))
            worst = 0.0
            for (out_name, rel_bound), a, b in zip(outs, got, ref):
                err, rmax, fin = max_err(a, b)
                print(f"  {name} [1, {l:,}, {dim}] {out_name}: max_abs_err {err:.3e} "
                      f"(bound {rel_bound * rmax:.3e}, max|ref| {rmax:.3e})")
                expect(fin and err <= rel_bound * rmax,
                       f"{name} at [1, {l}, {dim}]: {out_name} error {err}")
                worst = max(worst, err)
            del got, ref
            ms, pms = timed_pair(kern, plain)
            bd = bound(nbytes)["bound_ms"]
            print(f"  {name} [1, {l:,}, {dim}]: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bd:.4f} ms (bytes), {bd / ms:.3f} of the bound")
            results[name].update({f"{tag}_ms": ms, f"{tag}_plain_ms": pms,
                                  f"{tag}_bound_ms": bd, f"{tag}_max_abs_err": worst})
        del x32, g32, xb, gh, cases
        torch.cuda.empty_cache()

    # K1 and K2 at the 14B self-attention's sequence-parallel shards: 40
    # heads x 18,900 tokens, and 10 or 5 heads x 75,600 (unit-variance q/k
    # for the qk-normed activations). The last key tile holds 84 and 80
    # keys; the persistent grid takes 5,920, 5,910 and 2,955 tiles. Bounds
    # as phases 2 and 2b: o within two bf16 ulps of max|o|, lse 1e-5
    # max|lse|.
    for n, l in ((40, 18900), (10, 75600), (5, 75600)):
        q = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
        k = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
        v = torch.randn(1, l, n, 128, device=dev, generator=g).bfloat16()
        vt = v.movedim(1, 2).contiguous()
        flop = 4 * n * l * l * 128
        bnd = bound(4 * n * l * 128 * 2, bf16=flop)["bound_ms"]
        for name, shifted, plain in (("K1", False, fa.flash_attention_plain),
                                     ("K2", True, fa.flash_attention_shifted_plain)):
            o, lse = fa.flash_fwd_kernel(q, k, v, False, shifted)
            po, plse = plain(q, k, v)
            err, rmax, fin = max_err(o, po)
            el, ml, fl = max_err(lse, plse)
            del o, lse, po, plse
            expect(fin and err <= 2.0 ** -6 * rmax,
                   f"{name} at {n} heads x {l}: error {err} over {2.0 ** -6 * rmax}")
            expect(fl and el <= 1e-5 * ml, f"{name} at {n} heads x {l}: lse error {el}")
            t = timed_turns({"kernel": lambda: fa.flash_fwd_kernel(q, k, v, False, shifted),
                             "library": lambda: sdpa_flash(q, k, vt)}, reps=3, calls=2)
            print(f"  {name} [1, {n}, {l:,}, 128]: max_abs_err {err:.3e} (bound "
                  f"{2.0 ** -6 * rmax:.3e}), lse {el:.3e} (bound {1e-5 * ml:.3e}); kernel "
                  f"{t['kernel']:.4f} ms ({flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
                  f"{bnd / t['kernel']:.3f} of the {bnd:.4f} ms bound), SDPA flash "
                  f"{t['library']:.4f} ms")
            tag = f"h{n}_l{l}"
            results[name].update({f"{tag}_ms": t["kernel"], f"{tag}_library_ms": t["library"],
                                  f"{tag}_bound_ms": bnd, f"{tag}_max_abs_err": err})
        del q, k, v, vt
        torch.cuda.empty_cache()

    # 2 blocks of t2v-14B (dim 5120, 40 heads, ffn 13,824), remat "attn" as
    # the training path runs them: output and gradients, card against CPU
    cfg = wan_dit.t2v_14b(num_layers=2, remat_policy="attn")
    state = phase_grad_model(cfg, GRID_14B_1, seed=41, label="t2v-14B 2 blocks, 1,560 tokens: ")

    # the same blocks at 720*1280, 81 frames (75,600 tokens), on the card
    model = wan_dit.WanModel(cfg, device=dev, param_dtype=torch.float32)
    model.load_state_dict(state)
    del state
    f, hh, ww = GRID_14B_81[0], GRID_14B_81[1] * 2, GRID_14B_81[2] * 2
    x = torch.randn(1, f, hh, ww, 16, device=dev, generator=g).requires_grad_()
    ctx = torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g)
    r = torch.randn(1, f, hh, ww, 16, device=dev, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = model(x, torch.tensor([700.0], device=dev), ctx)
    (out * r).sum().backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [name for name, p in model.named_parameters() if not bool(torch.isfinite(p.grad).all())]
    print(f"  t2v-14B 2 blocks, 720*1280, 81 frames ({math.prod(GRID_14B_81):,} tokens): "
          f"forward + backward {dt:.3f} s, peak {peak:.2f} GiB, launches {launches}")
    expect(tuple(out.shape) == (1, f, hh, ww, 16), f"t2v-14B output {tuple(out.shape)}")
    expect(bool(torch.isfinite(out).all()), "t2v-14B output is not finite")
    expect(not bad and bool(torch.isfinite(x.grad).all()),
           f"t2v-14B gradients not finite: {bad[:5]}")
    want = dit_launches(cfg.num_layers, True)
    expect(launches == want, f"t2v-14B launches {launches}, expected {want}")
    del model, out, x, ctx, r
    torch.cuda.empty_cache()


def phase_unnormed():
    """Phase 9: the un-normed DiT (qk_norm off) at t2v-1.3B width: a
    2-block card-against-CPU check of the output and every gradient on the
    9-frame grid, then a 30-block batched-CFG forward at 81 frames through
    the pipeline; returns the pipeline's launches."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.pipelines.pipeline import GenerateConfig, WanT2V
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    # no qk-norm and no norm3 (no K6, K7 or norm3 K8/K9: R, K2 and K3s in
    # their place), remat "full" (the training path runs "attn")
    cfg = wan_dit.t2v_1_3b(num_layers=2, qk_norm=False, cross_attn_norm=False,
                           remat_policy="full")
    state = from_jax_params(seeded_jax_tree(cfg, seed=31), cfg)
    rng = np.random.default_rng(32)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    ctx = rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32)
    r = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    outs, grads, launches = {}, {}, {}
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
        print(f"  un-normed forward + backward, {key}: {time.perf_counter() - t0:.2f} s")
        outs[key] = out.detach().cpu()
        grads[key] = {"input latent": xi.grad.cpu(),
                      **{name: p.grad.cpu() for name, p in model.named_parameters()}}
        del model, out, xi

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Output bound: 3e-2 max|cpu|, phase 3's (bf16 roundings in another order)
    err, rmax, fin = max_err(outs["card"], outs["cpu"])
    print(f"  un-normed 2-block output: max_abs_err {err:.3e} (bound {3e-2 * rmax:.3e}, "
          f"max|cpu| {rmax:.3e})")
    expect(fin and rmax > 0 and err <= 3e-2 * rmax, f"un-normed output: error {err}")
    # Gradient bounds, phase 6's: 2e-2 of each norm against the CPU bf16
    # run; the k biases, whose gradients are near-cancelling sums over keys,
    # against the CPU fp32 run at 1.5x the CPU bf16 run's distance from it.
    # Without qk-norm the cross-attention k bias shifts every logit of a row
    # alike and the softmax ignores it: its gradient is 0 up to rounding on
    # every run, so both distances measure rounding noise alone; its bound
    # is 2x (the noise norms of two runs agree only to a factor).
    worst = []
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        expect(bool(torch.isfinite(got).all()), f"un-normed gradient of {name}: non-finite")
        if name.endswith(".k.bias"):
            exact = grads["cpu fp32"][name]
            noise, e = rel(ref, exact), rel(got, exact)
            factor = 2.0 if "cross_attn" in name else 1.5
            print(f"  {name}: card against CPU fp32 {e:.3e} (bound {factor} x {noise:.3e}, the "
                  f"CPU bf16 run against fp32; norms card {got.norm():.3e}, CPU bf16 "
                  f"{ref.norm():.3e}, fp32 {exact.norm():.3e})")
            expect(e <= factor * noise, f"un-normed gradient of {name}: {e} over "
                                        f"{factor} x {noise}")
            continue
        expect(ref.norm().item() > 0, f"un-normed gradient of {name} is zero on the CPU")
        e = rel(got, ref)
        worst.append((e, name))
        expect(e <= 2e-2, f"un-normed gradient of {name}: relative error {e:.3e} over 2e-2")
    worst.sort(reverse=True)
    print(f"  the other {len(worst)} gradients within 2e-2 of the CPU bf16 run's; the largest: "
          + ", ".join(f"{name} {e:.3e}" for e, name in worst[:3]))
    want = dit_launches(cfg.num_layers, True, remat_policy="full", qk_norm=False,
                        cross_attn_norm=False)
    print(f"  launches {launches}, derived {want}")
    expect(launches == want, f"un-normed launches {launches}, expected {want}")

    # 30 blocks at 81 frames: one batched-CFG forward pair through the
    # pipeline (one UniPC step), random seeded weights with a seeded head
    dev = torch.device("cuda")
    cfg = wan_dit.t2v_1_3b(qk_norm=False)
    model = wan_dit.init_params(wan_dit.WanModel(cfg, device=dev),
                                torch.Generator(device=dev).manual_seed(33))
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, cfg.dim ** -0.5,
                                       generator=torch.Generator(device=dev).manual_seed(34))
    pipe = WanT2V(model.eval())
    g = torch.Generator(device=dev).manual_seed(35)
    context = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    lat_grid = (GRID_81[0], GRID_81[1] * 2, GRID_81[2] * 2)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    lat = pipe.generate(g, context, torch.zeros_like(context), *lat_grid,
                        gen=GenerateConfig(sampling_steps=1, guide_scale=5.0, shift=5.0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = dit_launches(cfg.num_layers, False, qk_norm=False)
    print(f"  un-normed 30 blocks, 81 frames, one forward pair: {dt:.3f} s, latents "
          f"{tuple(lat.shape)}, launches {launches} (derived {want})")
    expect(tuple(lat.shape) == (1, *lat_grid, 16), f"un-normed latents {tuple(lat.shape)}")
    expect(bool(torch.isfinite(lat).all()), "un-normed latents are not finite")
    expect(launches == want, f"un-normed pipeline launches {launches}, expected {want}")
    del pipe, model, lat
    torch.cuda.empty_cache()
    return launches


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


def _build_trainer(cli, raw, dev):
    """The trainer of a raw config, with the head seeded as the JAX
    initialisers would not (a zero head gives every block a zero gradient
    in the first refl step)."""
    import torch

    from hyvideo_prfl_torch.configs import config_from_dict

    config = config_from_dict(json.loads(json.dumps(raw)))
    t0 = time.perf_counter()
    trainer = cli.build_trainer(config, "cuda")
    with torch.no_grad():
        trainer.model.dit.head.head.weight.normal_(
            0.0, trainer.model.dit_cfg.dim ** -0.5,
            generator=torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    return trainer, config, time.perf_counter() - t0


def phase_train(root):
    """Phase 7: PRFL training through the CLI path, with the bf16 and the
    int8 rollout, then one step on the shifted route and one with the split
    backward K5; returns the launch counts of all."""
    import torch

    from hyvideo_prfl_torch.data.dataset import LatentCacheDataset
    from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(root, (21, 81))
    raw = json.loads(json.dumps(TRAIN_CONFIG))
    raw["dataset"].update(meta_file_list=[lists[21]], null_dir=null_dir)
    raw["save"] = {"output_dir": os.path.join(root, "out")}
    dev = torch.device("cuda")
    trainer, config, build_s = _build_trainer(cli, raw, dev)
    model = trainer.model
    cfg = model.dit_cfg
    n_lrm = model.lrm.dit_cfg.num_layers
    print(f"  trainer built in {build_s:.2f} s: policy "
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
    first_reward = hist[0]["reward"]
    del trainer, model
    torch.cuda.empty_cache()

    # The int8 rollout, from the same weights and draws: one outer step at
    # 21 frames and one at 81, each with the counters set to 0 just before.
    raw["train"]["rollout_quant"] = "int8"
    trainer, config, build_s = _build_trainer(cli, raw, dev)
    print(f"  int8-rollout trainer built in {build_s:.2f} s")
    per_step8 = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                        cfg.remat_policy, rollout_quant="int8")
    got8 = {}
    for frames in (21, 81):
        if frames == 81:
            trainer.loader = iter(BatchIterator(ds81, BlockDistributedSampler(len(ds81))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"  int8 rollout, {frames} frames: refl_loss {m['refl_loss']:.6f}, reward "
              f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
              f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            expect(math.isfinite(m[key]), f"{key} is not finite with the int8 rollout: {m}")
        expect(m["grad_norm"] > 0, f"grad norm {m['grad_norm']} is not above 0")
        expect(launches == per_step8, f"int8 rollout launches {launches}, expected {per_step8}")
        if frames == 21:
            # the same weights, data and draws as the bf16 run's first step:
            # only the rollout's quantization moves the reward (the bound of
            # tests/test_learning_dynamics.py:392)
            d = abs(m["reward"] - first_reward)
            print(f"  first reward, int8 rollout against bf16: {m['reward']:.6f} against "
                  f"{first_reward:.6f} ({d:.2e}, bound 0.05)")
            expect(d <= 0.05, f"the int8 rollout's first reward lies {d} from the bf16 run's")
        _add(got8, launches)
    del trainer
    torch.cuda.empty_cache()

    # The shifted route (HYV_FLASH_BOUNDED=0), from the same weights, data
    # and draws: one outer step at 21 frames through K2 and K3s. Bound on
    # the first reward: the routes differ only in where bf16 rounds p, so
    # the reward moves far less than under the int8 rollout (bound 0.05
    # above): 0.01.
    del raw["train"]["rollout_quant"]
    fa.FLASH_BOUNDED = False
    try:
        trainer, config, build_s = _build_trainer(cli, raw, dev)
        per_step_s = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                             cfg.remat_policy, shifted=True)
        name = "blocks.29.self_attn.q.weight"
        before = dict(trainer.model.dit.named_parameters())[name].detach().clone()
        torch.cuda.synchronize()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        got_s = dict(_build.LAUNCHES)
    finally:
        fa.FLASH_BOUNDED = True
    moved = (dict(trainer.model.dit.named_parameters())[name].detach() != before).float().mean()
    print(f"  shifted route, 21 frames: refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s (a fresh trainer's first "
          f"step); {name}: {moved.item():.1%} moved; launches {got_s}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite on the shifted route: {m}")
    expect(m["grad_norm"] > 0 and moved.item() > 0, "the shifted route's step moved nothing")
    expect(got_s == per_step_s, f"shifted route launches {got_s}, expected {per_step_s}")
    d = abs(m["reward"] - first_reward)
    print(f"  first reward, shifted route against bounded: {m['reward']:.6f} against "
          f"{first_reward:.6f} ({d:.2e}, bound 0.01)")
    expect(d <= 0.01, f"the shifted route's first reward lies {d} from the bounded run's")
    del trainer
    torch.cuda.empty_cache()

    # Every backward on K5 (HYV_FLASH_MERGED_BWD=0), from the same weights,
    # data and draws: one outer step at 21 frames. The forward is the bf16
    # run's, so its first reward is too (bound 0.01, as the shifted
    # route's); the gradients differ from K4's in where dq rounds, so the
    # grad norm stays within 1% of the bf16 run's.
    fa.FLASH_MERGED_BWD = False
    try:
        trainer, config, build_s = _build_trainer(cli, raw, dev)
        per_step_k5 = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                              cfg.remat_policy, merged_bwd=False)
        torch.cuda.synchronize()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        got_k5 = dict(_build.LAUNCHES)
    finally:
        fa.FLASH_MERGED_BWD = True
    print(f"  split backward (K5), 21 frames: refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s (a fresh trainer's first "
          f"step); launches {got_k5}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite with the split backward: {m}")
    expect(got_k5 == per_step_k5, f"split backward launches {got_k5}, expected {per_step_k5}")
    d = abs(m["reward"] - first_reward)
    g = abs(m["grad_norm"] / hist[0]["grad_norm"] - 1)
    print(f"  first step, split backward against merged: reward {d:.2e} apart (bound 0.01), "
          f"grad norm {m['grad_norm']:.6e} against {hist[0]['grad_norm']:.6e} ({g:.2e} "
          f"relative, bound 0.01)")
    expect(d <= 0.01 and g <= 0.01, "the split backward's first step strays from the merged one's")
    del trainer
    torch.cuda.empty_cache()
    return _add(_add(_add(got, got8), got_s), got_k5)


def phase_probes(results):
    """Phase 8: the int8 probes P1 and P2 through their scripts, each with
    the counters set to 0 just before; returns their launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    launches = {}
    for name, script, shown in (("P1", "probe_int8_rate_torch", "qk"),
                                ("P2", "probe_int8_mosaic_torch", "chain")):
        cli = load_script(script)
        _build.reset_launches()
        res = cli.main([])
        torch.cuda.synchronize()
        launches[name] = _build.LAUNCHES[name]
        for r in res:
            print(f"  {name} {r['probe']} [{r['m']}, {r['k']}] x [{r['k']}, {r['n_cols']}] x "
                  f"{r['nblocks']} blocks x {r['reps']} reps: int8 {r['int8_ms']:.4f} ms "
                  f"{r['int8_tops']:.1f} TOPS (torch._int_mm {r['int8_library_tops']:.1f}), "
                  f"bf16 {r['bf16_ms']:.4f} ms {r['bf16_tops']:.1f} TFLOP/s (torch.matmul "
                  f"{r['bf16_library_tops']:.1f}), int8 {r['int8_over_bf16']:.2f}x bf16; exact "
                  f"{r['int8_exact']}/{r['bf16_exact']}")
            expect(r["int8_exact"] and r["bf16_exact"],
                   f"{name} {r['probe']} differs from its plain version")
        r = next(r for r in res if r["probe"] == shown)
        ops = 2 * r["m"] * r["k"] * r["n_cols"] * r["nblocks"] * r["reps"]
        nbytes = r["m"] * r["k"] + r["nblocks"] * r["n_cols"] * r["k"] + 4 * r["m"] * r["n_cols"]
        # no single PyTorch call sums the reps and the b-blocks: library_ms
        # is null; the library's rate for one rep's product is printed above
        results[name] = {"max_abs_err": 0.0, "ms": r["int8_ms"], "plain_ms": r["plain_ms"],
                         **bound(nbytes, int8=ops), "library_ms": None,
                         "bf16_ms": r["bf16_ms"], "int8_tops": r["int8_tops"],
                         "bf16_tops": r["bf16_tops"]}
    return launches


def print_ptxas(log: str, smem: dict) -> None:
    """Registers and spills of the kernel instances the slice launches, any
    ptxas warning about them (a serialised wgmma pipeline, an ignored
    setmaxnreg), and the dynamic shared memory per block of the TMA/wgmma
    kernels (``smem``: name -> bytes). The
    norm kernels' instances: narrow rows (a warp each) under a ceiling of
    12 (K8/K9) or 6 (K6/K7) chunks a lane, filled exactly at D 1536 / 12
    heads (a compile-time count) and not at D 1280 / 10 heads, and wide
    rows (a block each) at D 5120 / 40 heads."""
    wanted = {"flash_fwd_kernelILb0ELb1E": "K1",
              "flash_fwd_kernelILb0ELb0E": "K3",
              "flash_fwd_kernelILb1ELb1E": "K2",
              "flash_fwd_kernelILb1ELb0E": "K3s",
              "rope_kernelI13__nv_bfloat16E": "R bf16",
              "rope_kernelIfE": "R fp32",
              "flash_bwd_merged_kernel": "K4",
              "flash_bwd_prologue_kernelILb0E": "K4 prologue",
              "flash_bwd_prologue_kernelILb1E": "K5 prologue",
              "flash_bwd_dkv_kernel": "K5 dk/dv",
              "flash_bwd_dq_kernel": "K5 dq",
              "rmsnorm_rope_bwd_kernelILi1ELi6ELb1ELb1": "K7 narrow 12 heads rope",
              "rmsnorm_rope_bwd_kernelILi1ELi6ELb1ELb0": "K7 narrow 12 heads norm-only",
              "rmsnorm_rope_bwd_kernelILi1ELi6ELb0ELb1": "K7 narrow 10 heads rope",
              "rmsnorm_rope_bwd_kernelILi8ELi4ELb0ELb1": "K7 wide rope",
              "rmsnorm_rope_bwd_kernelILi8ELi4ELb0ELb0": "K7 wide norm-only",
              "ln_scale_shift_bwd_kernelILi1ELi12ELb1E13__nv_bfloat16": "K9 narrow D=1536 bf16-g",
              "ln_scale_shift_bwd_kernelILi1ELi12ELb1Ef": "K9 narrow D=1536 fp32-g",
              "ln_scale_shift_bwd_kernelILi1ELi12ELb0E13__nv_bfloat16": "K9 narrow D=1280 bf16-g",
              "ln_scale_shift_bwd_kernelILi8ELi8ELb0E13__nv_bfloat16": "K9 wide bf16-g",
              "ln_scale_shift_bwd_kernelILi8ELi8ELb0Ef": "K9 wide fp32-g",
              "ln_scale_shift_kernelILi1ELi12ELb1E13__nv_bfloat16": "K8 narrow D=1536 bf16-out",
              "ln_scale_shift_kernelILi1ELi12ELb1Ef": "K8 narrow D=1536 fp32-out",
              "ln_scale_shift_kernelILi1ELi12ELb0E13__nv_bfloat16": "K8 narrow D=1280 bf16-out",
              "ln_scale_shift_kernelILi8ELi8ELb0E13__nv_bfloat16": "K8 wide bf16-out",
              "ln_scale_shift_kernelILi8ELi8ELb0Ef": "K8 wide fp32-out",
              "rmsnorm_rope_kernelILi1ELi6ELb1ELb1": "K6 narrow 12 heads rope",
              "rmsnorm_rope_kernelILi1ELi6ELb1ELb0": "K6 narrow 12 heads norm-only",
              "rmsnorm_rope_kernelILi1ELi6ELb0ELb1": "K6 narrow 10 heads rope",
              "rmsnorm_rope_kernelILi8ELi4ELb0ELb1": "K6 wide rope",
              "rmsnorm_rope_kernelILi8ELi4ELb0ELb0": "K6 wide norm-only",
              "flash_fwd_qk8_kernel": "K10",
              "probe_kernelILb1E": "P1/P2 int8",
              "probe_kernelILb0E": "P1/P2 bf16"}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in wanted.items() if k in line), None)
        elif "Performance Loss" in line or "arning" in line:
            print(f"  ptxas: {line.split(':', 1)[-1].strip()}")
        elif "(C75" in line:  # a note on a wgmma pipeline, naming its function
            named = next((v for k, v in wanted.items() if k in line), "another kernel")
            print(f"  ptxas note on {named}: {line.split(':', 1)[-1].split(' in function')[0].strip()}")
        elif current and ("registers" in line or "spill" in line):
            print(f"  ptxas {current}: {line.split(':', 1)[-1].strip()}")
            # the TMA/wgmma kernels and the norm kernels' wide row layout
            # must not spill
            if current in ("K1", "K2", "K3", "K3s", "K10") or current[:2] in ("K4", "K5") \
                    or "wide" in current:
                expect("spill" not in line or " 0 bytes spill stores" in line,
                       f"ptxas: {current} spills: {line.strip()}")
    print("  dynamic shared memory per block: "
          + ", ".join(f"{name} {n} bytes" for name, n in smem.items()))


def check_sass(lib_path) -> None:
    """The forward's four instances, K4's and K5's main kernels and K10,
    disassembled from the built library, must load by TMA (UTMALDG) and
    multiply on wgmma: HGMMA (bf16), and for K10's int8 score also IGMMA;
    the forward and K10 store o by TMA (UTMASTG), K4 adds dq by TMA
    reductions (UTMAREDG), K5's dq pass needs neither."""
    from hyvideo_prfl_torch.ops import _build

    kernels = {"flash_fwd_kernelILb0ELb1E": "K1", "flash_fwd_kernelILb1ELb1E": "K2",
               "flash_fwd_kernelILb0ELb0E": "K3", "flash_fwd_kernelILb1ELb0E": "K3s",
               "flash_bwd_merged_kernel": "K4", "flash_bwd_dkv_kernel": "K5 dk/dv",
               "flash_bwd_dq_kernel": "K5 dq", "flash_fwd_qk8_kernel": "K10"}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {name: {} for name in kernels.values()}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((v for k, v in kernels.items() if k in line), None)
        elif current:
            for op in ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "UTMAREDG", "ATOM", "RED."):
                if op in line:
                    counts[current][op] = counts[current].get(op, 0) + 1
    for name, c in counts.items():
        print(f"  {name} SASS instruction counts: {c}")
        expect(c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0,
               f"{name}'s kernel lacks HGMMA or UTMALDG: {c}")
        expect(name != "K10" or c.get("IGMMA", 0) > 0, f"K10's kernel lacks IGMMA: {c}")


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
    lib = _build.lib()
    print_ptxas(_build.build_log, {"K1/K2/K3/K3s": lib.hyv_flash_fwd_smem(),
                                   "K4 and K5 dk/dv": lib.hyv_flash_bwd_merged_smem(),
                                   "K5 dq": lib.hyv_flash_bwd_dq_smem(),
                                   "K10": lib.hyv_flash_fwd_qk8_smem()})
    check_sass(_build.build())

    results = {}
    print("phase 2: kernels against their plain versions at the 81-frame shapes")
    phase_kernels(results)
    print("phase 2b: the shifted forward (K2, K3s) and the rope R against their plain versions")
    phase_shifted_kernels(results)
    print("phase 3: whole-model check, card against CPU")
    phase_model()
    print("phase 4: serving through the CLI path")
    serve_launches = phase_serve()
    print("phase 5: backward kernels against their plain versions at the training shapes")
    route_launches = phase_bwd_kernels(results)
    print("phase 5b: the key mask through K4 and K5")
    phase_masked_bwd()
    print("phase 6: whole-model gradients, card against CPU")
    phase_grad_model()
    print("phase 7: PRFL training through the CLI path")
    with tempfile.TemporaryDirectory() as root:
        train_launches = phase_train(root)
    # every kernel of the training path ran there (K5 in the step with
    # HYV_FLASH_MERGED_BWD=0; the JAX rule routes every full-width call to
    # K4 otherwise)
    expect(all(train_launches.get(k, 0) > 0 for k in KERNELS if k not in ("P1", "P2", "R")),
           f"a kernel of the training path never launched: {train_launches}")
    print(f"  serving launches {serve_launches}; training launches {train_launches}")
    print("phase 8: the int8 probes P1 and P2")
    probe_launches = phase_probes(results)
    print("phase 9: the un-normed DiT (qk_norm off): R, K2 and K3s")
    unnormed_launches = phase_unnormed()
    print("phase 10: the 14B width (dim 5120, 40 heads) and bench.py's (1280, 10)")
    phase_wide(results)

    launches = _add(_add(_add(_add(dict(serve_launches), train_launches), route_launches),
                         probe_launches), unnormed_launches)
    expect(all(launches.get(k, 0) > 0 for k in KERNELS), f"a kernel never launched: {launches}")
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
