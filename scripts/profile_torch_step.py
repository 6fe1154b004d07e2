"""Where the port spends its device time: one batched-CFG DiT forward, or
one PRFL refl training step (PyTorch port).

    python3 scripts/profile_torch_step.py --frame_num 21 81 [--quant int8] [--quant_attn int8]
    python3 scripts/profile_torch_step.py --refl --frame_num 21 81 [--steps 8 --mid 3] \
        [--rollout_quant int8]

Forward mode, for each frame count: builds the t2v-1.3B 832*480 pipeline
once (random weights, seeded non-zero head), runs one warm-up forward at
CFG batch 2, one timed forward with the profiler off, then one under
torch.profiler. One sampling step is one such forward plus a few
elementwise solver passes. ``--quant int8`` quantizes the block matmuls
after the weights are made and ``--quant_attn int8`` takes K10, as the
serving CLI's flags do.

Refl mode (--refl): builds the PRFL trainer's model at t2v-1.3B (fp32
policy masters, remat "attn", the 8-block frozen LRM, AdamW), then for
each frame count runs one warm-up refl step, one timed with the profiler
off and one under torch.profiler: ``mid`` no-grad rollout forwards, one
forward and backward of the policy and of the LRM, and the optimizer;
``--rollout_quant int8`` runs the rollout through the int8 model.

Each run prints one JSON line with both wall times, the device time by
group (K1, K2, K3, K3s, K4, K5, K6, K7, K8, K9, K10, R, GEMM, other) from
the traced run, and the idle share: 1 - device busy time / untraced wall
time. ``HYV_FLASH_BOUNDED=0`` profiles the shifted route (K2, K3s). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.configs import dit_config_for_task  # noqa: E402
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.pipelines.pipeline import latent_size_for  # noqa: E402
from hyvideo_prfl_torch.utils.checkpoint import quantize_model  # noqa: E402

# kernel-name fragment -> group; first match wins
# (the forward's instances are flash_fwd_kernel<kShifted, kStreaming>)
GROUPS = (("flash_fwd_kernel<false, true>", "K1"),
          ("flash_fwd_kernel<false, false>", "K3"),
          ("flash_fwd_kernel<true, true>", "K2"),
          ("flash_fwd_kernel<true, false>", "K3s"),
          ("::rope_kernel<", "R"),
          ("flash_fwd_qk8_kernel", "K10"),
          ("flash_bwd_merged_kernel", "K4"),
          ("flash_bwd_prologue_kernel<true>", "K5"),  # K5's prologue also forms k_s
          ("flash_bwd_prologue_kernel", "K4"),
          ("flash_bwd_dkv_kernel", "K5"),
          ("flash_bwd_dq_kernel", "K5"),
          ("rmsnorm_rope_kernel", "K6"),
          ("rmsnorm_rope_bwd_kernel", "K7"),
          ("ln_scale_shift_kernel", "K8"),
          ("ln_scale_shift_bwd_kernel", "K9"),
          ("gemm", "GEMM"), ("sm90_xmma", "GEMM"), ("cutlass", "GEMM"),
          ("nvjet", "GEMM"))


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag.lower() in low), "other")


def _profile(run, label: dict) -> dict:
    """Warm-up, one untraced and one traced call of ``run``; device time by group."""
    run()  # warm-up: cuBLAS plans, rope tables, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # wall time with the profiler off
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        ms = evt.self_device_time_total / 1e3
        if evt.device_type != torch.autograd.DeviceType.CUDA or ms <= 0:
            continue
        groups[group_of(evt.key)] = groups.get(group_of(evt.key), 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:80]))
    if not groups:
        raise SystemExit("the profiler recorded no device time")
    busy = sum(groups.values())
    return {**label, "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in sorted(kernels, reverse=True)[:12]]}


def _latent_shape(frame_num: int, batch: int):
    lat_f, lat_h, lat_w = latent_size_for(832 * 480, 480 / 832, num_frames=frame_num)
    return (batch, lat_f, lat_h, lat_w, 16)


def profile_forward(model, frame_num: int, dev) -> dict:
    cfg = model.cfg
    shape = _latent_shape(frame_num, 2)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=dev)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    t = torch.full((2,), 999.0, device=dev)
    tokens, grid = wan_dit.patchify(x, cfg.patch_size)

    def run():
        with torch.inference_mode():
            model(tokens, t, ctx, grid=grid)

    return _profile(run, {"mode": "forward", "frame_num": frame_num, "tokens": tokens.shape[1],
                          "quant_dense": cfg.quant_dense, "quant_attn": cfg.quant_attn})


def build_prfl(dev, steps: int, mid: int, rollout_quant=None):
    """The trainer's model at t2v-1.3B: fp32 policy masters with seeded
    JAX-initialiser weights and a seeded non-zero head, the frozen LRM."""
    from hyvideo_prfl_torch.training import common
    from hyvideo_prfl_torch.training.pavrm import PavrmConfig
    from hyvideo_prfl_torch.training.prfl import PrflConfig, PrflModel, make_refl_step

    cfg = dataclasses.replace(dit_config_for_task("t2v-1.3B"), remat_policy="attn")
    model = PrflModel(cfg, PavrmConfig(feature_layer=(8,)),
                      PrflConfig(inference_steps=steps, fixed_mid=mid,
                                 rollout_quant=rollout_quant), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    wan_dit.init_params(model.dit, g)
    model.lrm.init_params(g)
    with torch.no_grad():
        model.dit.head.head.weight.normal_(0.0, cfg.dim ** -0.5, generator=g)
    tx = common.make_optimizer()
    return model, common.init_train_state(model.dit, tx), make_refl_step(model, tx)


def profile_refl(prfl, frame_num: int, dev) -> dict:
    model, state, refl = prfl
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"latents": torch.randn(*_latent_shape(frame_num, 1), generator=g, device=dev),
             "text": torch.randn(1, model.dit_cfg.text_len, model.dit_cfg.text_dim,
                                 generator=g, device=dev)}

    def run():
        refl(state, batch, g)

    return _profile(run, {"mode": "refl", "frame_num": frame_num, "mid": model.cfg.fixed_mid,
                          "inference_steps": model.cfg.inference_steps,
                          "rollout_quant": model.cfg.rollout_quant, "peak_gib": None})


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frame_num", type=int, nargs="+", default=[21, 81])
    p.add_argument("--refl", action="store_true", help="profile one PRFL refl step")
    p.add_argument("--steps", type=int, default=8, help="refl: PRFL inference steps")
    p.add_argument("--mid", type=int, default=3, help="refl: rollout forwards before the step")
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="forward: W8A8 int8 block matmuls")
    p.add_argument("--quant_attn", choices=("none", "int8"), default="none",
                   help="forward: the int8 q k^T self-attention (K10)")
    p.add_argument("--rollout_quant", choices=("none", "int8"), default="none",
                   help="refl: the rollout through the int8 model")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    if args.refl:
        prfl = build_prfl(dev, args.steps, args.mid,
                          None if args.rollout_quant == "none" else args.rollout_quant)
        for frame_num in args.frame_num:
            torch.cuda.reset_peak_memory_stats()
            out = profile_refl(prfl, frame_num, dev)
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            print(json.dumps(out))
        return 0
    cfg = dit_config_for_task(
        "t2v-1.3B", quant_attn=None if args.quant_attn == "none" else args.quant_attn)
    model = wan_dit.WanModel(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    wan_dit.init_params(model, g)
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, model.cfg.dim ** -0.5, generator=g)
    if args.quant == "int8":
        model = quantize_model(model)
    for frame_num in args.frame_num:
        print(json.dumps(profile_forward(model.eval(), frame_num, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
