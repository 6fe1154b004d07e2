"""Where one batched-CFG DiT forward spends its device time (PyTorch port).

    python3 scripts/profile_torch_step.py --frame_num 21 81

For each frame count: builds the t2v-1.3B 832*480 pipeline once (random
weights, seeded non-zero head), runs one warm-up forward at CFG batch 2,
one timed forward with the profiler off, then one under torch.profiler,
and prints one JSON line with both wall times, the device time by group
(K1, K3, K6, K8, GEMM, other) from the traced forward, and the idle share:
1 - device busy time / untraced wall time. One sampling step is
one such forward plus a few elementwise solver passes. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
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

# kernel-name fragment -> group; first match wins
GROUPS = (("flash_fwd_bounded_kernel<false>", "K1"),
          ("flash_fwd_bounded_kernel<true>", "K3"),
          ("rmsnorm_rope_kernel", "K6"),
          ("ln_scale_shift_kernel", "K8"),
          ("gemm", "GEMM"), ("sm90_xmma", "GEMM"), ("cutlass", "GEMM"),
          ("nvjet", "GEMM"))


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag.lower() in low), "other")


def profile_forward(model, frame_num: int, dev) -> dict:
    cfg = model.cfg
    lat_f, lat_h, lat_w = latent_size_for(832 * 480, 480 / 832, num_frames=frame_num)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, lat_f, lat_h, lat_w, 16, generator=g, device=dev)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    t = torch.full((2,), 999.0, device=dev)
    tokens, grid = wan_dit.patchify(x, cfg.patch_size)
    with torch.inference_mode():
        model(tokens, t, ctx, grid=grid)  # warm-up: cuBLAS plans, rope tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # wall time with the profiler off
        model(tokens, t, ctx, grid=grid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(tokens, t, ctx, grid=grid)
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
    return {"frame_num": frame_num, "tokens": lat_f * (lat_h // 2) * (lat_w // 2),
            "forward_wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in sorted(kernels, reverse=True)[:12]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frame_num", type=int, nargs="+", default=[21, 81])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    model = wan_dit.WanModel(dit_config_for_task("t2v-1.3B"), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    wan_dit.init_params(model, g)
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, model.cfg.dim ** -0.5, generator=g)
    for frame_num in args.frame_num:
        print(json.dumps(profile_forward(model.eval(), frame_num, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
