"""The multi-GPU layer of the PyTorch port on several cards of one host,
held to the same work on one card.

    torchrun --nproc_per_node 4 scripts/multi_gpu_check_torch.py \\
        [--frames 81] [--blocks 2] [--device cuda]

Every rank drives one GPU (NCCL; gloo with --device cpu, which runs the
plain op versions, at --frames 5 and a tiny width for a rehearsal). Rank 0
also runs each check alone, unsharded, and compares:

1. ``ulysses_attention`` at sp = world (t2v-1.3B's 12 heads, bounded
   logits, K6's head-major q/k) forward and backward against the one-card
   flash attention on the whole sequence;
2. a ``--blocks``-block t2v-1.3B DiT forward (bf16) at sp = world against
   the one-card forward;
3. one PRFL refl + SFT step (``--blocks`` policy blocks, a 2-block LRM, 8
   PRFL steps, mid 3; every backward on K5) under each FSDP strategy at
   (data 1, sp = world) and, for four ranks, (data 2, sp 2), against the
   one-card step on the global batch; seconds per step on each side;
4. a 2-step UniPC sample at ulysses = world, blocks sharded, against the
   one-card sample;
5. USP (``usp_attention``: ring attention over 2 ring ranks, Ulysses over
   world / 2) forward and backward against the one-card attention, as 1;
6. a 2-step UniPC sample at ring 2 x ulysses world / 2 (the serving CLI's
   ``--ring_size 2 --ulysses_size world/2``), blocks sharded, against the
   one-card sample;
7. the teacher-student collectives (``parallel/teacher_student.py``):
   each rank's value swapped with its partner's, the teacher's broadcast
   within each pair, both halves' gathered.

Prints one JSON line of the numbers (rank 0). Exits non-zero when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.ops import _build  # noqa: E402
from hyvideo_prfl_torch.ops import flash_attention as fa  # noqa: E402
from hyvideo_prfl_torch.ops.attention import dot_product_attention, ulysses_attention  # noqa: E402
from hyvideo_prfl_torch.ops.ring_attention import usp_attention  # noqa: E402
from hyvideo_prfl_torch.parallel import sharding, teacher_student  # noqa: E402
from hyvideo_prfl_torch.pipelines import pipeline  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import common, prfl  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import PavrmConfig  # noqa: E402

TEXT_LEN = 512


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(a, b) -> float:
    """Relative L2 distance of a from b."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


class Check:
    def __init__(self, main):
        self.main, self.failures, self.numbers = main, [], {}

    def expect(self, cond, msg):
        if self.main and not cond:
            self.failures.append(msg)
            print(f"FAILED: {msg}", flush=True)

    def note(self, key, value, text=""):
        self.numbers[key] = value
        if self.main:
            print(f"  {key}: {value}{text}", flush=True)


def check_ulysses(mesh, dev, lq, ck, ring=1):
    """1: Ulysses fwd + bwd at sp = world against the whole sequence; 5:
    with ``ring`` 2, USP (ring 2 x Ulysses world / 2)."""
    sp = sharding.build_mesh(mesh.world // ring, dev, ring_size=ring).seq()
    tag = "ulysses" if ring == 1 else "usp"
    g = torch.Generator(device=dev).manual_seed(1)
    n = 12
    q, k = (torch.randn(1, n, lq, 128, device=dev, generator=g).bfloat16() for _ in range(2))
    v = torch.randn(1, lq, n, 128, device=dev, generator=g).bfloat16()
    do = torch.randn(1, lq, n, 128, device=dev, generator=g).bfloat16()
    leaves = [sp.shard(x, dim).detach().clone().requires_grad_()
              for x, dim in ((q, 2), (k, 2), (v, 1))]
    o = (ulysses_attention(*leaves, sp, "bnld", bounded_logits=True) if ring == 1
         else usp_attention(*leaves, sp, "bnld", bounded_logits=True))
    grads = torch.autograd.grad(o, leaves, sp.shard(do, 1))
    with torch.no_grad():
        got = [sp.gather(o, 1)] + [sp.gather(gr, dim) for gr, dim in zip(grads, (2, 2, 1))]
    if ck.main:
        ref_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ro = dot_product_attention(*ref_leaves, qk_layout="bnld", bounded_logits=True)
        ref = [ro.detach(), *torch.autograd.grad(ro, ref_leaves, do)]
        same = torch.equal(got[0], ref[0])
        errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for a, b in zip(got, ref)]
        ck.note(f"{tag}_out_bitwise", same)
        ck.note(f"{tag}_rel_max_err", [round(e, 6) for e in errs], " (o, dq, dk, dv)")
        if ring == 1:
            # each head's attention is the same kernel on the same rows: o the
            # same bits; dq, dk, dv within two bf16 ulps of their largest entry
            ck.expect(same, "ulysses forward differs from the one-card attention")
            ck.expect(all(e <= 2.0 ** -6 for e in errs[1:]), f"ulysses gradients {errs}")
        else:
            # the ring merges bf16 hop outputs in fp32: o within two bf16 ulps
            # of max|o|, the gradients (a bf16 partial a hop) within four
            ck.expect(errs[0] <= 2.0 ** -6 and all(e <= 2.0 ** -5 for e in errs[1:]),
                      f"usp errors {errs}")


def _dit(cfg, dev, seed):
    model = wan_dit.WanModel(cfg, device=dev)
    wan_dit.init_params(model, torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, cfg.dim ** -0.5,
                                       generator=torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def check_forward(mesh, dev, cfg, shape, ck):
    """2: the DiT forward at sp = world against one card."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(shape, device=dev, generator=g)
    ctx = torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g)
    t = torch.tensor([700.0], device=dev)
    model = _dit(cfg, dev, 3)
    sharding.set_sequence_parallel(model, sharding.build_mesh(mesh.world, dev).seq())
    with torch.no_grad():
        got = model(x, t, ctx)
        if ck.main:
            sharding.set_sequence_parallel(model, None)
            ref = model(x, t, ctx)
            rel = _rel(got, ref)
            ck.note("forward_rel_l2", rel)
            ck.expect(bool(torch.isfinite(got).all()) and rel <= 1e-2,
                      f"sharded forward {rel} from one card")


def check_steps(mesh_sp, dev, cfg, shape, ck, world):
    """3: one PRFL refl + SFT step per strategy and mesh against one card."""
    pc = PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1))
    rc = prfl.PrflConfig(inference_steps=8, fixed_mid=3)
    g = torch.Generator(device=dev).manual_seed(4)
    b = 2
    full = (b, *shape[1:])
    batch = {"latents": torch.randn(full, device=dev, generator=g),
             "text": torch.randn(b, TEXT_LEN, cfg.text_dim, device=dev, generator=g)}
    sched = fm.train_schedule(1000)
    t, sigma = fm.sample_train_timestep(sched, b, "uniform",
                                        generator=torch.Generator(device=dev).manual_seed(5))
    draws = dict(latent0=torch.randn(full, device=dev, generator=g), t=t, sigma=sigma,
                 noise=torch.randn(full, device=dev, generator=g))

    def run(mesh, strategy):
        model = prfl.PrflModel(cfg, pc, rc, device=dev)
        wan_dit.init_params(model.dit, torch.Generator(device=dev).manual_seed(6))
        with torch.no_grad():
            model.dit.head.head.weight.normal_(
                0.0, cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(6))
        model.lrm.init_params(torch.Generator(device=dev).manual_seed(7))
        layout = prfl.parallelize(model, mesh, strategy) if mesh else None
        tx = common.make_optimizer(learning_rate=5e-6)
        state = common.init_train_state(model.dit, tx, layout)
        rows = mesh.rows if mesh else (lambda x: x)
        local = {k: rows(v) for k, v in batch.items()}
        secs = []
        for _ in range(2):  # the second step is the warm one
            _sync(dev)
            t0 = time.perf_counter()
            state, mr = prfl.make_refl_step(model, tx, mesh)(state, local,
                                                             latent0=draws["latent0"])
            state, ms = prfl.make_sft_step(model, tx, sched, mesh)(
                state, local, t=draws["t"], sigma=draws["sigma"], noise=draws["noise"])
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        return [float(mr["loss"]), float(mr["reward"]), float(mr["grad_norm"]),
                float(ms["loss"]), float(ms["grad_norm"])], secs[-1]

    results = {}
    meshes = [("d1_sp%d" % world, mesh_sp)]
    if world == 4:
        meshes.append(("d2_sp2", sharding.build_mesh(2, dev)))
    for tag, mesh in meshes:
        for strategy in sharding.FSDP_STRATEGIES:
            results[f"{tag}_{strategy}"] = run(mesh, strategy)
    if ck.main:
        ref, ref_s = run(None, None)
        ck.note("step_one_card", {"metrics": ref, "s": round(ref_s, 4)})
        for key, (got, secs) in results.items():
            rel = [abs(a - r) / max(abs(r), 1e-12) for a, r in zip(got, ref)]
            ck.note(f"step_{key}", {"metrics": got, "s": round(secs, 4),
                                    "rel": [round(x, 6) for x in rel]})
            # bf16 compute, sums in another order and split over other
            # matmul shapes: the loss and reward of the refl step within
            # 1e-2, every metric finite
            ck.expect(all(math.isfinite(x) for x in got) and rel[0] <= 1e-2
                      and rel[1] <= 1e-2, f"{key}: metrics {got} against {ref}")


def check_sample(mesh, dev, cfg, shape, ck, ring=1):
    """4: 2 UniPC steps at ulysses = world against one card; 6: with
    ``ring`` 2, at ring 2 x ulysses world / 2."""
    g = torch.Generator(device=dev).manual_seed(8)
    ctx = torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g)
    null = torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g) * 0.1
    noise = torch.randn(shape, device=dev, generator=g)
    gen = pipeline.GenerateConfig(sampling_steps=2, guide_scale=5.0, shift=5.0)
    model = _dit(cfg, dev, 9)
    if ck.main:
        ref = pipeline.WanT2V(model).generate(None, ctx, null, *shape[1:4], gen, noise=noise)
    sharding.shard_for_serving(model, sharding.build_mesh(mesh.world // ring, dev,
                                                          ring_size=ring))
    _sync(dev)
    t0 = time.perf_counter()
    got = pipeline.WanT2V(model).generate(None, ctx, null, *shape[1:4], gen, noise=noise)
    _sync(dev)
    secs = time.perf_counter() - t0
    if ck.main:
        rel = _rel(got, ref)
        tag = "sample" if ring == 1 else "usp_sample"
        ck.note(f"{tag}_rel_l2", rel, f" ({secs:.3f} s for 2 steps sharded)")
        ck.expect(bool(torch.isfinite(got).all()) and rel <= 2e-2, f"{tag} {rel} apart")


def check_teacher_student(dev, ck):
    """7: swap, broadcast from the teacher and gather of each rank's value."""
    world, rank = dist.get_world_size(), dist.get_rank()
    ts = teacher_student.make_ts_groups()
    x = torch.full((3,), float(rank), device=dev)
    got = torch.cat([teacher_student.ts_unit_swap(x, ts)[:1],
                     teacher_student.broadcast_from_teacher(x, ts)[:1],
                     teacher_student.all_gather_ts(x, ts)[:, 0]])
    parts = [torch.empty_like(got) for _ in range(world)]
    dist.all_gather(parts, got)
    if ck.main:
        half = world // 2
        want = [[(r + half) % world, r % half + half, r % half, r % half + half]
                for r in range(world)]
        seen = [[int(v) for v in p.tolist()] for p in parts]
        ck.note("teacher_student", seen, " (swap, broadcast, gathered student and teacher)")
        ck.expect(seen == want, f"teacher-student collectives {seen}, expected {want}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--blocks", type=int, default=2, help="at least 2: the LRM taps block 2")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="a 2-head width for a CPU rehearsal")
    args = p.parse_args(argv)
    dev = sharding.init_distributed(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    ck = Check(rank == 0)
    if dev.type == "cuda":
        # one build: rank 0 compiles, the others load it
        if rank == 0:
            _build.lib()
        dist.barrier()
        _build.lib()
        fa.FLASH_MERGED_BWD = False  # K5: a step that repeats its bits
    cfg = wan_dit.t2v_1_3b(num_layers=args.blocks, remat_policy="attn")
    if args.tiny:
        cfg = wan_dit.tiny_test(num_heads=4, dim=512, ffn_dim=512, num_layers=args.blocks,
                                text_dim=64)
    lat_f = (args.frames - 1) // 4 + 1
    h, w = (60, 104) if not args.tiny else (8, 8)
    shape = (1, lat_f, h, w, 16)
    step_shape = (1, min(lat_f, 6), h, w, 16)  # the steps at 21 frames at most
    mesh = sharding.build_mesh(world, dev)
    t0 = time.perf_counter()
    for name, fn in (("ulysses", lambda: check_ulysses(mesh, dev, lat_f * h * w // 4, ck)),
                     ("forward", lambda: check_forward(mesh, dev, cfg, shape, ck)),
                     ("steps", lambda: check_steps(mesh, dev, cfg, step_shape, ck, world)),
                     ("sample", lambda: check_sample(mesh, dev, cfg, shape, ck)),
                     ("usp", lambda: check_ulysses(mesh, dev, lat_f * h * w // 4, ck, ring=2)),
                     ("usp sample", lambda: check_sample(mesh, dev, cfg, shape, ck, ring=2)),
                     ("teacher-student", lambda: check_teacher_student(dev, ck))):
        if ck.main:
            print(f"{name} (at {time.perf_counter() - t0:.1f} s)", flush=True)
        fn()
        dist.barrier()
    if ck.main:
        card = ""
        if dev.type == "cuda":
            card = torch.cuda.get_device_name(0)
        print(json.dumps({"world": world, "card": card, "frames": args.frames,
                          "blocks": args.blocks, **ck.numbers,
                          "failures": ck.failures}))
    dist.barrier()
    dist.destroy_process_group()
    return 1 if ck.failures else 0


if __name__ == "__main__":
    sys.exit(main())
