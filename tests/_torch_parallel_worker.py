"""One rank of the port's multi-process checks on CPU gloo, for
tests/test_torch_parallel.py and tests/test_torch_parallel_train.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_parallel_worker.py <group> <dir>

torchrun's variables, as a multi-GPU run gets them. Imports no JAX: the
JAX package is blocked before anything loads. Reads <dir>/inputs.npz,
runs every case of <group> in order (every rank runs every case, so the
collectives pair up), and rank 0 writes each case's outputs to
<dir>/<case>.npz.
"""

import dataclasses
import importlib.util
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
for _m in ("jax", "jaxlib", "flax", "optax", "chex", "hyvideo_prfl_tpu"):
    sys.modules[_m] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.ops import attention, ring_attention  # noqa: E402
from hyvideo_prfl_torch.parallel import sharding, teacher_student  # noqa: E402
from hyvideo_prfl_torch.pipelines import pipeline  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import common, lora, pavrm, prfl  # noqa: E402
from chip_smoke import Recording  # noqa: E402

torch.set_num_threads(1)

TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)  # head_dim 128
LR = 1e-3
STEPS, MID = 4, 1
_MESHES = {}


def mesh(sp: int, ring: int = 1) -> sharding.Mesh:
    """One (data, sp) mesh per Ulysses and ring degree, built once (every
    rank builds them in the same order)."""
    if (sp, ring) not in _MESHES:
        _MESHES[sp, ring] = sharding.build_mesh(sp, "cpu", ring_size=ring)
    return _MESHES[sp, ring]


def full(x, sp, dim=1):
    """The whole token axis of this rank's block (a no-grad gather)."""
    with torch.no_grad():
        return x.detach() if sp is None else sp.gather(x.detach(), dim)


def summed(x):
    t = x.detach().clone()
    dist.all_reduce(t)
    return t


def t_(a):
    return torch.from_numpy(np.array(a))


def weights(inp, prefix):
    return {k[len(prefix):]: t_(v) for k, v in inp.items() if k.startswith(prefix)}


def tiny_cfg(**kw):
    return wan_dit.tiny_test(**TINY, compute_dtype=torch.float32, remat_policy="attn", **kw)


# -- attention and the DiT -----------------------------------------------------------


def ulysses(inp, sp_size, chunks, layout):
    sp = dataclasses.replace(mesh(sp_size).seq(), chunks=chunks)
    q, k, v, g = (t_(inp[n]) for n in ("uq", "uk", "uv", "ug"))
    ql, kl, vl = (sp.shard(x, 1).clone().requires_grad_() for x in (q, k, v))
    qa, ka = (ql.transpose(1, 2), kl.transpose(1, 2)) if layout == "bnld" else (ql, kl)
    out = attention.ulysses_attention(qa, ka, vl, sp, qk_layout=layout, bounded_logits=True)
    (out * sp.shard(g, 1)).sum().backward()
    return {"out": full(out, sp), "dq": full(ql.grad, sp), "dk": full(kl.grad, sp),
            "dv": full(vl.grad, sp)}


def usp(inp, uly, ring, chunks, bounded, layout="bnld"):
    """USP attention (ring x Ulysses) forward and backward on this rank's
    tokens, gathered."""
    sp = dataclasses.replace(mesh(uly, ring).seq(), chunks=chunks)
    assert sp.ring is not None and sp.ring.size == ring and sp.ulysses_size == uly
    q, k, v, g = (t_(inp[n]) for n in ("uq", "uk", "uv", "ug"))
    ql, kl, vl = (sp.shard(x, 1).clone().requires_grad_() for x in (q, k, v))
    qa, ka = (ql.transpose(1, 2), kl.transpose(1, 2)) if layout == "bnld" else (ql, kl)
    out = ring_attention.usp_attention(qa, ka, vl, sp, qk_layout=layout,
                                       bounded_logits=bounded)
    (out * sp.shard(g, 1)).sum().backward()
    return {"out": full(out, sp), "dq": full(ql.grad, sp), "dk": full(kl.grad, sp),
            "dv": full(vl.grad, sp)}


def ts_collectives(inp):
    """The teacher-student exchanges of each rank's row, gathered in rank order."""
    ts = teacher_student.make_ts_groups()
    x = t_(inp["ts_x"])[dist.get_rank()]
    out = {"swap": teacher_student.ts_unit_swap(x, ts),
           "bcast": teacher_student.broadcast_from_teacher(x, ts),
           "gather": teacher_student.all_gather_ts(x, ts),
           "ts_index": torch.tensor([float(teacher_student.is_teacher_half(ts.ts_index))])}
    res = {}
    for key, val in out.items():
        parts = [torch.empty_like(val) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, val.contiguous())
        res[key] = torch.stack(parts)
    return res


def token_parallel(inp):
    sp = mesh(2).seq()
    q = sp.shard(t_(inp["tq"]), 1).clone().requires_grad_()
    k, v, ki, vi = (t_(inp[n]).requires_grad_() for n in ("tk", "tv", "tki", "tvi"))
    # the cross-attention on a token shard: the plain call on this rank's queries
    out = (attention.dot_product_attention(q, k, v, bounded_logits=True)
           + attention.dot_product_attention(q, ki, vi, bounded_logits=True))
    (out * sp.shard(t_(inp["tg"]), 1)).sum().backward()
    # the replicated keys' gradients are each rank's share: their sum is the whole
    return {"out": full(out, sp), "dq": full(q.grad, sp), "dk": summed(k.grad),
            "dv": summed(v.grad), "dki": summed(ki.grad), "dvi": summed(vi.grad)}


def dit_model(inp, sp):
    model = wan_dit.WanModel(tiny_cfg())
    model.load_state_dict(weights(inp, "dit."))
    return sharding.set_sequence_parallel(model.eval(), sp)


def dit_forward(inp):
    model = dit_model(inp, mesh(2).seq())
    with torch.no_grad():
        out = model(t_(inp["x"]), t_(inp["t"]), t_(inp["ctx"]))
    return {"out": out}


def uneven(inp):
    model = dit_model(inp, mesh(dist.get_world_size()).seq())
    try:
        with torch.no_grad():
            model(t_(inp["x_odd"]), t_(inp["t"]), t_(inp["ctx"]))
    except ValueError as e:
        return {"msg": np.array(str(e))}
    return {"msg": np.array("no error")}


def sample(inp, uly=2, ring=1):
    model = sharding.shard_for_serving(dit_model(inp, None), mesh(uly, ring))
    gen = pipeline.GenerateConfig(sampling_steps=2, guide_scale=5.0, shift=5.0)
    out = pipeline.WanT2V(model).generate(None, t_(inp["ctx"]), t_(inp["ctx_null"]), 3, 8, 8,
                                          gen, noise=t_(inp["noise"]))
    return {"out": out}


def serve_bf16(inp):
    """shard_for_serving on a model that stores its matmul weights in bf16
    beside fp32 gains: the parameters' dtypes and which are sharded, and
    the forward at sp 2 before and after."""
    m = mesh(2)
    model = wan_dit.WanModel(wan_dit.tiny_test(**TINY, compute_dtype=torch.bfloat16))
    model.load_state_dict(weights(inp, "dit."))
    model = sharding.set_sequence_parallel(model.eval(), m.seq())
    before = {n: str(p.dtype) for n, p in model.named_parameters()}
    args = (t_(inp["x"]), t_(inp["t"]), t_(inp["ctx"]))
    with torch.no_grad():
        want = model(*args)
        sharding.shard_for_serving(model, m)
        got = model(*args)
    names = list(before)
    params = dict(model.named_parameters())
    return {"want": want, "got": got, "names": np.array(names),
            "before": np.array([before[n] for n in names]),
            "after": np.array([str(params[n].dtype) for n in names]),
            "sharded": np.array([sharding.is_dtensor(params[n]) for n in names])}


# -- training steps ------------------------------------------------------------------


def gathered_grads(state, tx):
    return {f"grad.{n}": sharding.full_of(g, p)
            for n, g, p in zip(state.names, tx.grads, state.params)}


def gathered_params(state):
    return {n: sharding.full_of(p, q).detach()
            for n, p, q in zip(state.names, state.local_params(), state.params)}


def rows(m, batch):
    return {k: m.rows(t_(v)) for k, v in batch.items()}


def prfl_step(inp, sp, strategy="full", offload=False, use_lora=False):
    """One refl step and one SFT step (AdamW) with the JAX draws of the
    global batch; with ``use_lora`` the factors of ``lora.*`` train on the
    frozen base (each in its block's FSDP2 unit)."""
    m = mesh(sp)
    model = prfl.PrflModel(tiny_cfg(), pavrm.PavrmConfig(feature_layer=(2,),
                                                         trainable_blocks=(0, 1)),
                           prfl.PrflConfig(inference_steps=STEPS, fixed_mid=MID))
    model.dit.load_state_dict(weights(inp, "policy."))
    model.lrm.load_state_dict(weights(inp, "lrm."))
    if use_lora:
        lora.attach_lora(model.dit, lora.lora_tree(weights(inp, "lora.")))
    layout = prfl.parallelize(model, m, strategy)
    tx = Recording(common.make_optimizer(learning_rate=LR))
    state = common.init_train_state(model.dit, tx, layout, offload)
    batch = rows(m, {"latents": inp["p_latents"], "text": inp["p_text"]})
    state, mr = prfl.make_refl_step(model, tx, m)(state, batch, latent0=t_(inp["p_latent0"]))
    state, ms = prfl.make_sft_step(model, tx, fm.train_schedule(1000), m)(
        state, batch, t=t_(inp["p_t"]), sigma=t_(inp["p_sigma"]), noise=t_(inp["p_noise"]))
    out = {f"param.{k}": v for k, v in gathered_params(state).items()}
    out.update(gathered_grads(state, tx))  # the refl step's
    out.update({f"mu.{n}": sharding.full_of(mu, p) for n, mu, p in
                zip(state.names, state.opt_state["mu"], state.params)})
    out.update(refl_loss=mr["loss"], reward=mr["reward"], refl_gnorm=mr["grad_norm"],
               sft_loss=ms["loss"], sft_gnorm=ms["grad_norm"])
    return out


def pavrm_step(inp, loss):
    m = mesh(2)
    pc = pavrm.PavrmConfig(loss=loss, feature_layer=(2,), trainable_blocks=(0, 1),
                           timesteps=(400, 700, 100), task="t2v")
    model = pavrm.PavrmModel(tiny_cfg(), pc, param_dtype=torch.float32)
    model.load_state_dict(weights(inp, "pv."))
    model.freeze_embeddings()
    layout = model.parallelize(m, "full")
    tx = Recording(common.make_optimizer(learning_rate=LR))
    state = common.init_train_state(model, tx, layout)
    keys = ("latents", "text", "labels") if loss == "ce" else ("latents", "text",
                                                                 "latents_lose")
    batch = rows(m, {k: inp[f"pv_{loss}_{k}"] for k in keys})
    state, met = pavrm.make_train_step(model, tx, fm.train_schedule(1000), m)(
        state, batch, t=t_(inp[f"pv_{loss}_t"]), noise=t_(inp[f"pv_{loss}_noise"]))
    out = {f"param.{k}": v for k, v in gathered_params(state).items()}
    out.update(gathered_grads(state, tx))
    out.update(loss=met["loss"], grad_norm=met["grad_norm"], acc=met["acc"])
    return out


def resume(inp, out_dir):
    """train_prfl_torch at world 2 (data 2): 3 steps whole; 2 steps, saved,
    and 1 resumed."""
    spec = importlib.util.spec_from_file_location(
        "train_prfl_torch", os.path.join(REPO, "scripts", "train_prfl_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    sys.modules["train_prfl_torch"] = cli
    spec.loader.exec_module(cli)
    from hyvideo_prfl_torch.configs import load_config

    def config(sub, resume_from=None):
        cfg = load_config(str(inp["resume_config"]))
        cfg.save.output_dir = os.path.join(out_dir, sub)
        if resume_from:
            cfg.model.resume_transformer_path = resume_from
        return cfg

    def metrics(hist):
        return np.array([[h[k] for k in ("refl_loss", "reward", "grad_norm", "sft_loss",
                                          "mid")] for h in hist], np.float64)

    whole = cli.build_trainer(config("a"), "cpu")
    hist = cli.run(whole, 3)
    first = cli.build_trainer(config("b"), "cpu")
    cli.run(first, 2)
    ckpt = os.path.join(out_dir, "b", "smoke_prfl", "checkpoint-2")
    resumed = cli.build_trainer(config("c", ckpt), "cpu")
    assert resumed.step == 2 and resumed.mesh.data == 2
    hist_r = cli.run(resumed, 1)
    out = {"whole": metrics(hist), "resumed": metrics(hist_r),
           "saved": np.array(os.path.isdir(os.path.join(ckpt, "opt_state")))}
    for tag, tr in (("whole", whole), ("resumed", resumed)):
        out.update({f"{tag}.param.{k}": v for k, v in gathered_params(tr.state).items()})
        out.update({f"{tag}.ema.{n}": sharding.full_of(e, p) for n, e, p in
                    zip(tr.state.names, tr.ema, tr.state.params)})
        out.update({f"{tag}.mu.{n}": sharding.full_of(mu, p) for n, mu, p in
                    zip(tr.state.names, tr.state.opt_state["mu"], tr.state.params)})
    return out


def cases(group, inp, out_dir):
    world = dist.get_world_size()
    if group == "attn":
        yield "uneven", lambda: uneven(inp)
        for chunks, layout in ((1, "bnld"), (2, "bnld"), (1, "blnd")):
            yield (f"ulysses_sp{world}_c{chunks}_{layout}",
                   lambda c=chunks, lay=layout: ulysses(inp, world, c, lay))
        if world == 2:
            yield "token_parallel", lambda: token_parallel(inp)
            yield "dit_forward", lambda: dit_forward(inp)
            yield "sample", lambda: sample(inp)
            yield "serve_bf16", lambda: serve_bf16(inp)
            for bounded in (True, False):
                yield f"ring2_b{int(bounded)}", lambda b=bounded: usp(inp, 1, 2, 1, b)
        else:
            yield "ring4", lambda: usp(inp, 1, 4, 1, True)
            yield "usp_r2u2_c1", lambda: usp(inp, 2, 2, 1, True)
            yield "usp_r2u2_c2_shifted", lambda: usp(inp, 2, 2, 2, False, "blnd")
            yield "usp_sample", lambda: sample(inp, 2, 2)
            yield "ts", lambda: ts_collectives(inp)
    elif group == "train" and world == 2:
        yield "prfl_d1_sp2", lambda: prfl_step(inp, 2)
        yield "prfl_d2_sp1", lambda: prfl_step(inp, 1)
        yield "prfl_d1_sp2_lora", lambda: prfl_step(inp, 2, use_lora=True)
        yield "prfl_d1_sp2_offload", lambda: prfl_step(inp, 2, offload=True)
        yield "pavrm_ce", lambda: pavrm_step(inp, "ce")
        yield "pavrm_bt", lambda: pavrm_step(inp, "bt")
        yield "resume", lambda: resume(inp, out_dir)
    elif group == "train":
        for strategy in sharding.FSDP_STRATEGIES:
            yield f"prfl_d2_sp2_{strategy}", lambda s=strategy: prfl_step(inp, 2, s)


def main(group, out_dir):
    device = sharding.init_distributed("cpu")
    assert device.type == "cpu" and dist.get_backend() == "gloo"
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    rank = dist.get_rank()
    for name, fn in cases(group, inp, out_dir):
        try:
            res = fn()
        except Exception:  # noqa: BLE001 -- every rank reports, the test reads rank 0's
            traceback.print_exc()
            raise
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"), **{
                k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
