"""The port's sequence parallelism against the JAX package, on CPU gloo.

The port's ranks run in spawned processes that import no JAX
(tests/_torch_parallel_worker.py, started with torchrun's variables),
once per world size for every case of this file: Ulysses attention at
sp 2 and 4 (head chunks 1 and 2, head-major and token-major q/k), ring
attention at ring 2 and 4 and USP at ring 2 x Ulysses 2 (forward and
backward; and a 2-step sample), the teacher-student collectives at
world 4, the
cross-attention on a token shard with the image keys, a 2-block DiT forward
and a 2-step UniPC sample at sp 2 (blocks sharded with FSDP2), a served
model's bf16 weights sharded as they are stored, and the uneven token
count's ValueError. The JAX results are the one-device
ones, computed here. The data-parallel sampler and loader are held to
the JAX package's in this process.
"""

import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.data import loader as jloader
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import attention as jattn
from hyvideo_prfl_tpu.pipelines import pipeline as jpipe
from hyvideo_prfl_torch.data import loader as tloader
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.ops import attention as tattn
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)
SHAPE = (1, 3, 8, 8, 16)  # 48 tokens
U = (1, 24, 8, 64)  # Ulysses q/k/v: 24 tokens, 8 heads


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_group(group: str, world: int, out_dir: str):
    """``world`` worker processes of ``group`` on ``out_dir``, as torchrun starts them."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, group, out_dir], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def wait_group(procs, timeout=300):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]


def _inputs():
    rng = np.random.RandomState(0)
    inp = {n: (rng.randn(*U) * 0.5).astype(np.float32) for n in ("uq", "uk", "uv", "ug")}
    inp.update({n: (rng.randn(1, lk, 8, 64) * 0.5).astype(np.float32) for n, lk in (
        ("tk", 10), ("tv", 10), ("tki", 6), ("tvi", 6))})
    inp["tq"] = (rng.randn(*U) * 0.5).astype(np.float32)
    inp["tg"] = rng.randn(*U).astype(np.float32)
    tree = tck.seeded_jax_tree(tdit.tiny_test(**TINY), seed=3)
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    inp.update({f"dit.{k}": v.numpy() for k, v in tck.from_jax_params(tree, cfg).items()})
    inp["x"] = rng.randn(*SHAPE).astype(np.float32)
    inp["x_odd"] = rng.randn(1, 3, 6, 6, 16).astype(np.float32)  # 27 tokens
    inp["t"] = np.array([700.0], np.float32)
    inp["ctx"] = rng.randn(1, 16, 64).astype(np.float32)
    inp["ctx_null"] = rng.randn(1, 16, 64).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(5)
    inp["noise"] = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    inp["ts_x"] = rng.randn(4, 3).astype(np.float32)
    return inp, tree, key


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inp, tree, key = _inputs()
    dirs = {w: str(tmp_path_factory.mktemp(f"attn{w}")) for w in (2, 4)}
    for d in dirs.values():
        np.savez(os.path.join(d, "inputs.npz"), **inp)
    groups = [start_group("attn", w, d) for w, d in dirs.items()]
    # the JAX references while the ranks work
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    ref = {"dit": np.asarray(jdit.WanModel(jcfg).apply(
        tree, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"])))}
    jgen = jpipe.GenerateConfig(sampling_steps=2, guide_scale=5.0, shift=5.0)
    ref["sample"] = np.asarray(jpipe.WanT2V(jcfg, tree).sample(
        key, SHAPE, jnp.asarray(inp["ctx"]), jnp.asarray(inp["ctx_null"]), jgen))

    def attn(q, k, v):
        return jattn.dot_product_attention(q, k, v, backend="xla")

    q, k, v, g = (jnp.asarray(inp[n]) for n in ("uq", "uk", "uv", "ug"))
    out, vjp = jax.vjp(attn, q, k, v)
    ref["ulysses"] = dict(zip(("out", "dq", "dk", "dv"), map(np.asarray, (out, *vjp(g)))))
    tq, tk, tv, tki, tvi = (jnp.asarray(inp[n]) for n in ("tq", "tk", "tv", "tki", "tvi"))
    out, vjp = jax.vjp(lambda q, k, v, ki, vi: attn(q, k, v) + attn(q, ki, vi),
                       tq, tk, tv, tki, tvi)
    ref["token_parallel"] = dict(zip(("out", "dq", "dk", "dv", "dki", "dvi"),
                                     map(np.asarray, (out, *vjp(jnp.asarray(inp["tg"]))))))
    ref["ts"] = _jax_ts(inp["ts_x"])
    for procs in groups:
        wait_group(procs)
    return dirs, ref


def _jax_ts(x):
    """The JAX teacher-student collectives on a ("ts" 2, "data" 2, "sp" 1)
    mesh of 4 devices, device (t, d) holding row 2 t + d -> each device's
    result, in device order."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from hyvideo_prfl_tpu.parallel import teacher_student as jts

    mesh = jts.make_ts_mesh(data=2, sp=1, devices=jax.devices()[:4])
    spec = P(("ts", "data"), None)
    out = {}
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        for key, fn in (("swap", jts.ts_unit_swap), ("bcast", jts.broadcast_from_teacher),
                        ("gather", jts.all_gather_ts)):
            y = np.asarray(jax.jit(jax.shard_map(
                fn, mesh=jax.sharding.get_abstract_mesh(), in_specs=spec,
                out_specs=P(("ts", "data")), check_vma=False))(xs))
            # all_gather_ts gives each device [2, 1, 3]: both halves' rows
            out[key] = y.reshape(4, 2, 3) if key == "gather" else y
    return out


def _read(d, name):
    return dict(np.load(os.path.join(d, f"{name}.npz")))


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks,layout", [(1, "bnld"), (2, "bnld"), (1, "blnd")])
def test_ulysses_attention_matches_jax(run, world, chunks, layout):
    dirs, ref = run
    got = _read(dirs[world], f"ulysses_sp{world}_c{chunks}_{layout}")
    # head-major q/k are views of token-major leaves, whose gradients compare as they are
    for key in ("out", "dq", "dk", "dv"):
        _close(got[key], ref["ulysses"][key])


def test_ulysses_chunks_clamp_as_jax(monkeypatch):
    for heads, sp, c in ((8, 2, 2), (8, 4, 2), (8, 4, 4), (40, 4, 3), (12, 4, 5), (2, 2, 2)):
        monkeypatch.setenv("HYV_ULYSSES_CHUNKS", str(c))
        assert tattn.ulysses_chunks(heads, sp) == jattn.ulysses_chunks(heads, sp)
        assert tattn.ulysses_chunks(heads, sp, c) == jattn.ulysses_chunks(heads, sp)


def test_token_parallel_attention_matches_jax(run):
    dirs, ref = run
    got = _read(dirs[2], "token_parallel")
    for key, want in ref["token_parallel"].items():
        _close(got[key], want)


def test_dit_forward_at_sp2_matches_jax(run):
    dirs, ref = run
    # the model tests hold the fp32 forward to 1e-4 of its scale
    _close(_read(dirs[2], "dit_forward")["out"], ref["dit"], rel=1e-4)


def test_ulysses_sample_matches_jax(run):
    dirs, ref = run
    got = _read(dirs[2], "sample")["out"]
    assert got.shape == SHAPE
    _close(got, ref["sample"], rel=1e-4)


@pytest.mark.parametrize("world,name", [
    (2, "ring2_b1"), (2, "ring2_b0"), (4, "ring4"), (4, "usp_r2u2_c1"),
    (4, "usp_r2u2_c2_shifted")])
def test_ring_attention_matches_jax(run, world, name):
    """Ring attention (ring 2, ring 4: the bounded and the shifted forms)
    and USP (ring 2 x Ulysses 2, head chunks 1 and 2, head-major and
    token-major q/k), forward and backward, against the one-device JAX
    attention, to the Ulysses cases' 1e-5 of each tensor's largest."""
    dirs, ref = run
    got = _read(dirs[world], name)
    for key in ("out", "dq", "dk", "dv"):
        _close(got[key], ref["ulysses"][key])


def test_usp_sample_matches_jax(run):
    """A 2-step UniPC sample at ring 2 x Ulysses 2 (blocks sharded over the
    4 ranks) against the JAX one-device sample."""
    dirs, ref = run
    got = _read(dirs[4], "usp_sample")["out"]
    assert got.shape == SHAPE
    _close(got, ref["sample"], rel=1e-4)


def test_teacher_student_collectives_match_jax(run):
    dirs, ref = run
    got = _read(dirs[4], "ts")
    for key in ("swap", "bcast", "gather"):
        np.testing.assert_array_equal(got[key], ref["ts"][key], err_msg=key)
    np.testing.assert_array_equal(got["ts_index"].ravel(), [0, 0, 1, 1])


def test_serving_shards_bf16_weights_as_stored(run):
    # FSDP2 gathers one dtype per group: each block shards its bf16 weights
    # and keeps its fp32 gains whole; nothing is recast, and the forward at
    # sp 2 is the unsharded one bit for bit
    dirs, _ = run
    got = _read(dirs[2], "serve_bf16")
    np.testing.assert_array_equal(got["after"], got["before"])
    for name, dtype, sharded in zip(got["names"], got["after"], got["sharded"]):
        assert bool(sharded) == (name.startswith("blocks.") and dtype == "torch.bfloat16"), name
    assert "torch.float32" in set(got["after"]) and got["sharded"].any()
    np.testing.assert_array_equal(got["got"], got["want"])


@pytest.mark.parametrize("world", [2, 4])
def test_uneven_tokens_raise(run, world):
    dirs, _ = run
    msg = str(_read(dirs[world], "uneven")["msg"])
    assert "(3, 3, 3)" in msg and "27 tokens" in msg and f"degree {world}" in msg, msg


@pytest.mark.parametrize("area,aspect,frames,sp", [
    (832 * 480, 480 / 832, 81, 4), (1280 * 720, 720 / 1280, 81, 4),
    (832 * 480, 480 / 832, 21, 3), (1280 * 720, 720 / 1280, 21, 8)])
def test_latent_size_for_sp_matches_jax(area, aspect, frames, sp):
    got = tpipe.latent_size_for(area, aspect, num_frames=frames, sp_size=sp)
    assert got == jpipe.latent_size_for(area, aspect, num_frames=frames, sp_size=sp)
    f, h, w = got
    assert (f * (h // 2) * (w // 2)) % sp == 0


@pytest.mark.parametrize("n,replicas,shuffle", [(10, 2, False), (10, 3, True), (2, 4, True),
                                                (7, 1, True)])
def test_block_sampler_matches_jax(n, replicas, shuffle):
    for rank in range(replicas):
        t = tloader.BlockDistributedSampler(n, shuffle=shuffle, seed=4, num_replicas=replicas,
                                            rank=rank)
        j = jloader.BlockDistributedSampler(n, replicas, rank, shuffle=shuffle, seed=4)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


class _Toy:
    """Samples that draw from the dataset's one random.Random, as the
    latent cache draws captions."""

    def __init__(self, n):
        self.n, self.rng = n, random.Random(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"latents": np.full((1, 2, 2, 4), i, np.float32),
                "draw": np.float32(self.rng.random())}

    replay = __getitem__


@pytest.mark.parametrize("replicas,batch", [(2, 1), (3, 2)])
def test_data_parallel_loader_matches_jax(replicas, batch):
    jit = iter(jloader.DataParallelLoader(_Toy(7), num_replicas=replicas, batch_size=batch,
                                          shuffle=True, seed=1, prefetch=0))
    want = [next(jit) for _ in range(5)]
    for rank in range(replicas):
        it = iter(tloader.DataParallelLoader(_Toy(7), replicas, rank, batch_size=batch,
                                             shuffle=True, seed=1, prefetch=1))
        for w in want:
            got = next(it)
            for k in ("latents", "draw"):
                np.testing.assert_array_equal(got[k], w[k][rank * batch:(rank + 1) * batch])
