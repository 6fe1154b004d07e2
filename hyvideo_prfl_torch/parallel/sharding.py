"""The multi-GPU layer (hyvideo_prfl_tpu/parallel/sharding.py and the
mesh half of scripts/_common.py): the ("data", "sp") process mesh,
sequence parallelism's differentiable collectives, the five FSDP
strategies as FSDP2 and the gather/scatter of sharded state.

A run starts one process per GPU (``torchrun --nproc_per_node N``), each
on ``cuda:$LOCAL_RANK`` over NCCL, or on the CPU over gloo. The mesh is
(data, sp) with data outermost: rank r is data replica ``r // sp`` and
sequence rank ``r % sp``; ``sp = min(dataset.sp_size, world)`` and
``data = world // sp``, as the JAX ``build_mesh`` sizes it. One process
with no ``WORLD_SIZE`` starts no process group: every path is then the
one-GPU path.

Sequence parallelism (``SeqParallel``): each sp rank holds a contiguous
block of the DiT's tokens. The self-attention exchanges them for heads
with two all-to-alls (ops/attention.ulysses_attention); the text/image
cross-attention runs each rank's queries against the replicated context
(the plain call, no collective); token-wise ops need nothing. ``gather``
rebuilds the full token axis where every token meets: the head's output,
the reward model's feature taps. Serving under USP (``build_mesh``'s
``ring_size``; the JAX ``make_usp_mesh`` and ``usp_policy``) splits the
sp axis into (ring, ulysses), ring the slower: the tokens lie over both
jointly, the all-to-all runs over the Ulysses ranks and ring attention
(ops/ring_attention.py) rotates the keys over the ring ranks.

The gradients' convention: every rank runs the loss on the gathered,
replicated tensors, and ``gather``'s backward is a reduce-scatter (a sum
over the sp ranks). Each rank's parameter gradient is then sp times the
partial sum over its own tokens (a replicated input's too: the context,
the time embedding, the cross-attention's k/v), and FSDP's average over
all data x sp ranks turns that into the sum over tokens, averaged over
the data replicas: the one-GPU gradient of the global batch. No psum of
a replicated tensor's cotangent is needed, as JAX's shard_map transpose
inserts one: the sum happens once, in the gradient reduction.

The FSDP strategies (``FSDP_STRATEGIES``, model.fsdp.fsdp_sharding_startegy):

    full           fully_shard over all ranks
    hybrid_full    HSDP: replicated over data, sharded over sp
    shard_grad_op  fully_shard over all ranks, reshard_after_forward=False
    hybrid_zero2   HSDP with reshard_after_forward=False
    none           replicated; the gradients all-reduced (averaged)

FSDP2 hands each wrapped module's forward unsharded plain tensors, so the
ctypes-bound kernels never see a DTensor (ops/_build.plain asserts it).
The optimizer works on each rank's local shards (``local``); the
optimizer state, the EMA and a saved checkpoint are gathered to full
tensors (``full_of``, ``full_state_dict``) and scattered back onto the
shards (``shard_of``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS, SP_AXIS = "data", "sp"
RING_AXIS, ULYSSES_AXIS = "ring", "ulysses"  # the sp axis under USP, ring the slower
FSDP_STRATEGIES = ("full", "hybrid_full", "shard_grad_op", "hybrid_zero2", "none")


def _dtensor_cls():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # torch < 2.5
        from torch.distributed._tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    return dist.is_available() and isinstance(t, _dtensor_cls())


def _fully_shard():
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:  # torch < 2.6
        from torch.distributed._composable.fsdp import fully_shard
    return fully_shard


def init_distributed(device) -> torch.device:
    """Join the process group that torchrun describes (``WORLD_SIZE`` > 1
    in the environment, with RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL on the card, gloo on the CPU. Returns this process's device,
    ``cuda:$LOCAL_RANK`` on the card. One process without WORLD_SIZE
    starts no group; a group started before (chip_smoke's world of one)
    is kept."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda" and (world > 1 or dist.is_initialized()):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """One sp group: this rank holds tokens [rank * L/size, (rank + 1) * L/size).

    Under USP (``ring``, an ops/ring_attention.DistRing) the group's ranks
    form ring x Ulysses, rank r * ulysses + u being ring rank r and Ulysses
    rank u: the all-to-all runs over ``ulysses_group`` and the key/value
    rotation over the ring."""

    group: Any
    size: int
    rank: int
    # Ulysses head chunks (--ulysses_chunks); None reads HYV_ULYSSES_CHUNKS
    chunks: Optional[int] = None
    ring: Any = None
    ulysses_group: Any = None

    @property
    def ulysses_size(self) -> int:
        return self.size // self.ring.size if self.ring is not None else self.size

    def shard(self, x: torch.Tensor, dim: int, grid=None) -> torch.Tensor:
        """This rank's block of ``x``'s token axis ``dim`` (a view; its
        gradient is zero outside the block)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"the token grid {tuple(grid) if grid else n} ({n} tokens) does "
                             f"not divide by the sequence-parallel degree {self.size}")
        per = n // self.size
        return x.narrow(dim, self.rank * per, per)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The full token axis from every rank's block, in rank order; the
        backward sums the cotangents over the ranks (reduce-scatter)."""
        return _Gather.apply(x, self.group, self.size, dim)

    def all_to_all(self, x: torch.Tensor, scatter_dim: int, gather_dim: int) -> torch.Tensor:
        """Split ``scatter_dim`` into ``ulysses_size`` blocks, send block i
        to Ulysses rank i and concatenate what arrives along ``gather_dim``,
        in rank order; differentiable (the backward is the inverse
        exchange)."""
        group = self.group if self.ring is None else self.ulysses_group
        return _AllToAll.apply(x, group, self.ulysses_size, scatter_dim, gather_dim)


def _all_to_all(x, group, size, scatter_dim, gather_dim):
    send = torch.stack(x.tensor_split(size, dim=scatter_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, scatter_dim, gather_dim):
        ctx.args = (group, size, gather_dim, scatter_dim)
        return _all_to_all(x, group, size, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_gather(x, group, size, dim):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.args = (group, size, dim)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, dim = ctx.args
        full = g.movedim(dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // size, *full.shape[1:]))
        dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM, group=group)
        return out.movedim(0, dim), None, None, None


@dataclasses.dataclass
class Mesh:
    """The ("data", "sp") process mesh; the default is one process. Under
    USP the sp axis is (ring, ulysses) with ring the slower: ``ring`` > 1
    and ``usp`` the DeviceMesh (data, ring, ulysses)."""

    data: int = 1
    sp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    device_mesh: Any = None  # DeviceMesh (data, sp), None without a process group
    flat: Any = None  # DeviceMesh over all ranks
    chunks: Optional[int] = None
    ring: int = 1
    usp: Any = None

    @property
    def world(self) -> int:
        return self.data * self.sp

    @property
    def data_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.flat.get_group() if axis == "world" else self.device_mesh.get_group(axis)

    def seq(self) -> Optional[SeqParallel]:
        """The sp group of this rank, None at sp 1."""
        if self.sp == 1:
            return None
        if self.ring == 1:
            return SeqParallel(self.group(SP_AXIS), self.sp, self.sp_rank, self.chunks)
        from ..ops.ring_attention import DistRing

        return SeqParallel(self.group(SP_AXIS), self.sp, self.sp_rank, self.chunks,
                           ring=DistRing(self.usp.get_group(RING_AXIS)),
                           ulysses_group=self.usp.get_group(ULYSSES_AXIS))

    def rows(self, x):
        """This data replica's rows of a global-batch tensor."""
        if self.data == 1 or x is None:
            return x
        b = x.shape[0] // self.data
        return x[self.data_rank * b:(self.data_rank + 1) * b]

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data replicas of a per-replica value."""
        if self.data == 1:
            return x
        t = x.detach().clone()
        dist.all_reduce(t, group=self.group(DATA_AXIS))
        return t / self.data

    def all_true(self, flag) -> bool:
        """True when ``flag`` holds on every rank."""
        if self.device_mesh is None or self.world == 1:
            return bool(flag)
        t = torch.tensor([1 if bool(flag) else 0], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group("world"))
        return bool(t.item())

    def barrier(self) -> None:
        if self.device_mesh is not None and self.world > 1:
            dist.barrier(group=self.group("world"))


def build_mesh(sp_size: int, device, chunks: Optional[int] = None,
               ring_size: int = 1) -> Mesh:
    """The mesh of the running process group (one process: ``Mesh()``):
    Ulysses u = min(sp_size, world), ring r = min(ring_size, world // u)
    (the JAX serving CLI's clamps), sp = r u and data = world // sp."""
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(device=device, chunks=chunks)
    from torch.distributed.device_mesh import init_device_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    uly = max(1, min(int(sp_size or 1), world))
    ring = max(1, min(int(ring_size or 1), world // uly))
    sp = uly * ring
    if world % sp:
        raise ValueError(f"world size {world} does not divide by the sp degree {sp}")
    data = world // sp
    dm = init_device_mesh(device.type, (data, sp), mesh_dim_names=(DATA_AXIS, SP_AXIS))
    flat = init_device_mesh(device.type, (world,), mesh_dim_names=("world",))
    usp = (init_device_mesh(device.type, (data, ring, uly),
                            mesh_dim_names=(DATA_AXIS, RING_AXIS, ULYSSES_AXIS))
           if ring > 1 else None)
    return Mesh(data=data, sp=sp, rank=rank, device=device, device_mesh=dm, flat=flat,
                chunks=chunks, ring=ring, usp=usp)


def fsdp_strategy_from(config) -> str:
    """model.fsdp.fsdp_sharding_startegy [sic], the reference's key (the
    correct spelling also read), "full" by default."""
    s = str(config.get_path("model.fsdp.fsdp_sharding_startegy")
            or config.get_path("model.fsdp.fsdp_sharding_strategy") or "full")
    if s not in FSDP_STRATEGIES:
        raise ValueError(f"unknown FSDP strategy {s!r} (have {FSDP_STRATEGIES})")
    return s


def offload_from(config) -> bool:
    """model.fsdp.use_cpu_offload or train.offload_opt_state: the AdamW
    moments live in host memory between steps."""
    return bool(config.get_path("model.fsdp.use_cpu_offload")
                or config.get_path("train.offload_opt_state"))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a module's trainable parameters lie after ``shard_model``."""

    strategy: str = "none"
    # the ranks whose shards make up the full parameters (the gradient
    # norm's sum runs over them); None: every rank holds them whole
    norm_group: Any = None
    # "none": the gradients are averaged over these ranks
    mean_group: Any = None


def shard_model(mesh: Mesh, roots: Sequence[torch.nn.Module], strategy: str = "full",
                units: Sequence[torch.nn.Module] = ()) -> Layout:
    """Wrap each of ``units`` (the WanBlocks), then each of ``roots``, in
    FSDP2 under ``strategy``. Without a process group nothing changes."""
    if mesh.device_mesh is None:
        return Layout()
    if strategy not in FSDP_STRATEGIES:
        raise ValueError(f"unknown FSDP strategy {strategy!r} (have {FSDP_STRATEGIES})")
    if strategy == "none":
        return Layout("none", None, mesh.group("world"))
    hybrid = strategy.startswith("hybrid")
    dm = mesh.device_mesh if hybrid else mesh.flat
    reshard = strategy in ("full", "hybrid_full")
    fully_shard = _fully_shard()
    for m in (*units, *roots):
        fully_shard(m, mesh=dm, reshard_after_forward=reshard)
    return Layout(strategy, mesh.group(SP_AXIS if hybrid else "world"))


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a parameter or gradient (itself when plain)."""
    return t.to_local() if is_dtensor(t) else t


def full_of(shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full tensor of a local ``shard`` laid out as parameter ``like``
    (a collective for a DTensor: every rank calls it)."""
    if not is_dtensor(like):
        return shard
    return _dtensor_cls().from_local(shard, like.device_mesh, like.placements,
                                     run_check=False, shape=like.shape,
                                     stride=like.stride()).full_tensor()


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` laid out as parameter ``like``: the
    torch.chunk block FSDP2 keeps (no collective)."""
    if not is_dtensor(like):
        return full
    out = full
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            n, r = like.device_mesh.size(i), like.device_mesh.get_local_rank(i)
            blocks = torch.chunk(out, n, dim=pl.dim)
            out = blocks[r] if r < len(blocks) else out.narrow(pl.dim, 0, 0)
    return out


def gather_to_host(shards: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                   main: bool = True) -> list:
    """Each full tensor of the local ``shards`` (laid out as ``params``),
    gathered one at a time and moved to the host, so a card never holds
    more than one full tensor; every rank calls it, and only ``main``
    keeps the tensors (the others get Nones)."""
    out = []
    for s, p in zip(shards, params):
        t = full_of(s.to(local(p.detach()).device), p)
        out.append(t.detach().cpu() if main else None)
    return out


def full_state_dict(module: torch.nn.Module, main: bool = True) -> Dict[str, torch.Tensor]:
    """The module's state with every DTensor gathered, one tensor at a
    time, to the host; every rank calls it, and only ``main`` keeps the
    tensors (the others get {})."""
    out = {}
    for k, v in module.state_dict().items():
        v = v.full_tensor() if is_dtensor(v) else v
        if main:
            out[k] = v.detach().cpu()
    return out


def set_sequence_parallel(model, sp: Optional[SeqParallel]):
    """Give a WanModel (and its blocks' self-attentions) the sp group."""
    model.sp = sp
    for block in model.blocks:
        block.self_attn.sp = sp
    return model


def shard_for_serving(model, mesh: Mesh):
    """A serving WanModel on a mesh of several ranks: its tokens split over
    the sp ranks, its blocks' weights sharded over all ranks (FSDP2, each
    block gathered for its forward; the embeddings and the head stay whole,
    TeaCache's gate reads them). FSDP2 gathers one dtype per wrapped
    module, so each block shards the weights of its storage dtype (the
    bf16 matmul weights) and leaves the rest (the fp32 gains and
    modulation, under 0.1 % of a block's elements) whole on every rank."""
    set_sequence_parallel(model, mesh.seq())
    fully_shard = _fully_shard()
    for block in model.blocks:
        numel: Dict[torch.dtype, int] = {}
        for p in block.parameters():
            numel[p.dtype] = numel.get(p.dtype, 0) + p.numel()
        if not numel:
            continue
        storage = max(numel, key=numel.get)
        whole = {p for p in block.parameters() if p.dtype != storage}
        fully_shard(block, mesh=mesh.flat, reshard_after_forward=True,
                    ignored_params=whole or None)
    return model
