"""Teacher-student process groups (hyvideo_prfl_tpu/parallel/teacher_student.py).

The world splits into a student half (ranks 0 .. n/2 - 1) and a teacher
half (n/2 .. n - 1), and rank i of the student half pairs with rank
i + n/2 (a "ts unit"), as the JAX ("ts", "data", "sp") mesh lays its
devices out. ``make_ts_groups`` builds the torch.distributed groups
(every rank calls it: the two halves, then each pair in order); the
collectives exchange within a rank's pair. Infrastructure for dual-model
runs: no CLI of either package uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

TS_AXIS = "ts"


@dataclasses.dataclass(frozen=True)
class TsGroups:
    """This rank's side of the split: its half's group, its pair's group
    (student first), its ts index (0 student, 1 teacher) and its
    partner's global rank."""

    half: Any
    unit: Any
    ts_index: int
    partner: int

    @property
    def teacher(self) -> int:
        """The global rank of the pair's teacher."""
        return self.partner if self.ts_index == 0 else dist.get_rank()


def is_teacher_half(ts_index: int) -> bool:
    """The second half of the world is the teacher's."""
    return ts_index == 1


def make_ts_groups() -> TsGroups:
    """The teacher-student groups of the running process group (an even
    world)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % 2:
        raise ValueError(f"a teacher-student split needs an even world, got {world}")
    half = world // 2
    halves = [dist.new_group(list(range(h * half, (h + 1) * half))) for h in (0, 1)]
    units = [dist.new_group([i, i + half]) for i in range(half)]
    ts_index = rank // half
    return TsGroups(half=halves[ts_index], unit=units[rank % half], ts_index=ts_index,
                    partner=(rank + half) % world)


def ts_unit_swap(x: torch.Tensor, ts: TsGroups) -> torch.Tensor:
    """The partner's value of ``x`` (a student and its teacher exchange)."""
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ts.partner, ts.unit),
           dist.P2POp(dist.irecv, recv, ts.partner, ts.unit)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def broadcast_from_teacher(x: torch.Tensor, ts: TsGroups) -> torch.Tensor:
    """The teacher's value of ``x`` on both ranks of the pair."""
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=ts.teacher, group=ts.unit)
    return out


def all_gather_ts(x: torch.Tensor, ts: TsGroups) -> torch.Tensor:
    """[student's x, teacher's x] stacked on a new leading axis, on both ranks."""
    parts = [torch.empty_like(x.contiguous()) for _ in range(2)]
    dist.all_gather(parts, x.contiguous(), group=ts.unit)
    return torch.stack(parts)
