"""Sharding: meshes of rank processes and logical-axis partitioning.

The port of ``repro.sharding``.  :func:`make_mesh` returns a
:class:`Mesh` in one of two forms:

  * **shape-only**, when no ``torch.distributed`` process group is up:
    axis names and sizes, enough to resolve the partitioning rules and to
    cost a layout (the reference's tests use such a ``FakeMesh``);
  * **bound** to the ranks of the current group, through
    ``torch.distributed.device_mesh.DeviceMesh``: rank ``r`` sits at the
    row-major coordinates of ``r`` over ``shape``.  The group's size must
    be the product of ``shape``.

A bound mesh hands out process groups over any set of its axes
(:meth:`Mesh.group`), created on first use.  Creating a group is a
collective of the whole world, so every rank asks for the same groups in
the same order, as an SPMD program does; ``sharding.collectives`` runs
the collectives over them.  The backend is the group's own: ``nccl``
where each rank has its own card, ``gloo`` where ranks share one (NCCL
refuses two ranks on one card); under gloo the mesh's transport is host
memory.
"""

from __future__ import annotations

import collections
import math
from typing import Sequence


class Mesh:
    """Named axes over ranks, row-major (the last axis minor)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "pair up")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axis_names = axes
        self.shape = collections.OrderedDict(zip(axes, shape))
        self.size = math.prod(shape)
        self.device_mesh = device_mesh
        self._groups: dict = {}
        if device_mesh is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank()
            self.coords = dict(zip(axes, _unravel(self.rank, shape)))
        else:
            self.rank, self.coords = None, None

    @property
    def bound(self) -> bool:
        return self.device_mesh is not None

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}{', bound' if self.bound else ''})"

    def _need_bound(self) -> None:
        if not self.bound:
            raise RuntimeError(
                f"{self!r} is shape-only: no torch.distributed process "
                "group was up when it was made")

    def shard_index(self, axes: Sequence[str], rank: int | None = None
                    ) -> int:
        """The position of ``rank`` (default: this one) along ``axes``,
        the first axis major: which slice of a dimension split over
        ``axes`` it holds."""
        self._need_bound()
        coords = (self.coords if rank is None else
                  dict(zip(self.axis_names,
                           _unravel(rank, tuple(self.shape.values())))))
        index = 0
        for a in axes:
            index = index * self.shape[a] + coords[a]
        return index

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def members(self, axes: Sequence[str]) -> list[int]:
        """The ranks that share this rank's coordinates off ``axes``,
        ordered by their :meth:`shard_index` along ``axes``."""
        self._need_bound()
        shape = tuple(self.shape.values())
        ranks = [r for r in range(self.size)
                 if all(c == self.coords[a] for a, c in zip(
                     self.axis_names, _unravel(r, shape)) if a not in axes)]
        return sorted(ranks, key=lambda r: self.shard_index(axes, r))

    def group(self, axes: Sequence[str]):
        """The process group of :meth:`members` (every rank creates every
        group of the partition, in one order, on first use)."""
        self._need_bound()
        key = frozenset(axes)
        if key not in self._groups:
            if len(axes) == 1:
                self._groups[key] = self.device_mesh.get_group(axes[0])
            else:
                import torch.distributed as dist
                shape = tuple(self.shape.values())
                parts: dict = {}
                for r in range(self.size):
                    coords = _unravel(r, shape)
                    off = tuple(c for a, c in zip(self.axis_names, coords)
                                if a not in key)
                    parts.setdefault(off, []).append(r)
                mine = None
                for off in sorted(parts):
                    g = dist.new_group(ranks=parts[off])
                    if self.rank in parts[off]:
                        mine = g
                self._groups[key] = mine
        return self._groups[key]


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes``: bound to the current
    process group when one is up (its size must be the product of
    ``shape``), else shape-only."""
    import torch.distributed as dist

    mesh = Mesh(shape, axes)
    if not (dist.is_available() and dist.is_initialized()):
        return mesh
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(
            f"a {tuple(mesh.shape.values())} mesh needs {mesh.size} ranks; "
            f"the process group has {world}")
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    return Mesh(shape, axes, DeviceMesh(device_type, layout,
                                        mesh_dim_names=tuple(axes)))
