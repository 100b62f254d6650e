"""Logical-axis partitioning rules -> concrete partition specs.

The port of ``repro.sharding.partitioning``.  Parameters, optimizer
state and batches are annotated with *logical* axis names ("vocab",
"heads", "ffn", "experts", "batch", "kv_seq", ...).  The rules resolve
each logical axis to mesh axes, guarded by divisibility: a dimension
whose size is not divisible by the product of its mesh axes falls back
to the longest divisible prefix of them, else to replication.  So every
(arch x shape x mesh) cell has a layout, and a rank's slice of a leaf is
always the same size as its siblings'.

A spec is :class:`PartitionSpec` (``P``), the port's small counterpart of
``jax.sharding.PartitionSpec``: a tuple with one entry per dimension,
``None`` (replicated), one mesh axis name, or a tuple of names (the
dimension split over their product, the first name major).  Rule
resolution reads only ``mesh.shape`` (an axis-name -> size mapping), so a
shape-only mesh (``sharding.make_mesh`` without a process group) resolves
specs as a bound one does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

from repro_torch.training.tree import tree_map


class PartitionSpec(tuple):
    """One entry per dimension: ``None``, a mesh axis name, or a tuple of
    names.  ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec

# Default logical -> mesh-axis mapping.  "batch"-like axes span the
# data-parallel axes (pod composes with data, so adding pods scales DP);
# "model"-like axes carry tensor / expert parallelism.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # data-parallel axes
    "batch": ("pod", "data"),
    "corpus": ("pod", "data"),          # corpus shards at inference
    "candidates": ("pod", "data"),      # recsys retrieval candidates
    "nodes": ("pod", "data"),           # GNN node tables
    "edges": ("pod", "data"),           # GNN edge lists
    "kv_seq": ("pod", "data"),          # long-context decode: the KV cache
    # model-parallel axes
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "expert_ffn": ("model",),
    "embed_rows": ("model",),           # recsys embedding-table rows
    "embed": ("model",),                # d_model sharding of embeddings
    # replicated
    "layers": (),
    "d_model": (),
    "pos": (),
    "dense": (),
}


def _axis_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Resolves logical axis names against a mesh."""

    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **overrides: tuple[str, ...]) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return AxisRules(merged)

    def mesh_axes_for(self, logical: str | None, mesh) -> tuple[str, ...]:
        """The rule's mesh axes that exist on ``mesh`` ("pod" drops out
        on a single-pod mesh)."""
        if logical is None:
            return ()
        return tuple(a for a in self.rules.get(logical, ())
                     if a in mesh.shape)

    def spec_for(self, logical_axes: Sequence[str | None],
                 dims: Sequence[int], mesh) -> PartitionSpec:
        """The spec of an array with these logical axes and shape: each
        dimension takes its rule's mesh axes not yet used by an earlier
        dimension, or their longest prefix whose size divides it (the
        pod prefix), else none."""
        if len(logical_axes) != len(dims):
            raise ValueError(f"{len(logical_axes)} logical axes "
                             f"{tuple(logical_axes)} for shape {tuple(dims)}")
        entries: list[Any] = []
        used: set[str] = set()
        for logical, dim in zip(logical_axes, dims):
            axes = tuple(a for a in self.mesh_axes_for(logical, mesh)
                         if a not in used)
            if axes:
                size = _axis_size(mesh, axes)
                if size <= 1 or dim % size != 0:
                    ok: tuple[str, ...] = ()
                    for i in range(len(axes) - 1, 0, -1):
                        sz = _axis_size(mesh, axes[:i])
                        if sz > 1 and dim % sz == 0:
                            ok = axes[:i]
                            break
                    axes = ok
            if not axes:
                entries.append(None)
            else:
                used.update(axes)
                entries.append(axes if len(axes) > 1 else axes[0])
        return P(*entries)


def _dims(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's ``.shape`` or a shape tuple itself."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def tree_pspecs(abstract_tree: Any, logical_tree: Any, mesh,
                rules: AxisRules | None = None) -> Any:
    """A tree of leaves (tensors or shape tuples) and the same tree of
    logical axes -> the same tree of specs."""
    rules = rules or AxisRules()
    return tree_map(lambda leaf, axes: rules.spec_for(axes, _dims(leaf),
                                                      mesh),
                    abstract_tree, logical_tree)


def spec_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec: Sequence) -> tuple[str, ...]:
    """Every mesh axis a spec shards over, in dimension order."""
    return tuple(a for entry in spec for a in spec_axes(entry))


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape of one rank's slice of a leaf under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(d) // _axis_size(mesh, spec_axes(e))
                 for d, e in zip(shape, spec))


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present on this mesh (pod composes with
    data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_parallelism(mesh) -> int:
    return _axis_size(mesh, data_axes(mesh))


def model_parallelism(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def local_mesh():
    """A (1, n) ("data", "model") mesh over this process group's ranks
    (bound when a group is up, else shape-only over one rank)."""
    import torch.distributed as dist

    from repro_torch.sharding import make_mesh
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh((1, n), ("data", "model"))
