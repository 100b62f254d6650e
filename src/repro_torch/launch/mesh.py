"""Production mesh construction.

The port of ``repro.launch.mesh``: a function, so importing this module
touches no process group.  Single pod: (16, 16) over ("data", "model"),
256 ranks; multi-pod: (2, 16, 16) over ("pod", "data", "model"), 512
ranks.  "pod" composes with "data" for the batch and FSDP axes
(``sharding.partitioning.DEFAULT_RULES``), so adding pods scales data
parallelism; "model" carries tensor / expert parallelism.

Without a process group the mesh is shape-only (rule resolution and
costing); under a group of 256 / 512 ranks it is bound to them; under a
group of any other size it raises a ``ValueError`` that names the world
size it needs.
"""

from __future__ import annotations

from repro_torch.sharding import Mesh, make_mesh


def production_shape(multi_pod: bool = False
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return make_mesh(*production_shape(multi_pod))
