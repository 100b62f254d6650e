"""Index subsystem: the cluster-pruned search backend.

The port of ``repro.index``:

  * :mod:`repro_torch.index.kmeans` — the mini-batch k-means coarse
    quantizer (plain torch on the caller's device, deterministic per-
    cluster sums), trained off contiguous ``get_range`` streams;
  * :mod:`repro_torch.index.ivf` — :class:`IVFIndex`, the cluster-sorted
    row permutation and per-cluster offsets over any row-addressable
    embedding store, persisted torn-write-safe in the reference's layout.

The flat exhaustive scan stays the recall oracle
(``EvaluationArguments.index_impl="flat"``).
"""

from repro_torch.index.ivf import IVFIndex
from repro_torch.index.kmeans import assign_rows, train_kmeans

__all__ = ["IVFIndex", "assign_rows", "train_kmeans"]
