"""Mini-batch k-means coarse quantizer (the index's trainer).

The port of ``repro.index.kmeans``: centroids are trained with streaming
mini-batch k-means (Sculley 2010's per-centre count-weighted update,
batched) where every batch is one contiguous ``get_range(lo, hi)`` read
— an ``EmbeddingCache`` snapshot's mmap fast path, or a slice of a
device-resident corpus — so training never materialises the corpus.
Assignment uses squared L2 (``argmin ||x - c||² = argmin ||c||² -
2 x·c``), one matrix product per batch.  The steps are plain torch on
the caller's device: the reference computes them in XLA, outside any
Pallas kernel.

Determinism: all randomness (centroid seeding, batch window starts)
comes from one ``np.random.default_rng(seed)``, the draws the reference
makes, and the iteration budget is fixed.  The per-cluster sums are a
one-hot ``(k × b) @ (b × d)`` matrix product, not a float scatter: on
CUDA ``index_add_`` / ``scatter_add_`` / a weighted ``bincount`` add
with atomics in whatever order the threads arrive, while a product of
fixed shapes (TF32 off, ``repro_torch.device``) gives the same bits on
every call.  Same seed + same rows = same centroids, on every worker of
a cluster: the W > 1 path relies on every rank building the identical
index.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.result_heap import to_tensor
from repro_torch.device import resolve_device


def _assign_step(centroids: torch.Tensor, batch: torch.Tensor
                 ) -> torch.Tensor:
    """Nearest-centroid ids for one batch: argmin_c ||x - c||² (the
    first index on ties, as ``jnp.argmin``)."""
    c2 = (centroids * centroids).sum(dim=1)
    sims = batch @ centroids.T
    return torch.argmin(c2[None, :] - 2.0 * sims, dim=1)


def _train_step(centroids: torch.Tensor, counts: torch.Tensor,
                batch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One mini-batch update: assign, then move each hit centroid to the
    count-weighted running mean of everything ever assigned to it (the
    batched form of the per-sample ``c += (x - c) / count`` rule)."""
    k = centroids.shape[0]
    assign = _assign_step(centroids, batch)
    onehot = (assign[None, :] == torch.arange(
        k, device=batch.device)[:, None]).to(batch.dtype)
    # (k, b) @ (b, d): every cluster's row sum, in an order fixed by the
    # product's shapes; the hit counts are sums of ones, exact in float32
    sums = onehot @ batch
    hits = onehot.sum(dim=1)
    new_counts = counts + hits
    moved = ((centroids * counts[:, None] + sums)
             / torch.clamp(new_counts, min=1.0)[:, None])
    # a centroid no batch row hit must stay put, not decay toward zero
    centroids = torch.where((hits > 0)[:, None], moved, centroids)
    return centroids, new_counts


def _rows(x, device: torch.device) -> torch.Tensor:
    """A ``get_range`` result (array or tensor) as float32 on ``device``."""
    return to_tensor(x, device, torch.float32)


def train_kmeans(get_range, n_rows: int, n_clusters: int, *,
                 train_steps: int = 40, batch_size: int = 1024,
                 seed: int = 0,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Train ``min(n_clusters, n_rows)`` centroids off a row stream.

    ``get_range(lo, hi)`` returns rows ``[lo, hi)`` as an (hi-lo, d)
    array or tensor.  Each of the ``train_steps`` mini-batches is one
    contiguous window at a seeded-random start (cache rows arrive in
    corpus order, which is already topic-arbitrary, so contiguous
    windows behave like uniform samples while staying one mmap read).
    The steps run on ``device``.  Returns the centroids as a float32
    (k, d) numpy array.
    """
    if n_rows <= 0:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    if train_steps < 1:
        raise ValueError(f"train_steps must be >= 1, got {train_steps}")
    dev = resolve_device(device)
    k = int(min(n_clusters, n_rows))
    rng = np.random.default_rng(seed)
    init_rows = np.sort(rng.choice(n_rows, size=k, replace=False))
    centroids = torch.cat([_rows(get_range(int(r), int(r) + 1), dev)
                           for r in init_rows])
    # each centroid starts owning its seed row, so the first batches
    # can't yank a centroid across the space on a single stray sample
    counts = torch.ones(k, dtype=torch.float32, device=dev)
    b = int(min(batch_size, n_rows))
    with torch.no_grad():
        for _ in range(train_steps):
            lo = int(rng.integers(0, n_rows - b + 1))
            centroids, counts = _train_step(
                centroids, counts, _rows(get_range(lo, lo + b), dev))
    return centroids.cpu().numpy()


def assign_rows(centroids: np.ndarray, get_range, n_rows: int, *,
                batch_size: int = 4096,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Stream every row through nearest-centroid assignment.

    Returns an (n_rows,) int32 cluster id per row.  The ragged tail
    batch pads up to ``batch_size`` with zero rows, as the reference's
    does, so every product has one shape and a row's assignment does
    not depend on which batch it falls in.
    """
    dev = resolve_device(device)
    out = np.empty(n_rows, np.int32)
    cents = _rows(centroids, dev)
    b = int(min(batch_size, max(n_rows, 1)))
    with torch.no_grad():
        for lo in range(0, n_rows, b):
            hi = min(lo + b, n_rows)
            batch = _rows(get_range(lo, hi), dev)
            if hi - lo < b:
                batch = torch.cat([batch, batch.new_zeros(
                    (b - (hi - lo), batch.shape[1]))])
            out[lo:hi] = _assign_step(cents, batch)[: hi - lo].cpu().numpy()
    return out
