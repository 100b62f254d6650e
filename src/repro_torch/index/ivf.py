"""IVFIndex: a cluster-pruned (inverted-file) search layout.

The port of ``repro.index.ivf``.  An :class:`IVFIndex` turns any
row-addressable embedding store (an ``EmbeddingCache`` snapshot's mmap,
a device-resident tensor) into a sublinear search structure:

  * **build** — the mini-batch k-means coarse quantizer
    (:mod:`repro_torch.index.kmeans`, on the caller's device) is trained
    off contiguous ``get_range`` streams; every row is then assigned to
    its nearest centroid and the index keeps a *cluster-sorted row
    permutation* plus per-cluster ``[lo, hi)`` offsets.  The vectors are
    never copied: the permutation addresses the original store.
  * **query** — ``select(q_emb, nprobe)`` scores the query batch against
    the centroids on the host and returns the union of every query's
    ``nprobe`` nearest clusters, ascending; ``gather_rows`` concatenates
    the selected clusters' permutation slices.  The caller streams those
    rows through the unchanged superchunk executor (K1 / K2), so
    ``nprobe == n_clusters`` reproduces the flat ranking.
  * **persist** — ``save`` / ``load`` write ``centroids.bin`` /
    ``perm.bin`` / ``offsets.bin`` and atomically replace ``meta.json``
    last, like the embedding cache's commit: readers trust only the meta
    row counts, trailing torn bytes are ignored, and a load that cannot
    satisfy the meta (a crash mid-save, a stale corpus digest, a shape
    mismatch) returns ``None`` so callers rebuild.  The layout (version
    1) is the reference's byte for byte: an index either package saved
    loads in the other.

``select``, ``gather_rows`` and ``slice_boundaries`` are the reference's
numpy code, so given the same centroids and queries the two packages'
selections are bitwise equal.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
import torch

from repro_torch.index.kmeans import assign_rows, train_kmeans

_I64 = np.dtype("<i8")
_F32 = np.dtype("<f4")


def corpus_digest(hashes, *, seed: int = 0, train_steps: int = 40,
                  train_batch: int = 1024, generation=None) -> str:
    """Digest key binding a persisted index to the exact corpus it was
    built over: the id hashes, the build knobs, and — for a mutable
    cache-backed corpus — the cache generation, so a post-mutation
    ``load`` returns ``None`` (rebuild) instead of serving a permutation
    over another row set.  ``generation`` may be an int or a cache
    ``(generation, epoch)`` key.  The reference's string, exactly."""
    digest = hashlib.sha1(
        np.ascontiguousarray(hashes, np.int64).tobytes()).hexdigest()[:16]
    digest += f"-s{seed}-t{train_steps}-b{train_batch}"
    if generation is not None:
        if isinstance(generation, tuple):
            gen, epoch = generation
        else:
            gen, epoch = generation, 0
        digest += f"-g{int(gen)}e{int(epoch)}"
    return digest


def cluster_order(get_range, n_rows: int, n_clusters: int, *,
                  seed: int = 0, train_steps: int = 40,
                  train_batch: int = 1024,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """The cluster-sorted row permutation for ``n_rows`` rows served by
    ``get_range`` — what :meth:`EmbeddingCache.compact` takes as its
    ``order``, so compaction rewrites the live rows into the IVF layout
    (cluster-contiguous on disk)."""
    index = IVFIndex.build(get_range, n_rows,
                           int(min(n_clusters, max(n_rows, 1))),
                           seed=seed, train_steps=train_steps,
                           train_batch=train_batch, device=device)
    return index.perm


def _read_exact(path: str, dtype: np.dtype, count: int):
    """Exactly ``count`` items, or ``None`` if the file is missing or
    shorter (a torn write); trailing bytes beyond ``count`` are
    ignored, as the cache's reopen ignores them."""
    if not os.path.exists(path):
        return None
    arr = np.fromfile(path, dtype=dtype, count=count)
    if len(arr) != count:
        return None
    return arr


class IVFIndex:
    """Cluster-sorted layout: centroids (k, d), row permutation (n,),
    per-cluster offsets (k + 1,), cluster ``c`` owning the permutation
    slice ``perm[offsets[c]:offsets[c + 1]]`` (store rows in their
    original relative order: a stable sort).  All three are host numpy
    arrays."""

    def __init__(self, centroids: np.ndarray, perm: np.ndarray,
                 offsets: np.ndarray):
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self.perm = np.ascontiguousarray(perm, np.int64)
        self.offsets = np.ascontiguousarray(offsets, np.int64)
        if self.offsets.shape != (len(self.centroids) + 1,):
            raise ValueError(f"offsets {self.offsets.shape} for "
                             f"{len(self.centroids)} centroids")
        if self.offsets[0] != 0 or self.offsets[-1] != len(self.perm):
            raise ValueError(f"offsets run {self.offsets[0]}.."
                             f"{self.offsets[-1]}, not 0..{len(self.perm)}")

    @property
    def n_rows(self) -> int:
        return len(self.perm)

    @property
    def n_clusters(self) -> int:
        return len(self.centroids)

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def cluster_sizes(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    # -- build ----------------------------------------------------------------
    @classmethod
    def build(cls, get_range, n_rows: int, n_clusters: int, *,
              seed: int = 0, train_steps: int = 40,
              train_batch: int = 1024,
              device: str | torch.device = "cuda") -> "IVFIndex":
        """Train the quantizer on ``device`` and lay out the
        cluster-sorted permutation.  ``get_range(lo, hi)`` serves rows
        of the store being indexed; only a batch of rows is ever read at
        once."""
        centroids = train_kmeans(get_range, n_rows, n_clusters,
                                 train_steps=train_steps,
                                 batch_size=train_batch, seed=seed,
                                 device=device)
        assign = assign_rows(centroids, get_range, n_rows, device=device)
        # stable: rows of one cluster keep their original relative order,
        # so a full-probe scan replays the store in a fixed permutation
        perm = np.argsort(assign, kind="stable").astype(np.int64)
        sizes = np.bincount(assign, minlength=len(centroids))
        offsets = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(sizes, dtype=np.int64)])
        return cls(centroids, perm, offsets)

    # -- persistence ----------------------------------------------------------
    def save(self, path: str, *, digest: str | None = None) -> None:
        """Persist under ``path``, crash-safe like the embedding cache:
        payload files land first (tmp + atomic replace, names unique per
        thread so concurrent identical builders never collide), then
        ``meta.json`` replaces atomically — a reader sees the old
        committed index or the new one, never a torn mix."""
        os.makedirs(path, exist_ok=True)
        tag = f".tmp{os.getpid()}_{threading.get_ident()}"
        for fname, arr in (("centroids.bin", self.centroids.astype(_F32)),
                           ("perm.bin", self.perm.astype(_I64)),
                           ("offsets.bin", self.offsets.astype(_I64))):
            tmp = os.path.join(path, fname + tag)
            with open(tmp, "wb") as f:
                f.write(np.ascontiguousarray(arr).tobytes())
            os.replace(tmp, os.path.join(path, fname))
        meta = {"n": self.n_rows, "dim": self.dim,
                "n_clusters": self.n_clusters, "digest": digest,
                "version": 1}
        tmp = os.path.join(path, "meta.json" + tag)
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))

    @classmethod
    def load(cls, path: str, *, expect_n: int | None = None,
             expect_dim: int | None = None,
             expect_clusters: int | None = None,
             expect_digest: str | None = None) -> "IVFIndex | None":
        """Reopen a persisted layout; ``None`` means "rebuild": missing
        or torn files, or a meta that does not describe the corpus the
        caller is about to search (row count / dim / cluster count /
        content digest)."""
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        n, dim, k = meta.get("n"), meta.get("dim"), meta.get("n_clusters")
        if not all(isinstance(v, int) and v >= 0 for v in (n, dim, k)):
            return None
        for want, got in ((expect_n, n), (expect_dim, dim),
                          (expect_clusters, k)):
            if want is not None and want != got:
                return None
        if expect_digest is not None and meta.get("digest") != expect_digest:
            return None
        cents = _read_exact(os.path.join(path, "centroids.bin"), _F32,
                            k * dim)
        perm = _read_exact(os.path.join(path, "perm.bin"), _I64, n)
        offsets = _read_exact(os.path.join(path, "offsets.bin"), _I64,
                              k + 1)
        if cents is None or perm is None or offsets is None:
            return None
        offsets = offsets.astype(np.int64)
        if (offsets[0] != 0 or offsets[-1] != n
                or (np.diff(offsets) < 0).any()):
            return None
        # perm must be a permutation of [0, n): a torn perm.bin whose
        # byte count happens to line up must still be rejected
        if n and (perm.min() < 0 or perm.max() >= n):
            return None
        if n and (np.bincount(perm, minlength=n) != 1).any():
            return None
        return cls(cents.reshape(k, dim), perm.astype(np.int64), offsets)

    # -- query ----------------------------------------------------------------
    def select(self, q_emb, nprobe: int) -> np.ndarray:
        """Union of each query's ``nprobe`` nearest (squared-L2)
        clusters, ascending, empty clusters dropped.  On the host: the
        centroid table is tiny next to the corpus, and the selection
        drives host-side gather planning anyway."""
        if isinstance(q_emb, torch.Tensor):
            q_emb = q_emb.detach().cpu().numpy()
        q = np.asarray(q_emb, np.float32)
        if q.ndim == 1:
            q = q[None]
        k = self.n_clusters
        nprobe = max(1, min(int(nprobe), k))
        if nprobe >= k:
            clusters = np.arange(k, dtype=np.int64)
        else:
            c2 = (self.centroids * self.centroids).sum(axis=1)
            d2 = c2[None, :] - 2.0 * (q @ self.centroids.T)
            part = np.argpartition(d2, nprobe - 1, axis=1)[:, :nprobe]
            clusters = np.unique(part).astype(np.int64)
        sizes = self.offsets[clusters + 1] - self.offsets[clusters]
        return clusters[sizes > 0]

    def gather_rows(self, clusters: np.ndarray) -> np.ndarray:
        """Concatenated store-row indices of the selected clusters — the
        contiguous permutation slices the search space streams."""
        if len(clusters) == 0:
            return np.empty(0, np.int64)
        return np.concatenate(
            [self.perm[self.offsets[c]:self.offsets[c + 1]]
             for c in clusters])

    def slice_boundaries(self, clusters: np.ndarray) -> np.ndarray:
        """Cumulative cluster edges inside the selected search space
        (``[0, s1, s1+s2, ..., n_selected]``) — the cut points a fair
        sharder may split at so every shard stays a run of whole
        clusters."""
        sizes = self.offsets[clusters + 1] - self.offsets[clusters]
        return np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(sizes, dtype=np.int64)])
