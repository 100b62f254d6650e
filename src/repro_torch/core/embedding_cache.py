"""Memory-mapped, generation-versioned embedding cache (paper §3.2.2).

The port's counterpart of ``repro.core.embedding_cache``, with the same
on-disk format (``meta.json``, ``vectors*.bin``, ``ids*.bin``,
``tombstones*.bin``, the same dtypes and meta keys), so a cache written
by either package opens in the other.  It is host storage: numpy and
``np.memmap``, no tensors; the search driver casts each streamed
superchunk to float32 and uploads it once.

``cache_records(ids, vectors)`` appends; vectors are served from an
``np.memmap`` so only requested rows are faulted in.  Both the vector
payload and the id index are **append-only** files — an append writes
only the new rows' bytes (O(delta), not O(n)).  Crash safety is kept via
the meta file: a record batch is appended to the payload files first,
then ``meta.json`` is atomically replaced (pid-unique tmp +
``os.replace``) with the new committed counts.  Readers trust only the
meta counts — torn trailing bytes from a crashed append are ignored and
truncated away before the next append so row alignment between the
files can never drift.

Live corpus mutation (generation log)
-------------------------------------
The cache is a *log*, not a table:

  * re-caching an existing id appends a new row — lookups are
    **last-write-wins** (the newest committed row for a hash wins);
  * :meth:`delete_records` appends a *tombstone* ``(hash, seq)`` to
    ``tombstones.bin`` where ``seq`` is the committed row count at
    delete time: the tombstone kills every row of that hash below
    ``seq``, and a later re-add (row ≥ seq) resurrects the id;
  * every committed mutation bumps ``generation``; ``meta.json`` keeps
    a bounded history of ``(generation, n_rows, n_tombstones)`` triples
    so past generations stay resolvable;
  * :meth:`snapshot` pins an immutable view of one generation — a live
    row set + id→row map that ``get_range`` / ``get_rows`` /
    ``row_plan`` all honor.  A reader pinned to generation g never sees
    rows from g+1 or resurrected tombstones, even mid-compaction.

:meth:`compact` rewrites the live rows into a fresh payload *epoch*
(``vectors.e<k>.bin`` / ``ids.e<k>.bin``), optionally permuted into the
IVF cluster-sorted layout, using the same pid-unique tmp +
atomic-replace + meta-last protocol.  Writers are only blocked for the
short catch-up append at the end; pinned readers keep streaming the old
epoch, whose files are retired only once no pinned reader remains.
Crash at any point (the ``compact_payload`` / ``compact_meta`` /
``compact_swap`` fault-injection points) reopens to exactly the pre- or
post-compaction generation — never a torn hybrid; stray epoch files are
swept on open.

Thread-safety: one instance may be shared by the sharded search driver's
prefetch thread and by simulated-cluster worker threads — mutations are
serialized under a lock and reads snapshot the (index, perm, mmap)
triple under the same lock, so a concurrent append can never mix old
row mappings with a new mmap.
"""

from __future__ import annotations

import glob
import json
import os
import threading

import numpy as np

from repro_torch.data.table import stable_id_hash, stable_id_hash_array

_IDS_DTYPE = np.dtype("<i8")
# tombstones are (id_hash, rows_at_delete) int64 pairs
_TOMB_DTYPE = np.dtype("<i8")
# generations resolvable via snapshot(generation=g); older ones age out
_HISTORY_KEEP = 256


def _live_rows(ids, tombs, n: int, n_tombs: int) -> np.ndarray:
    """Row indices (ascending) live at log position ``(n, n_tombs)``:
    the newest row per hash (last-write-wins), minus rows killed by a
    tombstone whose ``seq`` exceeds the winning row's index."""
    if n == 0:
        return np.empty(0, np.int64)
    ids = np.asarray(ids[:n], np.int64)
    perm = np.argsort(ids, kind="stable")
    sids = ids[perm]
    last = np.empty(n, bool)
    last[:-1] = sids[1:] != sids[:-1]
    last[-1] = True
    winners = perm[last]          # newest row per unique hash
    if n_tombs:
        uids = sids[last]
        t = np.asarray(tombs[:n_tombs], np.int64)
        pos = np.minimum(np.searchsorted(uids, t[:, 0]), len(uids) - 1)
        valid = uids[pos] == t[:, 0]
        dead_seq = np.zeros(len(uids), np.int64)
        np.maximum.at(dead_seq, pos[valid], t[valid, 1])
        winners = winners[winners >= dead_seq]
    winners.sort()
    return winners


class CacheSnapshot:
    """An immutable, pinned view of one cache generation.

    ``ids`` holds the live id hashes in insertion (winning-row) order;
    positions are *live-space* — ``get_range(lo, hi)`` / ``get_rows``
    address ``[0, n_live)`` and resolve through the frozen live-row map,
    so the view never changes under later appends, deletes, or
    compactions.  The snapshot pins its payload epoch: compaction
    retires the old epoch's files only once every snapshot on it is
    closed (or garbage-collected).
    """

    def __init__(self, cache: "EmbeddingCache", epoch: int, generation: int,
                 n: int, n_tombs: int, ids, mmap, tombs):
        self._cache = cache
        self.epoch = epoch
        self.generation = generation
        self.dim = cache.dim
        self.dtype = cache.dtype
        self._rows = _live_rows(ids, tombs, n, n_tombs)
        self.ids = (np.asarray(ids[:n], np.int64)[self._rows]
                    if n else np.empty(0, np.int64))
        self.n_live = len(self._rows)
        self._mmap = mmap
        self._contig = self.n_live == n  # live rows are exactly [0, n)
        self._sorted = None
        self._closed = False

    @property
    def key(self) -> tuple[int, int]:
        """Agreement key for multi-worker rounds: compaction changes the
        physical row layout without changing the generation, so workers
        must agree on ``(generation, epoch)``, not the generation
        alone."""
        return (self.generation, self.epoch)

    def __len__(self):
        return self.n_live

    # -- reads (live-space positions) -----------------------------------------
    def get_range(self, lo: int, hi: int) -> np.ndarray:
        if not 0 <= lo <= hi <= self.n_live:
            raise IndexError(
                f"range [{lo}, {hi}) outside [0, {self.n_live}]")
        if lo == hi:
            return np.empty((0, self.dim), self.dtype)
        if self._contig:
            return np.asarray(self._mmap[lo:hi])
        return np.asarray(self._mmap[self._rows[lo:hi]])

    def get_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        if len(rows) and (rows.min() < 0 or rows.max() >= self.n_live):
            bad = rows[(rows < 0) | (rows >= self.n_live)]
            raise IndexError(
                f"{len(bad)} row(s) outside [0, {self.n_live}) (e.g. "
                f"{bad[:5].tolist()}); positions are live-space for "
                f"generation {self.generation}")
        if not len(rows):
            return np.empty((0, self.dim), self.dtype)
        if self._contig:
            return np.asarray(self._mmap[rows])
        return np.asarray(self._mmap[self._rows[rows]])

    def _positions(self, hashes: np.ndarray) -> np.ndarray:
        """Live-space position per hash (-1 = not live in this view)."""
        if self._sorted is None:
            order = np.argsort(self.ids)     # live ids are unique
            self._order = order
            self._sorted = self.ids[order]
        if not self.n_live:
            return np.full(len(hashes), -1, np.int64)
        pos = np.minimum(np.searchsorted(self._sorted, hashes),
                         self.n_live - 1)
        ok = self._sorted[pos] == hashes
        return np.where(ok, self._order[pos], -1)

    def has(self, ids) -> np.ndarray:
        return self._positions(stable_id_hash_array(ids)) >= 0

    def get(self, ids) -> np.ndarray:
        pos = self._positions(stable_id_hash_array(ids))
        if (pos < 0).any():
            missing = np.flatnonzero(pos < 0)
            sample = ", ".join(repr(ids[int(i)]) for i in missing[:5])
            more = "" if len(missing) <= 5 else ", ..."
            raise KeyError(f"{len(missing)} ids not live in generation "
                           f"{self.generation} (e.g. {sample}{more})")
        return self.get_rows(pos)

    def row_plan(self, hashes: np.ndarray):
        """Same contract as :meth:`EmbeddingCache.row_plan`, but
        positions are live-space (feed them to :meth:`get_rows` of this
        snapshot, not of the cache)."""
        hashes = np.asarray(hashes, np.int64)
        if len(self.ids) == len(hashes) and np.array_equal(self.ids,
                                                           hashes):
            return ("range", None)
        if self.n_live:
            pos = self._positions(hashes)
            if not (pos < 0).any():
                return ("rows", pos)
        return None

    # -- pin lifetime ---------------------------------------------------------
    def close(self):
        if not self._closed:
            self._closed = True
            self._cache._unpin(self.epoch)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class EmbeddingCache:
    def __init__(self, path: str, dim: int, dtype=np.float16):
        self.path = path
        self.dim = dim
        self.dtype = np.dtype(dtype)
        # optional FaultInjector (repro_torch.core.faults) consulted
        # between the write steps of one append / compaction — lets
        # chaos tests produce real torn-on-disk states instead of
        # hand-truncating files
        self.fault_injector = None
        os.makedirs(path, exist_ok=True)
        self._legacy_ids_path = os.path.join(path, "ids.npy")
        self._meta_path = os.path.join(path, "meta.json")
        self._epoch = 0
        self._gen = 0
        self._n = 0
        self._n_tombs = 0
        self._history = [[0, 0, 0]]
        self._set_epoch_paths(0)
        self._ids = np.empty(0, np.int64)
        self._tombs = np.empty((0, 2), np.int64)
        self._sorted = None
        self._live = None
        self._mmap = None
        self._pins: dict[int, int] = {}
        self._retired: dict[int, dict] = {}
        self._lock = threading.RLock()
        self._load()

    # -- layout ---------------------------------------------------------------
    def _epoch_paths(self, epoch: int) -> tuple[str, str, str]:
        if epoch == 0:     # epoch 0 keeps the original file names
            names = ("vectors.bin", "ids.bin", "tombstones.bin")
        else:
            names = (f"vectors.e{epoch}.bin", f"ids.e{epoch}.bin",
                     f"tombstones.e{epoch}.bin")
        return tuple(os.path.join(self.path, nm) for nm in names)

    def _set_epoch_paths(self, epoch: int):
        self._vec_path, self._ids_path, self._tombs_path = \
            self._epoch_paths(epoch)

    def _tmp_tag(self) -> str:
        return f".tmp{os.getpid()}_{threading.get_ident()}"

    def _load(self):
        if not os.path.exists(self._meta_path):
            return
        with open(self._meta_path) as f:
            meta = json.load(f)
        if meta["dim"] != self.dim:
            raise ValueError(
                f"embedding cache {self.path} holds rows of dim "
                f"{meta['dim']}, not {self.dim}: another encoder's cache")
        self.dtype = np.dtype(meta["dtype"])
        n = int(meta["n"])
        # pre-generation metas: epoch 0, no tombstones, one synthetic
        # generation covering whatever rows were committed
        self._epoch = int(meta.get("epoch", 0))
        self._gen = int(meta.get("generation", 1 if n else 0))
        self._n_tombs = int(meta.get("n_tombstones", 0))
        self._history = [list(map(int, h)) for h in meta.get(
            "history", [[self._gen, n, self._n_tombs]])]
        self._set_epoch_paths(self._epoch)
        if (os.path.exists(self._legacy_ids_path)
                and not os.path.exists(self._ids_path)):
            # one-shot migration from the legacy full-rewrite ids.npy
            # layout (atomic: tmp + replace; the .npy is kept as-is and
            # simply ignored once ids.bin exists)
            legacy = np.load(self._legacy_ids_path)
            tmp = self._ids_path + self._tmp_tag()
            with open(tmp, "wb") as f:
                f.write(np.ascontiguousarray(legacy, _IDS_DTYPE).tobytes())
            os.replace(tmp, self._ids_path)
        self._sweep_stray_files()
        self._truncate_uncommitted(n, self._n_tombs)
        self._refresh(n, self._n_tombs)

    def _sweep_stray_files(self):
        """Remove payload files that do not belong to the committed
        epoch: a crash between a compaction's meta commit and its
        old-file retirement (or before its meta commit) leaves the
        losing epoch's files behind."""
        keep = set(self._epoch_paths(self._epoch))
        for pat in ("vectors*.bin*", "ids*.bin*", "tombstones*.bin*"):
            for p in glob.glob(os.path.join(self.path, pat)):
                if p not in keep and os.path.isfile(p):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    def _truncate_uncommitted(self, n: int, n_tombs: int):
        """Drop torn trailing bytes left by a crashed append: everything
        past the committed counts in any payload file is garbage."""
        for fpath, row_bytes, rows in (
                (self._ids_path, _IDS_DTYPE.itemsize, n),
                (self._vec_path, self.dim * self.dtype.itemsize, n),
                (self._tombs_path, 2 * _TOMB_DTYPE.itemsize, n_tombs)):
            want = rows * row_bytes
            if os.path.exists(fpath) and os.path.getsize(fpath) > want:
                with open(fpath, "r+b") as f:
                    f.truncate(want)

    def _refresh(self, n: int, n_tombs: int):
        self._n = n
        self._n_tombs = n_tombs
        self._ids = (np.memmap(self._ids_path, dtype=_IDS_DTYPE, mode="r",
                               shape=(n,)) if n else np.empty(0, np.int64))
        self._mmap = (np.memmap(self._vec_path, dtype=self.dtype, mode="r",
                                shape=(n, self.dim)) if n else None)
        if n_tombs and os.path.exists(self._tombs_path):
            self._tombs = np.fromfile(
                self._tombs_path, dtype=_TOMB_DTYPE,
                count=2 * n_tombs).reshape(-1, 2)
        else:
            self._tombs = np.empty((0, 2), np.int64)
        self._sorted = None
        self._live = None

    def __len__(self):
        """Committed *physical* rows (the log length, superseded and
        tombstoned rows included); see :attr:`n_live` for the logical
        corpus size."""
        return self._n

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def generation_key(self) -> tuple[int, int]:
        with self._lock:
            return (self._gen, self._epoch)

    @property
    def n_live(self) -> int:
        return len(self._live_rows_locked())

    def _on_fault(self, point: str):
        if self.fault_injector is not None:
            self.fault_injector.on_cache(point)

    # -- write ----------------------------------------------------------------
    def _write_meta(self, n: int, n_tombs: int):
        tmp_meta = self._meta_path + self._tmp_tag()
        with open(tmp_meta, "w") as f:
            json.dump({"dim": self.dim, "dtype": self.dtype.name,
                       "n": n, "version": 2, "epoch": self._epoch,
                       "generation": self._gen,
                       "n_tombstones": n_tombs,
                       "history": self._history}, f)
        os.replace(tmp_meta, self._meta_path)

    def _commit(self, n: int, n_tombs: int):
        """Meta-last commit of one mutation: bump the generation, extend
        the history, atomically replace meta.json, re-mmap."""
        self._gen += 1
        self._history.append([self._gen, n, n_tombs])
        del self._history[:-_HISTORY_KEEP]
        self._write_meta(n, n_tombs)
        self._refresh(n, n_tombs)

    def cache_records(self, ids, vectors: np.ndarray):
        """Append (ids, vectors); re-caching an existing id appends a
        new version that wins every later lookup.  ids: raw ids or int
        hashes."""
        vectors = np.asarray(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"vectors must be (n, {self.dim}), got shape "
                f"{vectors.shape}")
        hashes = stable_id_hash_array(ids)
        if len(hashes) != len(vectors):
            raise ValueError(
                f"ids/vectors length mismatch: {len(hashes)} ids vs "
                f"{len(vectors)} vector rows")
        with np.errstate(over="ignore"):
            # overflow in a narrowing cast shows up as inf below and is
            # rejected with the offending positions, not warned about
            vectors = np.ascontiguousarray(vectors, dtype=self.dtype)
        bad = np.flatnonzero(~np.isfinite(vectors).all(axis=1))
        if len(bad):
            more = "" if len(bad) <= 5 else ", ..."
            raise ValueError(
                f"non-finite embedding vectors: {len(bad)} row(s) "
                f"contain NaN/inf after cast to {self.dtype.name} "
                f"(positions {bad[:5].tolist()}{more})")
        with self._lock:
            n = self._n
            self._truncate_uncommitted(n, self._n_tombs)
            with open(self._vec_path, "ab") as f:
                f.write(vectors.tobytes())
            # crash mid-append: vector payload on disk, id index not
            self._on_fault("payload")
            with open(self._ids_path, "ab") as f:
                f.write(np.ascontiguousarray(hashes, _IDS_DTYPE).tobytes())
            # crash after both payloads but before the meta commit
            self._on_fault("meta")
            self._commit(n + len(hashes), self._n_tombs)

    def delete_records(self, ids):
        """Tombstone ``ids``: append ``(hash, committed_row_count)``
        pairs — every existing row of those hashes is dead from the next
        generation on; a later :meth:`cache_records` of the same id
        resurrects it.  Deleting an id that was never cached is a no-op
        tombstone (still a new generation)."""
        hashes = stable_id_hash_array(ids)
        if not len(hashes):
            return
        with self._lock:
            n, nt = self._n, self._n_tombs
            self._truncate_uncommitted(n, nt)
            pairs = np.empty((len(hashes), 2), _TOMB_DTYPE)
            pairs[:, 0] = hashes
            pairs[:, 1] = n
            with open(self._tombs_path, "ab") as f:
                f.write(pairs.tobytes())
            # crash after the tombstone append, before the meta commit
            self._on_fault("tombstone")
            self._commit(n, nt + len(hashes))

    # -- snapshots ------------------------------------------------------------
    def snapshot(self, generation=None) -> CacheSnapshot:
        """Pin an immutable view.  ``generation`` may be ``None`` (the
        newest committed generation), an int (resolved in the current
        epoch's history), or a ``(generation, epoch)`` key from another
        snapshot — resolvable across a compaction as long as a pinned
        reader kept the old epoch alive."""
        with self._lock:
            if generation is None:
                gen, epoch = self._gen, self._epoch
            elif isinstance(generation, tuple):
                gen, epoch = int(generation[0]), int(generation[1])
            else:
                gen, epoch = int(generation), self._epoch
            if epoch == self._epoch:
                ids, mmap, tombs = self._ids, self._mmap, self._tombs
                history = self._history
            else:
                st = self._retired.get(epoch)
                if st is None:
                    raise KeyError(
                        f"epoch {epoch} is retired (no pinned reader "
                        f"kept it alive); current epoch is "
                        f"{self._epoch}")
                ids, mmap, tombs = st["ids"], st["mmap"], st["tombs"]
                history = st["history"]
            for g, n, nt in reversed(history):
                if g == gen:
                    break
            else:
                raise KeyError(
                    f"generation {gen} not resolvable in epoch {epoch} "
                    f"(history keeps the last {_HISTORY_KEEP} "
                    f"generations; compaction drops pre-compaction "
                    f"entries)")
            self._pins[epoch] = self._pins.get(epoch, 0) + 1
            return CacheSnapshot(self, epoch, gen, n, nt, ids, mmap,
                                 tombs)

    def _unpin(self, epoch: int):
        drop_paths = None
        with self._lock:
            count = self._pins.get(epoch, 0) - 1
            if count > 0:
                self._pins[epoch] = count
            else:
                self._pins.pop(epoch, None)
                if epoch != self._epoch and epoch in self._retired:
                    drop_paths = self._retired.pop(epoch)["paths"]
        if drop_paths:
            for p in drop_paths:
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- compaction -----------------------------------------------------------
    def compact(self, order=None) -> dict:
        """Rewrite the live rows into a fresh payload epoch, dropping
        superseded rows and applied tombstones.  ``order`` optionally
        permutes the live rows (live-space positions — e.g. an IVF
        cluster-sorted permutation).

        Zero-downtime: the payload rewrite streams outside the write
        lock; writers are blocked only for the final catch-up append
        (rows/tombstones committed since the compaction snapshot) and
        the meta swap.  Pinned snapshots keep reading the old epoch,
        whose files are removed only when the last pin drops.  The
        logical content — and therefore the generation — is unchanged.
        """
        with self._lock:
            n0, nt0, g0 = self._n, self._n_tombs, self._gen
            old_epoch = self._epoch
            ids0, tombs0, old_mmap = self._ids, self._tombs, self._mmap
            live = _live_rows(ids0, tombs0, n0, nt0)
        if order is not None:
            order = np.asarray(order, np.int64)
            if (len(order) != len(live)
                    or (len(order)
                        and not np.array_equal(np.sort(order),
                                               np.arange(len(live))))):
                raise ValueError(
                    f"order must be a permutation of the {len(live)} "
                    f"live rows")
            rows = live[order]
        else:
            rows = live
        n_live = len(rows)
        new_epoch = old_epoch + 1
        new_vec, new_ids, new_tombs = self._epoch_paths(new_epoch)
        tag = self._tmp_tag()
        # payload first (pid-unique tmp + atomic replace), meta last
        with open(new_vec + tag, "wb") as f:
            for s in range(0, n_live, 65536):
                block = rows[s:s + 65536]
                f.write(np.ascontiguousarray(
                    old_mmap[block], self.dtype).tobytes())
        os.replace(new_vec + tag, new_vec)
        with open(new_ids + tag, "wb") as f:
            f.write(np.ascontiguousarray(
                np.asarray(ids0[:n0], np.int64)[rows],
                _IDS_DTYPE).tobytes())
        os.replace(new_ids + tag, new_ids)
        # crash here: meta still names the old epoch — reopen is
        # pre-compaction, the new epoch's files are swept as strays
        self._on_fault("compact_payload")
        with self._lock:
            n1, nt1 = self._n, self._n_tombs
            if n1 > n0:
                # rows committed since the snapshot carry over verbatim
                with open(new_vec, "ab") as f:
                    f.write(np.ascontiguousarray(
                        self._mmap[n0:n1], self.dtype).tobytes())
                with open(new_ids, "ab") as f:
                    f.write(np.ascontiguousarray(
                        np.asarray(self._ids[n0:n1], np.int64),
                        _IDS_DTYPE).tobytes())
            if nt1 > nt0:
                # remap seq: old row r >= n0 lands at n_live + (r - n0)
                t = np.array(self._tombs[nt0:nt1], _TOMB_DTYPE)
                t[:, 1] = n_live + (t[:, 1] - n0)
                with open(new_tombs, "ab") as f:
                    f.write(np.ascontiguousarray(t,
                                                 _TOMB_DTYPE).tobytes())
            new_n = n_live + (n1 - n0)
            new_nt = nt1 - nt0
            # history entries from the snapshot generation on remap into
            # the new epoch; older generations age out with the old one
            new_history = [[g, n_live + (n - n0), nt - nt0]
                           for g, n, nt in self._history if g >= g0]
            # crash here: catch-up written but meta not replaced —
            # still pre-compaction on reopen
            self._on_fault("compact_meta")
            old_state = {"ids": ids0, "mmap": old_mmap, "tombs": tombs0,
                         "history": self._history,
                         "paths": self._epoch_paths(old_epoch)}
            self._epoch = new_epoch
            self._history = new_history
            self._set_epoch_paths(new_epoch)
            self._write_meta(new_n, new_nt)
            self._refresh(new_n, new_nt)
            pinned = self._pins.get(old_epoch, 0) > 0
            if pinned:
                self._retired[old_epoch] = old_state
            # crash here: meta already names the new epoch — reopen is
            # post-compaction, the old epoch's files are swept as strays
            self._on_fault("compact_swap")
            if not pinned:
                for p in old_state["paths"]:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        return {"epoch": new_epoch, "rows_before": n1, "rows_after": new_n,
                "dropped": n1 - new_n, "tombstones_applied": nt0}

    # -- read -----------------------------------------------------------------
    def _live_rows_locked(self) -> np.ndarray:
        with self._lock:
            if self._live is None:
                self._live = _live_rows(self._ids, self._tombs, self._n,
                                        self._n_tombs)
            return self._live

    def _index(self):
        """Consistent (sorted_live_ids, perm, mmap) snapshot: lookups
        resolve to the newest non-tombstoned row per hash (see module
        doc)."""
        with self._lock:
            if self._sorted is None:
                live = self._live_rows_locked()
                lids = (np.asarray(self._ids, np.int64)[live]
                        if len(live) else np.empty(0, np.int64))
                order = np.argsort(lids)       # live ids are unique
                self._perm = live[order]
                self._sorted = lids[order]
            return self._sorted, self._perm, self._mmap

    def _rows_for(self, hashes: np.ndarray,
                  sorted_ids=None, perm=None) -> np.ndarray:
        if sorted_ids is None:
            sorted_ids, perm, _ = self._index()
        if not len(sorted_ids):
            return np.full(len(hashes), -1, np.int64)
        pos = np.searchsorted(sorted_ids, hashes)
        pos = np.clip(pos, 0, len(sorted_ids) - 1)
        ok = sorted_ids[pos] == hashes
        rows = np.where(ok, perm[pos], -1)
        return rows

    def __contains__(self, raw_id) -> bool:
        if not self._n:
            return False
        h = np.asarray([stable_id_hash(raw_id)], np.int64)
        return bool(self._rows_for(h)[0] >= 0)

    def has(self, ids) -> np.ndarray:
        if not self._n:
            return np.zeros(len(ids), bool)
        return self._rows_for(stable_id_hash_array(ids)) >= 0

    def get(self, ids) -> np.ndarray:
        """Lazy fetch: only the requested rows are read from disk;
        resolves to each id's newest live version."""
        if not self._n:
            raise KeyError(f"{len(ids)} ids not cached (cache empty)")
        sorted_ids, perm, mmap = self._index()
        rows = self._rows_for(stable_id_hash_array(ids), sorted_ids, perm)
        if (rows < 0).any():
            missing = np.flatnonzero(rows < 0)
            sample = ", ".join(repr(ids[int(i)]) for i in missing[:5])
            more = "" if len(missing) <= 5 else ", ..."
            raise KeyError(
                f"{len(missing)} ids not cached (e.g. {sample}{more})")
        return np.asarray(mmap[rows])

    def get_one(self, raw_id) -> np.ndarray:
        return self.get([raw_id])[0]

    # -- bulk plans (superchunk streaming) ---------------------------------------
    def ids_array(self) -> np.ndarray:
        """Committed id hashes in insertion (row) order — the raw log,
        superseded and tombstoned rows included."""
        with self._lock:
            return np.asarray(self._ids)

    def live_ids(self) -> np.ndarray:
        """Live id hashes in insertion (winning-row) order."""
        with self._lock:
            live = self._live_rows_locked()
            return (np.asarray(self._ids, np.int64)[live]
                    if len(live) else np.empty(0, np.int64))

    def get_range(self, lo: int, hi: int) -> np.ndarray:
        """Physical rows ``[lo, hi)`` in insertion order: one contiguous
        mmap read, no searchsorted — the streaming fast path when the
        cache's row order is the corpus order (see :meth:`row_plan`)."""
        with self._lock:
            n, mmap = self._n, self._mmap
        if not 0 <= lo <= hi <= n:
            raise IndexError(f"range [{lo}, {hi}) outside [0, {n}]")
        if lo == hi:
            return np.empty((0, self.dim), self.dtype)
        return np.asarray(mmap[lo:hi])

    def get_rows(self, rows: np.ndarray) -> np.ndarray:
        """Fetch explicit physical row numbers (from a precomputed
        plan).

        Rows must be in ``[0, n)``: a stale plan carrying ``-1``
        missing-id sentinels (what :meth:`_rows_for` returns) used to
        wrap via fancy indexing and silently serve the *last* row's
        embedding — now it's an ``IndexError``.
        """
        with self._lock:
            n, mmap = self._n, self._mmap
        rows = np.asarray(rows)
        if len(rows) and (rows.min() < 0 or rows.max() >= n):
            bad = rows[(rows < 0) | (rows >= n)]
            raise IndexError(
                f"{len(bad)} row(s) outside [0, {n}) (e.g. "
                f"{bad[:5].tolist()}); negative rows usually mean a "
                f"stale plan with -1 missing-id sentinels")
        if not len(rows):
            return np.empty((0, self.dim), self.dtype)
        return np.asarray(mmap[rows])

    def row_plan(self, hashes: np.ndarray):
        """One-shot lookup plan for streaming ``hashes`` in order.

        Returns ``("range", None)`` when the cache rows are exactly
        ``hashes`` in insertion order with nothing superseded or
        tombstoned (chunks can use :meth:`get_range` — zero per-chunk
        index work), ``("rows", rows)`` when every hash resolves to a
        live row but permuted (one upfront searchsorted instead of one
        per chunk), or ``None`` if any hash is missing or deleted
        (callers fall back to the encode-missing path)."""
        hashes = np.asarray(hashes, np.int64)
        with self._lock:
            live = self._live_rows_locked()
            ids = np.asarray(self._ids)
        if (len(live) == self._n and len(ids) == len(hashes)
                and np.array_equal(ids, hashes)):
            return ("range", None)
        if len(live):
            rows = self._rows_for(hashes)
            if not (rows < 0).any():
                return ("rows", rows)
        return None
